"""Flow records of an ingester tier: the `flows` generator's records,
each batch cut into one contiguous slice per ingester card, every slice
drawn from its own card's flows.

DeepFlow's server scales sideways: the controller assigns each agent to
one analyzer (ingester), so an ingester sees only its own agents'
flows. A mix of this generator (`cards` C) splits the `tuples` 5-tuples
into C disjoint sets of tuples / C and the `pod_ips` pods into C
disjoint parts of pod_ips / C: set c's tuples take their client pod
from part c and their server pod from all the pods, as `flows` draws
it. Card c's slice of every batch (rows c·n … (c+1)·n of the
`records_per_batch` = C·n) draws its tuples from set c alone, by the
mix's key draw within the set. So no client and no flow key spans two
cards, while a server is reached from several: a server-side document
key can be on more than one card. Everything else — the counter-based
draws (the same bits on the CPU and the card), the meters, ports,
protocols, late classes, the pool and its re-stamp — is `flows`'s.

`card(c)` is card c's slice as a stream of its own (the same batches'
rows c·n … (c+1)·n), for references computed a card at a time.
"""

from __future__ import annotations

import torch

from .flows import (
    S_KEY_A,
    S_KEY_B,
    S_POP_IP0,
    S_IP_OFFSET,
    FlowStream,
    draw_range,
    draw_unit,
    stream_keys,
)


class CardFlowStream(FlowStream):
    """The records of one mix for one seed, cut by card."""

    def __init__(self, mix: dict, seed: int, device):
        self.cards = int(mix["cards"])
        rows, tuples, pods = (int(mix[k]) for k in ("records_per_batch", "tuples", "pod_ips"))
        if rows % self.cards or tuples % self.cards or pods % self.cards:
            raise ValueError(f"records_per_batch {rows}, tuples {tuples} and pod_ips {pods} "
                             f"must split over {self.cards} cards")
        self.card_rows = rows // self.cards
        self.card_tuples = tuples // self.cards
        self.card_pods = pods // self.cards
        # the base draws the whole population; its key CDF is over one set
        super().__init__({**mix, "tuples": self.card_tuples}, seed, device)
        self.mix = mix
        self._population_by_card()

    def _population(self) -> None:
        """Filled by `_population_by_card` once the sizes are set."""

    def _population_by_card(self) -> None:
        mix, seed = self.mix, self.seed
        # the base's population over every tuple (its draws, ports,
        # protocols, VPCs, process ids and directions) ...
        FlowStream._population(self)
        i = torch.arange(int(mix["tuples"]), dtype=torch.int64, device=self.device)
        # ... with the client pod of set c's tuples in part c (the same
        # odd-multiplier bijection onto 10.0.0.0/8 as the base's); the
        # server pod stays the base's draw over every pod
        off = stream_keys(seed, S_IP_OFFSET)[0] & 0xFFFFFF
        base = (i // self.card_tuples) * self.card_pods
        pod0 = base + draw_range(seed, S_POP_IP0, i, 0, self.card_pods)
        self.pop["ip0_w3"] = 0x0A000000 | ((pod0 * 0x9E3779B1 + off) & 0xFFFFFF)
        self.pop["pod_id"] = pod0 + 1

    def card_of_tuple(self, t: torch.Tensor) -> torch.Tensor:
        return t // self.card_tuples

    def keys(self, b: int) -> torch.Tensor:
        """The tuple index of every record of pool batch b: card c's rows
        draw from set c."""
        idx = self._row_index(b)
        if self.mix["key_draw"] == "zipf":
            u = draw_unit(self.seed, S_KEY_A, S_KEY_B, idx)
            r = torch.searchsorted(self._cdf, u, right=True).clamp_(max=self.card_tuples - 1)
        else:
            r = draw_range(self.seed, S_KEY_A, idx, 0, self.card_tuples)
        card = (idx - b * self.rows) // self.card_rows
        return card * self.card_tuples + r

    def card(self, c: int) -> "CardSlice":
        return CardSlice(self, c)


class CardSlice:
    """Card c's rows of every batch of a CardFlowStream, with the stream
    interface the references read (`batch`, `pool_of`, `time_of`, the
    sizes and the late bound)."""

    def __init__(self, stream: CardFlowStream, c: int):
        if not 0 <= c < stream.cards:
            raise ValueError(f"card {c} outside [0, {stream.cards})")
        self.stream, self.c = stream, c
        self.rows = stream.card_rows
        self.pool, self.start_time, self.max_late = stream.pool, stream.start_time, \
            stream.max_late
        self.device = stream.device

    def batch(self, b: int, t: int | None = None):
        """Card c's slice of pool batch b (tags, meters, lateness)."""
        tags, meters, late = self.stream.batch(b, t)
        rows = slice(self.c * self.rows, (self.c + 1) * self.rows)
        return tags[:, rows], meters[rows], late[rows]

    def pool_of(self, k: int) -> int:
        return self.stream.pool_of(k)

    def time_of(self, k: int) -> int:
        return self.stream.time_of(k)


Stream = CardFlowStream
