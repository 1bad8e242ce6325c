"""Size each card's tables for a configuration under a `card_flows`
mix, and write the sizes into the cell's sizing file,
benchmark/sizing/<config>.<traffic>.json.

`size_mixes.py`'s rule a card at a time: for every card's slice of
every pool batch, the distinct raw records, and for every full window
of a card (its on-time records of one batch and the late ones of the
next), the distinct document keys. Over the seeds given it takes the
largest of each and sets

    batch_unique_cap = next power of two >= largest distinct raw records of a card
    capacity         = next power of two >= (delay/interval + 2) * largest window docs of a card

the sizes of one shard. Run from the root of the repository, on a
card (the mix's full size does not belong on a shared CPU):

    python3 benchmark/size_cards.py hicard4x --config l4_1s_sharded4 [--device cuda] [--seeds 1 2 3] [--write]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):
    sys.path.insert(0, str(HERE.parent))

from benchmark import size_mixes  # noqa: E402
from benchmark.generators.card_flows import CardFlowStream  # noqa: E402


def size_cards(mix: dict, seeds, device, delay: int, interval: int) -> dict:
    raw, docs = [], []
    for seed in seeds:
        stream = CardFlowStream(mix, seed, device)
        for c in range(stream.cards):
            card = stream.card(c)
            for b in range(stream.pool):
                raw.append(size_mixes.batch_raw(card, b))
                docs.append(size_mixes.window_docs(card, b))
    ring = delay // interval + 2
    return {
        "seeds": list(seeds),
        "batch_raw_max": max(raw), "batch_raw_min": min(raw),
        "window_docs_max": max(docs), "window_docs_min": min(docs),
        "batch_unique_cap": size_mixes.next_pow2(max(raw)),
        "capacity": size_mixes.next_pow2(ring * max(docs)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mixes", nargs="+")
    ap.add_argument("--config", required=True, help="a file name under benchmark/configs/")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--write", action="store_true", help="write the sizing files")
    args = ap.parse_args(argv)
    config = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    window = config["pipeline"]["config"]["window"]
    for name in args.mixes:
        mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        sized = size_cards(mix, args.seeds, args.device, window["delay"], window["interval"])
        print(json.dumps({"config": args.config, "mix": name, **sized}))
        if args.write:
            out = {"overlay": size_mixes.sizing_overlay(sized), "measured": sized}
            (HERE / "sizing" / f"{args.config}.{name}.json").write_text(
                json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
