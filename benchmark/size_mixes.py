"""Size the rollup's tables for a configuration under each traffic mix,
and write the sizes into the cell's sizing file,
benchmark/sizing/<config>.<traffic>.json.

For every pool batch of a mix the script counts the distinct raw
records (the batch-local pre-reduce's segments) and, for every full
window (one batch's on-time records and the later batches' late ones),
the distinct document keys. Over the seeds given it takes the largest
of each and sets

    batch_unique_cap = next power of two >= largest distinct raw records
    capacity         = next power of two >= (delay/interval + 2) * largest window docs

with delay and interval from the configuration, so that the pre-reduce
and the stash shed nothing. The sizing file holds them as an overlay
that the harness merges into the configuration's pipeline, and the
counts they follow from. Run from the root of the repository, on the
CPU or a card:

    python3 benchmark/size_mixes.py --config l4_1s_exact [--device cuda] [--seeds 1 2 3] [--write] [mix ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):
    sys.path.insert(0, str(HERE.parent))

from benchmark import reference as R  # noqa: E402
from benchmark import schema as S  # noqa: E402
from benchmark.generators.flows import FlowStream  # noqa: E402


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _distinct_raw(tags: torch.Tensor):
    """The first row of every distinct raw record of [F, n] tag lanes."""
    var = [i for i in range(tags.shape[0]) if not bool((tags[i] == tags[i][0]).all())]
    _, first = R._unique_rows(tags[var].t())
    return tags[:, first]


def window_docs(stream: FlowStream, b: int) -> int:
    """Distinct document keys of a full window whose on-time records come
    from pool batch b (and its late ones from the batches after it)."""
    k = 3 * stream.pool + b
    w = stream.start_time + k
    parts = [_distinct_raw(torch.stack([cols[f] for f in S.FLOW_FIELDS]))
             for cols, _ in R.window_parts(stream, w, k + stream.max_late)]
    rows = torch.cat(parts, dim=1)
    cols = {f: rows[i] for i, f in enumerate(S.FLOW_FIELDS)}
    meters = torch.zeros((rows.shape[1], len(S.METER_NAMES)), dtype=torch.float32,
                         device=rows.device)
    keys = [lane_tags[valid][:, list(S.DOC_KEY_INDEX)]
            for lane_tags, valid, _ in R.fanout_l4(cols, meters)]
    return int(torch.unique(torch.cat(keys), dim=0).shape[0])


def batch_raw(stream: FlowStream, b: int) -> int:
    tags, _, _ = stream.batch(b, stream.start_time + 10)
    return int(_distinct_raw(tags).shape[1])


def size_mix(mix: dict, seeds, device, delay: int, interval: int) -> dict:
    raw, docs = [], []
    for seed in seeds:
        stream = FlowStream(mix, seed, device)
        for b in range(stream.pool):
            raw.append(batch_raw(stream, b))
            docs.append(window_docs(stream, b))
    ring = delay // interval + 2
    return {
        "seeds": list(seeds),
        "batch_raw_max": max(raw), "batch_raw_min": min(raw),
        "window_docs_max": max(docs), "window_docs_min": min(docs),
        "batch_unique_cap": next_pow2(max(raw)),
        "capacity": next_pow2(ring * max(docs)),
    }


def sizing_overlay(sized: dict) -> dict:
    """The sizes as an overlay of the configuration's pipeline spec."""
    return {"pipeline": {"config": {"batch_unique_cap": sized["batch_unique_cap"],
                                    "window": {"capacity": sized["capacity"]}}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mixes", nargs="*", default=["hicard", "lowcard"])
    ap.add_argument("--config", required=True, help="a file name under benchmark/configs/")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--write", action="store_true", help="write the sizing files")
    args = ap.parse_args(argv)
    config = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    window = config["pipeline"]["config"]["window"]
    for name in args.mixes:
        mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        sized = size_mix(mix, args.seeds, args.device, window["delay"], window["interval"])
        print(json.dumps({"config": args.config, "mix": name, **sized}))
        if args.write:
            out = {"overlay": sizing_overlay(sized), "measured": sized}
            (HERE / "sizing" / f"{args.config}.{name}.json").write_text(
                json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
