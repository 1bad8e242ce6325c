"""The control of the sharded cell's comparison: `control.py`'s control
(the reference computed in bfloat16, one precision below the
configuration's float32 meters, put in the program's place) for a
`card_flows` mix, a card at a time as `checks/l4_sharded.py` computes
the reference, and held to it by that module's comparison. Its
readings set the upper end of each limit.

    python3 benchmark/control_cards.py --workload sharded4.hicard4x --seeds 11 12 13 [--windows 2]

prints, per seed, the numbers of `windows` full windows drawn from the
seed, the control against the float64 reference, at the cell's own
sizes. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import random
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from benchmark import reference as R  # noqa: E402
from benchmark import sketch_ref  # noqa: E402
from benchmark.checks import l4_sharded as C  # noqa: E402
from benchmark.control import CONTROL_DTYPE, control_block  # noqa: E402


def control_numbers(stream, w: int, last: int, sketch: dict | None) -> dict:
    """The comparison's numbers of window w with the control in the
    program's place: each card's control rows, computed a card at a
    time, held to the cards' references as the check holds the
    program's rows (`l4_sharded.compare_window`)."""
    refs, ctl_tags, ctl_meters = [], [], []
    for c in range(stream.cards):
        parts = R.window_parts(stream.card(c), w, last)
        refs.append(R.rollup(parts))
        ctl = R.rollup([(p, m.to(CONTROL_DTYPE)) for p, m in parts], meter_dtype=CONTROL_DTYPE)
        ctl_tags.append(ctl.tags)
        ctl_meters.append(ctl.meters.float())
        del ctl
    out, _ = C.compare_window(torch.cat(ctl_tags), torch.cat(ctl_meters), refs)
    del refs, ctl_tags, ctl_meters
    if sketch:
        blocks = [control_block(sketch_ref.window_sketch(
            R.window_parts(stream.card(c), w, last), sketch, CONTROL_DTYPE))
            for c in range(stream.cards)]
        merged = blocks[0]
        for b in blocks[1:]:
            merged.hll = np.maximum(merged.hll, b.hll)
            for lane in ("cms", "hist"):
                setattr(merged, lane, getattr(merged, lane) + getattr(b, lane))
            for lane in ("tk_hi", "tk_lo", "tk_votes"):
                setattr(merged, lane, np.concatenate([getattr(merged, lane), getattr(b, lane)]))
            merged.n_updates += b.n_updates
        hll = merged.hll
        merged.distinct = lambda: sketch_ref.hll_estimate(hll)
        merged.cms = merged.cms & 0xFFFFFFFF
        out.update(C.compare_block(merged, C.merged_sketch(
            [C.card_window(stream.card(c), w, last, sketch)[1] for c in range(stream.cards)])))
    return out


def main(argv=None) -> int:
    from benchmark import harness as H

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = H.load_spec(args.workload)
    _, _, sketch = C.settings(spec.config)
    gen = importlib.import_module(f"benchmark.generators.{spec.mix['generator']}")
    for seed in args.seeds:
        stream = gen.Stream(spec.mix, seed, args.device)
        rng = random.Random(seed)
        last = 3 * stream.pool
        for w in rng.sample(range(stream.start_time, stream.start_time + last), args.windows):
            nums = control_numbers(stream, w, last, sketch)
            print(json.dumps({"workload": args.workload, "seed": seed, "window": w,
                              "control": {k: (float(v) if isinstance(v, (float, np.floating))
                                              else int(v)) for k, v in nums.items()}}))
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
