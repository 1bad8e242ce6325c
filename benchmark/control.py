"""The control of the comparison: the reference itself, computed one
precision below the configuration's float32 meters — in bfloat16 — put
in the program's place. Its readings set the upper end of each limit
(the lower end comes from the program's own runs); a comparison the
control passes could not tell a program that cut the precision.

    python3 benchmark/control.py --workload exact.hicard --seeds 11 12 13 [--windows 2]

prints, per seed, the numbers of `windows` full windows drawn from the
seed, computed by the control, against the float64 reference, at the
cell's own sizes. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from benchmark import reference as R  # noqa: E402
from benchmark.generators.flows import FlowStream  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def control_block(ref: dict):
    """A closed-block stand-in built from a reference sketch (the
    fields `sketch_ref.compare_block` reads)."""
    from benchmark import sketch_ref

    live = ref["votes"] > 0
    hll = ref["hll"].cpu().numpy()
    return SimpleNamespace(
        n_updates=ref["n_updates"], hll=hll, cms=ref["cms"].cpu().numpy() & 0xFFFFFFFF,
        hist=ref["hist"].cpu().numpy(), tk_hi=ref["tk"][0][live].cpu().numpy(),
        tk_lo=ref["tk"][1][live].cpu().numpy(), tk_votes=ref["votes"][live].cpu().numpy(),
        distinct=lambda: sketch_ref.hll_estimate(hll))


def control_numbers(stream: FlowStream, w: int, last: int, sketch: dict | None) -> dict:
    """The comparison's numbers of window w, the control in the
    program's place (`sketch`: the configuration's sketch settings, or
    None)."""
    parts = R.window_parts(stream, w, last)
    ref = R.rollup(parts)
    ctl = R.rollup([(c, m.to(CONTROL_DTYPE)) for c, m in parts], meter_dtype=CONTROL_DTYPE)
    out = R.compare_docs(ctl.tags, ctl.meters.float(), ref)
    if sketch:
        from benchmark import sketch_ref

        blk = control_block(sketch_ref.window_sketch(parts, sketch, CONTROL_DTYPE))
        out.update(sketch_ref.compare_block(blk, sketch, parts))
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
    _, _, sketch = H.checker(spec).settings(spec.config)
    for seed in args.seeds:
        stream = FlowStream(spec.mix, seed, args.device)
        rng = random.Random(seed)
        last = 3 * stream.pool
        for w in rng.sample(range(stream.start_time, stream.start_time + last), args.windows):
            nums = control_numbers(stream, w, last, sketch)
            print(json.dumps({"workload": args.workload, "seed": seed, "window": w,
                              "control": {k: (float(v) if isinstance(v, (float, np.floating))
                                              else int(v)) for k, v in nums.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
