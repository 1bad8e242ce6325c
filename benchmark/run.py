"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload exact.hicard --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the result object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with --trace 1
`breakdown`, and last `checks`: each number compared beside its limit);
the line before it describes the window. The checks are repeated as the
last lines of standard error. Without a CUDA card (or with fewer than
the cell asks for), or with JAX or the JAX package loaded by the time
the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # any library build or kernel cache stays inside the checkout (the
    # program builds its CUDA kernels into its own _build/ there)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from benchmark import harness as H

    spec = H.load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"needs {spec.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = H.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = H.forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"window": result.pop("window_line")}))
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result))
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
