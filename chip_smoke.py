#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to account.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc). Phases, each failing
loudly with a nonzero exit:

1. Device line (`nvidia-smi` name + power limit, torch CUDA version) and
   the kernel build from the sources in this checkout (one nvcc per
   source, started together) into deepflow_tpu_torch/_build/.
2. Kernel parity at the full-width main-path shapes: every segmented-
   reduce launcher against its plain PyTorch version on the same
   inputs, at the pre-reduce shape (N = 2^21 rows, cap = 2^15) and the
   fold shape (N = 2^16 + 2·4·2^15, cap = 2^16), with rows from
   SyntheticFlowGen(10_000, seed=0) through the port's own pre-reduce,
   fanout and stash. Live segments only; SUM lanes within rtol 1e-5
   (summation order), MAX lanes exact. CUDA-event times, median of 20.
3. The main path at full width, launch counts zeroed just before and
   read just after: the bench.py cycle (batch 2^21, stash 2^16, 2
   appends + 1 fold, unique cap 2^15) through make_ingest_step, then
   L4Pipeline over 6 consecutive seconds of 2^21-row batches and a
   drain. Then the same cycle once more with DEEPFLOW_FUSED_GATHER=0,
   the pre-gathered launcher's path.
4. The same L4Pipeline stream at 2^14-row batches on the card and on
   the CPU (plain path): flushed windows and counters must match
   exactly.
5. One JSON line of the cycle's records/s, then one of the kernels
   (both with the card's name and power limit), then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH = 1 << 21
CAPACITY = 1 << 16
ACCUM_BATCHES = 2
UNIQUE_CAP = 1 << 15
CYCLES = 4
SMALL_BATCH = 1 << 14
STASH_CAPACITY = 1 << 18  # L4Pipeline stash rows
T0 = 1_700_000_000
REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SUM_RTOL = 1e-5

KERNELS = {
    "segreduce_gather": "deepflow_tpu/ops/segreduce_pallas.py:117",
    "segreduce_sorted": "deepflow_tpu/ops/segreduce_pallas.py:87",
}
SOURCE = "deepflow_tpu_torch/kernels/segreduce.cu"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn) -> float:
    """Median CUDA-event time of one call, over REPS calls after a warmup."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no device")
    return out[0].strip()


def kernel_operands(dev):
    """The segmented-reduce operands of the two main-path call sites,
    built with the port's own functions from the bench.py stream."""
    from deepflow_tpu_torch.aggregator.fanout import FANOUT_LANES, FanoutConfig
    from deepflow_tpu_torch.aggregator.pipeline import (
        make_ingest_step, prereduce_keys, upload_flow_batch,
    )
    from deepflow_tpu_torch.aggregator.stash import accum_init, fold_operands, stash_init
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.segment import SENTINEL_SLOT, segment_ids, sort_keys

    def operands(slot, hi, lo, rows, valid, cap):
        s_slot, s_hi, s_lo, perm = sort_keys(slot, hi, lo, valid)
        seg, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, cap)
        return dict(rows=rows, seg=seg, first_pos=first_pos, perm=perm.to(torch.int32),
                    cap=cap, live=min(int(num_seg), cap),
                    live_rows=int((seg < cap).sum()))

    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    tags, meters, valid = upload_flow_batch(gen.flow_batch(BATCH, T0), dev)
    _, slot, hi, lo, _ = prereduce_keys(tags, 1)
    pre = operands(slot, hi, lo, meters, valid, UNIQUE_CAP)

    append, fold = make_ingest_step(FanoutConfig(), interval=1,
                                    batch_unique_cap=UNIQUE_CAP, device=dev)
    stride = FANOUT_LANES * UNIQUE_CAP
    state = stash_init(CAPACITY, TAG_SCHEMA, FLOW_METER, device=dev)
    acc = accum_init(ACCUM_BATCHES * stride, TAG_SCHEMA, FLOW_METER, device=dev)
    for cycle in range(2):  # the second cycle's fold sees a live stash
        if cycle:
            state, acc = fold(state, acc)
        for k in range(ACCUM_BATCHES):
            state, acc = append(state, acc, k * stride, tags, meters, valid)
    f_slot, f_hi, f_lo, _, f_rows, f_valid = fold_operands(
        state, acc.slot, acc.key_hi, acc.key_lo, acc.tags, acc.meters,
        acc.slot != SENTINEL_SLOT,
    )
    fold_ops = operands(f_slot, f_hi, f_lo, f_rows, f_valid, CAPACITY)
    check(f_rows.shape[0] == CAPACITY + ACCUM_BATCHES * stride, "fold shape")
    return {"prereduce": pre, "fold": fold_ops}


def kernel_parity(name: str, ops: dict) -> dict:
    """One launcher at one shape: parity with the plain version, times,
    and the bytes/operations bound of this input."""
    from deepflow_tpu_torch.ops.segreduce import (
        sorted_segment_sum_max, sorted_segment_sum_max_plain,
    )

    gather = name == "segreduce_gather"
    cap, seg, fp = ops["cap"], ops["seg"], ops["first_pos"]
    perm = ops["perm"] if gather else None
    rows = ops["rows"] if gather else ops["rows"].index_select(0, ops["perm"].long())

    ks, km = sorted_segment_sum_max(rows, seg, cap, fp, perm=perm)
    ps, pm = sorted_segment_sum_max_plain(rows, seg, cap, fp, perm=perm)
    torch.cuda.synchronize()
    live = ops["live"]
    check(live > 0, f"{name}: no live segments")
    ks, km, ps, pm = ks[:live], km[:live], ps[:live], pm[:live]
    check(bool(torch.isfinite(ks).all() and torch.isfinite(km).all()),
          f"{name}: non-finite kernel output")
    sum_err = (ks - ps).abs()
    check(bool((sum_err <= SUM_RTOL * ps.abs()).all()),
          f"{name}: SUM lanes off by more than rtol {SUM_RTOL}")
    check(bool(torch.equal(km, pm)), f"{name}: MAX lanes differ")

    m = rows.shape[1]
    n_live = ops["live_rows"]
    nbytes = (n_live * (4 * m + 4 + (4 if gather else 0)) + 4 * cap
              + 2 * 4 * cap * m)
    ops_count = 2 * n_live * m
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    return {
        "max_abs_err": float(max(sum_err.max(), (km - pm).abs().max())),
        "ms": time_ms(lambda: sorted_segment_sum_max(rows, seg, cap, fp, perm=perm)),
        "plain_ms": time_ms(
            lambda: sorted_segment_sum_max_plain(rows, seg, cap, fp, perm=perm)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
        "rows": int(seg.shape[0]), "live_rows": n_live, "m": m, "cap": cap,
        "live_segments": live,
    }


def profile_cycle(cycle, state, acc):
    """One cycle under torch.profiler: wall time (host clock, synced),
    device-busy time (sum of CUDA kernel times — one stream, so kernels
    do not overlap), the idle share, and the top kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, acc = cycle(state, acc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    summary = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"kernel": e.key[:90], "count": e.count, "ms": dev_us(e) / 1e3}
                for e in top],
    }
    return summary, state, acc


def bench_cycle(dev, cycles: int, with_profile: bool = False):
    """The bench.py cycle on the card: returns (records/s over `cycles`
    timed cycles after one warmup, launches of the warmup cycle, and —
    with `with_profile` — one more cycle's profile_cycle summary)."""
    from deepflow_tpu_torch.aggregator.fanout import FANOUT_LANES, FanoutConfig
    from deepflow_tpu_torch.aggregator.pipeline import make_ingest_step, upload_flow_batch
    from deepflow_tpu_torch.aggregator.stash import accum_init, stash_init
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.segreduce import LAUNCHES

    tags, meters, valid = upload_flow_batch(
        SyntheticFlowGen(num_tuples=10_000, seed=0).flow_batch(BATCH, T0), dev)
    append, fold = make_ingest_step(FanoutConfig(), interval=1,
                                    batch_unique_cap=UNIQUE_CAP, device=dev)
    stride = FANOUT_LANES * UNIQUE_CAP
    state = stash_init(CAPACITY, TAG_SCHEMA, FLOW_METER, device=dev)
    acc = accum_init(ACCUM_BATCHES * stride, TAG_SCHEMA, FLOW_METER, device=dev)

    def cycle(state, acc):
        for k in range(ACCUM_BATCHES):
            state, acc = append(state, acc, k * stride, tags, meters, valid)
        return fold(state, acc)

    before = sum(LAUNCHES.values())
    state, acc = cycle(state, acc)
    torch.cuda.synchronize()
    per_cycle = sum(LAUNCHES.values()) - before
    t0 = time.perf_counter()
    for _ in range(cycles):
        state, acc = cycle(state, acc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary = None
    if with_profile:
        summary, state, acc = profile_cycle(cycle, state, acc)
    live = int(state.valid.sum())
    check(live > 0, "bench cycle left an empty stash")
    check(int(state.dropped_overflow) == 0, "bench cycle shed stash segments")
    check(bool(torch.isfinite(state.meters[:, :live]).all()), "non-finite stash meters")
    return BATCH * ACCUM_BATCHES * cycles / dt, per_cycle, summary


def pipeline_stream(device, batch: int, seconds: list[int]):
    """L4Pipeline over one SyntheticFlowGen stream; returns (windows
    closed before the drain, all DocBatches, counters, counter blocks)."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    # ~33k docs a second at 10k tuples; with delay=2 the fold before an
    # advance holds four windows (the closing one included): 2^18 rows
    pipe = L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES),
        batch_size=batch, batch_unique_cap=min(UNIQUE_CAP, batch),
    ), device=device)
    blocks = []
    process = pipe.wm._process_block

    def record(vec):
        blocks.append(list(vec))
        process(vec)

    pipe.wm._process_block = record
    gen = SyntheticFlowGen(num_tuples=10_000, seed=1)
    docs = []
    for dt in seconds:
        docs += pipe.ingest(gen.flow_batch(batch, T0 + dt))
    closed_before_drain = len(docs)
    docs += pipe.drain()
    return closed_before_drain, docs, pipe.counters, blocks


def check_pipeline_run(closed: int, docs, counters: dict, blocks) -> None:
    """What a healthy main-path stream shows: windows closed before the
    drain, every counter block at layout v7, no stash eviction, and
    every admitted doc flushed once, with finite meters."""
    from deepflow_tpu_torch.aggregator.window import (
        CB_STASH_EVICTIONS, CB_VERSION, COUNTER_BLOCK_VERSION,
    )

    check(closed > 0, "no window closed before the drain")
    check(blocks and all(b[CB_VERSION] == COUNTER_BLOCK_VERSION for b in blocks),
          "a counter block's lane 0 is not the layout version 7")
    check(all(b[CB_STASH_EVICTIONS] == 0 for b in blocks)
          and counters["stash_evictions"] == 0 and counters["drop_overflow"] == 0,
          "the stash evicted segments")
    flushed = sum(d.size for d in docs)
    check(counters["doc_in"] == flushed == counters["flushed_doc"],
          f"doc_in {counters['doc_in']} != flushed {flushed}")
    check(all(np.isfinite(d.meters).all() for d in docs), "non-finite flushed meters")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 2
    from deepflow_tpu_torch.kernels import build
    from deepflow_tpu_torch.ops.segreduce import LAUNCHES, reset_launch_counts

    dev = torch.device("cuda")
    gpu = device_line()
    name = torch.cuda.get_device_name(0)
    print(gpu)
    t0 = time.perf_counter()
    build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "device", "nvidia_smi": gpu, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_s": round(build_s, 3),
                      "build_seconds": build.build_seconds}), flush=True)

    # 2. kernel parity at the main-path shapes
    ops = kernel_operands(dev)
    results = {k: {shape: kernel_parity(k, o) for shape, o in ops.items()}
               for k in KERNELS}
    print(json.dumps({"phase": "parity", "results": results}), flush=True)

    # 3. main path, fused gather (the default)
    os.environ["DEEPFLOW_FUSED_GATHER"] = "1"
    reset_launch_counts()
    rate_gather, per_cycle_gather, prof = bench_cycle(dev, CYCLES, with_profile=True)
    closed, docs, counters, blocks = pipeline_stream(dev, BATCH, list(range(6)))
    main_gather = dict(LAUNCHES)
    check_pipeline_run(closed, docs, counters, blocks)
    check(len(docs) == 6, f"{len(docs)} windows from 6 seconds of data")
    check(main_gather["segreduce_gather"] > 0 and main_gather["segreduce_sorted"] == 0,
          f"fused-gather main path launches {main_gather}")
    print(json.dumps({"phase": "profile", "cycle": prof}), flush=True)
    print(json.dumps({"phase": "main_path", "fused_gather": True,
                      "launches": main_gather, "windows": len(docs),
                      "counters": counters}), flush=True)

    # 3b. main path through the pre-gathered launcher
    os.environ["DEEPFLOW_FUSED_GATHER"] = "0"
    reset_launch_counts()
    rate_sorted, per_cycle_sorted, _ = bench_cycle(dev, CYCLES // 2)
    main_sorted = dict(LAUNCHES)
    os.environ["DEEPFLOW_FUSED_GATHER"] = "1"
    check(main_sorted["segreduce_sorted"] > 0 and main_sorted["segreduce_gather"] == 0,
          f"pre-gathered main path launches {main_sorted}")

    # 4. card vs CPU on the same stream, exact
    seconds = [0, 0, 1, 2, 1, 3, 4, 6, 3, 5, 8]  # the second 3 is late
    card = pipeline_stream(dev, SMALL_BATCH, seconds)
    host = pipeline_stream("cpu", SMALL_BATCH, seconds)
    check(len(card[1]) == len(host[1]) and len(card[1]) > 0,
          "card and CPU closed different window counts")
    for a, b in zip(card[1], host[1]):
        check(np.array_equal(a.timestamp, b.timestamp), "window timestamps differ")
        check(np.array_equal(a.tags, b.tags), "flushed tags differ card vs CPU")
        check(np.array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32)),
              "flushed meters differ card vs CPU")
    for key in ("doc_in", "flushed_doc", "drop_before_window", "prereduce_dropped",
                "drop_overflow"):
        check(card[2][key] == host[2][key], f"counter {key} differs card vs CPU")
    check(card[3] == host[3], "counter blocks differ card vs CPU")
    print(json.dumps({"phase": "card_vs_cpu", "windows": len(card[1]),
                      "docs": card[2]["flushed_doc"]}), flush=True)

    # 5. result lines
    kernels = []
    launches = {"segreduce_gather": (main_gather, per_cycle_gather),
                "segreduce_sorted": (main_sorted, per_cycle_sorted)}
    for k, replaces in KERNELS.items():
        pre, fold = results[k]["prereduce"], results[k]["fold"]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[k][0][k],
            "launches_per_cycle": launches[k][1],
            "parity": {"ok": True, "sum_rtol": SUM_RTOL, "max": "exact",
                       "against": "sorted_segment_sum_max_plain"},
            "max_abs_err": max(pre["max_abs_err"], fold["max_abs_err"]),
            "ms": pre["ms"], "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
            "shape": "prereduce", "fold": fold,
        })
    print(json.dumps({"metric": "port_bench_cycle_records_per_sec",
                      "value": rate_gather, "value_pregather": rate_sorted,
                      "unit": "records/s", "gpu": gpu, "batch": BATCH,
                      "capacity": CAPACITY, "accum_batches": ACCUM_BATCHES,
                      "unique_cap": UNIQUE_CAP}))
    print(json.dumps({"gpu": gpu, "kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
