"""The benchmark harness: one cell, one seed, one run.

Everything that belongs to one cell is found by name. A cell of
BENCHMARK.json names a configuration and a traffic mix:

  * the configuration's file (benchmark/configs/<name>.json) holds the
    system under test as a spec (`pipeline`: nested objects, each with
    its `_class` and its keyword arguments, built as they stand), the
    check module that decides `correct` (`check`:
    benchmark/checks/<name>.py), the warm-up, the sample and the limits
    of the comparison;
  * the traffic mix (benchmark/traffic/<name>.json) names its generator
    (`generator`: benchmark/generators/<name>.py) and holds its
    parameters;
  * the cell's sizing (benchmark/sizing/<config>.<traffic>.json, where
    the cell needs one) holds the table sizes measured for that pair, an
    overlay merged into the configuration;
  * each metric is read by its own file, benchmark/metrics/<name>.py,
    from what the run recorded; a reader that finds nothing to read
    returns None and the metric is left out. A kernel's launch counter
    and kernel names are in benchmark/kernels/<operation>.json.

The run: set-up builds the generator's pool of host batches from the
seed (drawn on the device, copied to pageable host memory), builds the
system and replays the first `warmup_batches` batches through it, so
every kernel is built and the stash holds its steady span of windows.
The window then replays batch after batch for the given seconds: each
call is `stage()` then `ingest_staged()`, and each closes one window.
The loop is closed (the next batch is handed in when the previous call
returns) unless the mix sets `arrival_interval_s`: then batch i arrives
i intervals after the window's start, and a window's close latency runs
from its batch's arrival, not from the call's start. After the window, `drain()` closes the open windows, the
peak memory is read, the system is freed, and the check module holds a
sample of the closed windows, drawn from the seed, and every drained
window against the reference.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import os
import random
import statistics
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deepflow_tpu")
TRACE_BATCHES = 6


def process_age_s() -> float:
    """Seconds since this process started (from /proc; the clock ticks
    of its start time against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Spec:
    workload: str
    config: dict  # the configuration's file with the cell's sizing merged in
    mix: dict
    end_to_end: list
    per_layer: list
    chips: int


def merge(base: dict, overlay: dict) -> dict:
    """`base` with `overlay`'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    """The cell's configuration, traffic mix, sizing and metrics, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    sizing = BENCH / "sizing" / f"{cell['config']}.{cell['traffic']}.json"
    if sizing.exists():
        config = merge(config, json.loads(sizing.read_text())["overlay"])

    def applies(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and ("workloads" in m or m["moves"] in names)]
    return Spec(workload, config, mix, e2e, per_layer, int(cell["chips"]))


def build(spec, **kwargs):
    """An object from its spec: a dict with `_class` (a dotted name) is
    that class called with the dict's other keys, each built the same
    way, and with `kwargs`; a list becomes a tuple."""
    if isinstance(spec, list):
        return tuple(build(v) for v in spec)
    if not isinstance(spec, dict):
        return spec
    args = {k: build(v) for k, v in spec.items() if k != "_class"}
    if "_class" not in spec:
        return args
    module, _, name = spec["_class"].rpartition(".")
    return getattr(importlib.import_module(module), name)(**args, **kwargs)


def checker(spec: Spec):
    """The configuration's check module."""
    return importlib.import_module(f"benchmark.checks.{spec.config['check']}")


def kernel_ops() -> dict:
    """Every operation of benchmark/kernels/: its kernel names and the
    dotted name of its launch counter."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((BENCH / "kernels").glob("*.json"))}


@dataclasses.dataclass
class Context:
    """What a run recorded, for the metric readers."""

    spec: Spec
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    records: int = 0
    calls: int = 0
    close_ms: list = dataclasses.field(default_factory=list)
    stage_s: list = dataclasses.field(default_factory=list)
    restamp_s: list = dataclasses.field(default_factory=list)
    fold_rows: list = dataclasses.field(default_factory=list)
    occupancy: list = dataclasses.field(default_factory=list)
    spans_before: dict = dataclasses.field(default_factory=dict)
    spans_after: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    trace: object = None  # trace.TraceSummary of the traced batches
    traced: list = dataclasses.field(default_factory=list)  # per traced call

    @staticmethod
    def percentile(values, q: int) -> float | None:
        """The q-th percentile (statistics.quantiles, inclusive method)."""
        if len(values) < 2:
            return None
        return statistics.quantiles(values, n=100, method="inclusive")[q - 1]

    def span_ms(self, name: str) -> float | None:
        """Mean ms of one program span over the window (its total and
        count at the window's close less those at its start)."""
        a, b = self.spans_before.get(name, {}), self.spans_after.get(name)
        if not b:
            return None
        n = b["count"] - a.get("count", 0)
        return (b["total_us"] - a.get("total_us", 0)) / n / 1e3 if n > 0 else None

    def roofline_pct(self, op: str, least) -> float | None:
        """Sum of the traced calls' least seconds (`least`, one per launch
        of `op`, in launch order) over the sum of the device seconds of
        the kernels benchmark/kernels/<op>.json names; None unless every
        traced launch of the operation was seen once."""
        if self.trace is None or not least or None in least:
            return None
        took = self.trace.kernel_durations(kernel_ops()[op]["kernels"])
        launched = sum(c["launches"].get(op, 0) for c in self.traced)
        if len(took) != len(least) or launched != len(least) or sum(took) <= 0:
            return None
        return 100.0 * sum(least) / sum(took)


@contextlib.contextmanager
def _no_range(_name: str):
    yield


class Run:
    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool, device):
        self.spec = spec
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.ctx = Context(spec=spec, device=self.device)
        self.cuda = self.device.type == "cuda"
        self.check = checker(spec)
        self.k = 0  # replay batches handed in so far
        self.sample: list = []  # [(first timestamp, DocBatch)] closed in the window
        self.closed_in_window = 0
        self.blocks: dict = {}  # what the check module collects, by window
        self._rng = random.Random(self.seed ^ 0x5EED)
        # named host ranges around the calls, for the traced batches only
        self._ranges = _no_range

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        if self.cuda:
            torch.cuda.set_device(self.device)
            torch.cuda.init()
            torch.zeros((), device=self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        gen = importlib.import_module(f"benchmark.generators.{self.spec.mix['generator']}")
        self.stream = gen.Stream(self.spec.mix, self.seed, self.device)
        self.pool = [self.stream.host_batch(b) for b in range(self.stream.pool)]
        self.batches = [hb.as_input() for hb in self.pool]
        self.pipe = build(self.spec.config["pipeline"], device=self.device)
        for _ in range(int(self.spec.config["warmup_batches"])):
            self._call()
        self._sync()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _call(self):
        """Hand in the next replay batch: re-stamp it (outside the call),
        then stage + ingest_staged. Returns (closed DocBatches, stage
        start, stage end, ingest end)."""
        k = self.k
        rng = self._ranges
        r0 = time.perf_counter()
        with rng("bench.restamp"):
            self.pool[self.stream.pool_of(k)].stamp(self.stream.time_of(k))
        t0 = time.perf_counter()
        with rng("bench.stage"):
            staged = self.pipe.stage(self.batches[self.stream.pool_of(k)])
        t1 = time.perf_counter()
        with rng("bench.ingest_staged"):
            out = self.pipe.ingest_staged(staged)
        t2 = time.perf_counter()
        self.k += 1
        self.ctx.restamp_s.append(t0 - r0)
        self.check.collect(self)
        return out, t0, t1, t2

    # -- the measured window --------------------------------------------
    def window(self) -> None:
        ctx = self.ctx
        ctx.restamp_s.clear()
        ctx.setup_s = process_age_s()
        ctx.spans_before = self.pipe.tracer.summary()
        prof = None
        if self.trace:
            prof, rng_cm = self._start_trace()
        interval = self.spec.mix.get("arrival_interval_s")
        t_start = time.perf_counter()
        t_end = t_start
        n = self.stream.rows
        while True:
            traced = prof is not None
            if traced:
                before = self._launch_counts()
            arrival = None
            if interval:
                arrival = t_start + ctx.calls * float(interval)
                time.sleep(max(0.0, arrival - time.perf_counter()))
            out, t0, t1, t2 = self._call()
            t_end = t2
            ctx.calls += 1
            ctx.records += n
            ctx.stage_s.append(t1 - t0)
            ctx.fold_rows.append(self.pipe.wm.fold_rows)
            ctx.occupancy.append(self.pipe.wm.stash_occupancy)
            for db in out:
                ctx.close_ms.append((t2 - (t0 if arrival is None else arrival)) * 1e3)
                self._keep(db)
            if traced:
                self._note_traced(out, before)
                if ctx.calls >= TRACE_BATCHES:
                    self._stop_trace(prof, rng_cm)
                    prof = None
            # a traced run reads the counter mirrors of one call past the
            # traced ones (they carry the last traced fold)
            done = not self.trace or ctx.calls > TRACE_BATCHES
            if t_end - t_start >= self.seconds and done:
                break
        ctx.window_s = t_end - t_start
        ctx.spans_after = self.pipe.tracer.summary()

    def _keep(self, db) -> None:
        """Reservoir sample of the windows closed in the window, drawn
        from the seed; a replaced window's arrays are released."""
        i = self.closed_in_window
        self.closed_in_window += 1
        size = int(self.spec.config["sample_windows"])
        ts = int(db.timestamp[0])
        if len(self.sample) < size:
            self.sample.append((ts, db))
        else:
            j = self._rng.randrange(i + 1)
            if j < size:
                self.sample[j] = (ts, db)

    # -- tracing --------------------------------------------------------
    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        self._ranges = record_function
        rng_cm = record_function("bench.window")
        rng_cm.__enter__()
        return prof, rng_cm

    def _stop_trace(self, prof, rng_cm) -> None:
        from . import trace as T

        self._sync()
        rng_cm.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        self._ranges = _no_range
        self.ctx.trace = T.summarize(prof.events())

    def _launch_counts(self) -> dict:
        """Launches so far of each operation of benchmark/kernels/."""
        out = {}
        for op, k in kernel_ops().items():
            module, _, name = k["launch_counter"].rpartition(".")
            out[op] = sum(getattr(importlib.import_module(module), name).values())
        return out

    def _note_traced(self, out, before: dict) -> None:
        after = self._launch_counts()
        self.ctx.traced.append({
            "pool_batch": self.stream.pool_of(self.k - 1),
            "launches": {k: after[k] - before.get(k, 0) for k in after},
            "flushed": sum(db.size for db in out),
        })

    # -- after the window -------------------------------------------------
    def finish(self) -> None:
        """Drain (untimed), read the counters and the peak, free the
        pipeline's state."""
        self.drained = [(int(db.timestamp[0]), db) for db in self.pipe.drain()]
        self.check.collect(self)
        self.counters = self.pipe.counters
        self._sync()
        if self.cuda:
            self.ctx.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        self.pipe.close()
        del self.pipe
        self.batches = self.pool = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def read_metrics(entries, run: Run) -> dict:
    out = {}
    for m in entries:
        v = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """Top-level module names of JAX or the JAX package in this process
    (each name compared whole)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def device_line(ctx: Context, chips: int) -> dict:
    dev = ctx.device
    line = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": ctx.peak_bytes}
    return line


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of one cell; returns the result object (printed by run.py)."""
    run = Run(spec, seed, seconds, trace, device)
    run.setup()
    run.window()
    run.finish()
    t_ref = time.perf_counter()
    verdict = run.check.check_run(run)
    ref_s = time.perf_counter() - t_ref
    ctx = run.ctx
    result = {
        "correct": verdict["correct"],
        "attempted": ctx.calls,
        "failed": 0,
        "metrics": read_metrics(spec.per_layer if trace else spec.end_to_end, run),
        "device": device_line(ctx, spec.chips),
    }
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["window_line"] = {
        "calls": ctx.calls, "closed_windows": len(ctx.close_ms),
        "window_s": ctx.window_s,
        "restamp_ms_mean": (1e3 * statistics.fmean(ctx.restamp_s) if ctx.restamp_s else None),
        "close_ms_min_median_max": ([min(ctx.close_ms), statistics.median(ctx.close_ms),
                                     max(ctx.close_ms)] if ctx.close_ms else None),
        "stage_ms_median": 1e3 * statistics.median(ctx.stage_s) if ctx.stage_s else None,
        "compared_windows": verdict.get("windows"), "reference_s": ref_s,
    }
    result["checks"] = verdict["checks"]
    return result
