#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to account.

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR   # kernel A/B only, see `against`

Needs one CUDA device and the CUDA toolkit (nvcc). Phases, each failing
loudly with a nonzero exit:

1. Device line (`nvidia-smi` name + power limit, torch CUDA version,
   `utils/provenance.bench_provenance()`) and
   the kernel build from the sources in this checkout (one nvcc per
   source, started together) into deepflow_tpu_torch/_build/.
2. Kernel parity at the full-width main-path shapes: every segmented-
   reduce launcher against its plain PyTorch version on the same
   inputs, at the pre-reduce shape (N = 2^21 rows, cap = 2^15), the
   fold shape (N = 2^16 + 2·4·2^15, cap = 2^16, in the full fold's
   sorted order and in the merge fold's merged order) and the cascade's
   tier-merge shape (N = 2^18 tier + 2^19 ring + 2^18 flush rows, cap =
   2^18, at the ninth 1-window tier step of the bench.py stream), with
   rows from SyntheticFlowGen(10_000, seed=0) through the port's own
   pre-reduce, fanout, stash and tier step. Live segments only; SUM
   lanes within rtol 1e-5
   (summation order), MAX lanes exact. Times: the call (CUDA events
   around the wrapper, median of 20), the kernel's device time alone
   (torch.profiler over 20 calls) and the library's (torch.segment_reduce
   sum + max over the sorted live rows, two calls, after an index_select
   for the gather launcher); the bound counts the outputs of live
   segments only, since absent ones are not written.
3. The main path at full width, launch counts zeroed just before and
   read just after: the bench.py cycle (batch 2^21, stash 2^16, 2
   appends + 1 fold, unique cap 2^15) through make_ingest_step, then
   L4Pipeline over 6 consecutive seconds of 2^21-row batches and a
   drain. Then the same cycle once more with DEEPFLOW_FUSED_GATHER=0,
   the pre-gathered launcher's path.
2b. Sketch-kernel parity at full width: the fused sketch update (HLL
   max, count-min run-head adds, top-K challengers) against its plain
   PyTorch version on the operands of one sketch-plane phase, built
   with the port's own functions from the bench.py stream (pre-reduce →
   sketch inputs → span bounds → shared sort → phase mask), on two
   clones of a plane that already holds one batch. hll, cms, the top-K
   lanes after the vote epilogue and the raw challenger tables where a
   bucket was hit must be exactly equal. Times: the call (CUDA events),
   the kernel's device time and launches per call (torch.profiler; one
   launch) and the wrapper's host time (perf_counter over queued calls).
3c. The sketch-on main path, launch counts zeroed just before and read
   just after: the bench.py cycle with the production sketch plane of
   bench/foldbench.py:166-170 through make_ingest_step(sketch_config=),
   then L4Pipeline with the same plane over 6 consecutive seconds and a
   drain — six WindowSketchBlocks, n_updates summing to the
   sketch_rows counter, nothing shed or dropped, ≤ 3 fetches per ingest,
   and each window's distinct() within 2% of the exact count of client
   addresses in that second.
3d. The merge fold (fold_mode="merge"), counts zeroed before and read
   after: the bench.py cycle, whose final stash must equal phase 3's
   full-fold stash lane for lane; the segreduce kernels also run at the
   merge-fold shape in phase 2 (the ring sorted alone and rank-merged
   into the stash, rows read through the merged order).
3e. The pool + merge main path, counts zeroed before and read after:
   the bench.py cycle and L4Pipeline over the same 6 seconds with
   pooled sketch memory (`pool_sketch_config`) and the merge fold. The
   windows must equal phase 3's, no sketch_fused launch (pool mode
   takes plain scatters, as in the reference), segreduce launches > 0,
   ≥ 1 promotion, ≤ 3 fetches per ingest; each block that lost no row
   to a spill has the slab run's HLL registers and a distinct() within
   2%, and spilled rows account for the rest. Both planes' resident
   bytes are printed (sums of tensor sizes).
3f. The cascade main path, counts zeroed before and read after:
   L4Pipeline (batch 2^21 of SyntheticFlowGen(10_000, seed=0), stash
   2^18, the slab sketch plane) with a minute + hour cascade of 2^18-row
   tier stashes over seconds T0+34 … T0+45 and a drain. T0 is 20 s into
   its minute, so a minute closes during the ingest. Checks: 12 one-
   second windows, 2 minute and 1 hour windows; each minute's keys are
   its seconds' keys, its SUM meters the f32 fold of their docs in
   window order (rtol 1e-5) and its MAX meters their max (exact); the
   hour's packets equal the minutes'; the cascade lanes after the drain
   are [1 s rows + minute rows, 0]; each minute sketch block equals the
   merge of its seconds' blocks and its distinct() is within 2% of the
   exact client count; ≤ 3 fetches per ingest; segreduce launches
   inside the tier steps; no device→host copy in the profiler traces of
   two on_advance calls (a 1-window append, the minute close). Then the
   device time and launches of one tier step and of one tier close.
3g. The counter ring and async drain, counts zeroed before and read
   after: L4Pipeline as in 3c (batch 2^21, stash 2^18, the slab plane)
   over 3 batches a second for T0 … T0+5 (18 ingests, staged on the card
   first from SyntheticFlowGen(10_000, seed=1)) and a drain, three times:
   per-batch fetching (the oracle), a K = 4 ring, and async_drain. The
   ring's DocBatches, sketch blocks and stream counters equal the
   oracle's; async emits the oracle's windows one ingest call later; the
   ring's fetches over the 18 ingests are ≤ ⌈18/4⌉ + 2 · advances and
   < 18; ingests 12–15 of each run are profiled one by one, and the
   ring's three that do not drain it record no device→host copy. Per
   run: wall seconds and records/s over the other ingests and the drain,
   and the profiled ingests' device idle share.
3h. The live read, counts zeroed before and read after: the K = 4 run
   again with snapshot_open(force=True) after every third ingest (the
   one after ingest 8 timed with CUDA events, the one after ingest 17
   profiled), then with pooled memory and the merge fold. Both streams
   equal the oracle's; each snapshot takes ≤ 2 fetches; the last
   snapshot before the drain equals the drained rows (and closed sketch
   blocks) of each window it holds; the pooled run's snapshots read
   compact slots and a promoted wide slot.
3i. The checkpoint round trip at the 3f widths, counts zeroed before and
   read after: the 3f stream saved after T0+40 (mid-minute; the save
   folds the tier rings) with the v6 writer and loaded into a fresh
   L4Pipeline on the card, then finished and drained. Its 1 s and tier
   DocBatches (meter bits included), sketch blocks, tier sketch blocks,
   counters and cascade lanes equal 3f's uninterrupted run. Both kernels launch after the load, and on the restored state — the
   fold of its stash and ring, its sketch plane with the next batch —
   each is held against its plain version once more (uncounted). Printed:
   the file's raw and on-disk bytes, and the wall of the save (the
   settled payload's device→host copies; the atomic write) and of the
   load (read + digest check; the restore's upload), with the sha256
   and zlib shares timed again on the same arrays.
3j. Kill and recover through PyOverwriteQueue → FeederRuntime (with a
   FrameJournal) → PipelineFeedSink → L4Pipeline on the card, counts
   zeroed before and read after: the schedule of tests/test_recovery.py
   (capacity 2^12, buckets 64/128/256) uninterrupted — equal to the CPU
   run, seam for seam — and killed at its four kill-points (dispatch 2,
   fetch 5, dispatch 3, dispatch 4), each landing on the reference's step
   and recovered from checkpoint + journal alone bit-exact, outputs and
   counters; then at the 3f widths with 2^18-row buckets (2^21-row
   seconds in 1024 frames of 2048 rows): seconds T0+34, T0+35, a
   checkpoint, T0+36, T0+37 and a drain, killed at the first flush-row
   fetch after the checkpoint (found in the uninterrupted run) and
   recovered bit-exact, with the time to recover (load + replay_journal
   + the tail pump, synchronised wall) and the journal's bytes per
   record. Journals and checkpoints live in a temporary directory that
   is deleted.
3k. The sharded path, counts zeroed before and read after each run:
   BASELINE config 5 (bench_all.py:300-309; a 2^18-row stash a shard)
   on 4 logical shards of the card in a (2 × 2) mesh, fed 2^21-row
   batches of SyntheticFlowGen(10_000, seed=0) for T0 … T0+5 and a
   drain (the T0+4 ingest profiled). Checks: segreduce_gather and
   sketch_fused on shard 0's operands equal their plain versions
   (uncounted); ≤ 3 fetches per ingest, 2 per drain; per key, the
   shards' DocBatch SUM meters summed equal the single-chip L4Pipeline's
   1 s rollup of the same batches (integer values below 2^24 bit for
   bit, the rest within rtol 1e-5; MAX exact); the merged window_close
   HLL view equals the single-chip plane's registers, and each closed
   block's HLL the single-chip block's. Run B saves after T0+3
   (save_sharded_state), restores into a fresh manager and must emit
   the same stream; run C adds the minute + hour cascade over T0+38 …
   T0+43, whose minute must equal the fold of its seconds. Then card =
   CPU at 2^14-row batches (DocBatches, tier DocBatches, blocks,
   snapshots, counters). Printed: records/s, launches and idle share of
   an ingest, window_close ms, the file's bytes and save/load wall.
3l. The server deployment, counts zeroed before and read after its main
   path: bench/e2e_ingest.py's stream (SyntheticFlowGen(5_000, seed=0),
   4096 records a second through L4Pipeline on the card, 100,000 1 s docs
   in frames of 256 from 8 agent ids; one doc in 20 moved to the
   internet EPC, one in 20 to an unregistered address) over localhost
   TCP into Receiver → FlowMetricsIngester (4 workers, 8192-doc enrich
   chunks; the Python decoder and queue, prefer_native=False, so docs/s
   stays comparable with earlier runs) → DocStoreWriter → ColumnarStore
   on disk, enriched against a
   platform state at Kubernetes' large-cluster limits (150,000 pods with
   an IPv4, a MAC and a gprocess each, 5,000 nodes, 10,000 pod services;
   the stream's addresses are pods' addresses); then the Downsampler
   (network_1s and network_map_1s → 1 h, chained network_1h → 1 d) and
   a SQL corpus over the 1 s, 1 h and 1 d tables. The same frames go
   through the CPU twin: ingester counters, the stored rows (as
   multisets), the rollups and every query result must equal the card's
   (integer-valued floats below 2^24 bit for bit, the rest within rtol
   1e-5). segreduce_gather at the downsample shape is held against its
   plain version and timed. Printed: docs/s (first frame sent alone as
   a warm-up, then all frames; until every doc is enriched and handed
   to the writer), one 8192-doc enrich chunk's device time, launches and
   fetches, the downsample's rows in/out, wall and device time, and the
   median query wall. A dead ingester worker fails the phase.
3m. The agent deployment, counts zeroed before run_pcap and read after
   its drain (BASELINE configs 1–2): a capture crafted from a seed with
   agent/packet.py — 8,000 HTTP/1.1 keep-alive connections, 1,000 gRPC
   unary ones (HTTP/2 HEADERS + DATA in literal HPACK), 1,000 DNS
   5-tuples between 2,000 client and 200 server addresses of 3l's pods
   (1 in 20 outside them), a request every ~3 s on each for 20 s from 5 s
   before a minute boundary (46,828 requests), 1 response in 20 an
   error, 1 data segment in 100 resent, 1 connection in 50 reset by the
   server, half closed with FIN and the rest left to the drain — goes
   through Agent(device="cuda").run_pcap at the reference's widths
   (FlowMap 2^16 rows, MinuteAggr 2^16 rows in 4 × 2^12-row batches,
   2^12-packet batches, l4 log throttle 10,000, a 2^18-row metrics
   window), its UniformSenders over localhost TCP into one Receiver
   feeding FlowMetricsIngester and FlowLogIngester over one store,
   enriched against 3l's platform state. Checks: every module call
   (FlowMap inject / tick, MinuteAggr, both metric pipelines) replayed on
   a CPU Agent's modules gives the card's result (ints exact, integer-
   valued floats below 2^24 bit for bit, the rest within rtol 1e-5); the
   minute logs equal flowlog/oracle.py's merge of the tick emissions;
   every drop lane is 0; inject fetches nothing and a tick at most
   twice; the stored l4_flow_log, l7_flow_log, network_1s and network_1m
   rows equal the CPU twin's (the card's ingested batches enriched again
   on the CPU) and one SQL statement a table returns the same result.
   Each profiled part has the card to itself (the server's enrichment
   waits, `CardGate`). Printed: packets/s and requests/s of run_pcap, each part
   of 4 profiled mid-run steps (launches, device ms, idle share), the
   fetches, the rows written per table and the docs written.
3n. Self-observability, counts zeroed before its main path (below) and
   read after: the standalone sketch functions (ops/{hll,cms,histogram,
   tdigest,topk}.py: init, update, merge, estimate / query / quantiles,
   t-digests) at tests/test_sketches.py's sizes and the production
   widths (HLL p = 14, count-min 4 × 2^16, top-K 2 × 1024), card against
   CPU — integer lanes exact (the histogram by 4b's adjacent-bin rule),
   floats within rtol 1e-5; 3c's slab L4Pipeline over 3f's first four
   seconds (2^21-row batches) and a drain with DEEPFLOW_SHARED_SORT=0
   and =1 — identical windows and sketch blocks, the census's plane
   sorts 2 × topk_rows and 1, no sketch_fused launch under the oracle;
   3f's L4Pipeline (slab plane, minute + hour cascade) built on an
   emptied cache and fed the same batches — Σ ledger bytes ≤ the growth
   of torch.cuda.memory_allocated, the gap within the allocator's
   rounding of the plane blocks plus the named tensors that are not
   planes (the allocator's block table, `torch.cuda.memory_snapshot`),
   a ledger snapshot with no fetch and no device→host copy in its
   profiler trace, per-plane bytes with their ratio to the reference's
   (REF_PLANE_BYTES_3N); a small save's checkpoint_scratch watermark;
   the pipeline, its spans, the ledger and the step census through a
   collector tick into deepflow_system, read back by the SQL engine on
   the card bit for bit; a closed block's sketch rows against the
   tensor t-digest on the card; telemetry() of the pipeline and of a
   4-shard ShardedWindowManager at 3k's shape over three of the
   batches (bytes per device = bytes / 4). Printed with the phase's
   wall seconds.
3o. Window lineage and the push plane, counts zeroed before its main
   path and read after. (a) 3c's slab L4Pipeline (2^21-row batches,
   2^18-row stash) over 3f's first four seconds and a drain, every
   window into a store through docbatch_window_sink and a forced live
   read after the second ingest: passive, then with a LineageTracker +
   FreshnessTracker under a frozen clock (both runs profiled), then on
   the wall clock with every tracker call timed. Windows, sketch blocks,
   snapshots and host fetches equal the passive run's, and the lineage
   run's trace holds no device→host copy beyond the passive run's; the
   span rows, trace trees, hop records and freshness lanes of the
   frozen-clock run at 2^14-row batches equal the CPU's (the 4b cut).
   Printed: p50 / p99 of each lag lane on the wall clock and the host µs
   a hop costs. (b) 3l's METRICS stream at 256 records a second (1 s
   docs in frames of 256 from 8 agents, ~1k docs a second, ten seconds
   and a drain) through PyOverwriteQueue → FeederRuntime +
   WindowManagerFeedSink (buckets 2048/4096/8192) with event_bus= and
   lineage=, each pump's windows into a store through
   flow_window_sink(bus=, lineage=) and a collector tick of the
   freshness lanes into deepflow_system; one SQL and one PromQL standing
   query, a PromQL rule over tpu_freshness_visibility_lag_ms and a SQL
   rule, both crossed mid-run. Card = CPU on the windows, the event
   batches, the subscription results, the alert transitions and the
   lineage records; `events_published` equals the close events of the
   pumps' windows, each pump that flushed published exactly one batch,
   and every stored window has store.insert and query.first. Printed:
   events per pump and the CUDA-event wall of one SQL subscription
   re-evaluation and of one SQL rule evaluation.
3p. The multi-process deployment: host processes, each joined over gloo
   by MeshTopology.distributed, sharing the one card (count 1), launch
   counts summed over the processes (each counts its own from its
   start). (a) tests/torch_mesh_harness.py's recipes at their test size
   with every host on the card — the clean two-process run and the
   kill-and-recover run side by side, then the clean rebalance — each
   group's rows and sketch blocks (from the hosts' .npz) against the
   harness's CPU oracle in this process under the float rule (integers
   and integer-valued floats below 2^24 exact, MAX exact, SUM within
   rtol 1e-5, a histogram count one bin at most), counters and
   freshness lags exact; misroutes equal the frames of the other
   group's agents, all handed off; ≤ 3 fetches an ingest, none
   off-device; the census's buckets steady; the killed host's combined
   stream and the moved group's stream across both owners equal the
   oracle's; the handover pause (release and adopt ms). (b) Two hosts
   at full width, one group each of 2 logical shards with BASELINE
   config 5 (`sharded_config()`), fed the bench.py stream
   (SyntheticFlowGen(10_000, seed=0), 2^21 rows a second cut into 8
   agents' 2048-row frames, each agent sent to its owner) through
   receiver → queue → FeederRuntime → ShardedFeedSink at 2^18-row
   buckets for 4 seconds (3 timed, both hosts started together; the
   4th profiled) and a drain; each group against one process serving
   both groups on the card (MeshTopology.single) under the same rule.
   Printed: per-host and aggregate records/s, the init_process_group
   wall, fetches an ingest, the profiled ingest's launches and idle
   share per host. Any host that exits non-zero (but the scripted
   kill), times out or ran elsewhere than on the card fails the phase.
3q. The composed server (server/main.py's Server, as `dfctl server` runs
   it) at 3l's width, counts zeroed before and read after: booted on the
   card from the reference's default ingester and wire settings (the
   native C++ decoder and queue, the wire plane on, its framed-TCP
   listener too), 3l's platform through its resource plane, 3l's frames
   over TCP with one pod service replaced mid-stream, a 1 h downsampling
   tick, REST / debug / MCP / `dfctl query`. The phase fails, printing
   the native build error, unless the card's ingester decoded natively.
   After the ingest, one SSE `GET /v1/watch?sql=` stream and one
   framed-TCP stream on the first SQL statement, beside a direct local
   subscription on it, take 4 WindowClosed batches: every result both
   streams delivered equals the direct one's under result_to_jsonable.
   A CPU Server in another process, decoding in Python, is its twin:
   counters, ticks, every stored row and every query result equal.
   Printed: docs/s, the decoder, the native build, the wire deliveries,
   drops and reaps.
3r. The last slice's modules at test size, counts zeroed before (a) and
   (b) and read after: (a) the rollup oracle (oracle/numpy_oracle.py)
   against the card's L4Pipeline and L7Pipeline windows on the reference
   conformance tests' seeded streams, keys and meters exact; (b) 2,048
   HTTP sessions as eBPF socket events through EbpfDispatcher and
   L7Pipeline on the card — app documents equal to the CPU's, all tagged
   eBPF — and the same rows through L4Pipeline, which emits nothing;
   (c) a FleetSubscriptionRouter here and one publisher host process
   (tests/torch_wire_host.py) whose SQL subscription evaluates on the
   card: every merged envelope equals the host's own subscription
   oracle, and the host killed and respawned with a higher seq_base is
   counted lost and recovered, its results not taken for duplicates.
4. The same L4Pipeline stream at 2^14-row batches on the card and on
   the CPU (plain path): flushed windows and counters must match
   exactly; then again with the sketch plane on (4b): every block lane
   equal, except that histogram counts may move to an adjacent bin
   (CUDA logf vs the CPU's) — group totals must still agree; then with
   pooled memory and the merge fold (4c), counter lanes 18–20 included
   and histograms compared at the compact bin width; then the cascade
   (4d: 2^16-row window and tier stashes, ~13k docs a second, a minute
   boundary, a fold+append and a direct fold), with the full fold and
   the slab plane and with the merge fold and pooled memory: tier
   windows, tier sketch blocks, cascade lanes and counters exact; then
   (4e) a K = 4 ring with a snapshot after every second ingest, slab +
   full fold and pool + merge fold — windows, sketch blocks and every
   snapshot's windows and open blocks equal — and async_drain once;
   then (4f) 4d's slab stream saved after T0+40 on the card and resumed
   on the CPU, and the other way round: both files have one digest, the
   two resumed streams are equal, and each equals 4d's uninterrupted CPU
   run.
5. One JSON line of each cycle's records/s (with its device idle share
   and kernel launches, and the launches of one fold alone in each fold
   mode), the agent's packets/s and requests/s, then one of the kernels (with the card's name and power limit;
   each row with ms, device_ms, plain_ms, bound_ms, bound_by and
   library_ms, the segreduce rows also at the fold, merge-fold and
   tier-fold shapes), then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import threading
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
SKETCH_KERNEL = ("sketch_fused", "deepflow_tpu/ops/sketch_pallas.py:107",
                 "deepflow_tpu_torch/kernels/sketch_fused.cu")
DELAY = 2
RING = DELAY + 2  # open windows at interval 1
DISTINCT_RTOL = 0.02
# the rollup cascade: a minute and an hour tier. T0 is 20 s into its
# minute, so the minute [T0 − 20, T0 + 40) closes during the stream of
# seconds T0+34 … T0+45, once T0+42 arrives
CASCADE_INTERVALS = (60, 3600)
CASCADE_SECONDS = list(range(34, 46))
TIER_SMALL = 1 << 16  # phase 4d: window and tier stash rows
TIER_SMALL_TUPLES = 4000  # ~13k docs a second: 4 open windows hold ~53k rows


def sketch_config():
    """The production sketch shape of bench/foldbench.py:166-170."""
    from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
    from deepflow_tpu_torch.ops.histogram import LogHistSpec

    return SketchConfig(num_groups=8, hll_precision=14, cms_depth=4, cms_width=1 << 16,
                        hist=LogHistSpec(bins=128, vmin=1.0, gamma=1.1), topk_rows=2,
                        topk_cols=1024, pending=8)


def pool_sketch_config():
    """The same widths with pooled sketch memory: the pool variant of
    bench/sketchbench.py:132 (3 compact slots, 1 wide, count-min and
    histogram factor 8, top-K factor 2, promotion at fill 0.5)."""
    from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig

    return dataclasses.replace(sketch_config(), pool=PoolConfig(topk_factor=2))


def plane_bytes(cfg, dev) -> dict:
    """Resident bytes of a fresh plane of `cfg`, as a sum of its tensors'
    sizes: the pending buffer (its scratch row included) apart from the
    rest."""
    from deepflow_tpu_torch.aggregator.sketchplane import sketch_init

    sk = sketch_init(cfg, RING, device=dev)
    sizes = {f.name: getattr(sk, f.name).nbytes for f in dataclasses.fields(sk)}
    pending = sizes.pop("pend") + sizes.pop("pend_win")
    return {"planes": sum(sizes.values()), "pending": pending,
            "total": sum(sizes.values()) + pending}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def native_build_info() -> dict:
    """The native decoder and queue library (host C++, built at first use
    into deepflow_tpu_torch/_build/): compiler, build seconds (0.0 when
    it was already built), or the build error."""
    from deepflow_tpu_torch import native

    if not native.native_available():
        return {"error": native.build_error()}
    return {k: native.build_info[k] for k in ("compiler", "seconds")}


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


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total


# Where the profiler's trace came back without the device time after
# every session, in the order met: the matched kernel name (or "all
# kernels") of each call whose device time CUDA events took instead.
PROFILER_GAPS: list[str] = []
SPIN_CYCLES = 100_000_000  # ~50 ms of spin at the H100's clock


def queued_device_ms(fn, counter=None, reps: int = REPS) -> tuple[float, float | None]:
    """Device time per call from CUDA events around `reps` calls queued
    behind a spin kernel: the card starts the first call only after the
    host has queued them all, so the host's launch gaps fall outside the
    events (the calls' kernels back to back, the gaps between kernels
    included). Launches per call from the wrapper's `counter`, or None
    without one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    n0 = counter() if counter else 0
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    launches = (counter() - n0) / reps if counter else None
    return a.elapsed_time(b) / reps, launches


def device_time(fn, match, launches_per_call: int | None = None,
                counter=None) -> tuple[float, float | None]:
    """Device time per call of the CUDA kernels whose name holds `match`
    (a string, or None for every kernel the call launches), from
    torch.profiler over REPS calls after a warmup — without the host work
    that an event pair around the call encloses — and their launches per
    call. With `launches_per_call` (what the wrapper's counter says a call
    launches), a session whose trace holds another count is taken again:
    the profiler on the card has dropped kernel records (0.55 and 0.95 of
    the one launch a call in two sessions). When four sessions all miss
    the device time (once, every session of a late phase saw no kernel),
    CUDA events time the calls queued behind a spin (`queued_device_ms`),
    the launches come from the wrapper's `counter` (None without one),
    and the call is listed in PROFILER_GAPS."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # sessions are taken again while the trace is incomplete: once, the
    # first session of a process on the card recorded no kernel at all
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (match is None or match in e.key)]
        complete = (launches_per_call is None
                    or sum(e.count for e in events) == launches_per_call * REPS)
        if events and sum(_dev_us(e) for e in events) > 0 and complete:
            return (sum(_dev_us(e) for e in events) / 1e3 / REPS,
                    sum(e.count for e in events) / REPS)
    PROFILER_GAPS.append(match or "all kernels")
    print(f"chip_smoke: the profiler missed {match or 'all kernels'} in 4 sessions; "
          "CUDA events time it", file=sys.stderr, flush=True)
    dev_ms, launches = queued_device_ms(fn, counter)
    check(dev_ms > 0, f"no device time for {match}")
    return dev_ms, launches


def host_ms(fn, reps: int = 10 * REPS) -> float:
    """Host time per call: time.perf_counter around `reps` calls that
    queue without a sync (their device work is far shorter than their
    host work, so the queue never stalls the loop), synchronised before
    and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


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
    from deepflow_tpu_torch.aggregator.stash import (
        accum_init, fold_operands, merge_fold_keys, merge_operands, stash_init,
    )
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.segment import SENTINEL_SLOT, segment_ids, sort_keys

    def sorted_operands(s_slot, s_hi, s_lo, perm, rows, cap):
        seg, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, cap)
        return dict(rows=rows, seg=seg, first_pos=first_pos, perm=perm.to(torch.int32),
                    cap=cap, live=min(int(num_seg), cap),
                    live_rows=int((seg < cap).sum()))

    def operands(slot, hi, lo, rows, valid, cap):
        return sorted_operands(*sort_keys(slot, hi, lo, valid), rows, cap)

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
    # the merge fold of the same stash and ring: the ring sorted alone and
    # rank-merged into the stash; the kernel reads rows through that order
    _, na, a_perm = merge_fold_keys(acc, SENTINEL_SLOT)
    m_sl, m_hi, m_lo, order, _, m_rows = merge_operands(state, *na, a_perm, acc.tags,
                                                        acc.meters)
    merge_ops = sorted_operands(m_sl, m_hi, m_lo, order, m_rows, CAPACITY)
    check(merge_ops["live"] == fold_ops["live"], "merge and full fold segment counts differ")
    t_slot, t_hi, t_lo, _, t_rows, t_valid = tier_merge_operands(dev)
    tier_ops = operands(t_slot, t_hi, t_lo, t_rows, t_valid, STASH_CAPACITY)
    return {"prereduce": pre, "fold": fold_ops, "merge_fold": merge_ops, "tier_fold": tier_ops}


def tier_merge_operands(dev):
    """The group-by operands of the cascade's tier merge at full width:
    nine consecutive seconds of the bench.py stream, each pre-reduced,
    fanned out and folded into a 2^18-row stash and flushed, go through
    the port's tier step into a 2^18-row minute tier; at the ninth the
    2^19-row ring is full (fold+append), and its merge sorts tier stash ‖
    ring ‖ the 2^18 packed flush rows (masked: they append) — 2^20 rows
    with a live tier stash. Returns fold_operands' tuple."""
    from deepflow_tpu_torch.aggregator import cascade
    from deepflow_tpu_torch.aggregator.fanout import FANOUT_LANES, FanoutConfig
    from deepflow_tpu_torch.aggregator.pipeline import make_ingest_step, upload_flow_batch
    from deepflow_tpu_torch.aggregator.stash import (
        _flush_range_impl, accum_init, fold_operands, stash_init,
    )
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    append, fold = make_ingest_step(FanoutConfig(), interval=1,
                                    batch_unique_cap=UNIQUE_CAP, device=dev)
    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    num_tags = TAG_SCHEMA.num_fields
    prefix = cascade.tier_prefix(STASH_CAPACITY)
    tier = stash_init(STASH_CAPACITY, TAG_SCHEMA, FLOW_METER, device=dev)
    acc = accum_init(cascade.tier_ring_rows(STASH_CAPACITY), TAG_SCHEMA, FLOW_METER,
                     device=dev)
    fill = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.zeros((2,), dtype=torch.int64, device=dev)
    for k, s in enumerate(CASCADE_SECONDS[:9]):
        tags, meters, valid = upload_flow_batch(gen.flow_batch(BATCH, T0 + s), dev)
        child = stash_init(STASH_CAPACITY, TAG_SCHEMA, FLOW_METER, device=dev)
        ring = accum_init(FANOUT_LANES * UNIQUE_CAP, TAG_SCHEMA, FLOW_METER, device=dev)
        child, ring = fold(*append(child, ring, 0, tags, meters, valid))
        _, packed, total = _flush_range_impl(child, T0 + s, T0 + s + 1)
        hi = T0 + s + 1
        if k < 8:
            tier, acc, fill, lanes = cascade.tier_step(
                tier, acc, fill, lanes, packed, total, hi, ratio=CASCADE_INTERVALS[0],
                meter_schema=FLOW_METER, num_tags=num_tags, prefix=prefix)
            continue
        check(int(fill) + prefix > acc.capacity and 0 < int(total) <= prefix
              and int(tier.valid.sum()) > 0, "tier_fold: the ninth step is no fold+append")
        cols = list(cascade._parent_columns(packed, hi, ratio=CASCADE_INTERVALS[0],
                                            num_tags=num_tags))
        cols[5] = cols[5] & (total > prefix)  # the tier step's mask: rows append
        return fold_operands(tier, *cascade.merge_row_lanes(acc, cols))


def kernel_parity(name: str, ops: dict, *, timed: bool = True) -> dict:
    """One launcher at one shape: parity with the plain version, and
    (`timed`) the call time (CUDA events around the wrapper), the
    kernel's device time (profiler), the library time, and the
    bytes/operations bound of this input."""
    from deepflow_tpu_torch.ops import segreduce
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
    finite = bool(torch.isfinite(ks).all() and torch.isfinite(km).all())
    sum_err = (ks - ps).abs()
    sum_ok = bool((sum_err <= SUM_RTOL * ps.abs()).all())
    max_ok = bool(torch.equal(km, pm))
    check(finite, f"{name}: non-finite kernel output")
    check(sum_ok, f"{name}: SUM lanes off by more than rtol {SUM_RTOL}")
    check(max_ok, f"{name}: MAX lanes differ")
    max_abs_err = float(max(sum_err.max(), (km - pm).abs().max()))
    if not timed:
        return {"parity_ok": finite and sum_ok and max_ok, "max_abs_err": max_abs_err,
                "rows": int(seg.shape[0]), "live_segments": live}

    # the library's segmented reduce over the pre-sorted live rows: two
    # calls (sum, max), plus the index_select that sorts them for the
    # gather launcher
    n_live = ops["live_rows"]
    offsets = torch.cat([fp[:live].long(),
                         torch.tensor([n_live], dtype=torch.int64, device=fp.device)])
    live_perm = ops["perm"][:n_live].long()

    def library():
        x = rows.index_select(0, live_perm) if gather else rows[:n_live]
        return (torch.segment_reduce(x, "sum", offsets=offsets, axis=0),
                torch.segment_reduce(x, "max", offsets=offsets, axis=0))

    ls, lm = library()
    library_agrees = bool((((ls - ps).abs() <= SUM_RTOL * ps.abs()).all())
                          and torch.equal(lm, pm))

    # bytes this input needs: each kept row read once with its id (and
    # its perm entry with the gather), first_pos once, and the live
    # segments' sums and maxs written once (absent ones are garbage by
    # contract and not written)
    m = rows.shape[1]
    nbytes = (n_live * (4 * m + 4 + (4 if gather else 0)) + 4 * cap + 2 * 4 * live * m)
    ops_count = 2 * n_live * m
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3

    def call():
        return sorted_segment_sum_max(rows, seg, cap, fp, perm=perm)

    dev_ms, dev_launches = device_time(
        call, "segreduce", launches_per_call=1,
        counter=lambda: sum(segreduce.LAUNCHES.values()))
    check(dev_launches == 1, f"{name}: {dev_launches} device launches per call")
    return {
        "parity_ok": finite and sum_ok and max_ok, "max_abs_err": max_abs_err,
        "ms": time_ms(call), "device_ms": dev_ms,
        "plain_ms": time_ms(
            lambda: sorted_segment_sum_max_plain(rows, seg, cap, fp, perm=perm)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": time_ms(library), "library_agrees": library_agrees,
        "library": ("torch.segment_reduce sum + max over the sorted live rows, 2 calls"
                    + (", after index_select through perm" if gather else "")),
        "rows": int(seg.shape[0]), "live_rows": n_live, "m": m, "cap": cap,
        "live_segments": live, "bytes": nbytes,
    }


def sketch_operands(dev, sk=None, fb=None, sw: int | None = None):
    """(cfg, plane, keywords) of the fused sketch update at the main-path
    shape: the phase-c operands of a bench.py batch against a plane that
    already holds one of another flow population (so registers rise and
    top-K buckets are contested), built with the port's own functions.
    With `sk`, `fb` and `sw`: the operands of host batch `fb` against
    plane `sk` behind the gate `sw` (a restored manager's next batch)."""
    from deepflow_tpu_torch.aggregator import sketchplane as sp
    from deepflow_tpu_torch.aggregator.pipeline import batch_prereduce, upload_flow_batch
    from deepflow_tpu_torch.aggregator.stash import sum_max_cols
    from deepflow_tpu_torch.aggregator.window import (
        sketch_inputs_from_columns, sketch_span_bounds,
    )
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    cfg = sketch_config()
    sum_cols, max_cols = sum_max_cols(FLOW_METER)
    sw = T0 - DELAY if sw is None else sw

    def plane_batch(batch):
        tags, meters, valid = upload_flow_batch(batch, dev)
        tags, meters, valid, _ = batch_prereduce(tags, meters, valid, 1, UNIQUE_CAP,
                                                 sum_cols, max_cols)
        inp = sketch_inputs_from_columns(tags, meters, cfg.num_groups, FLOW_METER.index)
        ts = tags["timestamp"]
        base_w, close_w = sketch_span_bounds(sw, ts, valid, interval=1, delay=DELAY)
        return dict(window=ts, valid=valid, base_w=base_w, close_w=close_w, **inp)

    if sk is None:
        def bench_batch(seed):
            return SyntheticFlowGen(num_tuples=10_000, seed=seed).flow_batch(BATCH, T0)

        sk = sp.sketch_init(cfg, RING, device=dev)
        # the plane holds a batch
        sk = sp.sketch_plane_step(sk, cfg.hist, **plane_batch(bench_batch(1)))
        fb = bench_batch(0)
    x = plane_batch(fb)
    _, in_c, _ = sp.phase_masks(sk, window=x["window"], valid=x["valid"],
                                base_w=x["base_w"], close_w=x["close_w"])
    presorted = sp.batch_sort(x["window"], x["key_hi"], x["key_lo"])
    return cfg, sk, sp.fused_operands(sk, in_c, presorted=presorted, **x)


def sketch_kernel_parity(dev, *, timed: bool = True, fused=None, **operands) -> dict:
    """The fused sketch update at the main-path shape (`sketch_operands`,
    which takes `operands`; or the given `fused` = (cfg, plane, keywords)),
    kernel vs plain on clones, exact; with `timed`, times and the bytes
    bound of this input."""
    from deepflow_tpu_torch.aggregator import sketchplane as sp
    from deepflow_tpu_torch.ops import sketch_fused
    from deepflow_tpu_torch.ops.cms import row_slots
    from deepflow_tpu_torch.ops.sketch_fused import (
        sketch_update_fused, sketch_update_fused_plain,
    )
    from deepflow_tpu_torch.ops.topk import _apply_challengers

    cfg, sk, kw = fused if fused is not None else sketch_operands(dev, **operands)
    n = int(kw["s_pos"].shape[0])
    s_mask = kw["mask"][kw["s_pos"]]
    live = int(s_mask.sum())
    check(live > 0, "sketch parity: the phase holds no live row")

    hk, ck = sk.hll.clone(), sk.cms.clone()
    hp, cp = sk.hll.clone(), sk.cms.clone()
    _, _, ch_k = sketch_update_fused(hk, ck, **kw)
    _, _, ch_p = sketch_update_fused_plain(hp, cp, **kw)
    torch.cuda.synchronize()
    check(bool((hk != sk.hll).any()) and bool((ck != sk.cms).any()),
          "sketch parity: the kernel changed no HLL or CMS cell")
    errs = []

    def same(a, b) -> bool:
        """Exact equality, recording the largest |a − b| (int64, so int32
        bit patterns cannot overflow) for the kernels line."""
        errs.append(int((a.long() - b.long()).abs().max()) if a.numel() else 0)
        return a.shape == b.shape and errs[-1] == 0

    check(same(hk, hp), "sketch_fused: HLL registers differ from the plain version")
    check(same(ck, cp), "sketch_fused: CMS counters differ from the plain version")
    lanes = tuple(getattr(sk, k) for k in sp.TOPK_LANES)
    for name, a, b in zip(sp.TOPK_LANES, _apply_challengers(lanes, ch_k),
                          _apply_challengers(lanes, ch_p)):
        check(same(a, b), f"sketch_fused: top-K lane {name} differs after the vote")
    hit = 0
    for (kg, *k_lanes, k_hw), (pg, *p_lanes, p_hw) in zip(ch_k, ch_p):
        check(same(kg, pg) and same(k_hw, p_hw),
              "sketch_fused: challenger got/hw tables differ")
        for a, b in zip(k_lanes, p_lanes):
            check(same(a[kg], b[kg]), "sketch_fused: challenger key/id lanes differ")
        hit += int(kg.sum())
    if not timed:
        return {"parity_ok": max(errs) == 0, "max_abs_err": float(max(errs)), "rows": n,
                "live_rows": live, "buckets_hit": hit}

    h, c = sk.hll.clone(), sk.cms.clone()

    def call():
        return sketch_update_fused(h, c, **kw)

    def plain():
        return sketch_update_fused_plain(h, c, **kw)

    dev_ms, dev_launches = device_time(call, "sketch_fused_kernel", launches_per_call=1,
                                       counter=lambda: sketch_fused.LAUNCHES["sketch_fused"])
    check(dev_launches == 1, f"sketch_fused: {dev_launches} device launches per call")

    # bytes this input needs, at the reference kernel's 4-byte u32/i32
    # lanes (the port's int64 lanes are its own cost, not the function's):
    # s_pos and the seven row lanes (window, gid, reg, rho, rw, key_hi,
    # key_lo) at 4 bytes a row and the mask and head flags at one; the
    # id_a/id_b lanes only of the rows that won a bucket (the resolve
    # reads nothing else of them); one read + write of each HLL / CMS cell
    # the live rows and run heads touch; the challenger tables (got + five
    # int32 lanes) written once
    g, m = cfg.num_groups, cfg.hll_m
    d_cms, w_cms = cfg.cms_depth, cfg.cms_width
    s_slot = kw["s_win"] % RING
    heads = kw["head"] & (kw["rw"] != 0)
    s_pos = kw["s_pos"]
    hll_cells = torch.unique(((s_slot * g + kw["gid"][s_pos]) * m + kw["reg"][s_pos])[s_mask])
    cms_flat = (s_slot[None, :] * (d_cms * w_cms)
                + row_slots(kw["s_hi"], kw["s_lo"], d_cms, w_cms))[:, heads]
    cms_cells = torch.unique(cms_flat)
    lane_bytes = (4 * 8 + 2) * n + 2 * 4 * hit
    tables = cfg.topk_rows * RING * cfg.topk_cols * (1 + 5 * 4)
    nbytes = lane_bytes + 8 * (int(hll_cells.numel()) + int(cms_cells.numel())) + tables
    ops_count = live * (6 * d_cms + 10 * cfg.topk_rows + 4)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_count / F32_OPS_PER_S * 1e3
    return {
        "parity_ok": max(errs) == 0, "max_abs_err": float(max(errs)),
        "ms": time_ms(call), "device_ms": dev_ms, "device_launches_per_call": dev_launches,
        "wrapper_host_ms": host_ms(call), "plain_ms": time_ms(plain),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None, "rows": n, "live_rows": live, "heads": int(heads.sum()),
        "hll_cells": int(hll_cells.numel()), "cms_cells": int(cms_cells.numel()),
        "buckets_hit": hit, "bytes": nbytes,
    }


def profile_cycle(cycle, *, host_ops: bool = True):
    """One cycle under torch.profiler: wall time (host clock, synced),
    device-busy time (sum of CUDA kernel times — one stream, so kernels
    do not overlap), the idle share, and the top kernels by time. With
    `host_ops=False` only device activity is traced (kernels and copies;
    a cheaper trace of a long cycle)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = _dev_us
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "copies": {d: sum(e.count for e in kernels if f"Memcpy {d}" in e.key)
                   for d in ("DtoH", "HtoD", "DtoD")},
        "top": [{"kernel": e.key[:90], "count": e.count, "ms": dev_us(e) / 1e3}
                for e in top],
    }


def bench_cycle(dev, cycles: int, with_profile: bool = False, sketch=None,
                fold_mode: str = "full"):
    """The bench.py cycle on the card (with `sketch`, the sketch plane
    folds every append's pre-reduced rows, gated at T0 − delay; the fold
    of `fold_mode`): returns (records/s over `cycles` timed cycles after
    one warmup, launches per module in the warmup cycle, — with
    `with_profile` — one more cycle's profile_cycle summary with one more
    fold's alone under "fold", and the final stash)."""
    from deepflow_tpu_torch.aggregator.fanout import FANOUT_LANES, FanoutConfig
    from deepflow_tpu_torch.aggregator.pipeline import make_ingest_step, upload_flow_batch
    from deepflow_tpu_torch.aggregator.sketchplane import sketch_init
    from deepflow_tpu_torch.aggregator.stash import accum_init, stash_init
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    tags, meters, valid = upload_flow_batch(
        SyntheticFlowGen(num_tuples=10_000, seed=0).flow_batch(BATCH, T0), dev)
    append, fold = make_ingest_step(FanoutConfig(), interval=1,
                                    batch_unique_cap=UNIQUE_CAP, fold_mode=fold_mode,
                                    sketch_config=sketch, delay=DELAY, device=dev)
    stride = FANOUT_LANES * UNIQUE_CAP
    st = {"state": stash_init(CAPACITY, TAG_SCHEMA, FLOW_METER, device=dev),
          "acc": accum_init(ACCUM_BATCHES * stride, TAG_SCHEMA, FLOW_METER, device=dev),
          "sk": None if sketch is None else sketch_init(sketch, RING, device=dev)}

    def appends():
        for k in range(ACCUM_BATCHES):
            if sketch is None:
                st["state"], st["acc"] = append(st["state"], st["acc"], k * stride,
                                                tags, meters, valid)
            else:
                st["state"], st["acc"], st["sk"] = append(
                    st["state"], st["acc"], k * stride, st["sk"], tags, meters, valid,
                    T0 - DELAY)

    def fold_once():
        st["state"], st["acc"] = fold(st["state"], st["acc"])

    def cycle():
        appends()
        fold_once()

    before = all_launches()
    cycle()
    torch.cuda.synchronize()
    diff = {k: v - before[k] for k, v in all_launches().items()}
    per_cycle = {"segreduce": diff["segreduce_gather"] + diff["segreduce_sorted"],
                 "sketch_fused": diff["sketch_fused"]}
    t0 = time.perf_counter()
    for _ in range(cycles):
        cycle()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary = None
    if with_profile:
        summary = profile_cycle(cycle)
        appends()
        summary["fold"] = profile_cycle(fold_once)
        del summary["fold"]["top"][4:]
    state = st["state"]
    live = int(state.valid.sum())
    check(live > 0, "bench cycle left an empty stash")
    check(int(state.dropped_overflow) == 0, "bench cycle shed stash segments")
    check(bool(torch.isfinite(state.meters[:, :live]).all()), "non-finite stash meters")
    if sketch is not None:
        sk = st["sk"]
        check(int(sk.rows) > 0 and int(sk.shed) == 0, "bench cycle sketch lanes")
        check(int(sk.count.sum()) == int(sk.rows), "sketch rows not all in the open slot")
        if sketch.pool is not None:
            check(int(sk.pool_promos) == 1 and int(sk.pool_spill) == 0,
                  "the bench cycle's one window did not promote once without spill")
    return BATCH * ACCUM_BATCHES * cycles / dt, per_cycle, summary, state


def pipeline_stream(device, batch: int, seconds: list[int], sketch=None,
                    fold_mode: str = "full", *, cascade=None, capacity: int = STASH_CAPACITY,
                    tuples: int = 10_000, seed: int = 1, profile_his=(),
                    capture_his=(), profile_dt: int | None = None, window_kw=None,
                    snapshot_every: int | None = None, save_after: int | None = None,
                    load_device=None, ckpt_dir: str | None = None, on_resume=None) -> dict:
    """L4Pipeline over one SyntheticFlowGen stream (sketch plane on with
    `sketch`, the fold of `fold_mode`, the rollup cascade with
    `cascade`): the windows closed before the drain, all DocBatches, the
    counters, every counter block, the closed sketch blocks, the host
    fetches of each ingest, and the client words' distinct counts per
    second and per minute; with the cascade, the (interval, DocBatch)
    tier windows, the merged tier sketch blocks, the cascade's device
    lanes after the drain and the `record_advances` records. With
    `profile_dt`, that second's ingest runs under `profile_cycle`.
    `window_kw` adds WindowConfig fields (stats_ring, async_drain); with
    `snapshot_every`, a forced snapshot follows every that many ingests
    (returned under "snapshots"). With `save_after`, the state is saved
    into `ckpt_dir` after that second's ingest and the stream goes on in a
    fresh pipeline on `load_device` that loaded it (`save_and_resume`;
    its measurements under "checkpoint"; the counter blocks and advances
    of both managers are recorded); `on_resume(pipe, fb)` runs on the
    resumed pipeline and its first batch before that is ingested (its
    result under "checkpoint", "restored")."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    # ~33k docs a second at 10k tuples; with delay=2 the fold before an
    # advance holds four windows (the closing one included): 2^18 rows
    pipe = L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=capacity, accum_batches=ACCUM_BATCHES,
                            delay=DELAY, sketch=sketch, fold_mode=fold_mode,
                            cascade=cascade, **(window_kw or {})),
        batch_size=batch, batch_unique_cap=min(UNIQUE_CAP, batch),
    ), device=device)
    blocks, snapshots, advances = [], [], []

    def instrument(wm):
        process = wm._process_block

        def record(vec):
            blocks.append(list(vec))
            process(vec)

        wm._process_block = record
        if cascade is not None:
            record_advances(wm, profile_his, capture_his, out=advances)

    instrument(pipe.wm)
    saved = None
    gen = SyntheticFlowGen(num_tuples=tuples, seed=seed)
    ingest_profile = None
    t_start = time.perf_counter()
    docs, fetches, words, tiers = [], [], {}, []
    for dt in seconds:
        fb = gen.flow_batch(batch, T0 + dt)
        if on_resume is not None and saved is not None and "restored" not in saved:
            saved["restored"] = on_resume(pipe, fb)
        words.setdefault(T0 + dt, []).append(unique_pairs(
            *(fb.tags[f"ip0_w{w}"][fb.valid] for w in range(4))))
        before = pipe.wm.host_fetches
        if dt == profile_dt:
            ingest_profile = profile_cycle(lambda: docs.extend(pipe.ingest(fb)))
        else:
            docs += pipe.ingest(fb)
        fetches.append(pipe.wm.host_fetches - before)
        tiers += pipe.pop_tier_docbatches()
        if snapshot_every and len(fetches) % snapshot_every == 0:
            snapshots.append(pipe.snapshot_open(force=True))
        if dt == save_after:
            pipe, saved = save_and_resume(pipe, os.path.join(ckpt_dir, "wm.ckpt"),
                                          load_device)
            instrument(pipe.wm)
    closed_before_drain = len(docs)
    docs += pipe.drain()
    tiers += pipe.pop_tier_docbatches()
    by_minute = {}
    for w, v in words.items():
        by_minute.setdefault(w // 60, []).extend(v)

    def distinct(groups) -> int:
        return len(unique_pairs_of(groups))

    held = pipe.get_counters()
    return {"seconds": time.perf_counter() - t_start, "closed": closed_before_drain, "docs": docs, "counters": pipe.counters,
            "blocks": blocks, "sketches": pipe.pop_closed_sketches(), "fetches": fetches,
            "sketch_blocks_dropped": held["sketch_blocks_dropped"],
            "clients": {w: distinct(v) for w, v in words.items()},
            "minute_clients": {m: distinct(v) for m, v in by_minute.items()},
            "tiers": tiers, "tier_sketches": pipe.closed_tier_sketches,
            "tier_sketch_blocks_dropped": held.get("tier_sketch_blocks_dropped"),
            "advances": advances, "ingest_profile": ingest_profile, "snapshots": snapshots,
            "checkpoint": saved,
            "cascade_lanes": (None if cascade is None
                              else [int(v) for v in pipe.wm.cascade.lanes_dev.tolist()])}


def unique_pairs(w0, w1, w2, w3) -> np.ndarray:
    """The distinct 128-bit client addresses among four u32 word lanes,
    as sorted [n, 2] u64 (hi, lo) pairs (a lexsort: np.unique over rows
    of a 2^21-row batch takes seconds)."""
    u64 = lambda x: np.asarray(x).astype(np.uint64)  # noqa: E731
    pairs = np.stack([(u64(w0) << np.uint64(32)) | u64(w1),
                      (u64(w2) << np.uint64(32)) | u64(w3)], axis=1)
    return unique_pairs_of([pairs])


def unique_pairs_of(groups) -> np.ndarray:
    """The distinct rows of [n, 2] u64 arrays, sorted."""
    p = np.concatenate(groups)
    p = p[np.lexsort((p[:, 1], p[:, 0]))]
    keep = np.ones(len(p), bool)
    keep[1:] = (p[1:] != p[:-1]).any(axis=1)
    return p[keep]


def _clone(x):
    return type(x)(**{f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)})


def record_advances(wm, profile_his=(), capture_his=(), out: list | None = None) -> list:
    """Wrap the cascade's on_advance. Per call: tier 0's `hi`, the flush
    row count and tier 0's fill cursor before the step (device handles,
    read after the run), the prefix and ring sizes, the tier flushes and
    the segreduce launches the call made. At each `hi` in profile_his
    the call runs under torch.profiler and its device copies are counted
    by direction; at each `hi` in capture_his tier 0's inputs are cloned
    for the timings of `cascade_timings`. The records go to `out` (a new
    list by default), which is returned."""
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.aggregator import cascade
    from deepflow_tpu_torch.ops import segreduce

    casc = wm.cascade
    real = casc.on_advance
    out = [] if out is None else out

    def on_advance(packed, total, hi):
        rows = packed.shape[0]
        rec = {"hi": int(hi), "total": total, "fill": casc.fills[0],
               "prefix": cascade.tier_prefix(rows), "ring": cascade.tier_ring_rows(rows)}
        if hi in capture_his:
            rec["inputs"] = dict(
                tier=_clone(casc.tiers[0]), acc=_clone(casc.accs[0]),
                fill=casc.fills[0].clone(), lanes=casc.lanes_dev.clone(), packed=packed,
                total=total, watermark=casc.watermarks[0])
        before = sum(segreduce.LAUNCHES.values())
        if hi in profile_his:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                flushes = real(packed, total, hi)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            rec["copies"] = {d: sum(e.count for e in events if f"Memcpy {d}" in e.key)
                             for d in ("DtoH", "HtoD", "DtoD")}
            rec["device_ms"] = sum(_dev_us(e) for e in events
                                   if not e.key.startswith("Memcpy")) / 1e3
            rec["launches"] = sum(e.count for e in events if not e.key.startswith("Memcpy"))
        else:
            flushes = real(packed, total, hi)
        rec["segreduce"] = sum(segreduce.LAUNCHES.values()) - before
        rec["flushes"] = [(f.tier, f.lo, f.hi, f.total) for f in flushes]
        out.append(rec)
        return flushes

    casc.on_advance = on_advance
    return out


def advance_branches(advances: list) -> list:
    """Tier 0's tier-step branch at each recorded advance, from the flush
    row count and the fill cursor it met (read after the run)."""
    out = []
    for r in advances:
        total, fill = int(r["total"]), int(r["fill"])
        out.append("direct" if total > r["prefix"]
                   else "fold_append" if fill + r["prefix"] > r["ring"] else "append")
    return out


def check_cascade_run(run: dict, seconds: list[int]) -> dict:
    """Phase 3f's checks of the cascade main path; returns its summary."""
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    check_pipeline_run(run)
    docs, tiers = run["docs"], run["tiers"]
    check(len(docs) == len(seconds), f"{len(docs)} one-second windows from {len(seconds)}")
    minutes = [db for iv, db in tiers if iv == 60]
    hours = [db for iv, db in tiers if iv == 3600]
    check(len(minutes) == 2 and len(hours) == 1 and len(tiers) == 3,
          f"tier windows {[(iv, int(db.timestamp[0])) for iv, db in tiers]}")
    key_cols = [i for i, f in enumerate(TAG_SCHEMA.fields) if f.key]
    is_sum = np.asarray(FLOW_METER.sum_mask, bool)
    worst = 0.0
    for db in minutes:
        m = int(db.timestamp[0]) // 60
        kids = [d for d in docs if int(d.timestamp[0]) // 60 == m]
        keys = np.unique(np.concatenate([d.tags[:, key_cols] for d in kids]), axis=0)
        # the numpy f32 fold of the children in window order (one row per
        # key per second, so each second adds by fancy indexing)
        sums = np.zeros((len(keys), FLOW_METER.num_fields), np.float32)
        maxs = np.full((len(keys), FLOW_METER.num_fields), -np.inf, np.float32)
        for d in kids:
            ix = _rows_of(keys, d.tags[:, key_cols])
            sums[ix] += d.meters
            maxs[ix] = np.maximum(maxs[ix], d.meters)
        mk = db.tags[:, key_cols]
        check(len(mk) == len(keys), f"minute {m}: {len(mk)} keys, its seconds {len(keys)}")
        ix = _rows_of(keys, mk)
        got = db.meters
        check(np.array_equal(got[:, ~is_sum], maxs[ix][:, ~is_sum]),
              f"minute {m}: MAX meters differ from the fold of its seconds")
        err = np.abs(got[:, is_sum] - sums[ix][:, is_sum])
        check(bool((err <= SUM_RTOL * np.abs(sums[ix][:, is_sum])).all()),
              f"minute {m}: SUM meters off by more than rtol {SUM_RTOL}")
        worst = max(worst, float(err.max()))
    pkt = FLOW_METER.index("packet_tx")
    total = lambda dbs: sum(float(d.meters[:, pkt].astype(np.float64).sum()) for d in dbs)  # noqa: E731
    check(total(hours) == total(minutes) > 0, "the hour's packets differ from its minutes'")
    lanes = run["cascade_lanes"]
    rows = run["counters"]["flushed_doc"] + sum(db.size for db in minutes)
    check(lanes == [rows, 0], f"cascade lanes {lanes}, want [{rows}, 0]")
    check(run["counters"]["tier_windows_dropped"] == 0
          and run["tier_sketch_blocks_dropped"] == 0, "tier windows or blocks dropped")
    # sketches: each minute block is the merge of its seconds' blocks
    kids_of = {}
    for b in run["sketches"]:
        kids_of.setdefault(b.window // 60, []).append(b)
    minute_blocks = [b for b in run["tier_sketches"] if b.window in kids_of]
    check(len(minute_blocks) == 2, "minute sketch blocks missing")
    distinct_err = []
    for blk in minute_blocks:
        kids = sorted(kids_of[blk.window], key=lambda b: b.window)
        want = dataclasses.replace(kids[0], window=blk.window)
        for k in kids[1:]:
            want = want.merge(dataclasses.replace(k, window=blk.window))
        check(want.n_updates == blk.n_updates, "minute block n_updates")
        for lane in ("hll", "cms", "hist", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb"):
            check(np.array_equal(getattr(want, lane), getattr(blk, lane)),
                  f"minute block lane {lane} differs from the merge of its seconds")
        exact = run["minute_clients"][blk.window]
        distinct_err.append((blk.distinct() - exact) / exact)
        check(abs(distinct_err[-1]) <= DISTINCT_RTOL,
              f"minute distinct() {blk.distinct():.1f} vs exact {exact}")
    check(max(run["fetches"]) <= 3, f"host fetches per ingest {run['fetches']}")
    advances = run["advances"]
    check(sum(r["segreduce"] for r in advances) > 0, "no segreduce launch in a tier step")
    profiled = [r for r in advances if "copies" in r]
    check(profiled and all(r["launches"] > 0 for r in profiled),
          "the profiler saw no kernel of a traced on_advance")
    check(all(r["copies"]["DtoH"] == 0 for r in profiled),
          f"device→host copies inside on_advance: {[r['copies'] for r in profiled]}")
    return {"minute_sum_max_abs_err": worst, "distinct_rel_err": distinct_err,
            "minute_rows": [db.size for db in minutes], "hour_rows": hours[0].size,
            "cascade_lanes": lanes, "branches": advance_branches(advances),
            "tier0_totals": [int(r["total"]) for r in advances],
            "profiled_advances": [{k: r[k] for k in ("hi", "copies", "device_ms", "launches")}
                                  for r in profiled]}


def _rows_of(keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The index in `keys` (np.unique's lexicographically sorted rows) of
    each row of `rows`; fails if one is absent."""
    kv = np.ascontiguousarray(keys).view([("", keys.dtype)] * keys.shape[1]).ravel()
    rv = np.ascontiguousarray(rows).view([("", rows.dtype)] * rows.shape[1]).ravel()
    ix = np.searchsorted(kv, rv)
    check(bool((ix < len(kv)).all()) and bool((kv[np.minimum(ix, len(kv) - 1)] == rv).all()),
          "a minute key is not among its seconds' keys")
    return ix


def cascade_timings(run: dict, step_hi: int, close_hi: int) -> dict:
    """Device ms and launches of one tier step at a 1-window advance (the
    append branch replays idempotently: the same ring rows are written
    again) and of one tier close (ring fold + compacting flush, each
    call on a fresh replay of that advance's tier step), from tier 0's
    inputs captured at those advances."""
    from deepflow_tpu_torch.aggregator import cascade
    from deepflow_tpu_torch.aggregator.stash import _flush_range_impl
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    cap = {r["hi"]: r["inputs"] for r in run["advances"] if "inputs" in r}
    ratio = CASCADE_INTERVALS[0]

    def step(x, acc):
        return cascade.tier_step(x["tier"], acc, x["fill"], x["lanes"], x["packed"],
                                 x["total"], x["hi"], ratio=ratio, meter_schema=FLOW_METER,
                                 num_tags=TAG_SCHEMA.num_fields,
                                 prefix=cascade.tier_prefix(x["packed"].shape[0]))

    s = dict(cap[step_hi], hi=step_hi)
    s_acc = _clone(s["acc"])
    check(int(s["total"]) > 0 and int(s["fill"]) + cascade.tier_prefix(s["packed"].shape[0])
          <= s_acc.capacity, "the timed tier step is no append of rows")
    step_dev, step_launches = device_time(lambda: step(s, s_acc), None)
    step_ms = time_ms(lambda: step(s, s_acc))

    c = dict(cap[close_hi], hi=close_hi)
    lo_t, hi_t = c["watermark"], close_hi // ratio

    def replay():
        tier, acc, _, lanes = step(dict(c, tier=_clone(c["tier"])), _clone(c["acc"]))
        return tier, acc, lanes

    def close(tier, acc, lanes):
        tier, acc, lanes = cascade.tier_ring_fold(tier, acc, lanes, FLOW_METER)
        return _flush_range_impl(tier, lo_t, hi_t, compact=True)

    close_dev, close_launches = device_time_each(close, replay)
    return {"tier_step": {"device_ms": step_dev, "launches": step_launches, "ms": step_ms,
                          "rows": int(s["total"]), "merge_rows": s["tier"].capacity
                          + s_acc.capacity + s["packed"].shape[0]},
            "tier_close": {"device_ms": close_dev, "launches": close_launches,
                           "ring_rows": int((c["acc"].slot != 0xFFFFFFFF).sum())}}


def device_time_each(fn, setup, reps: int = 5) -> tuple[float, float]:
    """Device time and launches per call of fn(*setup()), each call
    profiled alone after its own setup (for a call that consumes its
    inputs); the setup is not profiled."""
    from torch.profiler import ProfilerActivity, profile

    fn(*setup())
    dev_ms = launches = 0.0
    for _ in range(reps):
        args = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms += sum(_dev_us(e) for e in events) / 1e3
        launches += sum(e.count for e in events)
    if dev_ms == 0:  # the profiler missed every call: CUDA events, as in device_time
        PROFILER_GAPS.append("tier close")
        launches = None
        for _ in range(reps):
            args = setup()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            dev_ms += a.elapsed_time(b)
    check(dev_ms > 0, "no device time for the tier close")
    return dev_ms / reps, None if launches is None else launches / reps


def check_pipeline_run(run: dict) -> None:
    """What a healthy main-path stream shows: windows closed before the
    drain, every counter block at layout v7, no stash eviction, and
    every admitted doc flushed once, with finite meters."""
    from deepflow_tpu_torch.aggregator.window import (
        CB_STASH_EVICTIONS, CB_VERSION, COUNTER_BLOCK_VERSION,
    )

    closed, docs, counters, blocks = (run[k] for k in ("closed", "docs", "counters", "blocks"))
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


def reset_all_launch_counts() -> None:
    from deepflow_tpu_torch.ops import segreduce, sketch_fused

    segreduce.reset_launch_counts()
    sketch_fused.reset_launch_counts()


def all_launches() -> dict:
    from deepflow_tpu_torch.ops import segreduce, sketch_fused

    return {**segreduce.LAUNCHES, **sketch_fused.LAUNCHES}


def same_docs(a: list, b: list) -> bool:
    """Two DocBatch lists with the same windows, tags and meter bits."""
    return len(a) == len(b) and all(
        np.array_equal(x.timestamp, y.timestamp) and np.array_equal(x.tags, y.tags)
        and np.array_equal(x.meters.view(np.uint32), y.meters.view(np.uint32))
        for x, y in zip(a, b))


def same_blocks(a: list, b: list) -> bool:
    """Two WindowSketchBlock lists equal lane for lane."""
    lanes = ("hll", "cms", "hist", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb")
    return len(a) == len(b) and all(
        (x.window, x.n_updates) == (y.window, y.n_updates)
        and all(np.array_equal(getattr(x, k), getattr(y, k)) for k in lanes)
        for x, y in zip(a, b))


def check_card_vs_cpu(card: dict, host: dict) -> None:
    """Phase 4: flushed windows, counters and counter blocks identical."""
    check(len(card["docs"]) > 0 and same_docs(card["docs"], host["docs"]),
          "flushed windows differ card vs CPU")
    for key in ("doc_in", "flushed_doc", "drop_before_window", "prereduce_dropped",
                "drop_overflow", "cascade_rows", "cascade_shed", "tier_windows_held",
                "tier_windows_dropped"):
        check(card["counters"][key] == host["counters"][key],
              f"counter {key} differs card vs CPU")
    # present only when the cascade is on
    for key in ("cascade_tier_windows", "cascade_pending_blocks"):
        check(card["counters"].get(key) == host["counters"].get(key),
              f"counter {key} differs card vs CPU")
    check(card["blocks"] == host["blocks"], "counter blocks differ card vs CPU")
    check(len(card["tiers"]) == len(host["tiers"]), "card and CPU closed different tier windows")
    for (iv_a, a), (iv_b, b) in zip(card["tiers"], host["tiers"]):
        check(iv_a == iv_b and np.array_equal(a.timestamp, b.timestamp)
              and np.array_equal(a.tags, b.tags)
              and np.array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32)),
              "tier windows differ card vs CPU")
    check(card["cascade_lanes"] == host["cascade_lanes"], "cascade lanes differ card vs CPU")


def check_sketch_blocks_card_vs_cpu(card: list, host: list, coarsen: int = 1) -> int:
    """Phase 4b: every block lane equal, except histogram counts that a
    different logf moved to an adjacent bin; returns how many moved. With
    pooled memory (4c) the histograms compare at the compact resolution
    (`coarsen` wide bins a bin): a compact slot's count sits at the centre
    of its compact bin, so a move by one wide bin there is a move by one
    compact bin."""
    check(len(card) == len(host) > 0, "card and CPU closed different sketch blocks")
    moved = 0
    for a, b in zip(card, host):
        check((a.window, a.n_updates) == (b.window, b.n_updates), "block window/n_updates")
        for lane in ("hll", "cms", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb"):
            check(np.array_equal(getattr(a, lane), getattr(b, lane)),
                  f"sketch lane {lane} differs card vs CPU (window {a.window})")
        g = a.hist.shape[0]
        d = (a.hist - b.hist).reshape(g, -1, coarsen).sum(axis=2)
        check(np.array_equal(d.sum(axis=1), np.zeros(d.shape[0])),
              "histogram group totals differ card vs CPU")
        # a count moved by one bin crosses one bin edge: the prefix sums
        # of the difference then add up to exactly half its L1 norm
        crossings = int(np.abs(np.cumsum(d, axis=1)).sum())
        check(2 * crossings == int(np.abs(d).sum()),
              "a histogram count moved further than one bin card vs CPU")
        moved += crossings
    return moved


def check_snapshots_card_vs_cpu(card: list, host: list, coarsen: int = 1) -> int:
    """Phase 4e: every snapshot's windows identical card vs CPU (rows bit
    for bit, partial, seq, span start) and their open sketch blocks as in
    `check_sketch_blocks_card_vs_cpu`; returns the histogram counts moved."""
    check(len(card) == len(host) > 0, "card and CPU took different snapshot counts")
    moved = 0
    for a, b in zip(card, host):
        check((a.seq, a.open_from) == (b.seq, b.open_from), "snapshot seq/open_from differ")
        check([w.window_idx for w in a.windows] == [w.window_idx for w in b.windows],
              "snapshot windows differ card vs CPU")
        for x, y in zip(a.windows, b.windows):
            check(x.partial and y.partial and x.count == y.count
                  and np.array_equal(x.key_hi, y.key_hi) and np.array_equal(x.key_lo, y.key_lo)
                  and np.array_equal(x.tags, y.tags)
                  and np.array_equal(x.meters.view(np.uint32), y.meters.view(np.uint32)),
                  f"snapshot rows of window {x.window_idx} differ card vs CPU")
            check((x.sketches is None) == (y.sketches is None), "open sketch blocks differ")
        blocks = [[w.sketches for w in snap.windows if w.sketches is not None]
                  for snap in (a, b)]
        if blocks[0]:
            moved += check_sketch_blocks_card_vs_cpu(*blocks, coarsen=coarsen)
    return moved


def stage_stream(dev, seconds: list[int], seed: int = 1) -> list:
    """Full-width SyntheticFlowGen(10_000) batches of the given seconds,
    each uploaded to the card as a pipeline's StagedBatch (the host copy
    is dropped at once: 18 of them would hold ~15 GB of host memory)."""
    from deepflow_tpu_torch.aggregator.pipeline import StagedBatch, upload_flow_batch
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=10_000, seed=seed)
    staged = []
    for dt in seconds:
        tags, meters, valid = upload_flow_batch(gen.flow_batch(BATCH, T0 + dt), dev)
        staged.append(StagedBatch(tags=tags, meters=meters, valid=valid, padded_rows=BATCH))
    torch.cuda.synchronize()
    return staged


def take_snapshot(pipe, how: str | None) -> dict:
    """One forced snapshot_open: its windows, the fetches and bytes it took
    (the manager's counters), the rows it returned and, with `how`
    "events" its CUDA-event time, with "profile" its device time (kernels
    and copies apart), launches and copies (torch.profiler); the segreduce
    launches of its eager fold; with the pool, which side of the combo
    rows each seated ring slot is on (read after the snapshot)."""
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.ops import segreduce

    wm = pipe.wm
    f0, b0, s0 = wm.host_fetches, wm.bytes_fetched, sum(segreduce.LAUNCHES.values())
    out = {}
    if how == "events":
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        snap = pipe.snapshot_open(force=True)
        b.record()
        b.synchronize()
        out.update(ms=a.elapsed_time(b), host_ms=(time.perf_counter() - t0) * 1e3)
    elif how == "profile":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            snap = pipe.snapshot_open(force=True)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in ev if not e.key.startswith("Memcpy")]
        copies = [e for e in ev if e.key.startswith("Memcpy")]
        out.update(device_ms=sum(_dev_us(e) for e in kernels) / 1e3,
                   copy_ms=sum(_dev_us(e) for e in copies) / 1e3,
                   launches=sum(e.count for e in kernels),
                   copies={d: sum(e.count for e in copies if d in e.key)
                           for d in ("DtoH", "HtoD", "DtoD")})
    else:
        snap = pipe.snapshot_open(force=True)
    out.update(snap=snap, fetches=wm.host_fetches - f0, bytes=wm.bytes_fetched - b0,
               fold_segreduce=sum(segreduce.LAUNCHES.values()) - s0,
               rows=sum(w.count for w in snap.windows),
               windows=[w.window_idx for w in snap.windows],
               blocks=sum(w.sketches is not None for w in snap.windows))
    if wm.sk is not None and wm.config.sketch.pool is not None:
        pc = wm.sk.p_hll.shape[0]
        out["sides"] = sorted({"wide" if s >= pc else "compact"
                               for s in wm.sk.slot_of.tolist() if s >= 0})
    return out


def ring_stream(dev, staged: list, *, sketch, fold_mode: str = "full", profile_at=(),
                snapshot_every: int | None = None, snapshot_how=None, **window_kw) -> dict:
    """L4Pipeline over pre-staged full-width batches (phases 3g–3h; the
    3c shape) and a drain, with the WindowConfig fields `window_kw`
    (stats_ring, async_drain). Returns the DocBatches of each ingest call
    and of the drain, the closed sketch blocks, the counters, the fetches
    and advances of the ingests, the wall seconds and records/s of the
    ingests that were not profiled (and the drain), each profiled
    ingest's `profile_cycle`, and — with `snapshot_every` — a forced
    snapshot after every that many ingests (`take_snapshot`;
    `snapshot_how` maps a snapshot's ingest index to its timing)."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig

    pipe = L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES, delay=DELAY,
                            sketch=sketch, fold_mode=fold_mode, **window_kw),
        batch_size=BATCH, batch_unique_cap=UNIQUE_CAP), device=dev)
    calls, profiles, snapshots = [], {}, []
    wall, rows = 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, st in enumerate(staged):
        if i in profile_at:
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            profiles[i] = profile_cycle(lambda: calls.append(pipe.ingest_staged(st)))
            t0 = time.perf_counter()
        else:
            calls.append(pipe.ingest_staged(st))
            rows += BATCH
        if snapshot_every and i % snapshot_every == snapshot_every - 1:
            snapshots.append(dict(take_snapshot(pipe, (snapshot_how or {}).get(i)), ingest=i))
    fetches, advances = pipe.wm.host_fetches, pipe.wm.n_advances
    calls.append(pipe.drain())
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    busy = sum(p["device_busy_ms"] for p in profiles.values())
    p_wall = sum(p["wall_ms"] for p in profiles.values())
    return {"calls": calls, "docs": [d for c in calls for d in c],
            "sketches": pipe.pop_closed_sketches(), "counters": pipe.counters,
            "fetches": fetches, "advances": advances, "wall_s": wall,
            "records_per_s": rows / wall, "profiles": profiles,
            "idle_share": (1 - busy / p_wall) if busy else None, "snapshots": snapshots}


STREAM_COUNTERS = ("doc_in", "flushed_doc", "drop_before_window", "prereduce_dropped",
                   "drop_overflow", "stash_evictions", "sketch_rows", "sketch_shed")


def check_ring_async(oracle: dict, ring: dict, asy: dict) -> None:
    """Phase 3g's checks (see the module docstring)."""
    check(len(oracle["docs"]) == 6, f"{len(oracle['docs'])} windows from 6 seconds")
    # the ring defers advance folds: the stash must hold the deferred
    # windows, as it does at 2^18 rows (with overflow the shed differs)
    check(ring["counters"]["drop_overflow"] == 0, "the K = 4 run's stash overflowed")
    check(same_docs(ring["docs"], oracle["docs"]), "K = 4 DocBatches differ from the oracle's")
    check(same_blocks(ring["sketches"], oracle["sketches"]) and len(oracle["sketches"]) == 6,
          "K = 4 sketch blocks differ from the oracle's")
    o_calls, a_calls = oracle["calls"], asy["calls"]
    check(a_calls[0] == [] and all(same_docs(a_calls[i + 1], o_calls[i])
                                   for i in range(len(o_calls) - 2))
          and same_docs(a_calls[-1], o_calls[-2] + o_calls[-1]),
          "async did not emit the oracle's windows one ingest call later")
    check(same_blocks(asy["sketches"], oracle["sketches"]), "async sketch blocks differ")
    for run in (ring, asy):
        for k in STREAM_COUNTERS:
            check(run["counters"][k] == oracle["counters"][k], f"counter {k} differs")
    n = len(o_calls) - 1
    bound = -(-n // 4) + 2 * ring["advances"]
    check(ring["fetches"] <= bound and ring["fetches"] < n,
          f"K = 4: {ring['fetches']} fetches over {n} ingests, bound {bound}")
    copies = {i: p["copies"]["DtoH"] for i, p in ring["profiles"].items()}
    check(all(copies[i] == 0 for i in (12, 13, 14)) and copies[15] > 0,
          f"device→host copies of the profiled K = 4 ingests {copies}")


def check_live_read(oracle: dict, run: dict) -> None:
    """Phase 3h's checks of one snapshot run (see the module docstring)."""
    check(same_docs(run["docs"], oracle["docs"]), "the snapshot run's DocBatches differ")
    snaps = run["snapshots"]
    check(snaps and all(s["fetches"] <= 2 for s in snaps),
          f"snapshot fetches {[s['fetches'] for s in snaps]}")
    last = snaps[-1]
    check(last["ingest"] == len(run["calls"]) - 2 and last["rows"] > 0,
          "the last snapshot is not after the last ingest")
    drained = {int(d.timestamp[0]): d for d in run["calls"][-1]}
    closed = {b.window: b for b in run["sketches"]}
    for w in last["snap"].windows:
        d = drained.get(w.start_time)
        check(d is not None and d.size == w.count and np.array_equal(d.tags, w.tags)
              and np.array_equal(d.meters.view(np.uint32), w.meters.view(np.uint32)),
              f"window {w.window_idx}: the last snapshot's rows differ from its flush")
        if w.sketches is not None:
            blk = closed.get(w.window_idx)
            check(blk is not None and same_blocks([w.sketches], [blk]),
                  f"window {w.window_idx}: the open block differs from the closed one")


def save_and_resume(pipe, path: str, load_device):
    """Save `pipe`'s window state to `path` as save_window_state does
    (the settled payload, then the atomic digested write) and load it into
    a fresh L4Pipeline on `load_device` as load_window_state does (read +
    digest check, then the restore), each piece timed on the host clock
    around synchronised work; the digest's and the npz deflate's shares
    are timed once more on the same arrays. The closed sketch blocks the
    old pipeline held move to the new one (their caller owns them).
    Returns (new pipeline, measurements)."""
    import io

    from deepflow_tpu_torch.aggregator import checkpoint as ckpt
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    (in_flight, meta, arrays), fetch_s = timed(lambda: ckpt._window_payload(pipe.wm))
    check(not in_flight, f"{len(in_flight)} windows in flight at a per-batch save")
    _, write_s = timed(lambda: ckpt._write_checkpoint(path, meta, arrays))
    digest, sha_s = timed(lambda: ckpt._digest(arrays))
    _, zlib_s = timed(lambda: np.savez_compressed(io.BytesIO(), **arrays))
    (meta2, arrays2), read_s = timed(lambda: ckpt._read_checkpoint(path))
    check(meta2["digest"] == digest, "the saved digest is not the payload's")
    new = L4Pipeline(pipe.config, device=load_device)
    new.wm, restore_s = timed(lambda: ckpt._restore_window(
        meta2, arrays2, path, TAG_SCHEMA, FLOW_METER, sketch_config=None,
        cascade_config=None, device=new.device))
    _, load_sha_s = timed(lambda: ckpt._digest(arrays2))
    new.closed_sketches, new.closed_tier_sketches = (pipe.closed_sketches,
                                                     pipe.closed_tier_sketches)
    return new, {
        "digest": digest, "raw_bytes": sum(a.nbytes for a in arrays.values()),
        "disk_bytes": os.path.getsize(path), "arrays": len(arrays),
        "array_bytes": {k: a.nbytes for k, a in arrays.items() if a.nbytes >= 1 << 20},
        "save_s": fetch_s + write_s, "save_fetch_s": fetch_s, "save_write_s": write_s,
        "save_sha256_s": sha_s, "save_zlib_s": zlib_s,
        "load_s": read_s + restore_s, "load_read_s": read_s, "load_sha256_s": load_sha_s,
        "load_restore_s": restore_s,
    }


RESUME_COUNTERS = STREAM_COUNTERS + ("cascade_rows", "cascade_shed", "cascade_tier_windows",
                                     "tier_windows_held", "tier_windows_dropped")


def check_resumed(run: dict, oracle: dict) -> None:
    """A stream saved and resumed midway against the same stream without
    the save: 1 s and tier DocBatches (meter bits included), the counters
    and the cascade lanes equal. The callers compare the sketch blocks."""
    check(same_docs(run["docs"], oracle["docs"]), "resumed 1 s windows differ")
    check(len(run["tiers"]) == len(oracle["tiers"]) > 0 and all(
        ia == ib and same_docs([a], [b]) for (ia, a), (ib, b) in zip(run["tiers"], oracle["tiers"])),
        "resumed tier windows differ")
    for k in RESUME_COUNTERS:
        check(run["counters"].get(k) == oracle["counters"].get(k), f"resumed counter {k}")
    check(run["cascade_lanes"] == oracle["cascade_lanes"], "resumed cascade lanes differ")


def fold_parity(state, acc) -> dict:
    """The fused-gather segmented reduce at the full fold of `state` and
    its ring `acc`, held against its plain version (untimed)."""
    from deepflow_tpu_torch.aggregator.stash import fold_operands
    from deepflow_tpu_torch.ops.segment import SENTINEL_SLOT, segment_ids, sort_keys

    f_slot, f_hi, f_lo, _, f_rows, f_valid = fold_operands(
        state, acc.slot, acc.key_hi, acc.key_lo, acc.tags, acc.meters,
        acc.slot != SENTINEL_SLOT)
    s_slot, s_hi, s_lo, perm = sort_keys(f_slot, f_hi, f_lo, f_valid)
    cap = state.capacity
    seg, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, cap)
    ops = dict(rows=f_rows, seg=seg, first_pos=first_pos, perm=perm.to(torch.int32), cap=cap,
               live=min(int(num_seg), cap), live_rows=int((seg < cap).sum()))
    return kernel_parity("segreduce_gather", ops, timed=False)


def restored_parity(pipe, fb) -> dict:
    """Both kernels held against their plain versions once more on what a
    restored manager feeds them: the segmented reduce at the fold of its
    restored stash and accumulator ring, the fused sketch update at its
    restored plane with the next batch."""
    wm = pipe.wm
    return {"segreduce_gather": fold_parity(wm.state, wm.acc),
            "sketch_fused": sketch_kernel_parity(wm.device, timed=False, sk=wm.sk, fb=fb,
                                                 sw=wm.start_window)}


# the kill-and-recover schedule of tests/test_recovery.py:44 (test size)
# and its kill matrix (:275): the seam, its call index and the step the
# kill lands on
RECOVERY_STEPS = (("batch", T0, 100), ("batch", T0 + 1, 120), ("ckpt",),
                  ("batch", T0 + 5, 90), ("batch", T0 + 6, 110), ("ckpt",),
                  ("batch", T0 + 7, 80), ("batch", T0 + 10, 100), ("drain",))
FULL_BUCKET = 1 << 18  # phase 3j: the full-width feeder's shape bucket
RECOVERY_KILLS = {"pre_advance": ("device.dispatch", 2, 4), "mid_flush": ("host.fetch", 5, 4),
                  "during_ckpt": ("device.dispatch", 3, 5), "post_ckpt": ("device.dispatch", 4, 7)}
# full width: seconds of the 3f stream (2^21 rows, 1024 frames of 2048
# rows each) through 2^18-row buckets; the first window advance that
# flushes rows (T0+37's dispatches close T0+34) follows the checkpoint
FULL_RECOVERY_STEPS = (("batch", T0 + 34, BATCH), ("batch", T0 + 35, BATCH), ("ckpt",),
                       ("batch", T0 + 36, BATCH), ("batch", T0 + 37, BATCH), ("drain",))


class FeederStack:
    """L4Pipeline behind PyOverwriteQueue → FeederRuntime (with a
    FrameJournal) → PipelineFeedSink, as a deployment runs it; its
    checkpoint is `save_window_state` into `d`."""

    def __init__(self, dev, d: str, jname: str, config, *, frames_per_queue: int,
                 journal_bytes: int):
        from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline
        from deepflow_tpu_torch.feeder import (FeederConfig, FeederRuntime, FrameJournal,
                                               PipelineFeedSink)
        from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue

        self.pipe = L4Pipeline(config, device=dev)
        self.q = PyOverwriteQueue(4 * frames_per_queue)
        self.journal = os.path.join(d, jname)
        self.feeder = FeederRuntime(
            [self.q], PipelineFeedSink(self.pipe),
            FeederConfig(frames_per_queue=frames_per_queue, rounds_per_pump=1),
            journal=FrameJournal(self.journal, max_bytes=journal_bytes))
        self.ckpt = os.path.join(d, "wm.ckpt")
        self.out = {"docs": [], "tiers": [], "blocks": []}
        self.durable = {k: 0 for k in self.out}
        self.step = None

    def save(self, barrier):
        from deepflow_tpu_torch.aggregator.checkpoint import save_window_state

        in_flight = save_window_state(self.pipe.wm, self.ckpt, extra_meta=barrier)
        return self.pipe._convert_flushed(in_flight)

    def collect(self, docs: list) -> None:
        self.out["docs"] += docs
        self.out["tiers"] += self.pipe.pop_tier_docbatches()
        self.out["blocks"] += self.pipe.pop_closed_sketches()

    def run(self, steps, frames, start: int = 0) -> None:
        """steps[start:]; every barrier (checkpoint, drain) marks the
        outputs so far durable; `step` is the step running."""
        for i in range(start, len(steps)):
            self.step = i
            kind = steps[i][0]
            if kind == "batch":
                for fr in frames[i]:
                    self.q.put(fr)
                self.collect(self.feeder.pump())
                continue
            if kind == "ckpt":
                self.collect(self.feeder.checkpoint(self.save))
            else:
                self.collect(self.feeder.flush() + self.pipe.drain())
            self.durable = {k: len(v) for k, v in self.out.items()}

    def counters(self) -> dict:
        c = self.pipe.get_counters()
        return {k: c[k] for k in ("doc_in", "flushed_doc", "drop_before_window",
                                  "prereduce_shed", "excess_word_hits", "stash_evictions",
                                  "window_advances", "feeder_shed", "sketch_rows",
                                  "cascade_rows")
                if k in c}


def same_stream(a: dict, b: dict) -> bool:
    return (same_docs(a["docs"], b["docs"]) and same_blocks(a["blocks"], b["blocks"])
            and len(a["tiers"]) == len(b["tiers"])
            and all(ia == ib and same_docs([x], [y])
                    for (ia, x), (ib, y) in zip(a["tiers"], b["tiers"])))


def feeder_oracle(dev, d: str, steps, frames, config, **stack_kw) -> dict:
    """The uninterrupted run of `steps` on a FeederStack under a chaos plan
    without rules (it counts the seams): its outputs, counters, wall
    seconds, and the host-fetch index and step of every drain's row
    fetch (a drain that made its second fetch)."""
    from deepflow_tpu_torch import chaos

    st = FeederStack(dev, d, "oracle.j", config, **stack_kw)
    plan = chaos.FaultPlan()
    row_fetches = []
    real = st.pipe.wm._drain_flush

    def drain(entry):
        n0 = plan.calls.get(chaos.SITE_FETCH, 0)
        out = real(entry)
        if plan.calls.get(chaos.SITE_FETCH, 0) - n0 == 2:
            row_fetches.append((st.step, n0 + 1))
        return out

    st.pipe.wm._drain_flush = drain
    t0 = time.perf_counter()
    with chaos.active(plan):
        st.run(steps, frames)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    os.remove(st.journal)
    return {"out": st.out, "counters": st.counters(), "row_fetches": row_fetches,
            "wall_s": wall, "seams": dict(plan.calls)}


def uncounted(fn):
    """fn() with the kernels' launch counters put back afterwards: a
    comparison with the plain version is not a launch of the main path."""
    from deepflow_tpu_torch.ops import segreduce, sketch_fused

    saved = (dict(segreduce.LAUNCHES), dict(sketch_fused.LAUNCHES))
    try:
        return fn()
    finally:
        segreduce.LAUNCHES.update(saved[0])
        sketch_fused.LAUNCHES.update(saved[1])


def kill_and_recover(dev, d: str, steps, frames, config, rule, oracle, **stack_kw) -> dict:
    """A victim stack killed by the chaos `rule` (a KillPoint), then a
    fresh stack recovering from disk alone — load_window_state of the
    last checkpoint (default device: the card), replay_journal with its
    barrier, the pump that completes the interrupted one — and finishing
    the schedule. Its outputs after the victim's durable ones, and its
    counters, must equal `oracle`'s. Returns the kill step, the time to
    recover (CUDA-synchronised wall) and the journal's size."""
    from deepflow_tpu_torch import chaos
    from deepflow_tpu_torch.aggregator.checkpoint import load_window_state, read_checkpoint_meta
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    victim = FeederStack(dev, d, "victim.j", config, **stack_kw)
    killed_at = None
    with chaos.active(chaos.FaultPlan().add(rule)):
        try:
            victim.run(steps, frames)
        except chaos.KillPoint:
            killed_at = victim.step
    check(killed_at is not None, "the kill-point never fired")
    journal_bytes = os.path.getsize(victim.journal)
    rec = FeederStack(dev, d, "recovered.j", config, **stack_kw)
    for k, v in victim.out.items():
        rec.out[k] = v[:victim.durable[k]]  # post-barrier outputs died with the process
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    barrier = None
    if os.path.exists(victim.ckpt):
        meta = read_checkpoint_meta(victim.ckpt)
        barrier = {k: meta[k] for k in ("journal_epoch", "journal_offset")}
        rec.pipe.wm = load_window_state(victim.ckpt, TAG_SCHEMA, FLOW_METER)
    rec.collect(rec.feeder.replay_journal(victim.journal, barrier=barrier))
    rec.collect(rec.feeder.pump())
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    replayed = rec.feeder.counters["replayed_frames"]
    rec.run(steps, frames, start=killed_at + 1)
    check(same_stream(rec.out, oracle["out"]), "recovered stream differs from the oracle's")
    check(rec.counters() == oracle["counters"], "recovered counters differ from the oracle's")
    for path in (victim.journal, rec.journal):
        os.remove(path)
    return {"killed_at": killed_at, "recover_s": recover_s, "replayed_frames": replayed,
            "journal_bytes": journal_bytes}


def checkpoint_phase(dev, sk_cfg, casc_cfg, oracle: dict):
    """Phase 3i: the 3f stream saved after T0+40 (mid-minute: the minute
    closes at T0+42), loaded into a fresh pipeline on the card, finished
    and drained, against 3f's uninterrupted run `oracle`; on the restored
    state both kernels are held against their plain versions once more
    (uncounted). Returns (launches, summary)."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def on_resume(pipe, fb):
            return {"parity": uncounted(lambda: restored_parity(pipe, fb)),
                    "launches": all_launches()}

        reset_all_launch_counts()
        resumed = pipeline_stream(dev, BATCH, CASCADE_SECONDS, sketch=sk_cfg, seed=0,
                                  cascade=casc_cfg, save_after=40, load_device=dev,
                                  ckpt_dir=work, on_resume=on_resume)
        launches = all_launches()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ck = resumed["checkpoint"]
    at_load = ck["restored"].pop("launches")
    after_load = {k: v - at_load[k] for k, v in launches.items()}
    check(after_load["segreduce_gather"] > 0 and after_load["sketch_fused"] > 0,
          f"the resumed stream launched {after_load}")
    check(all(r["parity_ok"] for r in ck["restored"]["parity"].values()),
          "a kernel disagrees with its plain version on the restored state")
    check_pipeline_run(resumed)
    check_resumed(resumed, oracle)
    check(same_blocks(resumed["sketches"], oracle["sketches"])
          and same_blocks(resumed["tier_sketches"], oracle["tier_sketches"]),
          "resumed sketch blocks differ")
    return launches, {"launches": launches, "launches_after_load": after_load, **ck,
                      "windows": len(resumed["docs"]), "tier_windows": len(resumed["tiers"])}


def step_frames(steps, gen, rows_per_frame: int) -> dict:
    """Each batch step's wire frames (SyntheticFlowGen `gen`, in order)."""
    from deepflow_tpu_torch.feeder import encode_flowbatch_frames

    return {i: encode_flowbatch_frames(gen.flow_batch(n, t), max_rows_per_frame=rows_per_frame)
            for i, (kind, *args) in enumerate(steps) if kind == "batch" for t, n in (args,)}


def recovery_phase(dev, sk_cfg, casc_cfg):
    """Phase 3j: kill and recover through FeederRuntime + FrameJournal +
    PipelineFeedSink — the four kill-points of tests/test_recovery.py at
    the test's size (card = CPU for the uninterrupted run), then a kill at
    the first flush-row fetch after the checkpoint at full width (2^18-row
    buckets). Returns (test-size launches, full-width launches, summary)."""
    import shutil
    import tempfile

    from deepflow_tpu_torch import chaos
    from deepflow_tpu_torch.aggregator.pipeline import PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        small_cfg = PipelineConfig(window=WindowConfig(capacity=1 << 12, delay=DELAY),
                                   batch_size=256, bucket_sizes=(64, 128, 256))
        frames = step_frames(RECOVERY_STEPS, SyntheticFlowGen(num_tuples=150, seed=31), 64)
        kw = dict(frames_per_queue=128, journal_bytes=64 << 20)
        reset_all_launch_counts()
        oracle = feeder_oracle(dev, work, RECOVERY_STEPS, frames, small_cfg, **kw)
        kills = {}
        for name, (site, index, step) in RECOVERY_KILLS.items():
            r = kill_and_recover(dev, work, RECOVERY_STEPS, frames, small_cfg,
                                 chaos.FaultRule(site, at=(index,), error=chaos.KillPoint()),
                                 oracle, **kw)
            check(r["killed_at"] == step, f"{name}: killed at step {r['killed_at']}, not {step}")
            kills[name] = r
        small_launches = all_launches()
        check(small_launches["segreduce_gather"] > 0,
              f"test-size recovery launches {small_launches}")
        host = feeder_oracle("cpu", work, RECOVERY_STEPS, frames, small_cfg, **kw)
        check(same_stream(host["out"], oracle["out"]) and host["counters"] == oracle["counters"]
              and host["seams"] == oracle["seams"],
              "the uninterrupted schedule differs card vs CPU")
        test_size = {"launches": small_launches, "kills": kills,
                     "oracle_wall_s": oracle["wall_s"], "seams": oracle["seams"]}

        full_cfg = PipelineConfig(
            window=WindowConfig(capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES,
                                delay=DELAY, sketch=sk_cfg, cascade=casc_cfg),
            batch_size=FULL_BUCKET, batch_unique_cap=UNIQUE_CAP, bucket_sizes=(FULL_BUCKET,))
        t_enc = time.perf_counter()
        frames = step_frames(FULL_RECOVERY_STEPS, SyntheticFlowGen(num_tuples=10_000, seed=0),
                             2048)
        encode_s = time.perf_counter() - t_enc
        kw = dict(frames_per_queue=BATCH // 2048, journal_bytes=16 << 30)
        reset_all_launch_counts()
        oracle = feeder_oracle(dev, work, FULL_RECOVERY_STEPS, frames, full_cfg, **kw)
        ckpt_step = FULL_RECOVERY_STEPS.index(("ckpt",))
        kill_index = next(n for step, n in oracle["row_fetches"] if step > ckpt_step)
        full = kill_and_recover(dev, work, FULL_RECOVERY_STEPS, frames, full_cfg,
                                chaos.FaultRule(chaos.SITE_FETCH, at=(kill_index,),
                                                error=chaos.KillPoint()),
                                oracle, **kw)
        full_launches = all_launches()
        check(full_launches["segreduce_gather"] > 0 and full_launches["sketch_fused"] > 0,
              f"full-width recovery launches {full_launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the journal at the kill holds the frames of every step since the
    # checkpoint's rotate, the killed one included (a pump journals its
    # whole round before it decodes)
    journaled = sum(FULL_RECOVERY_STEPS[i][2] for i in range(ckpt_step + 1, full["killed_at"] + 1))
    full_width = {"launches": full_launches, "kill_fetch_index": kill_index, **full,
                  "journaled_records": journaled,
                  "journal_bytes_per_record": full["journal_bytes"] / journaled,
                  "frames_encode_s": encode_s, "oracle_wall_s": oracle["wall_s"],
                  "windows": len(oracle["out"]["docs"]),
                  "tier_windows": len(oracle["out"]["tiers"])}
    return small_launches, full_launches, {"test_size": test_size, "full_width": full_width}


def checkpoint_card_vs_cpu(dev, sk_cfg, small_casc, host_run: dict) -> dict:
    """Phase 4f: 4d's slab + full-fold stream saved after T0+40 on the
    card and resumed on the CPU, and the other way round: one digest, the
    two resumed streams equal, and each equal to 4d's uninterrupted CPU
    run `host_run`. Returns the summary."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kw = dict(sketch=sk_cfg, cascade=small_casc, capacity=TIER_SMALL,
                  tuples=TIER_SMALL_TUPLES, save_after=40, ckpt_dir=work)
        c2h = pipeline_stream(dev, SMALL_BATCH, CASCADE_SECONDS + [140], load_device="cpu",
                              **kw)
        h2c = pipeline_stream("cpu", SMALL_BATCH, CASCADE_SECONDS + [140], load_device=dev,
                              **kw)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(c2h["checkpoint"]["digest"] == h2c["checkpoint"]["digest"],
          "the card's and the CPU's files of the same state have different digests")
    check_card_vs_cpu(c2h, h2c)
    moved = check_sketch_blocks_card_vs_cpu(c2h["sketches"], h2c["sketches"])
    for run in (c2h, h2c):
        check_resumed(run, host_run)
        moved += check_sketch_blocks_card_vs_cpu(run["sketches"], host_run["sketches"])
        moved += check_sketch_blocks_card_vs_cpu(run["tier_sketches"],
                                                 host_run["tier_sketches"])
    return {"digest": c2h["checkpoint"]["digest"], "raw_bytes": c2h["checkpoint"]["raw_bytes"],
            "disk_bytes": c2h["checkpoint"]["disk_bytes"], "windows": len(c2h["docs"]),
            "tier_windows": len(c2h["tiers"]), "hist_counts_moved": moved}


# phase 3k: the sharded path at BASELINE config 5 (bench_all.py:300-309):
# 4 shards in a (2 × 2) mesh — here 4 logical shards of the one card
SHARDS = 4
# config 5 says 2^12 rows a shard, which would shed: ~10k tuples × 4
# doc lanes a second land on every shard. 2^18 is the 3f stash's size
SHARD_CAPACITY = 1 << 18
SHARDED_SECONDS = list(range(6))
SHARDED_SAVE_AFTER = 3  # run B saves after T0+3's ingest
SHARDED_PROFILE_AT = 4  # the T0+4 ingest (a one-window advance) is profiled
# T0 is 20 s into its minute: [T0 − 20, T0 + 40) closes at T0+42
SHARDED_CASCADE_SECONDS = [38, 39, 40, 41, 42, 43]
SHARD_SMALL_CAPACITY = TIER_SMALL  # the card = CPU run at 2^14-row batches
SHARD_COUNTERS = ("flow_in", "flushed_doc", "drop_before_window", "window_advances")


def sharded_config(**kw):
    """BASELINE config 5 as bench_all.py:300-309 states it (256 service
    groups, HLL p = 10, count-min 4 × 2^14, histogram 256 bins γ = 1.08,
    sketch ring 8, top-K 2 × 512, pending 16, per-shard pre-reduce 2^14),
    with a 2^18-row stash a shard unless `kw` says otherwise."""
    from deepflow_tpu_torch.ops.histogram import LogHistSpec
    from deepflow_tpu_torch.parallel.sharded import ShardedConfig

    return ShardedConfig(**{"capacity_per_device": SHARD_CAPACITY, "num_services": 256,
                            "hll_precision": 10,
                            "hist": LogHistSpec(bins=256, vmin=1.0, gamma=1.08),
                            "batch_unique_cap": 1 << 14, **kw})


def sharded_manager(dev, cfg):
    """A ShardedWindowManager of SHARDS shards, all on `dev`, in a (2 × 2)
    mesh (placed explicitly: make_mesh puts one shard on a card by
    default)."""
    from deepflow_tpu_torch.parallel import make_mesh
    from deepflow_tpu_torch.parallel.sharded import ShardedPipeline, ShardedWindowManager

    mesh = make_mesh(devices=[torch.device(dev)] * SHARDS, n_hosts=2)
    return ShardedWindowManager(ShardedPipeline(mesh, cfg), delay=DELAY,
                                min_snapshot_interval=0.0)


def synced(fn):
    """(fn(), its wall seconds), the device synchronised on both sides."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def shard_parity(swm, fb) -> dict:
    """Both kernels on shard 0's operands, held against their plain
    versions (untimed): the segmented reduce at the fold of its stash and
    ring, the fused sketch update at its plane with its rows of `fb` (the
    new-span phase, as the step runs it)."""
    from deepflow_tpu_torch.aggregator import sketchplane as sp
    from deepflow_tpu_torch.aggregator.window import sketch_inputs_from_columns
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER

    pipe = swm.pipe
    tags, meters, valid = pipe.shard_inputs(fb.tags, fb.meters, fb.valid)[0]
    cfg, sk = pipe.config.sketch_config(), swm.sketches[0]
    inp = sketch_inputs_from_columns(tags, meters, cfg.num_groups, FLOW_METER.index)
    window = tags["timestamp"]
    _, in_c, _ = sp.phase_masks(sk, window=window, valid=valid, base_w=swm.start_window,
                                close_w=0)
    presorted = sp.batch_sort(window, inp["key_hi"], inp["key_lo"])
    kw = sp.fused_operands(sk, in_c, window=window, presorted=presorted, **inp)
    return {"segreduce_gather": fold_parity(swm.stash[0], swm.acc[0]),
            "sketch_fused": sketch_kernel_parity(None, timed=False, fused=(cfg, sk, kw))}


def sharded_stream(swm, batches, *, profile_at=None, parity_at=None, save_after=None,
                   path=None) -> dict:
    """`swm` over host `batches`, then a drain: every DocBatch, tier
    DocBatch and closed (tier) sketch block, the fetches of each ingest
    and of the drain, the synchronised wall of each unprofiled ingest,
    the merged window_close view after the last ingest, snapshots and
    counters. `profile_at`: that ingest runs under profile_cycle.
    `parity_at`: before that ingest, `shard_parity` (uncounted).
    `save_after`: after that ingest the state is saved to `path` and the
    stream goes on in a fresh manager that restored it (timed)."""
    from deepflow_tpu_torch.aggregator import checkpoint as ckpt

    out = {"docs": [], "tiers": [], "blocks": [], "fetches": [], "walls": []}
    for i, fb in enumerate(batches):
        if i == parity_at:
            out["parity"] = uncounted(lambda: shard_parity(swm, fb))
        f0 = swm.host_fetches

        def ingest():
            out["docs"].extend(swm.ingest(fb.tags, fb.meters, fb.valid))

        if i == profile_at:
            out["profile"] = profile_cycle(ingest)
        else:
            out["walls"].append(synced(ingest)[1])
        out["fetches"].append(swm.host_fetches - f0)
        out["tiers"] += swm.pop_tier_docbatches()
        out["blocks"] += swm.pop_closed_sketches()
        if i == save_after:
            (held, meta, arrays), fetch_s = synced(lambda: ckpt._sharded_payload(swm))
            out["tiers"] += held
            _, write_s = synced(lambda: ckpt._write_checkpoint(path, meta, arrays))
            out["blocks"] += swm.closed_tier_sketches
            fresh = sharded_manager(swm.pipe.devices[0], swm.pipe.config)
            swm.close()
            _, load_s = synced(lambda: ckpt.restore_sharded_state(fresh, path))
            swm = fresh
            out["checkpoint"] = {
                "raw_bytes": sum(a.nbytes for a in arrays.values()),
                "disk_bytes": os.path.getsize(path),
                "digest": ckpt.read_checkpoint_meta(path)["digest"],
                "save_s": fetch_s + write_s, "save_fetch_s": fetch_s, "save_write_s": write_s,
                "load_s": load_s}
    out["view"] = swm.pipe.window_close(swm.sketches)[1:]
    f0 = swm.host_fetches
    out["docs"] += swm.drain()
    out["drain_fetches"] = swm.host_fetches - f0
    out["tiers"] += swm.pop_tier_docbatches()
    out["blocks"] += swm.pop_closed_sketches() + swm.closed_tier_sketches
    out["counters"] = swm.get_counters()
    out["swm"] = swm
    return out


def rollup_by_key(docs, meter_schema, *, with_time: bool = True):
    """DocBatch rows reduced by (timestamp,) tag row with the schema's
    SUM (in float64) and MAX lanes — the query layer's cross-shard merge.
    Returns (sorted unique keys as a void array, [k, M] float64)."""
    ts = np.concatenate([d.timestamp for d in docs]).astype(np.uint32)
    tags = np.concatenate([d.tags for d in docs]).astype(np.uint32)
    meters = np.concatenate([d.meters for d in docs]).astype(np.float64)
    keys = np.concatenate([ts[:, None], tags], axis=1) if with_time else tags
    keys = np.ascontiguousarray(keys).view(np.dtype((np.void, keys.shape[1] * 4)))[:, 0]
    uniq, inv = np.unique(keys, return_inverse=True)
    out = np.zeros((len(uniq), meters.shape[1]))
    s, m = meter_schema.sum_mask, meter_schema.max_mask
    np.add.at(out, inv, np.where(s, meters, 0.0))
    mx = np.full_like(out, -np.inf)
    np.maximum.at(mx, inv, meters)
    return uniq, np.where(m, mx, out)


def check_rollups_equal(sharded, single, what: str) -> dict:
    """Per key the shards' SUM meters summed (float64) against the single
    pipeline's f32 rollup: every key on both sides, MAX lanes exact, SUM
    lanes bit-exact where the value is an integer below 2^24 (f32 adds
    those exactly in any order), within rtol 1e-5 elsewhere."""
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER

    ka, a = sharded
    kb, b = single
    check(len(ka) == len(kb) > 0 and np.array_equal(ka, kb), f"{what}: the keys differ")
    s = np.asarray(FLOW_METER.sum_mask, bool)
    check(np.array_equal(a[:, ~s], b[:, ~s]), f"{what}: MAX meters differ")
    exact = (a[:, s] == np.round(a[:, s])) & (np.abs(a[:, s]) < 2 ** 24)
    check(np.array_equal(a[:, s][exact], b[:, s][exact]), f"{what}: integer SUM meters differ")
    check(np.all(np.abs(a[:, s] - b[:, s]) <= SUM_RTOL * np.abs(b[:, s])),
          f"{what}: SUM meters off by more than rtol {SUM_RTOL}")
    return {"keys": int(len(ka)), "sum_values_exact": int(exact.sum()),
            "sum_values_rtol": int((~exact).sum())}


def sharded_card_vs_cpu(dev) -> dict:
    """Card = CPU for the sharded manager at test size: 4 shards (2 × 2),
    2^14-row batches of the phase-4 seconds (a late one included) with a
    minute cascade and a forced snapshot after every third ingest — the
    DocBatches, tier DocBatches and snapshots bit for bit, the closed and
    tier sketch blocks as in check_sketch_blocks_card_vs_cpu, counters."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    cfg = sharded_config(capacity_per_device=SHARD_SMALL_CAPACITY, batch_unique_cap=None,
                         accum_batches=2, cascade=(60,), cascade_capacity=SHARD_SMALL_CAPACITY)
    seconds = [0, 0, 1, 2, 1, 3, 4, 6, 3, 5, 8, 41, 42, 43]
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        gen = SyntheticFlowGen(num_tuples=TIER_SMALL_TUPLES, seed=3)
        swm = sharded_manager(d, cfg)
        snaps, docs, tiers = [], [], []
        for i, s in enumerate(seconds):
            fb = gen.flow_batch(SMALL_BATCH, T0 + s)
            docs += swm.ingest(fb.tags, fb.meters, fb.valid)
            tiers += swm.pop_tier_docbatches()
            if i % 3 == 2:
                snaps.append(swm.snapshot_open(force=True))
        docs += swm.drain()
        tiers += swm.pop_tier_docbatches()
        runs[name] = dict(docs=docs, tiers=tiers, snaps=snaps, counters=swm.get_counters(),
                          blocks=swm.pop_closed_sketches(), tier_blocks=swm.closed_tier_sketches)
        swm.close()
    card, host = runs["card"], runs["cpu"]
    check(same_docs(card["docs"], host["docs"]) and len(host["docs"]) >= 8,
          "3k: sharded DocBatches differ card vs CPU")
    check(len(card["tiers"]) == len(host["tiers"]) > 0 and all(
        ia == ib and same_docs([a], [b]) for (ia, a), (ib, b) in zip(card["tiers"], host["tiers"])),
        "3k: sharded tier DocBatches differ card vs CPU")
    check(card["counters"] == host["counters"], "3k: sharded counters differ card vs CPU")
    check(host["counters"]["drop_before_window"] > 0, "3k: the test stream dropped no late row")
    moved = check_sketch_blocks_card_vs_cpu(card["blocks"], host["blocks"])
    moved += check_sketch_blocks_card_vs_cpu(card["tier_blocks"], host["tier_blocks"])
    moved += check_snapshots_card_vs_cpu(card["snaps"], host["snaps"])
    return {"windows": len(card["docs"]), "tier_windows": len(card["tiers"]),
            "blocks": len(card["blocks"]), "snapshots": len(card["snaps"]),
            "hist_counts_moved": moved}


def sharded_phase(dev, gpu: str):
    """Phase 3k: the sharded path at full width on 4 logical shards of the
    card. Returns (launches of the main sharded run, of the checkpoint
    run, of the cascade run, summary)."""
    import shutil
    import tempfile

    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    batches = [gen.flow_batch(BATCH, T0 + s) for s in SHARDED_SECONDS]
    cfg = sharded_config()

    # run A: the main sharded path, counts zeroed before and read after
    reset_all_launch_counts()
    a = sharded_stream(sharded_manager(dev, cfg), batches, profile_at=SHARDED_PROFILE_AT,
                       parity_at=1)
    main = all_launches()
    swm = a.pop("swm")
    check(main["segreduce_gather"] > 0 and main["sketch_fused"] > 0
          and main["segreduce_sorted"] == 0, f"3k: sharded path launches {main}")
    check(all(r["parity_ok"] for r in a["parity"].values()),
          "3k: a kernel disagrees with its plain version on shard 0's operands")
    check(max(a["fetches"]) <= 3 and a["drain_fetches"] == 2,
          f"3k: fetches per ingest {a['fetches']}, drain {a['drain_fetches']}")
    c = a["counters"]
    flushed = sum(d.size for d in a["docs"])
    check(c["flow_in"] == sum(int(fb.valid.sum()) for fb in batches)
          and c["flushed_doc"] == flushed > 0
          and c["drop_before_window"] == 0, f"3k: counters {c}")
    check(all(np.isfinite(d.meters).all() for d in a["docs"]), "3k: non-finite meters")
    close_ms = time_ms(lambda: swm.pipe.window_close(swm.sketches))
    swm.close()
    view, pod_1m = a["view"]
    check(all(torch.equal(x, view.hll[0]) and torch.equal(y, view.hll[0])
              for x, y in zip(view.hll, pod_1m)), "3k: shards' merged views differ")

    # (b) and (c): the single-chip port over the same batches
    single = L4Pipeline(PipelineConfig(window=WindowConfig(
        capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES, delay=DELAY,
        sketch=cfg.sketch_config()), batch_size=BATCH, batch_unique_cap=UNIQUE_CAP), device=dev)
    s_docs = []
    for fb in batches:
        s_docs += single.ingest(fb)
    s_hll = single.wm.sk.hll.amax(0)
    s_docs += single.drain()
    s_blocks = single.pop_closed_sketches()
    rollup = check_rollups_equal(rollup_by_key(a["docs"], FLOW_METER),
                                 rollup_by_key(s_docs, FLOW_METER), "3k 1 s rollup")
    check(torch.equal(view.hll[0], s_hll),
          "3k: the merged window_close HLL differs from the single-chip plane's")
    check([b.window for b in a["blocks"]] == [b.window for b in s_blocks]
          and all(np.array_equal(x.hll, y.hll) for x, y in zip(a["blocks"], s_blocks)),
          "3k: merged closed blocks' HLL differ from the single-chip blocks'")
    del single, s_docs

    # run B: saved after T0+3, restored into a fresh manager, finished
    work = tempfile.mkdtemp(prefix="chip_smoke_3k_")
    try:
        reset_all_launch_counts()
        b = sharded_stream(sharded_manager(dev, cfg), batches, save_after=SHARDED_SAVE_AFTER,
                           path=os.path.join(work, "swm.ckpt"))
        ckpt_launches = all_launches()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    b.pop("swm").close()
    check(same_docs(b["docs"], a["docs"]) and same_blocks(b["blocks"], a["blocks"])
          and all(b["counters"][k] == a["counters"][k] for k in SHARD_COUNTERS),
          "3k: the resumed sharded stream differs from the uninterrupted one")
    del batches

    # run C: the same cell with the minute + hour cascade, over a minute close
    cb = [gen.flow_batch(BATCH, T0 + s) for s in SHARDED_CASCADE_SECONDS]
    reset_all_launch_counts()
    cc = sharded_stream(sharded_manager(dev, sharded_config(
        cascade=CASCADE_INTERVALS, cascade_capacity=SHARD_CAPACITY)), cb)
    casc_launches = all_launches()
    cc.pop("swm").close()
    del cb
    check(casc_launches["segreduce_gather"] > 0 and casc_launches["sketch_fused"] > 0,
          f"3k: cascade launches {casc_launches}")
    check(max(cc["fetches"]) <= 3, f"3k: cascade fetches per ingest {cc['fetches']}")
    minute = (T0 + 38) // 60
    m_docs = [db for iv, db in cc["tiers"] if iv == 60 and int(db.timestamp[0]) // 60 == minute]
    sec_docs = [d for d in cc["docs"] if int(d.timestamp[0]) // 60 == minute]
    check(m_docs and len(sec_docs) == 2, "3k: the minute did not close with its seconds")
    tier_rollup = check_rollups_equal(
        rollup_by_key(m_docs, FLOW_METER, with_time=False),
        rollup_by_key(sec_docs, FLOW_METER, with_time=False), "3k minute tier")
    check(cc["counters"]["cascade_shed"] == 0 and cc["counters"]["cascade_rows"] > 0
          and any(iv == 3600 for iv, _ in cc["tiers"]), f"3k: cascade counters {cc['counters']}")

    card_cpu = sharded_card_vs_cpu(dev)
    rows = (len(SHARDED_SECONDS) - 1) * BATCH
    prof = a["profile"]
    return main, ckpt_launches, casc_launches, {
        "gpu": gpu, "shards": SHARDS, "mesh": "2x2", "batch": BATCH,
        "capacity_per_shard": SHARD_CAPACITY,
        "records_per_s": rows / sum(a["walls"]), "ingest_walls_s": a["walls"],
        "launches": main, "launches_per_ingest": prof["kernel_launches"],
        "profiled_ingest": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "kernel_launches", "copies", "top")},
        "window_close_ms": close_ms, "fetches_per_ingest": a["fetches"],
        "drain_fetches": a["drain_fetches"], "parity_shard0": a["parity"],
        "rollup_vs_single_chip": rollup, "hll_equal_single_chip": True,
        "checkpoint": b["checkpoint"], "launches_checkpoint": ckpt_launches,
        "cascade": {"launches": casc_launches, "fetches_per_ingest": cc["fetches"],
                    "tier_windows": [iv for iv, _ in cc["tiers"]], "minute_vs_seconds": tier_rollup,
                    "counters": {k: cc["counters"][k] for k in ("cascade_rows", "cascade_shed",
                                                                "cascade_tier_windows")}},
        "card_vs_cpu": card_cpu, "counters": c,
    }


# phase 3l: the server deployment. The stream is bench/e2e_ingest.py's:
# SyntheticFlowGen(5_000, seed=0), 4096 records a second through the
# port's L4Pipeline, 100,000 docs in frames of 256 docs from 8 agent ids.
# The platform state has the scale of Kubernetes' published large-cluster
# limits (kubernetes.io "Considerations for large clusters": 5,000 nodes,
# 150,000 pods): 150,000 pods with one IPv4, one MAC and one gprocess row
# each, 5,000 node infos and 10,000 pod services; the stream's addresses
# are the first pods' addresses, so lookups probe the full tables.
SERVER_DOCS = 100_000  # depth cut from 200,000 for the command's time (PERF.md §4)
SERVER_FRAME_DOCS = 256
SERVER_AGENTS = 8
SERVER_RECORDS = 4096
SERVER_PODS = 150_000
SERVER_NODES = 5_000
SERVER_POD_SERVICES = 10_000
SERVER_REGION = 1
SERVER_CHUNK = 8192


def server_stream(dev):
    """(frames, docs) of the e2e stream: the port's L4Pipeline on the card
    over SyntheticFlowGen(5_000, seed=0), its DocBatches encoded as 1 s
    METRICS docs. One doc in 20 is moved to the internet EPC, one in 20
    to an unregistered address with no pod (lookup misses)."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.code import DocumentFlag
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA
    from deepflow_tpu_torch.enrich.platform import EPC_INTERNET
    from deepflow_tpu_torch.ingest.codec import encode_docbatch
    from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=5_000, seed=0)
    # the stash holds the 4 open windows of ~16k docs each without shedding
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 17),
                                     batch_size=SERVER_RECORDS), device=dev)
    docs, t = [], T0
    while sum(d.size for d in docs) < SERVER_DOCS:
        docs += pipe.ingest(gen.flow_batch(SERVER_RECORDS, t))
        t += 1
    docs += pipe.drain()
    check(pipe.counters["drop_overflow"] == 0, "3l: the stream's pipeline shed docs")
    idx = {n: TAG_SCHEMA.index(n) for n in ("l3_epc_id", "ip0_w3", "pod_id")}
    msgs, k = [], 0
    for db in docs:
        tags = db.tags.copy()
        j = (k + np.arange(len(tags))) % 20
        tags[j == 0, idx["l3_epc_id"]] = EPC_INTERNET
        tags[j == 1, idx["ip0_w3"]] = 0xC6336400 + (j[j == 1] & 0xFF)  # 198.51.100.x
        tags[j == 1, idx["pod_id"]] = 0
        k += len(tags)
        msgs += encode_docbatch(dataclasses.replace(db, tags=tags),
                                flags=int(DocumentFlag.PER_SECOND_METRICS))
    msgs = msgs[:SERVER_DOCS]
    frames = [encode_frame(FlowHeader(msg_type=int(MessageType.METRICS),
                                      agent_id=1 + (i // SERVER_FRAME_DOCS) % SERVER_AGENTS,
                                      organization_id=1),
                           msgs[i:i + SERVER_FRAME_DOCS])
              for i in range(0, len(msgs), SERVER_FRAME_DOCS)]
    return frames, len(msgs), gen, t - T0


def server_platform_rows(gen) -> tuple[list, list, list]:
    """The K8s-limit platform registry as rows: (interface infos as
    `PlatformInfoTable.add_info` keywords, gprocesses as (gpid, agent,
    pod), pod services as (service id, pod group))."""
    rng = np.random.default_rng(0)
    p = gen.pop
    n_t = len(p["ip0"])
    infos, gprocs = [], []
    # pods 1..10,000 take the stream's addresses (ip0 then ip1 with their
    # EPCs); the rest get unique 11.x addresses in EPCs 1..49
    macs = rng.choice(1 << 40, SERVER_PODS, replace=False) + (0x02 << 40)
    for pod in range(1, SERVER_PODS + 1):
        i = pod - 1
        if i < n_t:
            epc, ip = int(p["epc0"][i]), int(p["ip0"][i])
        elif i < 2 * n_t:
            epc, ip = int(p["epc1"][i - n_t]), int(p["ip1"][i - n_t])
        else:
            epc, ip = 1 + i % 49, 0x0B000000 + i
            if AGENT_POD0 <= pod < AGENT_POD0 + AGENT_PODS:
                epc = 0  # phase 3m's pods: the agent reports no EPC
        node = 1 + i % SERVER_NODES
        # one pod in 25 sits in another region (its docs are dropped)
        region = SERVER_REGION + 1 if pod % 25 == 0 else SERVER_REGION
        infos.append(dict(epc_id=epc, ips=[ip], mac=int(macs[i]), pod_id=pod, region_id=region,
                          host_id=node, l3_device_id=pod, l3_device_type=10,
                          subnet_id=1 + i % 4096, pod_node_id=node, pod_ns_id=1 + i % 500,
                          az_id=1 + i % 3, pod_group_id=1 + i % SERVER_POD_SERVICES,
                          pod_group_type=101, pod_cluster_id=1))
        gprocs.append((pod, 1 + i % SERVER_AGENTS, pod))
    for node in range(1, SERVER_NODES + 1):
        infos.append(dict(epc_id=1 + node % 49, ips=[0xC0A80000 + node],
                          region_id=SERVER_REGION, host_id=node, l3_device_id=200_000 + node,
                          l3_device_type=14, subnet_id=8192 + node % 64, pod_node_id=node,
                          az_id=1 + node % 3, pod_cluster_id=1))
    services = [(500_000 + g, g) for g in range(1, SERVER_POD_SERVICES + 1)]
    return infos, gprocs, services


def server_platform(gen):
    """The K8s-limit platform registry, numpy form (built once on the host)."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.enrich.platform import PlatformInfoTable

    pt = PlatformInfoTable(my_region_id=SERVER_REGION)
    infos, gprocs, services = server_platform_rows(gen)
    for info in infos:
        pt.add_info(**info)
    for gpid, agent, pod in gprocs:
        pt.add_gprocess(gpid=gpid, agent_id=agent, pod_id=pod)
    for sid, group in services:
        pt.add_pod_service(sid, pod_group_id=group)
    return convert.platform_state_to_numpy(pt.build(device="cpu"))


def rows_multiset(cols: dict) -> np.ndarray:
    """A table's rows as one sorted array of byte strings (strings by
    their codes, floats by their bits): equal multisets give equal arrays."""
    names = sorted(cols)
    if not names or not len(cols[names[0]]):
        return np.zeros(0, np.uint8)
    parts = []
    for k in names:
        a = np.asarray(cols[k])
        if a.dtype.kind == "U":
            a = np.unique(a, return_inverse=True)[1]
        parts.append(np.ascontiguousarray(a).view(np.uint8).reshape(len(a), -1))
    mat = np.ascontiguousarray(np.concatenate(parts, axis=1))
    return np.sort(mat.view(np.dtype((np.void, mat.shape[1]))).ravel())


def strings_of(store, db: str, table: str) -> dict:
    return {c.name: sorted(set(store.scan(db, table, columns=[c.name])[c.name].tolist()))
            for c in store.schema(db, table).columns if c.dtype.startswith("U")}


def drain_writer(writer) -> None:
    """Wait until every table writer of a DocStoreWriter has landed its
    rows; fail on a failed store write."""
    deadline = time.time() + 300
    for w in list(writer._writers.values()) + [writer._app_tags._w.writer]:
        while w.get_counters()["pending_rows"]:
            check(time.time() < deadline, f"3l: the table writer did not drain "
                                          f"{w.get_counters()}")
            time.sleep(0.01)
        check(w.get_counters()["write_fail"] == 0, f"3l: store writes failed "
                                                   f"{w.get_counters()}")


class TeeWriter:
    """Keeps every EnrichedBatch the ingester hands over (for the CPU
    twin) and passes it on to the DocStoreWriter, under one lock: the
    twin writes the batches in the order the store received them, so
    both stores hold their rows in one order and float32 sums over them
    add in one order."""

    def __init__(self, writer):
        self.writer = writer
        self.batches = []
        self.lock = threading.Lock()

    def put(self, batch) -> None:
        with self.lock:
            self.batches.append(batch)
            self.writer.put(batch)


def run_server_stack(state, frames, n_docs: int, root: str) -> dict:
    """Receiver → FlowMetricsIngester(4 workers) → DocStoreWriter over a
    ColumnarStore at `root`. The first frame goes alone (the warm-up, as
    bench/e2e_ingest.py does), then all frames in one write; docs/s is
    measured from that write until the ingester has enriched and handed
    every doc to the writer. A dead worker raises from get_counters()."""
    import socket

    from deepflow_tpu_torch.ingest.receiver import Receiver
    from deepflow_tpu_torch.server.flow_metrics import FlowMetricsIngester
    from deepflow_tpu_torch.server.metrics_tables import DocStoreWriter
    from deepflow_tpu_torch.storage.store import ColumnarStore

    recv = Receiver()
    recv.start()
    store = ColumnarStore(root)
    writer = DocStoreWriter(store)
    tee = TeeWriter(writer)
    # the Python decoder and queue: 3l's docs/s stays comparable across
    # slices; 3q runs the native ones (the reference's default)
    ing = FlowMetricsIngester(recv, tee, platform_state=state, n_workers=4,
                              queue_capacity=1 << 15, enrich_chunk=SERVER_CHUNK,
                              prefer_native=False)

    def settled(total):
        c = ing.get_counters()
        return (c["docs_written"] + c["drop_other_region"] == total
                and c["docs_in"] == total and writer.counters["rows"] == c["docs_written"])

    def wait(total, limit_s):
        deadline = time.time() + limit_s
        while not settled(total):
            check(time.time() < deadline, f"3l: the ingester did not settle {ing.get_counters()}")
            time.sleep(0.002)

    try:
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(frames[0])
            wait(SERVER_FRAME_DOCS, 300)
            t_start = time.perf_counter()
            s.sendall(b"".join(frames))
            wait(SERVER_FRAME_DOCS + n_docs, 600)
            dt = time.perf_counter() - t_start
        drain_writer(writer)
        counters = ing.get_counters()
        rx = recv.get_counters()
    finally:
        ing.stop()
        writer.stop()
        recv.stop()
    return {"store": store, "docs_per_s": n_docs / dt, "seconds": dt, "counters": counters,
            "batches": tee.batches,
            "receiver": {k: rx[k] for k in ("rx_frames", "rx_bytes", "bad_frames",
                                            "agents_seen")}}


def cpu_twin(batches, host_state, root: str) -> dict:
    """The card run's decoded batches enriched again on the CPU, chunk for
    chunk as the ingester enriches them, and written through a second
    DocStoreWriter: every enriched lane must equal the card's."""
    from deepflow_tpu_torch.server.flow_metrics import EnrichedBatch, enrich_batch
    from deepflow_tpu_torch.server.metrics_tables import DocStoreWriter
    from deepflow_tpu_torch.storage.store import ColumnarStore

    t0 = time.perf_counter()
    store = ColumnarStore(root)
    writer = DocStoreWriter(store)
    chunks = drops = 0
    try:
        for b in batches:
            d = b.decoded
            s0, s1, keep, n_drop, n_chunks = enrich_batch(
                host_state, d.tags, np.ones(len(d.tags), bool), SERVER_CHUNK)
            for side, got in ((b.side0, s0), (b.side1, s1)):
                for k, v in got.items():
                    check(np.array_equal(side[k], v), f"3l: enriched {k} differs card vs CPU")
            check(np.array_equal(b.keep, keep), "3l: keep mask differs card vs CPU")
            chunks += n_chunks
            drops += n_drop
            writer.put(EnrichedBatch(header=b.header, decoded=d, side0=s0, side1=s1, keep=keep))
        drain_writer(writer)
    finally:
        writer.stop()
    return {"store": store, "chunks": chunks, "drops": drops,
            "seconds": time.perf_counter() - t0}


SERVER_SQL = (
    "SELECT Count() AS c, Sum(byte_tx) AS b, Max(rtt_max) AS m, Min(rtt_max) AS mn "
    "FROM network.1s",
    "SELECT auto_service_id_0 AS s, auto_service_type_0 AS t, Sum(packet_tx) AS p, "
    "Avg(rtt_sum) AS a, Count() AS c FROM network.1s GROUP BY auto_service_id_0, "
    "auto_service_type_0 ORDER BY s, t",
    "SELECT region_id_0 AS r, tag_source_0 AS ts, Count() AS c FROM network.1s "
    "GROUP BY region_id_0, tag_source_0 ORDER BY r, ts",
    "SELECT interval(time, 60) AS t, Sum(byte_tx) AS b, Max(rtt_max) AS m FROM network.1s "
    "GROUP BY interval(time, 60) ORDER BY t",
    "SELECT name(protocol) AS p, Count() AS c, rtt_avg FROM network.1s "
    "GROUP BY name(protocol) ORDER BY p",
    "SELECT auto_instance_type_1 AS t, Uniq(auto_instance_id_1) AS u, Sum(byte_rx) AS b "
    "FROM network_map.1s GROUP BY auto_instance_type_1 ORDER BY t",
    "SELECT pod_group_id_0 AS g, Percentile(rtt_sum, 95) AS p95, Count() AS c "
    "FROM network.1s GROUP BY pod_group_id_0 HAVING Count() > 20 ORDER BY g LIMIT 50",
    "SELECT l3_epc_id AS e, Count() AS c, Sum(byte_tx) AS b FROM network.1s "
    "WHERE l3_epc_id IN (1, 2, 3, 65534) GROUP BY l3_epc_id ORDER BY e",
    "SELECT interval(time, 3600) AS t, Sum(byte_tx) AS b, Avg(rtt_max) AS a FROM network "
    "GROUP BY interval(time, 3600) ORDER BY t",
    "SELECT server_port AS sp, Sum(byte_tx) AS b, Max(rtt_max) AS m FROM network_1h "
    "GROUP BY server_port HAVING Sum(byte_tx) > 1000 ORDER BY sp",
    "SELECT Count() AS c, Sum(packet_tx) AS p, Max(rtt_max) AS m FROM network_1d",
    "SELECT Count() AS c, Sum(packet_tx) AS p, Spread(rtt_max) AS s FROM network_map_1h",
)


def same_result(a, b, what: str) -> None:
    """Query results card = CPU: integer-valued floats below 2^24 bit for
    bit, other floats within rtol 1e-5, the rest exactly."""
    check(a.columns == b.columns and a.rows == b.rows, f"{what}: shape differs")
    for c in a.columns:
        x, y = np.asarray(a.values[c]), np.asarray(b.values[c])
        if y.dtype.kind == "f":
            exact = np.all(np.abs(y) < 2 ** 24) and np.all(y == np.round(y))
            ok = (np.array_equal(x, y) if exact
                  else np.allclose(x, y, rtol=SUM_RTOL, atol=0, equal_nan=True))
        else:
            ok = np.array_equal(x, y)
        check(ok, f"{what}: column {c} differs card vs CPU")


def same_rollup(card_store, cpu_store, table: str) -> int:
    """A derived table card = CPU: the same groups (tags, time) in
    canonical order; meters as in `same_result`."""
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER

    a, b = card_store.scan("flow_metrics", table), cpu_store.scan("flow_metrics", table)
    meters = set(FLOW_METER.field_names())
    keys = sorted(k for k in a if k not in meters)

    def order(cols):
        codes = [np.unique(cols[k], return_inverse=True)[1] for k in keys]
        return np.lexsort(codes[::-1])

    oa, ob = order(a), order(b)
    check(len(oa) == len(ob) > 0, f"{table}: {len(oa)} card rows, {len(ob)} CPU rows")
    for k in a:
        x, y = a[k][oa], b[k][ob]
        if k in meters:
            exact = np.all(np.abs(y) < 2 ** 24) and np.all(y == np.round(y))
            ok = np.array_equal(x, y) if exact else np.allclose(x, y, rtol=SUM_RTOL, atol=0)
        else:
            ok = np.array_equal(x, y)
        check(ok, f"{table}: column {k} differs card vs CPU")
    return len(oa)


def downsample(store, device) -> dict:
    """network_1s → network_1h, network_map_1s → network_map_1h and the
    chained network_1h → network_1d, with every chunk closed; on the card
    under the profiler. Returns the counters, the wall, the profile and
    the arguments of every group-by call."""
    from deepflow_tpu_torch.server import datasource

    dsm = datasource.Downsampler(store, delay_s=0, device=device)
    dsm.add(datasource.DataSource(base_table="network_1s", interval="1h"))
    dsm.add(datasource.DataSource(base_table="network_map_1s", interval="1h"))
    dsm.add(datasource.DataSource(base_table="network_1h", interval="1d"))
    original = datasource.groupby_reduce
    calls = []

    def recording(*args, **kw):
        calls.append(args)
        return original(*args, **kw)

    datasource.groupby_reduce = recording
    try:
        now = T0 + 3 * 86400
        if device.type == "cuda":
            prof = profile_cycle(lambda: dsm.process(now))
            wall = prof["wall_ms"]
        else:
            t0 = time.perf_counter()
            dsm.process(now)
            wall = (time.perf_counter() - t0) * 1e3
            prof = None
    finally:
        datasource.groupby_reduce = original
    return {"counters": dsm.get_counters(), "wall_ms": wall, "profile": prof, "calls": calls,
            "groupby_rows": [int(c[0].shape[0]) for c in calls]}


def downsample_operands(args) -> dict:
    """The segmented-reduce operands of one recorded downsample group-by
    (the port's own sort and segment ids, capacity = rows)."""
    from deepflow_tpu_torch.ops.segment import segment_ids, sort_keys

    slot, hi, lo, _tags_t, rows, valid = args[:6]
    n = int(slot.shape[0])
    s_slot, s_hi, s_lo, perm = sort_keys(slot, hi, lo, valid)
    seg, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, n)
    return dict(rows=rows, seg=seg, first_pos=first_pos, perm=perm.to(torch.int32), cap=n,
                live=min(int(num_seg), n), live_rows=int((seg < n).sum()))


def enrich_chunk_profile(state, tags: np.ndarray) -> dict:
    """One 8192-doc chunk through enrich_docs and its one packed fetch,
    under the profiler (after a warm call): device time, kernel launches
    and copies."""
    from deepflow_tpu_torch.server.flow_metrics import enrich_chunk_host

    chunk = np.zeros((SERVER_CHUNK, tags.shape[1]), np.uint32)
    m = min(SERVER_CHUNK, len(tags))
    chunk[:m] = tags[:m]
    valid = np.zeros(SERVER_CHUNK, bool)
    valid[:m] = True
    prof = profile_cycle(lambda: enrich_chunk_host(state, chunk, valid))
    copies = sum(prof["copies"].values())
    return {"rows": m, "wall_ms": prof["wall_ms"], "device_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "device_events": prof["kernel_launches"],
            "kernel_launches": prof["kernel_launches"] - copies, "copies": prof["copies"],
            "top": prof["top"][:5]}


def server_phase(dev, gpu: str):
    """Phase 3l: the server deployment on the card, counts zeroed before
    its main path and read after. Returns (launches, segreduce parity at
    the downsample shape, summary, the platform's numpy form, and the
    stream (frames, docs, generator) that 3q sends again)."""
    import shutil
    import tempfile

    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.ingest.codec import DocumentDecoder
    from deepflow_tpu_torch.ingest.framing import HEADER_LEN, split_messages
    from deepflow_tpu_torch.querier import QueryEngine

    t_phase = time.perf_counter()
    frames, n_docs, gen, stream_seconds = server_stream(dev)
    t_stream = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    plat = server_platform(gen)
    t_platform = time.perf_counter() - t0
    state = convert.platform_state_from_numpy(plat, dev)
    host_state = convert.platform_state_from_numpy(plat, "cpu")
    work = tempfile.mkdtemp(prefix="chip_smoke_server_")
    try:
        # the main path: ingest → store → downsample → queries
        reset_all_launch_counts()
        card = run_server_stack(state, frames, n_docs, os.path.join(work, "card"))
        card_ds = downsample(card["store"], dev)
        card_eng = QueryEngine(card["store"], cache=False, device=dev)
        card_results, query_ms = [], []
        for sql in SERVER_SQL:
            card_results.append(card_eng.execute(sql))
            torch.cuda.synchronize()
            q0 = time.perf_counter()
            card_eng.execute(sql)
            torch.cuda.synchronize()
            query_ms.append((time.perf_counter() - q0) * 1e3)
        launches = all_launches()
        check(launches["segreduce_gather"] >= len(card_ds["calls"]) > 0
              and launches["segreduce_sorted"] == 0 and launches["sketch_fused"] == 0,
              f"3l: server path launches {launches}")

        # card = CPU: the card run's decoded batches through the CPU twin
        host = cpu_twin(card.pop("batches"), host_state, os.path.join(work, "cpu"))
        c = card["counters"]
        check(host["chunks"] == c["enrich_chunks"] and host["drops"] == c["drop_other_region"],
              f"3l: the CPU twin enriched {host['chunks']} chunks, dropped {host['drops']}")
        check(c["docs_in"] == n_docs + SERVER_FRAME_DOCS and c["decode_errors"] == 0
              and c["drop_other_region"] > 0 and c["enrich_fetches"] == c["enrich_chunks"],
              f"3l: ingester counters {c}")
        tables = {}
        check(card["store"].databases() == host["store"].databases(), "3l: databases differ")
        for db in host["store"].databases():
            derived = {"network_1h", "network_map_1h", "network_1d", "datasource_watermark"}
            check(set(card["store"].tables(db)) - derived == set(host["store"].tables(db)),
                  f"3l: {db} tables differ")
            for t in host["store"].tables(db):
                a = card["store"].scan(db, t)
                check(np.array_equal(rows_multiset(a), rows_multiset(host["store"].scan(db, t)))
                      and strings_of(card["store"], db, t) == strings_of(host["store"], db, t),
                      f"3l: stored rows of {db}.{t} differ card vs CPU")
                tables[f"{db}.{t}"] = len(next(iter(a.values())))
        stored = tables.get("flow_metrics.network_1s", 0) + tables.get(
            "flow_metrics.network_map_1s", 0)
        check(stored == c["docs_written"], f"3l: {stored} stored rows, {c['docs_written']} kept")
        host_ds = downsample(host["store"], torch.device("cpu"))
        check(host_ds["counters"] == card_ds["counters"], "3l: downsampler counters differ")
        rollups = {t: same_rollup(card["store"], host["store"], t)
                   for t in ("network_1h", "network_map_1h", "network_1d")}
        host_eng = QueryEngine(host["store"], cache=False, device="cpu")
        for sql, res in zip(SERVER_SQL, card_results):
            check(res.rows > 0, f"3l: no rows from {sql}")
            same_result(res, host_eng.execute(sql), sql)
        packets = {t: float(card_eng.execute(f"SELECT Sum(packet_tx) AS p FROM {t}").values["p"][0])
                   for t in ("network_1s", "network_1h", "network_1d")}
        check(np.allclose(list(packets.values()), packets["network_1s"], rtol=SUM_RTOL),
              f"3l: packets differ across tiers {packets}")

        # the segreduce kernel at the downsample shape (the 1 s → 1 h
        # rollup of network_1s, the largest call), held against its plain
        # version; and one enrichment chunk under the profiler
        big = max(card_ds.pop("calls"), key=lambda a: int(a[0].shape[0]))
        ds_parity = kernel_parity("segreduce_gather", downsample_operands(big))
        msgs = [m for f in frames[1:40] for m in split_messages(f[HEADER_LEN:])]
        tags = np.concatenate([d.tags for d in DocumentDecoder().decode(msgs).values()])
        enrich = enrich_chunk_profile(state, tags)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {
        "gpu": gpu, "docs": n_docs, "frames": len(frames), "stream_seconds": stream_seconds,
        "platform": {"pods": SERVER_PODS, "nodes": SERVER_NODES,
                     "pod_services": SERVER_POD_SERVICES,
                     "max_probes": {t: plat[t]["max_probes"] for t in (
                         "pod_t", "mac_t", "epcip_t", "gproc_t", "podsvc_t", "customsvc_t")},
                     "build_s": t_platform},
        "docs_per_s": card["docs_per_s"], "ingest_s": card["seconds"],
        "cpu_twin_s": host["seconds"], "counters": c,
        "receiver": card["receiver"], "stored_rows": tables,
        "enrich_chunk": enrich,
        "fetches_per_chunk": c["enrich_fetches"] / c["enrich_chunks"],
        "downsample": {"rows_in": card_ds["counters"]["rows_in"],
                       "rows_out": card_ds["counters"]["rows_out"],
                       "wall_ms": card_ds["wall_ms"],
                       "device_ms": card_ds["profile"]["device_busy_ms"],
                       "idle_share": card_ds["profile"]["idle_share"],
                       "launches": card_ds["profile"]["kernel_launches"],
                       "groupby_rows": card_ds["groupby_rows"], "rollup_rows": rollups},
        "segreduce_downsample": {k: ds_parity[k] for k in (
            "parity_ok", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "rows", "live_segments", "m")},
        "query_ms": {"median": statistics.median(query_ms), "max": max(query_ms),
                     "each": query_ms},
        "packets": packets, "launches": launches,
        "prep_s": {"stream": t_stream, "platform": t_platform},
        "phase_s": time.perf_counter() - t_phase,
    }
    return launches, ds_parity, summary, plat, (frames, n_docs, gen)


# phase 3q: the composed server — server/main.py's Server, as
# `dfctl server` runs it, at 3l's width. It boots from a dict config on
# the card (4 decode workers, ephemeral ports), takes 3l's large-cluster
# platform through its own resource plane (the pod and node interfaces
# as a file-reader cloud source that the leader's tick reconciles
# through the recorder; the pod services and gprocesses as resources),
# compiles it onto the card on its tick, receives 3l's frames over TCP,
# has one pod service replaced mid-stream, rolls 1 s up to 1 h on a
# tick, and answers over REST, debug UDP, MCP and `dfctl query`. A
# Server on the CPU fed the same frames and resources is its twin. The
# card's Server runs the reference's default config: the native decoder
# and queue, and the wire plane (with its framed-TCP listener); the twin
# decodes in Python, so their stored rows also hold one decoder against
# the other.
COMPOSED_GROUP = 1  # the pod group whose service is replaced mid-stream
COMPOSED_NEW_SERVICE = 600_001
COMPOSED_SQL = SERVER_SQL[:10]  # the statements over network_1s / _1h
COMPOSED_WAIT_S = 300  # a dead decode worker is silent: the wait fails
# the CPU twin runs as its own process beside the card's run (its decode
# workers take another interpreter lock, not the card run's)
COMPOSED_TWIN_ARGV = [os.path.abspath(__file__), "--composed-twin"]
COMPOSED_TWIN_THREADS = 2  # the twin's torch CPU threads
COMPOSED_WIRE_SQL = COMPOSED_SQL[0]  # the statement the wire streams watch
COMPOSED_WIRE_EVENTS = 4  # WindowClosed batches published to the streams


def composed_config(root: str, card: bool) -> dict:
    """The card's Server: the reference's ingester and wire defaults
    (native decode, wire plane on) plus the framed-TCP wire listener; the
    CPU twin's: the Python decoder."""
    return {"receiver": {"tcp_port": 0, "udp_port": 0},
            "ingester": {"n_decoders": 4, "queue_capacity": 1 << 15,
                         "prefer_native": card},
            "storage": {"root": root}, "wire": {"tcp_enabled": card},
            "region_id": SERVER_REGION}


def composed_wire(srv) -> dict:
    """3q's wire streams on COMPOSED_WIRE_SQL: one SSE `GET /v1/watch?sql=`
    stream off the REST server and one framed-TCP stream off the wire
    listener, beside a direct local subscription on the same statement;
    COMPOSED_WIRE_EVENTS WindowClosed batches on network_1s. Every result
    each stream delivered equals, under result_to_jsonable, the one the
    direct subscription delivered."""
    import socket
    import urllib.parse
    import urllib.request

    from deepflow_tpu_torch.ingest.framing import FrameReassembler
    from deepflow_tpu_torch.querier.events import WindowClosed
    from deepflow_tpu_torch.wire import (PushFrame, decode_push_frame, encode_push_frame,
                                         result_to_jsonable)

    def jn(obj):
        return json.loads(json.dumps(obj, default=str))

    direct, sse, tcp, eval_ms = [], [], [], []
    stop = threading.Event()
    sub, w = srv.subscriptions.subscribe_sql(
        COMPOSED_WIRE_SQL, callback=lambda r, _s: direct.append(jn(result_to_jsonable(r))))

    def sse_reader():
        url = (f"http://127.0.0.1:{srv.rest.port}/v1/watch?"
               + urllib.parse.urlencode({"sql": COMPOSED_WIRE_SQL, "heartbeat_s": 0.2,
                                         "maxlen": 1024}))
        with urllib.request.urlopen(url, timeout=120) as r:
            for raw in r:
                if raw.startswith(b"data: "):
                    sse.append(json.loads(raw[6:]))
                if stop.is_set():
                    return

    sock = socket.create_connection(srv.wire_tcp.endpoint, timeout=120)

    def tcp_reader():
        reasm = FrameReassembler()
        sock.sendall(encode_push_frame(PushFrame(kind="sub", body={
            "sql": COMPOSED_WIRE_SQL, "heartbeat_s": 0.2, "maxlen": 1024})))
        while not stop.is_set():
            chunk = sock.recv(1 << 20)
            if not chunk:
                return
            for h, b in reasm.feed(chunk):
                f = decode_push_frame(h, b)
                if f.kind == "result":
                    tcp.append(f.body["payload"])

    readers = [threading.Thread(target=fn, daemon=True) for fn in (sse_reader, tcp_reader)]
    for t in readers:
        t.start()
    hub = srv.wire
    try:
        deadline = time.time() + 60
        while hub.get_counters()["connections_open"] < 2:
            check(time.time() < deadline, f"3q: the wire streams did not open {hub.get_counters()}")
            time.sleep(0.01)
        for k in range(COMPOSED_WIRE_EVENTS):
            n = len(direct)
            t = time.perf_counter()
            srv.event_bus.publish(WindowClosed("flow_metrics", "network_1s", T0 + k))
            check(len(direct) > n, "3q: a WindowClosed batch did not evaluate the statement")
            eval_ms.append((time.perf_counter() - t) * 1e3)
        n = len(direct)  # a late store event may add one more later, to all three
        deadline = time.time() + 120
        while len(sse) < n or len(tcp) < n:
            check(time.time() < deadline, f"3q: the wire streams delivered {len(sse)} and "
                                          f"{len(tcp)} of {n} results")
            time.sleep(0.01)
        check(sse[:n] == direct[:n] and tcp[:n] == direct[:n],
              "3q: a wire stream delivered another result than the direct subscription")
        check(direct[-1]["rows"] and direct[-1]["columns"] == ["c", "b", "m", "mn"],
              f"3q: the watched statement returned {direct[-1]}")
        sock.sendall(encode_push_frame(PushFrame(kind="unsub")))
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
        sock.close()
        sub.unwatch(w)
    deadline = time.time() + 30
    while hub.get_counters()["connections_open"]:
        check(time.time() < deadline, f"3q: the wire streams did not close {hub.get_counters()}")
        time.sleep(0.02)
    c = hub.get_counters()
    check(c["deliveries"] >= 2 * n and c["drops"] == 0 and c["open_errors"] == 0,
          f"3q: wire counters {c} for {n} results a stream")
    return {"sql": COMPOSED_WIRE_SQL, "results_per_stream": n,
            "deliveries": c["deliveries"], "drops": c["drops"], "reaps": c["reaps"],
            "sse_connections": c["sse_connections"], "tcp_connections": c["tcp_connections"],
            "eval_ms": eval_ms, "rows": len(direct[-1]["rows"])}


def composed_register(srv, rows) -> None:
    """3l's platform into the server's resource plane."""
    from deepflow_tpu_torch.controller.cloud import FileReaderPlatform

    infos, gprocs, services = rows
    # the resource plane's interfaces carry no pod group type
    vifs = [{k: v for k, v in info.items() if k != "pod_group_type"} for info in infos]
    # reconciled now, as a cloud task's poll does (the leader's ticks poll
    # it again and find it unchanged)
    srv.add_cloud_source(FileReaderPlatform({"resources": {}, "vinterfaces": vifs},
                                            domain="k8s-large")).poll()
    for gpid, agent, pod in gprocs:
        srv.resources.put("gprocess", gpid, f"gprocess-{gpid}", agent_id=agent, pod_id=pod)
    for sid, group in services:
        srv.resources.put("pod_service", sid, f"service-{group}", pod_group_id=group)


def composed_send(srv, frames, total: int) -> float:
    """Frames over one TCP connection; waits until every doc is decoded,
    enriched and handed to the writer. Returns the seconds it took."""
    import socket

    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", srv.receiver.tcp_port)) as s:
        s.sendall(b"".join(frames))
        deadline = time.time() + COMPOSED_WAIT_S
        while True:
            c = srv.flow_metrics.get_counters()  # raises if a worker died
            if (c["docs_in"] == total and c["docs_written"] + c["drop_other_region"] == total
                    and srv.doc_writer.counters["rows"] == c["docs_written"]):
                break
            check(time.time() < deadline, f"3q: the server did not settle {c}")
            time.sleep(0.002)
    return time.perf_counter() - t0


def composed_http(port: int, path: str, body=None):
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data), timeout=120) as r:
        return json.loads(r.read())


def composed_run(dev, frames, n_docs: int, rows, root: str) -> dict:
    """One Server through the whole 3q scenario on `dev`: the results
    are host values only (they cross from the twin's process as JSON)."""
    import contextlib
    import io

    from deepflow_tpu_torch import cli
    from deepflow_tpu_torch.server.debug import debug_request
    from deepflow_tpu_torch.server.main import Server
    from deepflow_tpu_torch.utils.config import load_config

    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize()

    cfg, unknown = load_config(composed_config(root, card))
    check(unknown == [], f"3q: unknown config keys {unknown}")
    t0 = time.perf_counter()
    srv = Server(cfg, exporters=[], device=dev).start()
    from deepflow_tpu_torch import native

    # a failed native build must not hide behind the Python fallback
    check(srv.flow_metrics._use_native == card and (srv.wire_tcp is not None) == card,
          f"3q: the {dev.type} server decodes {'natively' if srv.flow_metrics._use_native else 'in Python'}"
          f" (native build: {native.build_error()}), wire listener {srv.wire_tcp}")
    refresh_ms = []
    refresh = srv.refresh_platform

    def timed_refresh():
        t = time.perf_counter()
        refresh()
        sync()
        refresh_ms.append((time.perf_counter() - t) * 1e3)

    srv.refresh_platform = timed_refresh
    out = {"device": str(dev)}
    try:
        composed_register(srv, rows)
        ticks = [srv.tick(now=T0)]  # every node compiles the new platform first
        sync()
        out["boot_s"] = time.perf_counter() - t0
        state = srv.flow_metrics.platform_state
        check(ticks[0]["platform"] and state.device.type == dev.type
              and srv.flow_log.platform_state is state,
              f"3q: the platform is on {state.device}, ticks {ticks}")
        half = len(frames) // 2
        n_first = min(half * SERVER_FRAME_DOCS, n_docs)
        dt_first = composed_send(srv, frames[:half], n_first)
        # one resource changes: the group's pod service is replaced
        srv.resources.delete("pod_service", 500_000 + COMPOSED_GROUP)
        srv.resources.put("pod_service", COMPOSED_NEW_SERVICE, "service-new",
                          pod_group_id=COMPOSED_GROUP)
        ticks.append(srv.tick(now=T0 + 1))
        check(ticks[-1]["platform"] and srv.flow_metrics.platform_state.device.type == dev.type,
              f"3q: the change did not refresh the platform {ticks[-1]}")
        dt_second = composed_send(srv, frames[half:], n_docs)
        drain_writer(srv.doc_writer)
        c = srv.flow_metrics.get_counters()
        check(c["decode_errors"] == 0 and c["docs_in"] == n_docs and c["drop_other_region"] > 0
              and c["enrich_fetches"] == c["enrich_chunks"] > 0, f"3q: ingester counters {c}")
        if card:
            out["wire"] = composed_wire(srv)
        srv.add_datasource(base_table="network_1s", interval="1h")
        did = {}
        ds_now = T0 + 3 * 3600
        if card:
            prof = profile_cycle(lambda: did.update(srv.tick(now=ds_now)))
            out["downsample_tick"] = {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "kernel_launches", "copies")}
        else:
            t = time.perf_counter()
            did.update(srv.tick(now=ds_now))
            out["downsample_tick"] = {"wall_ms": (time.perf_counter() - t) * 1e3}
        check(did["downsampled"] > 0 and srv.downsampler.list()[0].name == "network_1h",
              f"3q: the downsampling tick {did}")
        ticks.append(did)
        # the change is in the docs sent after it
        cols = srv.store.scan("flow_metrics", "network_1s", columns=["pod_group_id_0",
                                                                     "service_id_0"])
        svc = cols["service_id_0"][cols["pod_group_id_0"] == COMPOSED_GROUP]
        out["changed_service_rows"] = {"old": int((svc == 500_000 + COMPOSED_GROUP).sum()),
                                       "new": int((svc == COMPOSED_NEW_SERVICE).sum())}
        check(min(out["changed_service_rows"].values()) > 0,
              f"3q: the service change is not in the rows {out['changed_service_rows']}")
        # the server's own query surfaces
        rest = srv.rest.port
        results, rest_rows, rest_ms, cached_ms = [], [], [], []
        for sql in COMPOSED_SQL:
            # the first call computes (the server's engine caches results
            # per store epoch); the second is served from the cache
            for times in (rest_ms, cached_ms):
                sync()
                t = time.perf_counter()
                got = composed_http(rest, "/v1/query", {"sql": sql})["rows"]
                times.append((time.perf_counter() - t) * 1e3)
            rest_rows.append(got)
            results.append(srv.query.execute(sql))
        health = composed_http(rest, "/v1/health")
        datasources = composed_http(rest, "/v1/datasources")
        profile = composed_http(rest, "/v1/profile/device?analyze=0")
        check(health == {"status": "ok", "leader": True}
              and [d["name"] for d in datasources if d["served_by"] == "downsampler"]
              == ["network_1h"] and {"hbm", "hbm_totals", "census"} <= set(profile),
              f"3q: REST answered {health} {datasources}")
        dbg = {cmd: debug_request("127.0.0.1", srv.debug.port, {"cmd": cmd})
               for cmd in ("ping", "tables", "datasources")}
        check(dbg["ping"].get("pong") is True
              and dbg["tables"]["tables"]["flow_metrics"]["network_1s"] > 0
              and dbg["datasources"]["datasources"][0]["name"] == "network_1h",
              f"3q: debug answered {dbg['ping']}")
        mcp = srv.mcp.port
        init = composed_http(mcp, "/mcp", {"jsonrpc": "2.0", "id": 1, "method": "initialize",
                                           "params": {}})
        tool = composed_http(mcp, "/mcp", {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                                           "params": {"name": "query_sql",
                                                      "arguments": {"sql": COMPOSED_SQL[0]}}})
        mcp_rows = json.loads(tool["result"]["content"][0]["text"])
        check(init["result"]["serverInfo"]["name"].startswith("deepflow"),
              f"3q: MCP initialize answered {init}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["query", "--store", root, "--device", dev.type, COMPOSED_SQL[0]])
        dfctl_rows = json.loads(buf.getvalue())
        check(mcp_rows == rest_rows[0], "3q: MCP and REST answer the first statement "
                                        "differently")
        # dfctl reads the parts back from disk, in another row order: its
        # float32 sums may differ in the last bits
        same_rest_rows(dfctl_rows, rest_rows[0], "3q: dfctl query against REST")
        out.update({
            "ticks": ticks, "counters": c, "refresh_ms": refresh_ms,
            "docs_per_s": n_docs / (dt_first + dt_second),
            "decoder": "native" if srv.flow_metrics._use_native else "python",
            "ingest_s": [dt_first, dt_second],
            "rest_query_ms": {"median": statistics.median(rest_ms), "each": rest_ms,
                              "cached_median": statistics.median(cached_ms)},
            "fetches_per_chunk": c["enrich_fetches"] / c["enrich_chunks"],
            "results": [{"columns": r.columns,
                         "dtypes": {k: np.asarray(v).dtype.str for k, v in r.values.items()},
                         "values": {k: np.asarray(v).tolist() for k, v in r.values.items()}}
                        for r in results],
            "rest_rows": rest_rows,
            "tables": {t: srv.store.row_count("flow_metrics", t)
                       for t in ("network_1s", "network_map_1s", "network_1h")},
        })
    finally:
        srv.refresh_platform = refresh
        srv.stop()
    # a second start in the same process serves again, then stops
    srv.start()
    try:
        check(composed_http(srv.rest.port, "/v1/health")["status"] == "ok",
              "3q: the second start does not answer")
        out["restart_tables"] = srv.store.row_count("flow_metrics", "network_1s")
    finally:
        srv.stop()
    out["store"] = root
    return out


def same_rest_rows(a: list, b: list, what: str) -> None:
    """REST rows card = CPU under the float rule of `same_result`."""
    check(len(a) == len(b), f"{what}: {len(a)} card rows, {len(b)} CPU rows")
    for x, y in zip(a, b):
        check(sorted(x) == sorted(y), f"{what}: columns differ")
        for k, v in y.items():
            u = x[k]
            if isinstance(v, float) and not (abs(v) < 2 ** 24 and v == round(v)):
                ok = math.isclose(u, v, rel_tol=SUM_RTOL) or (math.isnan(u) and math.isnan(v))
            else:
                ok = u == v
            check(ok, f"{what}: column {k} differs card vs CPU")


def composed_twin_main(spec: dict) -> int:
    """The CPU twin of 3q, in its own process (`chip_smoke.py
    --composed-twin SPEC`): 3l's frames from the parent's file, the
    platform rows from the stream's seed, one Server on the CPU."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    torch.set_num_threads(COMPOSED_TWIN_THREADS)
    data = open(spec["frames"], "rb").read()
    frames, off = [], 0
    while off < len(data):  # each frame starts with its own u32 BE size
        size = int.from_bytes(data[off:off + 4], "big")
        frames.append(data[off:off + size])
        off += size
    rows = server_platform_rows(SyntheticFlowGen(num_tuples=5_000, seed=0))
    out = composed_run(torch.device("cpu"), frames, spec["docs"], rows, spec["root"])
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def composed_result(rec: dict):
    """A query result carried as JSON, back in the engine's Result."""
    from deepflow_tpu_torch.querier import Result

    return Result(columns=rec["columns"],
                  values={k: np.asarray(v, dtype=rec["dtypes"][k])
                          for k, v in rec["values"].items()})


def composed_phase(dev, gpu: str, stream) -> tuple[dict, dict]:
    """Phase 3q: the composed server on the card against its CPU twin
    (another process, started first and run beside it), counts zeroed
    before the card's run and read after it. Returns (launches, summary)."""
    import shutil
    import tempfile

    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.storage.store import ColumnarStore

    frames, n_docs, gen = stream
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_3q_")
    twin = None
    try:
        spec = {"frames": os.path.join(work, "frames.bin"), "docs": n_docs,
                "root": os.path.join(work, "cpu"), "result": os.path.join(work, "cpu.json")}
        with open(spec["frames"], "wb") as f:
            for fr in frames:
                f.write(fr)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        log = open(os.path.join(work, "twin.log"), "w")
        twin = subprocess.Popen([sys.executable, *COMPOSED_TWIN_ARGV, json.dumps(spec)],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        # the platform rows come from the stream's seed, as the twin's do
        seed_pop = SyntheticFlowGen(num_tuples=5_000, seed=0).pop
        check(seed_pop.keys() == gen.pop.keys()
              and all(np.array_equal(seed_pop[k], gen.pop[k]) for k in gen.pop),
              "3q: the stream's population is not the seed's")
        rows = server_platform_rows(gen)
        reset_all_launch_counts()
        card = composed_run(dev, frames, n_docs, rows, os.path.join(work, "card"))
        launches = all_launches()
        check(launches["segreduce_gather"] > 0 and launches["segreduce_sorted"] == 0
              and launches["sketch_fused"] == 0, f"3q: composed server launches {launches}")
        t_wait = time.perf_counter()
        try:
            rc = twin.wait(timeout=2 * COMPOSED_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        log.close()
        check(rc == 0, f"3q: the CPU twin ended with {rc}: "
                       f"{open(os.path.join(work, 'twin.log')).read()[-3000:]}")
        twin_wait_s = time.perf_counter() - t_wait
        with open(spec["result"]) as f:
            host = json.load(f)
        # (how frames group into decode batches, and so into enrichment
        # chunks, depends on the workers' timing)
        same = ("frames_in", "docs_in", "docs_written", "decode_errors", "drop_other_region",
                "drop_second_write")
        check(card["decoder"] == "native" and host["decoder"] == "python",
              f"3q: decoders card {card['decoder']}, CPU twin {host['decoder']}")
        check({k: card["counters"][k] for k in same} == {k: host["counters"][k] for k in same}
              and json.loads(json.dumps(card["ticks"])) == host["ticks"]
              and card["changed_service_rows"] == host["changed_service_rows"],
              f"3q: card and CPU servers counted differently: {card['counters']} "
              f"{host['counters']} {card['ticks']} {host['ticks']}")
        a, b = ColumnarStore(card["store"]), ColumnarStore(host["store"])
        check(a.databases() == b.databases(), "3q: databases differ")
        compared = {}
        for db in b.databases():
            check(a.tables(db) == b.tables(db), f"3q: {db} tables differ")
            if db == "event":
                continue  # resource-change events carry the wall clock
            for t in b.tables(db):
                if t == "network_1h":
                    continue  # float32 sums: compared under the float rule below
                x, y = a.scan(db, t), b.scan(db, t)
                check(np.array_equal(rows_multiset(x), rows_multiset(y))
                      and strings_of(a, db, t) == strings_of(b, db, t),
                      f"3q: stored rows of {db}.{t} differ card vs CPU")
                compared[f"{db}.{t}"] = len(next(iter(x.values()))) if x else 0
        compared["flow_metrics.network_1h"] = same_rollup(a, b, "network_1h")
        for sql, x, y in zip(COMPOSED_SQL, card["results"], host["results"]):
            x = composed_result(x)
            check(x.rows > 0, f"3q: no rows from {sql}")
            same_result(x, composed_result(y), f"3q: {sql}")
        for sql, x, y in zip(COMPOSED_SQL, card["rest_rows"], host["rest_rows"]):
            same_rest_rows(x, y, f"3q REST: {sql}")
    finally:
        if twin is not None and twin.poll() is None:
            twin.kill()
            twin.wait()
        shutil.rmtree(work, ignore_errors=True)
    summary = {
        "gpu": gpu, "docs": n_docs, "frames": len(frames),
        "platform": {"pods": SERVER_PODS, "nodes": SERVER_NODES,
                     "pod_services": SERVER_POD_SERVICES},
        "docs_per_s": card["docs_per_s"], "ingest_s": card["ingest_s"],
        "boot_s": card["boot_s"], "refresh_platform_ms": card["refresh_ms"],
        "downsample_tick": card["downsample_tick"],
        "rest_query_ms": card["rest_query_ms"], "fetches_per_chunk": card["fetches_per_chunk"],
        "counters": card["counters"], "changed_service_rows": card["changed_service_rows"],
        "tables": card["tables"], "restart_tables": card["restart_tables"],
        "compared_rows": compared, "launches": launches,
        "decoder": card["decoder"], "native_build": native_build_info(),
        "wire": card["wire"],
        "cpu_twin": {"docs_per_s": host["docs_per_s"], "decoder": host["decoder"],
                     "boot_s": host["boot_s"],
                     "refresh_platform_ms": host["refresh_ms"], "wait_s": twin_wait_s,
                     "torch_threads": COMPOSED_TWIN_THREADS},
        "phase_s": time.perf_counter() - t_phase,
    }
    return launches, summary


# phase 3r: the modules of the last slice, at test size. (a) The rollup
# oracle (oracle/numpy_oracle.py) against the card's L4Pipeline and
# L7Pipeline windows on the reference conformance tests' seeded streams
# (tests/test_pipeline_conformance.py::test_multi_window_replay and
# tests/test_l7_pipeline.py::test_l7_synthetic_conformance). (b) eBPF
# socket events (agent/ebpf_bridge.py's EbpfDispatcher over the L7
# engine) through L7Pipeline on the card: app documents equal to the
# CPU's, and the same rows through L4Pipeline give no document. (c) The
# fleet wire pin: a FleetSubscriptionRouter here, one publisher host
# process (tests/torch_wire_host.py) whose SQL subscription evaluates on
# cuda:0; the router's merged envelopes equal the host's own oracle, and
# a killed host respawned with a higher seq_base is not eaten by dedup.
REMAINING_EBPF_SESSIONS = 2048
REMAINING_WIRE_SQL = "SELECT Sum(value) AS v, Count() AS c FROM deepflow_system WHERE metric = 'm'"
REMAINING_WIRE_STEPS = (4, 2)  # the host's steps, then its respawn's
REMAINING_WIRE_SEQ_BASE = 1000  # the respawned host's sequence floor
REMAINING_WIRE_WAIT_S = 120
REMAINING_WIRE_DEVICE = "cuda:0"  # the publisher host's subscriptions


def oracle_keys(doc_batches, meter_schema) -> dict:
    """{(window start, key tuple): meter row (int64)} of DocBatches."""
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA

    idx = [TAG_SCHEMA.index(f.name) for f in TAG_SCHEMA.fields if f.key]
    out = {}
    for db in doc_batches:
        for i in range(db.size):
            key = (int(db.timestamp[i]),) + tuple(int(db.tags[i, j]) for j in idx)
            check(key not in out, f"3r: key emitted twice {key}")
            row = np.asarray(db.meters[i], np.float64)
            check(np.all(row == np.round(row)) and np.all(np.abs(row) < 2 ** 24),
                  "3r: a meter is not an integer below 2^24")
            out[key] = row.astype(np.int64)
    return out


def check_against_oracle(emitted: dict, oracle: dict, meter_schema, what: str) -> int:
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA

    names = [f.name for f in TAG_SCHEMA.fields if f.key]
    want = {(d.window,) + tuple(d.tag[k] for k in names): d.meter for d in oracle.values()}
    check(set(emitted) == set(want) and len(want) > 0,
          f"3r: {what} keys: {len(set(emitted) - set(want))} only on the card, "
          f"{len(set(want) - set(emitted))} only in the oracle")
    for key, row in emitted.items():
        check(all(row[i] == want[key][f.name] for i, f in enumerate(meter_schema.fields)),
              f"3r: {what} meters differ from the oracle at {key}")
    return len(want)


def oracle_on_card(dev) -> dict:
    """(a): the conformance streams through the card's pipelines against
    the port's oracle, keys and meters exact."""
    from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, L7Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.batch import FlowBatch
    from deepflow_tpu_torch.datamodel.schema import APP_METER, FLOW_METER
    from deepflow_tpu_torch.ingest.replay import SyntheticAppGen, SyntheticFlowGen
    from deepflow_tpu_torch.oracle import oracle_l4_rollup, oracle_l7_rollup

    def run(pipe_cls, records_per_t, schema):
        pipe = pipe_cls(PipelineConfig(window=WindowConfig(interval=1, delay=2, capacity=1 << 14),
                                       batch_size=512), device=dev)
        out = []
        for recs in records_per_t:
            out += pipe.ingest(FlowBatch.from_records(recs, schema))
        return oracle_keys(out + pipe.drain(), schema)

    gen = SyntheticFlowGen(num_tuples=300, seed=2)
    l4 = [gen.records(n, t) for t, n in [(t, 200) for t in range(2000, 2006)] + [(2010, 1)]]
    gen7 = SyntheticAppGen(num_services=16, endpoints_per_service=4, seed=3)
    l7 = [gen7.records(200, t) for t in range(T0, T0 + 5)]
    return {
        "l4_docs": check_against_oracle(
            run(L4Pipeline, l4, FLOW_METER),
            oracle_l4_rollup([r for rs in l4 for r in rs], FanoutConfig()), FLOW_METER, "L4"),
        "l7_docs": check_against_oracle(
            run(L7Pipeline, l7, APP_METER),
            oracle_l7_rollup([r for rs in l7 for r in rs], FanoutConfig()), APP_METER, "L7"),
    }


def ebpf_events(n: int) -> list:
    """n HTTP sessions as socket events: a request (egress) and its
    response (ingress) each, 1 in 5 answered 503, over 8 seconds."""
    from deepflow_tpu_torch.agent.ebpf_bridge import SocketDataEvent

    out = []
    for k in range(n):
        t_us = (T0 + k * 8 // n) * 10 ** 6 + k
        kw = dict(pid=7 + k % 3, ip_src=0x0A000001 + k % 50, ip_dst=0x0A100000 + k % 7,
                  port_src=30000 + k, port_dst=80, protocol=6)
        out.append(SocketDataEvent(
            **kw, direction=0, timestamp_us=t_us, cap_seq=2 * k,
            payload=f"GET /api/{k % 12} HTTP/1.1\r\nHost: svc-{k % 7}\r\n\r\n".encode()))
        out.append(SocketDataEvent(
            **kw, direction=1, timestamp_us=t_us + 300 + 7 * (k % 100), cap_seq=2 * k + 1,
            payload=b"HTTP/1.1 503 Busy\r\n\r\n" if k % 5 == 4 else b"HTTP/1.1 200 OK\r\n\r\n"))
    return out


def ebpf_on_card(dev) -> dict:
    """(b): the dispatcher's sessions through L7Pipeline on the card and
    on the CPU (equal documents, every one tagged eBPF), and the same
    rows through L4Pipeline on the card (no document)."""
    from deepflow_tpu_torch.agent.ebpf_bridge import EbpfDispatcher
    from deepflow_tpu_torch.agent.l7.engine import L7Engine
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, L7Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.batch import FlowBatch
    from deepflow_tpu_torch.datamodel.code import SignalSource
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    disp = EbpfDispatcher(L7Engine())
    t = time.perf_counter()
    logs, app = disp.process(ebpf_events(REMAINING_EBPF_SESSIONS))
    dispatch_s = time.perf_counter() - t
    check(logs.size == REMAINING_EBPF_SESSIONS and disp.counters["sessions_out"] == logs.size,
          f"3r: the dispatcher paired {logs.size} of {REMAINING_EBPF_SESSIONS} sessions")
    cfg = PipelineConfig(window=WindowConfig(capacity=1 << 14), batch_size=1 << 13)

    def run(pipe_cls, device, batch):
        pipe = pipe_cls(cfg, device=device)
        return pipe.ingest(batch) + pipe.drain()

    card, host = run(L7Pipeline, dev, app), run(L7Pipeline, torch.device("cpu"), app)
    check(same_docs(card, host), "3r: eBPF app documents differ card vs CPU")
    docs = sum(d.size for d in card)
    sig = TAG_SCHEMA.index("signal_source")
    check(docs > 0 and all((d.tags[:, sig] == int(SignalSource.EBPF)).all() for d in card),
          "3r: the eBPF app documents are not all tagged eBPF")
    l4_rows = FlowBatch(tags=app.tags, valid=app.valid,
                        meters=np.zeros((len(app.valid), FLOW_METER.num_fields), np.float32))
    l4 = run(L4Pipeline, dev, l4_rows)
    check(sum(d.size for d in l4) == 0, "3r: eBPF rows reached the L4 plane")
    return {"sessions": logs.size, "events": 2 * REMAINING_EBPF_SESSIONS,
            "dispatch_s": dispatch_s, "app_docs": docs, "l4_docs": 0}


def spawn_wire_host(spec: dict, log_path: str) -> subprocess.Popen:
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    log = open(log_path, "w")
    try:
        return subprocess.Popen(
            [sys.executable, os.path.join(here, "tests", "torch_wire_host.py"), json.dumps(spec)],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def wire_host_record(path: str, proc, log_path: str) -> dict:
    deadline = time.time() + REMAINING_WIRE_WAIT_S
    while True:
        if os.path.exists(path):
            try:
                rec = json.load(open(path))
            except ValueError:  # the host rewrites it atomically; a race at most
                rec = {}
            if rec.get("flushed"):
                return rec
        check(proc.poll() is None and time.time() < deadline,
              f"3r: the wire host ended or hung: {open(log_path).read()[-3000:]}")
        time.sleep(0.05)


def check_envelopes(envelopes, oracle: list, seq_base: int, what: str) -> int:
    """Every per-host state the router fanned out equals the host's own
    subscription oracle at that seq."""
    checked = 0
    for env in envelopes:
        hs = env["hosts"]["hA"]
        i = hs["seq"] - seq_base - 1
        check(0 <= i < len(oracle), f"3r: {what} seq {hs['seq']} outside the oracle")
        check(json.loads(json.dumps(hs["series"])) == oracle[i]["series"]
              and hs["now"] == oracle[i]["now"], f"3r: {what} envelope {i} differs from the oracle")
        checked += 1
    check(checked > 0, f"3r: no {what} envelope to compare")
    return checked


def wire_fleet_pin(work: str) -> dict:
    """(c): the router, one host on cuda:0, a kill and a respawn."""
    from deepflow_tpu_torch.wire import FleetSubscriptionRouter

    router = FleetSubscriptionRouter(name="chip_smoke").start()
    procs, envelopes = [], []
    try:
        entry, w = router.watch({"kind": "sql", "query": REMAINING_WIRE_SQL})

        def drain():
            while (env := w.poll()) is not None:
                envelopes.append(env)

        def wait_for(cond, what):
            deadline = time.time() + REMAINING_WIRE_WAIT_S
            while True:
                drain()
                if cond():
                    return
                check(time.time() < deadline and all(p.poll() is None for p in procs[-1:]),
                      f"3r: waited for {what}; router {router.get_counters()}")
                time.sleep(0.02)

        def spec(seq_base, t0, steps, base):
            tag = f"hA.{seq_base}"
            return {"host": "hA", "router": list(router.endpoint), "seq_base": seq_base,
                    "t0": t0, "steps": steps, "value_base": base, "step_sleep_s": 0.05,
                    "alert_at": -1, "device": REMAINING_WIRE_DEVICE,
                    "out": os.path.join(work, f"{tag}.json"),
                    "stop_file": os.path.join(work, f"stop.{tag}")}

        first = spec(0, T0, REMAINING_WIRE_STEPS[0], 100.0)
        t = time.perf_counter()
        procs.append(spawn_wire_host(first, os.path.join(work, "host0.log")))
        rec0 = wire_host_record(first["out"], procs[0], os.path.join(work, "host0.log"))
        wait_for(lambda: any(e.get("type") == "result"
                             and e["hosts"]["hA"]["seq"] == REMAINING_WIRE_STEPS[0]
                             for e in envelopes), "the host's last result")
        first_s = time.perf_counter() - t
        check(rec0["evals"] == rec0["event_batches"] == REMAINING_WIRE_STEPS[0]
              and rec0["publisher"]["shed_frames"] == 0, f"3r: host record {rec0}")
        gen0 = [e for e in envelopes if e.get("type") == "result"]
        n0 = check_envelopes(gen0, rec0["oracle"], 0, "first host")
        procs[0].kill()
        procs[0].wait(timeout=30)
        wait_for(lambda: any(e.get("type") == "staleness" for e in envelopes),
                 "the staleness notice")
        second = spec(REMAINING_WIRE_SEQ_BASE, T0 + 100, REMAINING_WIRE_STEPS[1], 300.0)
        procs.append(spawn_wire_host(second, os.path.join(work, "host1.log")))
        last = REMAINING_WIRE_SEQ_BASE + REMAINING_WIRE_STEPS[1]
        rec1 = wire_host_record(second["out"], procs[1], os.path.join(work, "host1.log"))
        wait_for(lambda: any(e.get("type") == "result" and e["hosts"]["hA"]["seq"] == last
                             and not e["hosts"]["hA"]["stale"] for e in envelopes),
                 "the respawned host's results")
        gen1 = [e for e in envelopes if e.get("type") == "result"
                and e["hosts"]["hA"]["seq"] > REMAINING_WIRE_SEQ_BASE]
        n1 = check_envelopes(gen1, rec1["oracle"], REMAINING_WIRE_SEQ_BASE, "respawned host")
        c = router.get_counters()
        check(c["hosts_lost"] == 1 and c["hosts_recovered"] == 1 and c["dup_results"] == 0
              and entry.dup_results == 0 and n1 == REMAINING_WIRE_STEPS[1],
              f"3r: router counters {c}, respawned envelopes {n1}")
        open(second["stop_file"], "w").close()
        out, _ = procs[1].communicate(timeout=60)
        check(procs[1].returncode == 0, f"3r: the respawned host ended with {procs[1].returncode}")
        return {"envelopes": len(envelopes), "checked": n0 + n1, "first_host_s": first_s,
                "router": {k: c[k] for k in ("results_rx", "merged_evals", "dup_results",
                                             "hosts_lost", "hosts_recovered",
                                             "staleness_notices")}}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        router.stop()


def remaining_phase(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 3r. Counts zeroed before (a) and (b) and read after them;
    (c)'s host counts its own launches in its own process. Returns
    (launches, summary)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    reset_all_launch_counts()
    oracle = oracle_on_card(dev)
    ebpf = ebpf_on_card(dev)
    torch.cuda.synchronize()
    launches = all_launches()
    check(launches["segreduce_gather"] > 0 and launches["segreduce_sorted"] == 0
          and launches["sketch_fused"] == 0, f"3r launches {launches}")
    work = tempfile.mkdtemp(prefix="chip_smoke_3r_")
    try:
        wire = wire_fleet_pin(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, {"gpu": gpu, "oracle": oracle, "ebpf": ebpf, "wire_fleet": wire,
                      "launches": launches, "phase_s": time.perf_counter() - t_phase}


# phase 3m: the agent deployment (BASELINE configs 1 and 2: a single
# agent replaying a capture of 10,000 unique 5-tuples, HTTP + gRPC
# request logs with RED metrics). The capture is crafted here from a
# seed: 8,000 HTTP/1.1 keep-alive connections, 1,000 gRPC unary ones
# (HTTP/2 HEADERS + DATA in literal HPACK) and 1,000 DNS 5-tuples between
# 2,000 client and 200 server addresses, a request every ~3 s on each
# for 20 s of capture time starting 5 s before a minute boundary. The
# addresses are 3l's pods AGENT_POD0 … (the agent reports no EPC, so
# those pods sit in EPC 0), 1 in 20 outside the registry. Widths are
# the reference's defaults: FlowMap 2^16 rows, MinuteAggr 2^16 rows in
# 4 × 2^12-row batches, 2^12-packet batches, an l4 log throttle of
# 10,000; the metrics window holds 2^18 rows (the default 2^14 sheds at
# 10k flows).
AGENT_T0 = T0 + 35  # 55 s into its minute
AGENT_SECONDS = 20  # depth cut from 70 s for the command's time (PERF.md §4)
AGENT_HTTP = 8_000
AGENT_GRPC = 1_000
AGENT_DNS = 1_000
AGENT_CLIENTS = 2_000
AGENT_SERVERS = 200
AGENT_POD0 = 10_001
AGENT_PODS = 4_400  # the pool the capture draws its addresses from
AGENT_PERIOD_US = 3_000_000
AGENT_SEED = 7
AGENT_PROFILED = 4
AGENT_TABLES = (("flow_log", "l4_flow_log"), ("flow_log", "l7_flow_log"),
                ("flow_metrics", "network_1s"), ("flow_metrics", "network_1m"))
AGENT_SQL = (
    "SELECT server_port AS sp, Count() AS c, Sum(packet_tx) AS p, Sum(byte_rx) AS b, "
    "Max(rtt_max) AS r FROM network.1s GROUP BY server_port ORDER BY sp",
    "SELECT interval(time, 60) AS t, Count() AS c, Sum(packet_tx) AS p, Sum(retrans_tx) AS r "
    "FROM network.1m GROUP BY interval(time, 60) ORDER BY t",
    "SELECT server_port AS sp, Count() AS c, Sum(packet_tx) AS p, Sum(retrans_tx) AS r, "
    "Max(rtt) AS t FROM flow_log.l4_flow_log GROUP BY server_port ORDER BY sp",
    "SELECT l7_protocol AS p, status_code AS s, Count() AS c, Max(response_duration) AS d "
    "FROM flow_log.l7_flow_log GROUP BY l7_protocol, status_code ORDER BY p, s",
)


def _h2(ftype: int, flags: int, stream: int, body: bytes) -> bytes:
    return len(body).to_bytes(3, "big") + bytes([ftype, flags]) + stream.to_bytes(4, "big") + body


def _hpack_lit(name_idx: int, value: bytes) -> bytes:
    return bytes([0x40 | name_idx, len(value)]) + value


def agent_capture(scale: float = 1.0) -> dict:
    """The 3m capture: frames (ts_s, ts_us, bytes) in time order and the
    request count. `scale` shrinks the connection counts (a CPU
    rehearsal of the phase); 1.0 is the phase's."""
    from deepflow_tpu_torch.agent.packet import (TCP_ACK, TCP_FIN, TCP_PSH, TCP_RST, TCP_SYN,
                                                 craft_tcp, craft_udp)

    rng = np.random.default_rng(AGENT_SEED)
    n_http, n_grpc, n_dns = (max(1, int(x * scale)) for x in (AGENT_HTTP, AGENT_GRPC, AGENT_DNS))
    n_tcp, n = n_http + n_grpc, n_http + n_grpc + n_dns
    pods = AGENT_POD0 + rng.permutation(AGENT_PODS)[:AGENT_CLIENTS + AGENT_SERVERS]
    addr = (0x0B000000 + pods - 1).astype(np.int64)  # the pods' addresses (server_platform)
    outside = rng.random(len(addr)) < 0.05  # 1 in 20: 198.18.0.0/15, not registered
    addr = np.where(outside, 0xC6120000 + np.arange(len(addr)), addr)
    cli = addr[:AGENT_CLIENTS][rng.integers(0, AGENT_CLIENTS, n)]
    srv = addr[AGENT_CLIENTS:][rng.integers(0, AGENT_SERVERS, n)]
    sport = 20_000 + np.arange(n)
    start = AGENT_T0 * 1_000_000 + rng.integers(0, AGENT_PERIOD_US, n)
    end = (AGENT_T0 + AGENT_SECONDS) * 1_000_000
    rtt_c, rtt_s = rng.integers(200, 2_000, n), rng.integers(50, 500, n)
    close = rng.random(n)  # < 0.02: server RST; < 0.51: FIN; else left open
    grpc_hdr = b"\x83" + _hpack_lit(4, b"/shop.Cart/Get") + _hpack_lit(31, b"application/grpc")
    http_resp = {False: b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n",
                 True: b"HTTP/1.1 503 NA\r\nContent-Length: 0\r\n\r\n"}
    events = []  # (t_us, kind, conn, k)
    requests = 0
    for c in range(n):
        t = int(start[c])
        last = (end - t - 200_000) // AGENT_PERIOD_US
        if c >= n_tcp:
            events += [(t + 10_000 + k * AGENT_PERIOD_US, "q", c, k) for k in range(last)]
            requests += last
            continue
        events += [(t, "syn", c, 0), (t + int(rtt_c[c]), "synack", c, 0),
                   (t + int(rtt_c[c] + rtt_s[c]), "ack", c, 0)]
        if close[c] < 0.51 and last > 1:
            last = int(rng.integers(last // 2, last))
        requests += last
        for k in range(last):
            tk = t + 10_000 + k * AGENT_PERIOD_US + int(rng.integers(0, 100_000))
            events.append((tk, "req", c, k))
            events.append((tk + int(rng.integers(300, 5_000)), "resp", c, k))
            # 1 data segment in 100 is resent: 1 response in 50 (a resent
            # request would be a second request to the L7 engine, which
            # reassembles no stream: unanswered, it times out 30 s later
            # and its RED record falls behind the L7 window)
            if rng.random() < 0.02:
                events.append((tk + 200_000, "resp", c, k))
        t_end = t + 10_000 + last * AGENT_PERIOD_US
        if close[c] < 0.02:
            events.append((t_end, "rst", c, last))
        elif close[c] < 0.51:
            events += [(t_end, "fin_c", c, last), (t_end + 300, "fin_s", c, last)]
    events.sort()
    frames = []
    for t, kind, c, k in events:
        a, b, p = int(cli[c]), int(srv[c]), int(sport[c])
        if c >= n_tcp:  # DNS: query and response, 1 in 20 SERVFAIL
            q = (k & 0xFFFF).to_bytes(2, "big") + b"\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00" \
                + b"\x03api\x04shop\x00\x00\x01\x00\x01"
            r = q[:2] + (b"\x81\x82" if (c + k) % 20 == 0 else b"\x81\x80") + q[4:]
            frames.append((t // 1_000_000, t % 1_000_000, craft_udp(a, b, p, 53, q)))
            t2 = t + int(rtt_s[c])
            frames.append((t2 // 1_000_000, t2 % 1_000_000, craft_udp(b, a, 53, p, r)))
            continue
        grpc = c >= n_http
        dport = 50051 if grpc else 80
        bad = (c * 31 + k) % 20 == 0
        if grpc:  # one HTTP/2 stream a call
            sid = 2 * k + 1
            req = _h2(1, 4, sid, grpc_hdr) + _h2(0, 1, sid, b"\x00\x00\x00\x00\x04cart")
            resp = (_h2(1, 4, sid, (b"\x8e" if bad else b"\x88")
                        + _hpack_lit(31, b"application/grpc"))
                    + _h2(0, 1, sid, b"\x00\x00\x00\x00\x02ok"))
        else:
            req = b"GET /api/items/%04d HTTP/1.1\r\nHost: shop\r\n\r\n" % (c % 10_000)
            resp = http_resp[bad]
        cseq, sseq = 1001 + k * len(req), 5001 + k * len(resp)
        if kind == "syn":
            f = craft_tcp(a, b, p, dport, flags=TCP_SYN, seq=1000)
        elif kind == "synack":
            f = craft_tcp(b, a, dport, p, flags=TCP_SYN | TCP_ACK, seq=5000, ack=1001)
        elif kind == "ack":
            f = craft_tcp(a, b, p, dport, flags=TCP_ACK, seq=1001, ack=5001)
        elif kind == "req":
            f = craft_tcp(a, b, p, dport, flags=TCP_ACK | TCP_PSH, seq=cseq, ack=sseq, payload=req)
        elif kind == "resp":
            f = craft_tcp(b, a, dport, p, flags=TCP_ACK | TCP_PSH, seq=sseq, ack=cseq + len(req),
                          payload=resp)
        elif kind == "rst":
            f = craft_tcp(b, a, dport, p, flags=TCP_RST, seq=sseq)
        elif kind == "fin_c":
            f = craft_tcp(a, b, p, dport, flags=TCP_FIN | TCP_ACK, seq=cseq, ack=sseq)
        else:
            f = craft_tcp(b, a, dport, p, flags=TCP_FIN | TCP_ACK, seq=sseq, ack=cseq + 1)
        frames.append((t // 1_000_000, t % 1_000_000, f))
    frames.sort(key=lambda x: (x[0], x[1]))
    return {"frames": frames, "requests": requests, "connections": n_tcp, "udp": n_dns,
            "clients": AGENT_CLIENTS, "servers": AGENT_SERVERS, "outside": int(outside.sum())}


class CountingSender:
    """Counts the messages the agent sends and passes them on to a
    UniformSender."""

    def __init__(self, sender):
        self.sender = sender
        self.sent = 0

    def send(self, msgs) -> None:
        self.sent += len(msgs)
        self.sender.send(msgs)

    def close(self) -> None:
        self.sender.close(drain_timeout=120.0)


# the agent's device modules and the calls the CPU twin replays on them
AGENT_MODULES = {"flow_map": ("inject", "tick"), "flow_aggr": ("ingest", "drain"),
                 "metrics": ("ingest", "drain"), "l7_metrics": ("ingest", "drain")}
AGENT_PARTS = {("flow_map", "inject"): "flow_map_inject", ("flow_map", "tick"): "flow_map_tick",
               ("flow_aggr", "ingest"): "minute_aggr", ("flow_aggr", "drain"): "minute_aggr",
               ("metrics", "ingest"): "pipelines_ingest", ("metrics", "drain"): "pipelines_ingest",
               ("l7_metrics", "ingest"): "pipelines_ingest",
               ("l7_metrics", "drain"): "pipelines_ingest", ("l7", "process"): "l7_engine"}


class CardGate:
    """Gives each profiled agent part the card to itself: the server's
    enrichment calls (`gated`) wait while a profile is on, and a profile
    (`exclusive`) waits for the calls in flight — torch.profiler records
    every thread's kernels and copies."""

    def __init__(self):
        self.cond = threading.Condition()
        self.busy = 0
        self.profiling = False

    def gated(self, fn):
        def call(*a):
            with self.cond:
                self.cond.wait_for(lambda: not self.profiling)
                self.busy += 1
            try:
                return fn(*a)
            finally:
                with self.cond:
                    self.busy -= 1
                    self.cond.notify_all()

        return call

    @contextlib.contextmanager
    def exclusive(self):
        with self.cond:
            self.profiling = True
            self.cond.wait_for(lambda: self.busy == 0)
        try:
            yield
        finally:
            with self.cond:
                self.profiling = False
                self.cond.notify_all()


def tap_agent(agent, profile_steps, gate):
    """Record every call of the agent's device modules — FlowMap's
    inject / tick, MinuteAggr's and both pipelines' ingest / drain — with
    its arguments and result (and FlowMap's fetches per call), the step
    times, and profile each part of the `profile_steps` steps on the card
    (one profiler session per call, inside `gate.exclusive()`; the L7
    engine's host time too). Returns the record."""
    rec = {"ts": [], "calls": {m: [] for m in AGENT_MODULES}, "inject_fetches": [],
           "tick_fetches": [], "profiles": {}}
    step_no = [-1]

    def wrap(module: str, name: str):
        obj = getattr(agent, module)
        orig = getattr(obj, name)
        part = AGENT_PARTS[(module, name)]

        def call(*a):
            f0 = agent.flow_map.host_fetches
            if step_no[0] in profile_steps:
                box = []
                with gate.exclusive():
                    prof = profile_cycle(lambda: box.append(orig(*a)))
                rec["profiles"].setdefault(step_no[0], {}).setdefault(part, []).append(prof)
                out = box[0]
            else:
                out = orig(*a)
            if module in rec["calls"]:
                rec["calls"][module].append((name, a, out))
            if module == "flow_map":
                rec[f"{name}_fetches"].append(agent.flow_map.host_fetches - f0)
            return out

        setattr(obj, name, call)

    for module, names in AGENT_MODULES.items():
        for name in names:
            wrap(module, name)
    wrap("l7", "process")
    orig_step = type(agent).step

    def step(buf, lengths, ts_s, ts_us):
        step_no[0] += 1
        rec["ts"].append(int(np.max(ts_s)))
        return orig_step(agent, buf, lengths, ts_s, ts_us)

    agent.step = step
    return rec


def floats_agree(x, y) -> bool:
    """Integer-valued floats below 2^24 bit for bit, the rest within rtol
    1e-5."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape != y.shape:
        return False
    exact = (np.abs(y) < 2 ** 24) & (y == np.round(y))
    return (np.array_equal(x[exact], y[exact])
            and np.allclose(x[~exact], y[~exact], rtol=SUM_RTOL, atol=0))


def same_output(a, b) -> int:
    """One module call's result card = CPU — a FlowLogBatch, a DocBatch,
    a (flags, DocBatch) pair or a list of them, None — as the rows it
    holds (-1 when they differ): ints, tags and times exact, floats by
    `floats_agree`."""
    if isinstance(a, tuple):  # (flags, DocBatch)
        return same_output(a[1], b[1]) if int(a[0]) == int(b[0]) else -1
    if isinstance(a, list):
        if len(a) != len(b):
            return -1
        rows = [same_output(x, y) for x, y in zip(a, b)]
        return -1 if -1 in rows else sum(rows)
    if a is None:
        return 0 if b is None else -1
    if hasattr(a, "ints"):  # FlowLogBatch
        ok = np.array_equal(a.ints, b.ints) and floats_agree(a.nums, b.nums)
    else:  # DocBatch
        ok = (np.array_equal(a.timestamp, b.timestamp) and np.array_equal(a.tags, b.tags)
              and floats_agree(a.meters, b.meters))
    return a.size if ok else -1


def agent_card_run(dev, state, path: str, root: str, n_steps: int, pool) -> dict:
    """Agent(device=dev).run_pcap over localhost TCP into Receiver →
    FlowMetricsIngester + FlowLogIngester over one store. Launch counts
    are zeroed just before run_pcap and read after its drain. The CPU
    twin (`agent_cpu_twin`) starts on `pool` once run_pcap has returned,
    while the server is still ingesting."""
    from deepflow_tpu_torch.agent.main import Agent, AgentConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.flowlog import server as fl_server
    from deepflow_tpu_torch.flowlog.server import FlowLogIngester
    from deepflow_tpu_torch.server import flow_metrics
    from deepflow_tpu_torch.ingest.framing import MessageType
    from deepflow_tpu_torch.ingest.receiver import Receiver
    from deepflow_tpu_torch.ingest.sender import UniformSender
    from deepflow_tpu_torch.server.flow_metrics import FlowMetricsIngester
    from deepflow_tpu_torch.server.metrics_tables import DocStoreWriter
    from deepflow_tpu_torch.storage.store import ColumnarStore

    recv = Receiver()
    recv.start()
    store = ColumnarStore(root)
    writer = DocStoreWriter(store)
    tee = TeeWriter(writer)
    metrics_ing = FlowMetricsIngester(recv, tee, platform_state=state, n_workers=4,
                                      queue_capacity=1 << 15, enrich_chunk=SERVER_CHUNK)

    class RecordingIngester(FlowLogIngester):
        """Keeps every sampled batch it writes (for the CPU twin)."""

        def __init__(self, *a, **kw):
            self.emitted, self.emit_lock = [], threading.Lock()
            super().__init__(*a, **kw)

        def _emit(self, mt, sampled, org):
            with self.emit_lock:
                self.emitted += [(mt, org, b) for b in sampled]
            super()._emit(mt, sampled, org)

    log_ing = RecordingIngester(recv, store, platform_state=state, queue_capacity=1 << 16)
    gate = CardGate()
    enrich_fns = {mod: mod.enrich_chunk_host for mod in (flow_metrics, fl_server)}
    for mod, fn in enrich_fns.items():
        mod.enrich_chunk_host = gate.gated(fn)
    mts = (MessageType.METRICS, MessageType.TAGGEDFLOW, MessageType.PROTOCOLLOG)
    cfg = AgentConfig(servers=(("127.0.0.1", recv.tcp_port),), flow_capacity=1 << 16,
                      batch_size=1 << 12, l4_log_throttle=10_000,
                      metrics_window=WindowConfig(capacity=STASH_CAPACITY))
    senders = {mt: CountingSender(UniformSender(list(cfg.servers), mt, agent_id=cfg.agent_id,
                                           organization_id=cfg.organization_id,
                                           compression=cfg.compression, queue_capacity=1 << 21))
               for mt in mts}
    try:
        agent = Agent(cfg, senders=senders, device=dev)
        mid = n_steps // 2
        rec = tap_agent(agent, profile_steps=range(mid, mid + AGENT_PROFILED), gate=gate)
        torch.cuda.synchronize()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        counters = agent.run_pcap(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        twin = pool.submit(agent_cpu_twin, agent, rec)
        agent.close()
        tx = {MessageType(mt).name: s.sender.get_counters() for mt, s in senders.items()}
        check(all(c["dropped"] == 0 and c["shutdown_shed_msgs"] == 0 for c in tx.values()),
              f"3m: a sender shed messages {tx}")
        sent = {MessageType(mt).name: s.sent for mt, s in senders.items()}
        n_logs = sent["TAGGEDFLOW"] + sent["PROTOCOLLOG"]
        deadline = time.time() + 600
        while True:
            c, lc = metrics_ing.get_counters(), log_ing.get_counters()
            if (c["docs_in"] == sent["METRICS"]
                    and c["docs_written"] + c["drop_other_region"] == sent["METRICS"]
                    and writer.counters["rows"] == c["docs_written"]
                    and lc["rows_in"] == n_logs and lc["rows_written"] == n_logs):
                break
            check(time.time() < deadline, f"3m: the server did not settle {c} {lc} {sent}")
            time.sleep(0.01)
        server_s = time.perf_counter() - t0
        drain_writer(writer)
        log_ing.flush()
        for w in list(log_ing._writers.values()):
            check(w.get_counters()["write_fail"] == 0, "3m: flow-log store writes failed")
        metrics_counters, log_counters = metrics_ing.get_counters(), log_ing.get_counters()
    finally:
        metrics_ing.stop()
        log_ing.stop()
        writer.stop()
        recv.stop()
        for mod, fn in enrich_fns.items():
            mod.enrich_chunk_host = fn
    return {"agent": agent, "rec": rec, "counters": counters, "wall_s": wall, "server_s": server_s,
            "launches": launches, "twin": twin, "sent": sent, "store": store,
            "metric_batches": tee.batches,
            "log_batches": log_ing.emitted, "metrics_ingest": metrics_counters,
            "log_ingest": log_counters, "senders": tx}


def agent_cpu_twin(agent, rec: dict) -> dict:
    """The agent's device modules again, on the CPU: each module of a CPU
    Agent of the same config takes the calls the card run recorded — the
    packet batches and tick times FlowMap took, the emissions MinuteAggr
    and the metrics pipeline took, the L7 app batches — in their order,
    and each result must equal the card's. The host parsers and the
    L7 engine are not run again. The four modules replay in threads of
    their own (their tensor work releases the GIL). Returns per module
    the calls and rows compared and the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    from deepflow_tpu_torch.agent.main import Agent

    twin = Agent(agent.config, senders={}, device="cpu")

    def replay(module: str) -> dict:
        obj = getattr(twin, module)
        t0 = time.perf_counter()
        rows = 0
        for i, (name, args, want) in enumerate(rec["calls"][module]):
            got = same_output(getattr(obj, name)(*args), want)
            check(got >= 0, f"3m: {module}.{name} call {i} differs card vs CPU")
            rows += got
        return {"calls": len(rec["calls"][module]), "rows": rows,
                "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(rec["calls"])) as threads:
        out = dict(zip(rec["calls"], threads.map(replay, rec["calls"])))
    out["wall_s"] = time.perf_counter() - t0
    check(twin.flow_map.get_counters() == agent.flow_map.get_counters(),
          "3m: FlowMap counters differ card vs CPU")
    check(twin.flow_aggr.get_counters() == agent.flow_aggr.get_counters(),
          "3m: MinuteAggr counters differ card vs CPU")
    return out


def write_log_twin(batches, host_state, store) -> None:
    """The card ingester's sampled flow-log batches enriched again on the
    CPU and written as the ingester writes them."""
    from deepflow_tpu_torch.flowlog import server as fl_server
    from deepflow_tpu_torch.ingest.framing import MessageType
    from deepflow_tpu_torch.server.flow_metrics import enrich_chunk_host
    from deepflow_tpu_torch.storage.store import org_db
    from deepflow_tpu_torch.storage.writer import TableWriter

    writers = {}
    try:
        for mt, org, b in batches:
            schema = fl_server.L4_FLOW_LOG if mt == MessageType.TAGGEDFLOW else fl_server.L7_FLOW_LOG
            tags, valid, _n = fl_server._tags_for_enrich(b)
            s0, s1, _keep, _drops = enrich_chunk_host(host_state, tags, valid)
            key = (org, schema.name)
            if key not in writers:
                writers[key] = TableWriter(store, org_db(fl_server.FLOW_LOG_DB, org),
                                           fl_server.log_table_schema(schema))
            writers[key].put(fl_server.log_batch_to_columns(b, s0, s1))
        for w in writers.values():
            w.flush()
            check(w.get_counters()["write_fail"] == 0, "3m: twin flow-log writes failed")
    finally:
        for w in writers.values():
            w.stop()


def same_stores(card_store, cpu_store, tables) -> dict:
    rows = {}
    for db, t in tables:
        a, b = card_store.scan(db, t), cpu_store.scan(db, t)
        check(np.array_equal(rows_multiset(a), rows_multiset(b))
              and strings_of(card_store, db, t) == strings_of(cpu_store, db, t),
              f"3m: stored rows of {db}.{t} differ card vs CPU")
        rows[f"{db}.{t}"] = len(next(iter(a.values())))
    return rows


def agent_phase(dev, gpu: str, plat: dict):
    """Phase 3m: the agent deployment on the card, counts zeroed before
    its main path (run_pcap and its drain) and read after. Returns
    (launches, summary)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.agent.pcap import write_pcap
    from deepflow_tpu_torch.datamodel.code import MeterId
    from deepflow_tpu_torch.flowlog.oracle import batches_to_dict, minute_merge_oracle
    from deepflow_tpu_torch.flowlog.schema import L4_FLOW_LOG
    from deepflow_tpu_torch.querier import QueryEngine
    from deepflow_tpu_torch.storage.store import ColumnarStore

    t_phase = time.perf_counter()
    cap = agent_capture()
    t_craft = time.perf_counter() - t_phase
    n_packets = len(cap["frames"])
    n_steps = -(-n_packets // (1 << 12))
    state = convert.platform_state_from_numpy(plat, dev)
    host_state = convert.platform_state_from_numpy(plat, "cpu")
    work = tempfile.mkdtemp(prefix="chip_smoke_agent_")
    try:
        path = os.path.join(work, "agent.pcap")
        write_pcap(path, cap.pop("frames"))
        pcap_bytes = os.path.getsize(path)
        with ThreadPoolExecutor(1) as pool:
            card = agent_card_run(dev, state, path, os.path.join(work, "card"), n_steps, pool)
            # 1. card = CPU on the device modules (the twin ran beside the server)
            twin = card["twin"].result()
        launches = card["launches"]
        check(launches["segreduce_gather"] > 0 and launches["segreduce_sorted"] == 0
              and launches["sketch_fused"] == 0, f"3m: agent path launches {launches}")
        rec, agent = card["rec"], card["agent"]
        check(card["counters"]["packets"] == n_packets and len(rec["ts"]) == n_steps,
              f"3m: {card['counters']} for {n_packets} packets")
        emissions = [out for name, _a, out in rec["calls"]["flow_map"] if name == "tick"]
        minutes = [b for _n, _a, out in rec["calls"]["flow_aggr"] for b in out]

        # 2. the fetch budget; 3. no drop anywhere
        check(max(rec["inject_fetches"]) == 0 and max(rec["tick_fetches"]) <= 2,
              "3m: FlowMap fetch budget")
        fm, fa = agent.flow_map.get_counters(), agent.flow_aggr.get_counters()
        pipes = {"metrics": agent.metrics.counters["second"], "l7": agent.l7_metrics.counters}
        drops = {"flow_map": fm["dropped_overflow"], "minute_aggr": fa["dropped_overflow"],
                 "minute_late": fa["drop_before_window"],
                 **{f"{p}.{k}": v for p, c in pipes.items() for k, v in c.items()
                    if k.startswith("drop_") or k.endswith(("_shed", "_dropped"))}}
        check(not any(drops.values()), f"3m: drops {drops}")

        # 2. the minute logs are the oracle's merge of the tick emissions
        want = minute_merge_oracle(L4_FLOW_LOG, emissions)
        got = batches_to_dict(L4_FLOW_LOG, minutes)
        check(got.keys() == want.keys(), "3m: minute logs' keys differ from the oracle's")
        for fields, exact in ((L4_FLOW_LOG.ints, True), (L4_FLOW_LOG.nums, False)):
            g, w = (np.array([[d[k][f.name] for f in fields] for k in want], np.float64)
                    for d in (got, want))
            check(np.array_equal(g, w) if exact else floats_agree(g, w),
                  "3m: minute logs differ from the oracle's merge")

        # 5. the stores: card = the CPU twin on the four tables, and one
        # SQL statement a table (the twin enriches the FLOW docs again)
        t_verify = time.perf_counter()
        flow = [b for b in card["metric_batches"] if b.decoded.meter_id == int(MeterId.FLOW)]
        cpu_store = cpu_twin(flow, host_state, os.path.join(work, "cpu"))["store"]
        write_log_twin(card["log_batches"], host_state, cpu_store)
        stored = same_stores(card["store"], cpu_store, AGENT_TABLES)
        check(min(stored.values()) > 0, f"3m: a table is empty {stored}")
        card_eng = QueryEngine(card["store"], cache=False, device=dev)
        cpu_eng = QueryEngine(cpu_store, cache=False, device="cpu")
        for sql in AGENT_SQL:
            res = card_eng.execute(sql)
            check(res.rows > 0, f"3m: no rows from {sql}")
            same_result(res, cpu_eng.execute(sql), sql)
        verify_s = time.perf_counter() - t_verify
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def part_sum(profs, f):
        return sum(p[f] for p in profs)

    steps = {}
    for s, parts in sorted(rec["profiles"].items()):
        steps[s] = {}
        for part, profs in parts.items():
            wall, busy = part_sum(profs, "wall_ms"), part_sum(profs, "device_busy_ms")
            steps[s][part] = {"calls": len(profs), "wall_ms": wall, "device_ms": busy,
                              "idle_share": (1 - busy / wall) if wall else None,
                              "launches": part_sum(profs, "kernel_launches"),
                              "copies": {d: sum(p["copies"][d] for p in profs)
                                         for d in ("DtoH", "HtoD")}}
    summary = {
        "gpu": gpu, "packets": n_packets, "pcap_bytes": pcap_bytes, "steps": n_steps,
        **{k: cap[k] for k in ("requests", "connections", "udp", "clients", "servers", "outside")},
        "run_pcap_s": card["wall_s"], "packets_per_s": n_packets / card["wall_s"],
        "requests_per_s": cap["requests"] / card["wall_s"],
        "until_stored_s": card["server_s"], "agent_counters": card["counters"],
        "flow_map": fm, "minute_aggr": fa, "card_vs_cpu": twin, "messages": card["sent"],
        "fetches": {"per_inject_max": max(rec["inject_fetches"]),
                    "per_tick_max": max(rec["tick_fetches"]),
                    "per_tick_mean": statistics.mean(rec["tick_fetches"])},
        "stored_rows": stored, "docs_written": card["metrics_ingest"]["docs_written"],
        "metrics_ingest": card["metrics_ingest"], "log_ingest": card["log_ingest"],
        "profiled_steps": steps, "launches": launches,
        "cpu_twin_s": twin["wall_s"], "verify_stores_s": verify_s, "craft_s": t_craft,
        "phase_s": time.perf_counter() - t_phase,
    }
    return launches, summary


# ---------------------------------------------------------------------------
# 3n. self-observability: the standalone sketch functions, the multi-sort
# oracle, the device-memory ledger against the allocator, the dogfood
# loop into deepflow_system, telemetry() and provenance

SELFOBS_SECONDS = [34, 35, 36, 37]  # 3f's first seconds: two advances, a tier-0 step each
SELFOBS_SHARDED_SECONDS = [34, 35, 37]
FLOAT_RTOL = 1e-5
# The reference's bytes per plane of 3n's ledger pipeline (3f's config
# after SELFOBS_SECONDS: both tier rings are sized at the first advance),
# read from the reference's own WindowManager.device_planes() through its
# plane_bytes by tests/test_torch_profiling.py::
# test_reference_plane_bytes_of_selfobs (the card has no JAX).
REF_PLANE_BYTES_3N = {"stash": 104071172, "accumulator": 103809024, "sketch": 19415160,
                      "cascade": 623378456, "lanes": 20}
# The caching allocator's block rule (c10/core/AllocatorConfig.h): a
# request is rounded up to kMinBlockSize; a cached block larger than that
# is split only when the remainder is at least kMinBlockSize (the small
# pool, requests up to kSmallSize) or more than kSmallSize (the large
# pool). So a block exceeds its request by at most the rounding plus 511 B
# (small) or plus 1 MiB (large).
K_MIN_BLOCK_SIZE = 512
K_SMALL_SIZE = 1 << 20
# CUDA tensors 3n's ledger pipeline may allocate outside its planes: the
# sketch kernel's scratch tables, made at the first call at a shape
# (earlier phases have usually made them already).
NON_PLANE_TENSORS = ("sketch_fused._TABLES",)


def sketch_fn_results(dev, hist_in=None) -> tuple[dict, dict, torch.Tensor]:
    """The standalone sketch functions on `dev`, at tests/test_sketches.py's
    sizes (HLL 200,000 draws of 100,000 ids; count-min 50,000 Zipf keys at
    4 × 2^14; log-histogram 100,000 lognormal values in 1024 bins) and at
    the production plane widths (HLL precision 14; count-min 4 × 2^16;
    top-K 2 × 1024 in a 4-slot ring over three 50,000-row batches):
    init, update, merge and estimate / query / quantiles, t-digests from
    the histogram, of raw values and their merge. Returns (integer
    results, float results, the histogram). The histogram's downstream
    functions read `hist_in` when given (the CPU's histogram: CUDA logf
    may move a value to an adjacent bin, phase 4b)."""
    from deepflow_tpu_torch.ops import cms, histogram, hll, tdigest, topk
    from deepflow_tpu_torch.ops.u32 import from_numpy_u32

    rng = np.random.default_rng(11)
    u32 = lambda x: from_numpy_u32(np.asarray(x, np.uint32), dev)
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    ints, floats = {}, {}
    ids = rng.integers(0, 100_000, 200_000).astype(np.uint64)
    hi, lo = u32((ids * 2654435761) & 0xFFFFFFFF), u32((ids * 40503 + 7) ^ 0x9E3779B9)
    gid, valid = t(np.arange(200_000) % 4), t(rng.random(200_000) > 0.05)
    a = hll.hll_update(hll.hll_init(4, 14, device=dev), gid, hi, lo, valid)
    b = hll.hll_update(hll.hll_init(4, 14, device=dev), gid, lo, hi, valid)
    ints["hll"] = hll.hll_merge(a, b)
    floats["hll_estimate"] = hll.hll_estimate(ints["hll"])
    keys = (rng.zipf(1.3, 50_000) % 1000).astype(np.uint64)
    k_hi, k_lo = u32((keys * 2654435761 + 1) & 0xFFFFFFFF), u32(keys ^ 0x9E3779B9)
    w = t(rng.integers(1, 50, 50_000).astype(np.int32))
    kv = t(rng.random(50_000) > 0.05)
    for width in (1 << 14, 1 << 16):
        plane = cms.cms_update(cms.cms_init(4, width, device=dev), k_hi, k_lo, w, kv)
        plane = cms.cms_merge(plane, cms.cms_update(cms.cms_init(4, width, device=dev), k_lo,
                                                    k_hi, w, kv))
        ints[f"cms_{width}"] = plane
        ints[f"cms_query_{width}"] = cms.cms_query(plane, k_hi, k_lo)
    spec = histogram.LogHistSpec(bins=1024, vmin=1.0, gamma=1.02)
    vals = t(rng.lognormal(6.0, 1.5, 100_000).astype(np.float32))
    hg, hv = t(rng.integers(0, 4, 100_000)), t(rng.random(100_000) > 0.05)
    hist = histogram.loghist_update(histogram.loghist_init(4, spec, device=dev), hg, vals, hv,
                                    spec)
    hist = histogram.loghist_merge(hist, hist)
    h = hist if hist_in is None else hist_in.to(dev)
    floats["loghist_quantiles"] = histogram.loghist_quantiles(h, spec, (0.5, 0.95, 0.99))
    m, wt = tdigest.tdigest_from_loghist(h, spec)
    floats.update(tdigest_means=m, tdigest_weights=wt)
    raw = [tdigest.tdigest_compress(t(rng.gamma(2.0, 300.0, 20_000).astype(np.float32)),
                                    torch.ones(20_000, device=dev), compression=100)
           for _ in range(2)]
    mm, mw = tdigest.tdigest_merge(*raw[0], *raw[1], compression=100)
    qs = torch.tensor([0.01, 0.5, 0.9, 0.99], device=dev)
    floats.update(merged_means=mm, merged_weights=mw,
                  merged_quantiles=tdigest.tdigest_quantile(mm, mw, qs),
                  hist_quantiles=tdigest.tdigest_quantile(m[0], wt[0], qs))
    lanes = topk.topk_init(2, 1024, 4, device=dev)
    for _ in range(3):
        kid = (rng.zipf(1.2, 50_000) % 20_000).astype(np.uint64)
        lanes = topk.topk_update(
            lanes, t(rng.integers(-1, 5, 50_000)), u32((kid * 2654435761 + 1) & 0xFFFFFFFF),
            u32(kid ^ 0x9E3779B9), u32(kid), u32(rng.integers(0, 2 ** 32, 50_000)),
            t(rng.integers(0, 900, 50_000).astype(np.int32)), t(rng.random(50_000) > 0.1))
    ints.update({f"topk_{k}": x for k, x in zip(("votes", "hi", "lo", "ia", "ib"), lanes)})
    return ints, floats, hist


def hist_moves(card: torch.Tensor, host: torch.Tensor) -> int:
    """Counts a histogram moved between bins card against CPU (4b's
    rule): group totals equal, and a count only moves to an adjacent bin
    (the prefix sums of the difference then add up to exactly half its
    L1 norm)."""
    d = (card.cpu() - host).numpy().astype(np.int64)
    check(np.array_equal(d.sum(axis=1), np.zeros(d.shape[0])),
          "3n: log-histogram group totals differ card vs CPU")
    crossings = int(np.abs(np.cumsum(d, axis=1)).sum())
    check(2 * crossings == int(np.abs(d).sum()),
          "3n: a histogram count moved further than one bin card vs CPU")
    return crossings


def sketch_fns_card_vs_cpu(dev) -> dict:
    host_i, host_f, host_h = sketch_fn_results(torch.device("cpu"))
    card_i, card_f, card_h = sketch_fn_results(dev, hist_in=host_h)
    for k, v in host_i.items():
        check(torch.equal(card_i[k].cpu(), v), f"3n: {k} differs card vs CPU")
    err = 0.0
    for k, v in host_f.items():
        c = card_f[k].cpu()
        check(c.shape == v.shape and bool(torch.isfinite(c).all()), f"3n: {k} shape/finite")
        rel = ((c - v).abs() / v.abs().clamp(min=1e-30)).max().item() if v.numel() else 0.0
        check(rel <= FLOAT_RTOL, f"3n: {k} rel err {rel} > {FLOAT_RTOL}")
        err = max(err, rel)
    return {"integer_lanes_exact": len(host_i), "float_results": len(host_f),
            "float_max_rel_err": err, "hist_counts_moved": hist_moves(card_h, host_h)}


def selfobs_pipeline(dev, sk_cfg, cascade=None):
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig

    return L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES, delay=DELAY,
                            sketch=sk_cfg, cascade=cascade),
        batch_size=BATCH, batch_unique_cap=UNIQUE_CAP), device=dev)


def oracle_runs(dev, batches, sk_cfg) -> tuple[dict, list]:
    """3c's slab L4Pipeline over `batches` and a drain with
    DEEPFLOW_SHARED_SORT=0 (the multi-sort oracle) and =1: identical
    windows and sketch blocks; the census reads the plane's sorts."""
    runs = {}
    for knob in ("0", "1"):
        os.environ["DEEPFLOW_SHARED_SORT"] = knob
        before = all_launches()
        pipe = selfobs_pipeline(dev, sk_cfg)
        docs = [db for fb in batches for db in pipe.ingest(fb)] + pipe.drain()
        torch.cuda.synchronize()
        (row,) = pipe.profile_snapshot()["census"]
        runs[knob] = {"docs": docs, "blocks": pipe.pop_closed_sketches(), "census": row,
                      "launches": {k: v - before[k] for k, v in all_launches().items()}}
        pipe.close()
    os.environ["DEEPFLOW_SHARED_SORT"] = "1"
    oracle, shared = runs["0"], runs["1"]
    check(same_docs(oracle["docs"], shared["docs"]), "3n: oracle windows differ")
    check(len(shared["blocks"]) == len(SELFOBS_SECONDS)
          and same_blocks(oracle["blocks"], shared["blocks"]), "3n: oracle sketch blocks differ")
    rows = sk_cfg.topk_rows
    check(oracle["census"]["plane_sorts"] == 2 * rows and shared["census"]["plane_sorts"] == 1,
          f"3n: plane sorts {oracle['census']} / {shared['census']}")
    check(oracle["launches"]["sketch_fused"] == 0 and shared["launches"]["sketch_fused"] > 0,
          "3n: sketch_fused launches (oracle none, shared sort some)")
    summary = {k: {"census": r["census"], "sketch_fused_launches": r["launches"]["sketch_fused"],
                   "segreduce_gather_launches": r["launches"]["segreduce_gather"]}
               for k, r in (("oracle", oracle), ("shared_sort", shared))}
    return summary, shared["blocks"]


def active_blocks() -> dict:
    """The caching allocator's allocated blocks: address → (block bytes,
    requested bytes, pool "small" or "large")."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                out[addr] = (b["size"], b["requested_size"], seg["segment_type"])
            addr += b["size"]
    return out


def block_slack(requested: int, pool: str) -> int:
    """The most a block of `pool` may exceed a request of `requested`
    bytes under the allocator's rounding and split rule."""
    rounded = -(-max(requested, 1) // K_MIN_BLOCK_SIZE) * K_MIN_BLOCK_SIZE
    unsplit = K_SMALL_SIZE if pool == "large" else K_MIN_BLOCK_SIZE - 1
    return rounded - requested + unsplit


def shard_part(tree, d: int):
    """Shard d's part of a ShardedWindowManager plane, whose trees hold
    one entry a shard in every list of SHARDS entries."""
    if isinstance(tree, list):
        return tree[d] if len(tree) == SHARDS else [shard_part(x, d) for x in tree]
    return tree


def storage_bytes(tree) -> int:
    """The summed sizes of the distinct storages of a plane tree."""
    from deepflow_tpu_torch.profiling.ledger import plane_tensors

    return sum({x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                for x in plane_tensors(tree)}.values())


def tensor_names(roots: dict, depth: int = 8) -> dict:
    """storage address → the attribute path of a CUDA tensor reachable
    from `roots` (the port's objects, dicts, lists, tuples, dataclasses)."""
    out, seen, queue = {}, set(), list(roots.items())
    for path, x in queue:  # grows while it is walked: breadth first
        if id(x) in seen or path.count(".") + path.count("[") > depth:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                out.setdefault(x.untyped_storage().data_ptr(), path)
        elif isinstance(x, dict):
            queue += [(f"{path}[{k!r}]", v) for k, v in x.items()]
        elif isinstance(x, (list, tuple)):
            queue += [(f"{path}[{i}]", v) for i, v in enumerate(x)]
        elif type(x).__module__.startswith("deepflow_tpu_torch") and hasattr(x, "__dict__"):
            queue += [(f"{path}.{k}", v) for k, v in vars(x).items()]
    return out


def ledger_on_card(dev, batches, sk_cfg) -> tuple[object, object, dict]:
    """3f's L4Pipeline (slab plane, minute + hour cascade, 2^18-row
    stashes) built on a collected, emptied cache and fed `batches`: the
    ledger's bytes against the allocator's. Returns (pipeline, ledger,
    summary)."""
    import gc

    from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
    from deepflow_tpu_torch.ops import sketch_fused
    from deepflow_tpu_torch.profiling import DeviceMemoryLedger
    from deepflow_tpu_torch.profiling.ledger import plane_tensors

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks0, alloc0 = active_blocks(), torch.cuda.memory_allocated()
    pipe = selfobs_pipeline(dev, sk_cfg, CascadeConfig(intervals=CASCADE_INTERVALS,
                                                       capacity=STASH_CAPACITY))
    for fb in batches:
        pipe.ingest(fb)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - alloc0
    led = DeviceMemoryLedger()
    led.register("window_manager", pipe.wm)
    f0, rows = pipe.wm.host_fetches, []
    trace = profile_cycle(lambda: rows.extend(led.snapshot()))
    check(pipe.wm.host_fetches == f0 and trace["copies"]["DtoH"] == 0,
          f"3n: a ledger snapshot fetched ({pipe.wm.host_fetches - f0}, {trace['copies']})")
    total = sum(r["bytes"] for r in rows)
    blocks1 = active_blocks()
    new = {a: b for a, b in blocks1.items() if blocks0.get(a) != b}
    freed = sum(b[0] for a, b in blocks0.items() if blocks1.get(a) != b)
    check(sum(b[0] for b in new.values()) - freed == delta,
          "3n: allocator blocks do not add up to the delta")
    storages = {}
    for tree in pipe.wm.device_planes().values():
        for x in plane_tensors(tree):
            check(x.is_cuda, "3n: a plane tensor is not on the card")
            if x.untyped_storage().nbytes():  # empty lanes own no block
                storages[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
    check(sum(storages.values()) == total, "3n: the ledger's bytes are not its storages'")
    check(all(p in new for p in storages), "3n: a plane storage predates the pipeline")
    # each plane block: asked for exactly its storage, and no larger than
    # the allocator's rule allows
    slack = 0
    for p, n in storages.items():
        size, requested, pool = new[p]
        check(requested == n, f"3n: plane block at {p:#x} asked for {requested} B, holds {n} B")
        check(size - n <= block_slack(n, pool),
              f"3n: plane block at {p:#x} is {size} B for {n} B ({pool} pool), past the "
              f"allocator's {block_slack(n, pool)} B")
        slack += block_slack(n, pool)
    names = tensor_names({"pipe": pipe, "sketch_fused._TABLES": sketch_fused._TABLES})
    others = {names.get(a, f"unnamed block at {a:#x}"): b[0] for a, b in new.items()
              if a not in storages}
    unexpected = {k: v for k, v in others.items() if not k.startswith(NON_PLANE_TENSORS)}
    check(not unexpected, f"3n: blocks outside the planes: {unexpected}")
    allowance = slack + sum(others.values())
    check(0 < total <= delta, f"3n: ledger {total} B vs allocated delta {delta} B")
    check(delta - total <= allowance,
          f"3n: allocated delta − ledger = {delta - total} B > allowance {allowance} B")
    per_plane = {r["plane"]: r["bytes"] for r in rows}
    return pipe, led, {
        "allocated_delta_bytes": delta, "ledger_bytes": total, "gap_bytes": delta - total,
        "allowance_bytes": allowance, "plane_block_slack_bytes": slack,
        "plane_block_overhead_bytes": sum(new[p][0] - n for p, n in storages.items()),
        "blocks": len(new), "plane_blocks": len(storages), "non_plane_tensors": others,
        "freed_bytes": freed,
        "per_plane_bytes": per_plane,
        "ratio_to_reference": {k: per_plane[k] / v for k, v in REF_PLANE_BYTES_3N.items()},
        "reference_bytes": REF_PLANE_BYTES_3N, "snapshot_trace": {
            k: trace[k] for k in ("wall_ms", "kernel_launches", "copies")},
    }


def checkpoint_watermark(dev) -> int:
    """A small save on a fresh default ledger: the checkpoint_scratch
    high watermark it leaves."""
    import shutil
    import tempfile

    from deepflow_tpu_torch.aggregator.checkpoint import save_window_state
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.profiling import DeviceMemoryLedger
    from deepflow_tpu_torch.profiling import ledger as ledger_mod

    saved, ledger_mod.default_ledger = ledger_mod.default_ledger, DeviceMemoryLedger()
    work = tempfile.mkdtemp(prefix="chip_smoke_selfobs_")
    try:
        pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12),
                                         batch_size=SMALL_BATCH), device=dev)
        gen = SyntheticFlowGen(num_tuples=500, seed=2)
        for dt in range(3):
            pipe.ingest(gen.flow_batch(SMALL_BATCH, T0 + dt))
        save_window_state(pipe.wm, os.path.join(work, "small.ckpt"))
        rows = {r["plane"]: r for r in ledger_mod.default_ledger.snapshot()}
        pipe.close()
    finally:
        ledger_mod.default_ledger = saved
        shutil.rmtree(work, ignore_errors=True)
    ck = rows.get("checkpoint_scratch", {"bytes": None, "bytes_hwm": 0})
    check(ck["bytes"] == 0 and ck["bytes_hwm"] > 0, f"3n: checkpoint scratch row {ck}")
    return ck["bytes_hwm"]


def dogfood(dev, pipe, led) -> dict:
    """The pipeline, its spans, the ledger and the step census through a
    collector tick into deepflow_system, read back by the port's SQL
    engine on the card: every value equal to get_counters() bit for bit."""
    from deepflow_tpu_torch.integration.dfstats import system_metric_name, system_sink
    from deepflow_tpu_torch.profiling import default_census
    from deepflow_tpu_torch.querier import QueryEngine
    from deepflow_tpu_torch.storage.store import ColumnarStore
    from deepflow_tpu_torch.utils.stats import StatsCollector

    store = ColumnarStore()
    col = StatsCollector(interval_s=1e9)
    faces = {"tpu_pipeline": pipe, "tpu_pipeline_spans": pipe.tracer, "tpu_hbm": led,
             "tpu_step_census": default_census}
    for module, face in faces.items():
        col.register(module, face, kind="L4Pipeline")
    col.add_sink(system_sink(store))
    expected = {m: dict(f.get_counters()) for m, f in faces.items()}
    expected["tpu_hbm"]["snapshots"] += 1  # the tick's read
    col.tick(now=float(T0 + 100))
    eng = QueryEngine(store, cache=False, device=dev)
    n = 0
    for module, fields in expected.items():
        for field, value in fields.items():
            metric = system_metric_name(module, field)
            res = eng.execute("SELECT value FROM deepflow_system.deepflow_system "
                              f"WHERE metric = '{metric}'")
            check(res.rows == 1 and float(res.values["value"][0]) == float(value),
                  f"3n: {metric} via SQL {res.values.get('value')} vs {value}")
            n += 1
    check(any(k.endswith("_bytes") for k in expected["tpu_hbm"])
          and expected["tpu_step_census"]["entries"] > 0, "3n: hbm / census lanes missing")
    return {"metrics": n, "hbm_bytes_lanes": sorted(k for k in expected["tpu_hbm"]
                                                    if k.endswith("_bytes"))}


def sketch_rows_card_vs_cpu(dev, block) -> int:
    """sketch_block_rows of a closed block (host numpy, as the sink runs
    it) against the same rows' quantiles from the tensor t-digest on the
    card."""
    from deepflow_tpu_torch.integration.dfstats import SKETCH_METRIC_QUANTILE, sketch_block_rows
    from deepflow_tpu_torch.ops import histogram, tdigest

    rows = sketch_block_rows(block, 1)
    spec = block.config.hist
    centers = histogram.loghist_centers(spec, dev)
    want = [r for r in rows if r[1] == SKETCH_METRIC_QUANTILE]
    check(want, "3n: the block gave no quantile rows")
    for r in want:
        g, q = int(r[2]["service"]), float(r[2]["q"])
        h = torch.from_numpy(block.hist[g].astype(np.float32)).to(dev)
        m, w = tdigest.tdigest_compress(centers, h)
        v = float(tdigest.tdigest_quantile(m, w, torch.tensor([q], device=dev))[0])
        check(abs(v - r[3]) <= FLOAT_RTOL * abs(r[3]), f"3n: quantile {g}/{q}: {v} vs {r[3]}")
    return len(rows)


def telemetry_of(tel: dict) -> dict:
    """A telemetry() record's headline: counters, span quantiles, bytes."""
    check(set(tel) >= {"counters", "spans", "profile"}
          and tel["profile"]["hbm_bytes"]["stash"] > 0
          and all("p99_us" in s for s in tel["spans"].values()), "3n: telemetry() shape")
    return {"counters": {k: tel["counters"][k] for k in (
                "window_advances", "host_fetches", "bytes_fetched") if k in tel["counters"]},
            "spans": {k: {f: s[f] for f in ("count", "p50_us", "p99_us")}
                      for k, s in tel["spans"].items()},
            "profile": {k: v for k, v in tel["profile"].items() if k != "census"}}


def selfobs_phase(dev, sk_cfg) -> tuple[dict, dict]:
    """Phase 3n. Counts zeroed before its main path (the oracle and
    shared-sort runs, the ledger pipeline, the sharded run) and read
    after. Returns (launches, summary)."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.profiling import default_ledger

    t_phase = time.perf_counter()
    fns = sketch_fns_card_vs_cpu(dev)
    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    batches = [gen.flow_batch(BATCH, T0 + dt) for dt in SELFOBS_SECONDS]
    reset_all_launch_counts()
    oracle, blocks = oracle_runs(dev, batches, sk_cfg)
    pipe, led, ledger = ledger_on_card(dev, batches, sk_cfg)
    swm = sharded_manager(dev, sharded_config())
    for dt, fb in zip(SELFOBS_SECONDS, batches):
        if dt in SELFOBS_SHARDED_SECONDS:
            swm.ingest(fb.tags, fb.meters, fb.valid)
    swm.drain()
    torch.cuda.synchronize()
    launches = all_launches()
    check(launches["segreduce_gather"] > 0 and launches["sketch_fused"] > 0,
          f"3n launches {launches}")
    sh_rows = [r for r in default_ledger.snapshot() if r["module"] == "sharded_window_manager"
               and r["devices"] == SHARDS]
    sh_planes = swm.device_planes()
    check("cascade" not in sh_planes and {r["plane"] for r in sh_rows} == set(sh_planes),
          "3n: sharded ledger planes")
    for r in sh_rows:
        per_shard = [storage_bytes(shard_part(sh_planes[r["plane"]], d)) for d in range(SHARDS)]
        check(r["bytes_per_device"] == per_shard[0] and r["bytes"] == sum(per_shard),
              f"3n: sharded {r['plane']}: ledger {r['bytes_per_device']} B a device, "
              f"{r['bytes']} B in all; the shards' storages hold {per_shard}")
    tel_pipe, tel_swm = pipe.telemetry(), swm.telemetry()
    check(tel_swm["profile"]["devices"] == SHARDS, "3n: sharded telemetry devices")
    check(tel_swm["spans"]["window.advance"]["count"]
          == tel_swm["counters"]["window_advances"], "3n: one window.advance per advance")
    census_rows = pipe.profile_snapshot(analyze=True)["census"]
    summary = {
        "sketch_functions": fns, "oracle": oracle, "ledger": ledger,
        "checkpoint_scratch_hwm_bytes": checkpoint_watermark(dev),
        "dogfood": dogfood(dev, pipe, led),
        "sketch_rows_checked": sketch_rows_card_vs_cpu(dev, blocks[0]),
        "census_ledger_pipeline": census_rows,
        "telemetry": {"pipeline": telemetry_of(tel_pipe), "sharded": telemetry_of(tel_swm)},
    }
    pipe.close()
    swm.close()
    del pipe, swm, led
    summary["wall_s"] = time.perf_counter() - t_phase
    return launches, summary


# ---------------------------------------------------------------------------
# 3o. window lineage and the push plane: the lineage tracker on 3c's slab
# pipeline at full width (fetch parity with the passive twin, card = CPU
# on the records), then the doc-frame feeder with the event bus, standing
# SQL / PromQL queries and alert rules over the store it fills

LINEAGE_CLOCK0 = 2_000_000_000.0  # the frozen clock's first reading
LINEAGE_SNAPSHOT_AT = 1  # a live read after the second ingest: the partial lane
PUSH_RECORDS = 256  # flow records a second behind the doc stream (~1k docs a second)
PUSH_SECONDS = 10  # then a drain: windows T0 … T0+9
PUSH_BUCKETS = (2048, 4096, 8192)
PUSH_CAPACITY = 1 << 16
# the frozen clock of (b) runs 1.5 s a pump from T0 + 3, so a window's
# visibility lag grows 0.5 s a pump from ~5 s: the rule crosses mid-run
PUSH_VISIBILITY_MS = 7000.0
PUSH_BYTES_THRESHOLD = 5e7  # the SQL rule: the stored windows' bytes


class FrozenClock:
    """An injectable clock that reads `t` until it is set again: card and
    CPU runs under one schedule stamp identical hops."""

    def __init__(self, t: float):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def lineage_sig(lin, fr) -> dict:
    """What the lineage plane recorded: per window its hops and lags and
    its assembled tree, then the drained span rows, the freshness lanes,
    histograms and exemplars, and the tracker's counters."""
    keys = sorted(lin._windows)
    return {
        "hops": {k: {h: tuple(getattr(a, f) for f in a.__slots__)
                     for h, a in lin._windows[k].hops.items()} for k in keys},
        "lags": {k: dict(lin._windows[k].lags) for k in keys},
        "trees": {k: lin.assemble(k[1], k[0]) for k in keys},
        "spans": [dataclasses.astuple(r) for r in lin.drain_spans()],
        "fresh": fr.get_counters(), "hist": fr.hist_dump(), "exemplars": fr.exemplars(),
        "counters": lin.get_counters(),
    }


def time_tracker_calls(lin) -> dict:
    """Wrap every recording method of a LineageTracker instance with a
    host timer: returns the running {"s": seconds, "calls": n}."""
    acc = {"s": 0.0, "calls": 0}
    for name in ("note_admit", "begin_pump", "note_frames", "drop_stamps", "note_journal",
                 "note_stage", "note_dispatch", "pop_dispatch_stamp", "note_advance",
                 "note_flush_windows", "note_tier_windows", "note_store_insert",
                 "note_snapshot", "note_query"):
        fn = getattr(lin, name)

        def timed(*a, _fn=fn, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc["s"] += time.perf_counter() - t0
                acc["calls"] += 1

        setattr(lin, name, timed)
    return acc


def lineage_pipeline(dev, sk_cfg, batch: int):
    """3c's slab L4Pipeline (2^18-row stash, unique cap 2^15) at `batch`."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig

    return L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=STASH_CAPACITY, accum_batches=ACCUM_BATCHES, delay=DELAY,
                            sketch=sk_cfg, min_snapshot_interval=0.0),
        batch_size=batch, batch_unique_cap=min(UNIQUE_CAP, batch)), device=dev)


def lineage_run(dev, batches, sk_cfg, *, lineage: bool, clock=None, profile: bool = False,
                live: bool = False) -> dict:
    """The pipeline over `batches` (one second each) and a drain, every
    flushed window into a store through docbatch_window_sink, a forced
    live read after ingest LINEAGE_SNAPSHOT_AT. With `lineage`, a
    LineageTracker + FreshnessTracker on `clock` (a FrozenClock steps 10 s
    an ingest and 1 s to each insert; None is the wall clock). With
    `profile`, the whole run is one profile_cycle. With `live` (wall
    clock), the batches replay as live traffic: each waits for the next
    wall second and carries it as its timestamp, and every tracker call
    is timed."""
    from deepflow_tpu_torch.integration.dfstats import docbatch_window_sink
    from deepflow_tpu_torch.storage.store import ColumnarStore
    from deepflow_tpu_torch.tracing.lineage import FreshnessTracker, LineageTracker

    pipe = lineage_pipeline(dev, sk_cfg, int(batches[0].size))
    lin = fr = acc = None
    if lineage:
        fr = FreshnessTracker(autoregister=False)
        lin = LineageTracker("tpu.pipeline", 1, freshness=fr,
                             clock=clock if clock is not None else time.time)
        acc = time_tracker_calls(lin) if live else None
        pipe.attach_lineage(lin)
    frozen = isinstance(clock, FrozenClock)
    sink = docbatch_window_sink(ColumnarStore(), lineage=lin)
    docs, snaps = [], []

    def run():
        for i, fb in enumerate(batches):
            if frozen:
                clock.t = LINEAGE_CLOCK0 + 10.0 * i
            if live:
                now = time.time()
                time.sleep(math.ceil(now) - now)
                ts = fb.tags["timestamp"].astype(np.int64)
                fb = dataclasses.replace(fb, tags={**fb.tags, "timestamp": (
                    ts + (round(time.time()) - int(ts.max()))).astype(np.uint32)})
            out = pipe.ingest(fb)
            docs.extend(out)
            if frozen:
                clock.t += 1.0
            sink(out)
            if i == LINEAGE_SNAPSHOT_AT:
                snap = pipe.snapshot_open(force=True)
                snaps.append([(w.window_idx, w.count) for w in snap.windows])
        if frozen:
            clock.t = LINEAGE_CLOCK0 + 10.0 * len(batches)
        out = pipe.drain()
        docs.extend(out)
        sink(out)

    t0 = time.perf_counter()
    trace = profile_cycle(run, host_ops=False) if profile else None
    if not profile:
        run()
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
    res = {"docs": docs, "blocks": pipe.pop_closed_sketches(), "snaps": snaps,
           "fetches": pipe.wm.host_fetches, "trace": trace, "wall_s": time.perf_counter() - t0}
    if lineage:
        res["fresh_hist"] = fr.hist_dump()
        res["sig"] = lineage_sig(lin, fr)
        res["hop_timer"] = acc
        lin.close()
    pipe.close()
    return res


def lag_quantiles(hist_dump: dict) -> dict:
    """p50 / p99 ms of each freshness lane from its raw log-histogram."""
    from deepflow_tpu_torch.tracing.lineage import _FRESH_HIST
    from deepflow_tpu_torch.utils.spans import loghist_quantiles_np

    out = {}
    for lane, pairs in sorted(hist_dump.items()):
        hist = np.zeros(_FRESH_HIST.bins, np.int64)
        for b, c in pairs:
            hist[b] = c
        p50, p99 = loghist_quantiles_np(hist, _FRESH_HIST, (0.5, 0.99))
        out[lane] = {"p50_ms": float(p50), "p99_ms": float(p99), "samples": int(hist.sum())}
    return out


def push_stream(dev) -> list:
    """3l's METRICS stream at PUSH_RECORDS records a second: 1 s docs of
    the port's L4Pipeline on the card over SyntheticFlowGen(5_000, seed=0),
    in frames of 256 docs from 8 agents, grouped by the second whose
    ingest produced them (the last group is the drain's)."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.code import DocumentFlag
    from deepflow_tpu_torch.ingest.codec import encode_docbatch
    from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=5_000, seed=0)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 17),
                                     batch_size=PUSH_RECORDS), device=dev)
    groups, k = [], 0
    for s in range(PUSH_SECONDS + 1):
        docs = pipe.ingest(gen.flow_batch(PUSH_RECORDS, T0 + s)) if s < PUSH_SECONDS \
            else pipe.drain()
        msgs = [m for db in docs
                for m in encode_docbatch(db, flags=int(DocumentFlag.PER_SECOND_METRICS))]
        frames = []
        for i in range(0, len(msgs), SERVER_FRAME_DOCS):
            frames.append(encode_frame(FlowHeader(
                msg_type=int(MessageType.METRICS), agent_id=1 + k % SERVER_AGENTS,
                organization_id=1), msgs[i:i + SERVER_FRAME_DOCS]))
            k += 1
        groups.append(frames)
    check(pipe.counters["drop_overflow"] == 0, "3o: the stream's pipeline shed docs")
    return groups


def push_run(dev, groups, *, timed: bool = False) -> dict:
    """The doc feeder and the push plane on `dev` under a frozen clock:
    PyOverwriteQueue → FeederRuntime + WindowManagerFeedSink (PUSH_BUCKETS)
    with event_bus= and lineage=; each pump's flushed windows into a store
    through flow_window_sink(bus=, lineage=), then a collector tick of the
    freshness lanes into deepflow_system at the newest window's time (and
    profile_tick_sink(bus)). One SQL and one PromQL standing query, and
    two alert rules: PromQL over tpu_freshness_visibility_lag_ms and SQL
    over the stored bytes. With `timed`, one subscription re-evaluation
    and one SQL rule evaluation are timed with CUDA events after the
    results are taken."""
    from deepflow_tpu_torch.aggregator.window import WindowConfig, WindowManager
    from deepflow_tpu_torch.feeder import FeederConfig
    from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue
    from deepflow_tpu_torch.integration import dfstats
    from deepflow_tpu_torch.ops import segreduce
    from deepflow_tpu_torch.profiling import DeviceMemoryLedger, profile_tick_sink
    from deepflow_tpu_torch.querier.alerts import AlertEngine, AlertRule
    from deepflow_tpu_torch.querier.events import (
        QueryEventBus,
        connect_store_events,
        docbatch_events,
    )
    from deepflow_tpu_torch.querier.live import LiveRegistry
    from deepflow_tpu_torch.querier.subscribe import SubscriptionManager
    from deepflow_tpu_torch.storage.store import ColumnarStore
    from deepflow_tpu_torch.tracing.lineage import (
        HOP_QUERY_FIRST,
        HOP_STORE_INSERT,
        FreshnessTracker,
        LineageTracker,
        connect_store_reads,
    )
    from deepflow_tpu_torch.utils.stats import StatsCollector

    db, table = dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE
    clock = FrozenClock(T0 + 3)
    store = ColumnarStore()
    dfstats.ensure_system_table(store)
    bus = QueryEventBus(name="push-3o")
    connect_store_events(store, bus)
    batches = []
    bus.subscribe(lambda evs: batches.append([(type(e).__name__, dataclasses.astuple(e))
                                              for e in evs]), name="record")
    col = StatsCollector(interval_s=3600.0)
    fr = FreshnessTracker(autoregister=True, collector=col)
    lin = LineageTracker("tpu.pipeline", 1, freshness=fr, clock=clock)
    col.add_sink(dfstats.system_sink(store))
    col.add_sink(profile_tick_sink(bus, ledger=DeviceMemoryLedger()))
    wm = WindowManager(WindowConfig(capacity=PUSH_CAPACITY), device=dev)
    wm.attach_lineage(lin)
    q = PyOverwriteQueue(1 << 12)
    feeder = wm.make_feeder([q], PUSH_BUCKETS, FeederConfig(frames_per_queue=64),
                            name="push-3o", event_bus=bus, lineage=lin)
    sink = dfstats.flow_window_sink(store, bus=bus, lineage=lin)
    connect_store_reads(store, lin, db, table)
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False, bus=bus, name="3o",
                               device=dev)
    sql_got, prom_got = [], []
    bytes_sql = (f"SELECT Sum(value) AS bytes, Count(value) AS n FROM {db}.{table} "
                 f"WHERE metric = '{dfstats.LIVE_METRIC_FLOW_BYTES}'")
    sql_sub, _ = subs.subscribe_sql(bytes_sql, callback=lambda r, s: sql_got.append(
        {c: [float(v) for v in r.values[c]] for c in r.columns}))
    prom_sub, _ = subs.subscribe_promql(
        f"sum({dfstats.LIVE_METRIC_FLOW_BYTES})", span_s=8, step=1, db=db, table=table,
        lookback_s=3, callback=lambda r, s: prom_got.append(r))
    eng = AlertEngine(store, live=LiveRegistry(), bus=bus, name="3o", log_sink=False,
                      device=dev)
    fired = []
    eng.add_sink(fired.append, name="record")
    eng.add_rule(AlertRule(name="visibility_lag_high", query="tpu_freshness_visibility_lag_ms",
                           comparator=">", threshold=PUSH_VISIBILITY_MS, for_s=0))
    eng.add_rule(AlertRule(name="bytes_high", engine="sql", comparator=">=",
                           threshold=PUSH_BYTES_THRESHOLD,
                           query=f"SELECT Sum(value) AS s FROM {db}.{table} WHERE metric = "
                                 f"'{dfstats.LIVE_METRIC_FLOW_BYTES}'"))
    windows, pump_batches, expected = [], [], 0
    seg0 = segreduce.LAUNCHES["segreduce_gather"]
    t0 = time.perf_counter()
    for i, group in enumerate(groups):
        clock.t = T0 + 3 + 1.5 * i
        for frame in group:
            q.put(frame)
        n0 = len(batches)
        out = feeder.pump()
        # the batches the pump itself published (the handlers publish none)
        pump_batches.append([len(b) for b in batches[n0:]])
        expected += len(docbatch_events(out, db=db, table=table))
        check(len(pump_batches[-1]) == (1 if out else 0),
              f"3o: pump {i} published {len(pump_batches[-1])} batches for {len(out)} windows")
        if out:
            clock.t += 0.5
            sink(out)
            col.tick(now=max(f.start_time for f in out))
        windows += out
    clock.t += 1.0
    out = wm.flush_all()
    windows += out
    sink(out)
    col.tick(now=max(f.start_time for f in out))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = feeder.get_counters()
    check(counters["events_published"] == expected > 0,
          f"3o: events_published {counters['events_published']}, expected {expected}")
    inserted = [(1, f.window_idx) for f in windows if f.count]
    check(all(HOP_STORE_INSERT in lin.record_of(w).hops and HOP_QUERY_FIRST
              in lin.record_of(w).hops for _, w in inserted),
          "3o: a stored window lacks store.insert or query.first")
    res = {
        "windows": [(f.window_idx, f.count, f.key_hi.tobytes(), f.key_lo.tobytes(),
                     f.tags.tobytes(), f.meters.tobytes()) for f in windows],
        "batches": list(batches), "sql": list(sql_got), "promql": list(prom_got),
        "fired": [{k: v for k, v in f.items()} for f in fired],
        "states": {r["name"]: (r["state"], r["transitions"]) for r in eng.list_rules()},
        "sig": lineage_sig(lin, fr), "feeder": {k: v for k, v in counters.items()},
        "expected_events": expected, "pump_batches": pump_batches,
        "segreduce_gather": segreduce.LAUNCHES["segreduce_gather"] - seg0,
        "wall_s": wall, "docs": sum(f.count for f in windows),
    }
    if timed:
        last = max(f.start_time for f in windows) + 1
        res["subscription_eval_ms"] = time_ms(lambda: subs.evaluate(sql_sub, now=last))
        res["alert_eval_ms"] = time_ms(lambda: eng.evaluate_rule("bytes_high", now=last))
    subs.close()
    eng.close()
    lin.close()
    fr.close()
    wm.close()
    return res


def lineage_phase(dev, sk_cfg) -> tuple[dict, dict]:
    """Phase 3o. Counts zeroed before its main path ((a) the lineage run
    at full width, (b) the doc feeder with the push plane) and read
    after. Returns (launches, summary)."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    t_phase = time.perf_counter()
    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    batches = [gen.flow_batch(BATCH, T0 + dt) for dt in SELFOBS_SECONDS]
    groups = push_stream(dev)
    reset_all_launch_counts()
    # (a) lineage at full width: passive, frozen-clock lineage (both
    # traced), then the wall clock with every tracker call timed
    passive = lineage_run(dev, batches, sk_cfg, lineage=False, profile=True)
    frozen = lineage_run(dev, batches, sk_cfg, lineage=True, clock=FrozenClock(LINEAGE_CLOCK0),
                         profile=True)
    wall = lineage_run(dev, batches, sk_cfg, lineage=True, live=True)
    # (b) the doc feeder and the push plane
    card_push = push_run(dev, groups, timed=True)
    torch.cuda.synchronize()
    launches = all_launches()
    check(launches["segreduce_gather"] > 0 and launches["sketch_fused"] > 0,
          f"3o launches {launches}")
    check(card_push["segreduce_gather"] > 0, "3o: the doc feeder's folds launched no segreduce")
    del batches

    check(same_docs(frozen["docs"], passive["docs"])
          and same_blocks(frozen["blocks"], passive["blocks"]),
          "3o: the lineage run's windows or sketch blocks differ from the passive run's")
    for run in (frozen, wall):  # the live replay's timestamps differ; its fetches do not
        check(run["fetches"] == passive["fetches"]
              and [[c for _, c in s] for s in run["snaps"]]
              == [[c for _, c in s] for s in passive["snaps"]],
              f"3o: fetches {run['fetches']} with lineage, {passive['fetches']} without")
    copies = {k: r["trace"]["copies"]["DtoH"] for k, r in (("passive", passive),
                                                          ("lineage", frozen))}
    check(copies["lineage"] <= copies["passive"],
          f"3o: the lineage run copied device→host more often {copies}")
    sig = frozen["sig"]
    check(sig["spans"] and sig["fresh"]["1s.partial_samples"] >= 1
          and sig["fresh"]["1s.visibility_samples"] == len(passive["docs"]),
          "3o: the frozen run's lineage is incomplete")
    # card = CPU on the lineage records at 2^14-row batches (the 4b cut)
    small = [SyntheticFlowGen(num_tuples=10_000, seed=0).flow_batch(SMALL_BATCH, T0 + dt)
             for dt in SELFOBS_SECONDS]
    twin_card, twin_cpu = (lineage_run(d, small, sk_cfg, lineage=True,
                                       clock=FrozenClock(LINEAGE_CLOCK0))
                           for d in (dev, torch.device("cpu")))
    check(same_docs(twin_card["docs"], twin_cpu["docs"])
          and twin_card["sig"] == twin_cpu["sig"],
          "3o: lineage records (spans, trees, lanes) differ card vs CPU")
    hop = wall["hop_timer"]

    # (b) card = CPU on the same frames and clock
    cpu_push = push_run(torch.device("cpu"), groups)
    for key in ("windows", "batches", "sig", "states", "pump_batches"):
        check(card_push[key] == cpu_push[key], f"3o: push plane {key} differ card vs CPU")
    for key in ("sql", "promql", "fired"):
        check(json.dumps(card_push[key], sort_keys=True, default=str)
              == json.dumps(cpu_push[key], sort_keys=True, default=str),
              f"3o: {key} results differ card vs CPU")
    fired = [(f["rule"], f["state"]) for f in card_push["fired"]]
    check(("visibility_lag_high", "firing") in fired and ("bytes_high", "firing") in fired,
          f"3o: the alert rules did not fire {fired}")
    events_per_pump = [sum(b) for b in card_push["pump_batches"]]
    summary = {
        "gpu": device_line(),
        "a_full_width": {
            "batches": len(SELFOBS_SECONDS), "rows_per_batch": BATCH,
            "windows": len(passive["docs"]), "fetches": passive["fetches"],
            "dtoh_copies": copies, "spans": len(sig["spans"]),
            "hops_recorded": sig["counters"]["hops_recorded"],
            "wall_s": {"passive": passive["wall_s"], "frozen": frozen["wall_s"],
                       "wall_clock": wall["wall_s"]},
            "lag_quantiles_wall_clock": lag_quantiles(wall["fresh_hist"]),
            "tracker_calls": hop["calls"], "tracker_host_s": hop["s"],
            "host_us_per_hop": 1e6 * hop["s"] / max(wall["sig"]["counters"]["hops_recorded"], 1),
            "card_vs_cpu_small": {"rows_per_batch": SMALL_BATCH,
                                  "spans": len(twin_card["sig"]["spans"]),
                                  "windows": len(twin_card["docs"])},
        },
        "b_push_plane": {
            "docs": card_push["docs"], "windows": len(card_push["windows"]),
            "pumps": len(groups), "pumps_with_windows": sum(1 for n in events_per_pump if n),
            "events_per_pump": events_per_pump,
            "events_published": card_push["feeder"]["events_published"],
            "expected_events": card_push["expected_events"],
            "bus_batches": len(card_push["batches"]),
            "subscription_deliveries": {"sql": len(card_push["sql"]),
                                        "promql": len(card_push["promql"])},
            "alert_transitions": fired,
            "subscription_eval_ms": card_push["subscription_eval_ms"],
            "alert_eval_ms": card_push["alert_eval_ms"],
            "segreduce_gather_launches": card_push["segreduce_gather"],
            "wall_s": {"card": card_push["wall_s"], "cpu": cpu_push["wall_s"]},
        },
        "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    return launches, summary


# phase 3p: the multi-process deployment. The card is one (count 1), so
# every host process of a run shares cuda:0; each joins the gloo process
# group of MeshTopology.distributed, owns one shard group and routes the
# other's agents away. (a) runs tests/torch_mesh_harness.py's recipes at
# their test size on the card against its CPU oracle; (b) runs two hosts
# at full width (BASELINE config 5 per shard, 2 shards a group) on the
# bench.py stream against one process serving both groups on the card.
MESH_SECONDS = 4  # (b): seconds of the bench.py stream, the last one profiled
MESH_AGENTS = 8
MESH_FRAME_ROWS = 2048
MESH_SHARDS = 2  # (b): logical shards of the card per group
MESH_HOST_TIMEOUT_S = 300
MESH_HOST_ARGV = [os.path.abspath(__file__), "--mesh-host"]  # (b)'s host entry


def mesh_harness():
    """tests/torch_mesh_harness.py (JAX-free) as a module."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_mesh_harness

    return torch_mesh_harness


def mesh_frames(gen, second: int, agents) -> list:
    """One second of the bench.py stream (BATCH rows of `gen`) cut into
    MESH_AGENTS equal slices — agent a sends slice a — as (agent, frame)
    pairs of 2048-row TAGGEDFLOW frames for `agents` only. Every host
    draws the whole second: the generator is stateful."""
    from deepflow_tpu_torch.feeder import encode_flowbatch_frames

    fb = gen.flow_batch(BATCH, T0 + second)
    n = BATCH // MESH_AGENTS
    return [(a, raw) for a in agents
            for raw in encode_flowbatch_frames(fb.slice(a * n, (a + 1) * n), agent_id=a,
                                               org_id=1, max_rows_per_frame=MESH_FRAME_ROWS)]


def mesh_runner(th, topology, workdir):
    """A host's full-width stack: receiver → one queue a group →
    FeederRuntime (one pump takes a whole second) → ShardedFeedSink at
    3j's 2^18-row bucket → BASELINE config 5 per shard."""
    from deepflow_tpu_torch.feeder import FeederConfig

    return th.HostRunner(topology, workdir, cfg=sharded_config(), buckets=(FULL_BUCKET,),
                         feeder_config=FeederConfig(frames_per_queue=BATCH // MESH_FRAME_ROWS,
                                                    rounds_per_pump=1),
                         queue_capacity=4 * BATCH // MESH_FRAME_ROWS, journal=False)


def mesh_host_main(spec: dict) -> int:
    """One full-width host of phase 3p (b), spawned by the parent as
    `chip_smoke.py --mesh-host SPEC`: bring-up over gloo, its own agents'
    frames of MESH_SECONDS seconds built first, a file barrier so both
    hosts start together, every second but the last timed, the last
    profiled, a drain; its results and rows beside spec["out"]."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.parallel.hostproc import await_peers, exit_after_barrier, mark_done
    from deepflow_tpu_torch.parallel.topology import MeshTopology

    th = mesh_harness()
    dev = torch.device(spec["device"])
    pid = int(spec["process_id"])
    t = time.perf_counter()
    topo = MeshTopology.distributed(spec["coordinator"], 2, pid, n_groups=2,
                                    devices_per_group=MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    init_s = time.perf_counter() - t
    statement = [[str(d) for d in row] for row in topo.global_mesh().devices]
    runner = mesh_runner(th, topo, spec["workdir"])
    fetch = th.fetch_shim(topo)
    agents = [a for a, g in th.agent_groups().items() if topo.owns_group(g)]
    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    t = time.perf_counter()
    seconds = [mesh_frames(gen, s, agents) for s in range(MESH_SECONDS)]
    frames_s = time.perf_counter() - t

    def ingest(frames):
        runner.dispatch_step(frames)
        runner.pump()

    ready = os.path.join(spec["workdir"], "ready")
    os.makedirs(ready, exist_ok=True)
    mark_done(ready, pid)
    check(await_peers(ready, pid, 2), f"3p full p{pid}: the peer never got ready")
    t_first = time.time()
    walls = [synced(lambda f=f: ingest(f))[1] for f in seconds[:-1]]
    t_last = time.time()
    rows = sum(len(f) for f in seconds[:-1]) * MESH_FRAME_ROWS
    profile = profile_cycle(lambda: ingest(seconds[-1]), host_ops=False)
    _, drain_s = synced(runner.finish)
    res = runner.results()
    res.update({
        "process_index": pid, "init_s": init_s, "global_mesh": statement, "agents": agents,
        "rows_timed": rows, "walls_s": walls, "t_first": t_first, "t_last": t_last,
        "frames_s": frames_s, "drain_s": drain_s, "profile": {
            k: profile[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                    "kernel_launches", "copies")},
        "fetch": {**fetch, "n_ingests": runner.n_ingests},
        "device": th.device_report(dev, runner), "launches": th.kernel_launches()})
    th.write_result(spec, runner, res)
    exit_after_barrier(spec["workdir"], pid, 2)
    return 0


def check_mesh_host(res: dict, what: str) -> None:
    """A host of 3p ran on this card and launched both kernels."""
    check(res["device"] == {"name": torch.cuda.get_device_name(0), "stash": ["cuda"]},
          f"3p {what}: the host ran on {res['device']}, not on this card")
    check(res["launches"]["segreduce_gather"] > 0 and res["launches"]["sketch_fused"] > 0,
          f"3p {what}: launches {res['launches']}")


def check_mesh_groups(th, res: dict, rows: dict, oracle: dict, want: dict, what: str,
                      groups=None) -> int:
    """Each group of `res` against the oracle: counters and freshness
    lags exact, rows and sketch blocks under the float rule; returns the
    histogram counts moved."""
    moved = 0
    for g in groups or res["groups"]:
        rec, o = res["groups"][g], oracle["groups"][g]
        check(rec["counters"] == o["counters"], f"3p {what}: group {g} counters differ")
        check(rec["fresh"] == o["fresh"], f"3p {what}: group {g} freshness lags differ")
        for kind in ("docs", "blocks"):
            moved += th.check_rows_close(rows[int(g)][kind], want[int(g)][kind],
                                         f"3p {what} group {g} {kind}")
    return moved


def mesh_rows(th, d, name: str) -> dict:
    return th.load_rows(os.path.join(d, f"{name}.npz"))


def mesh_test_size(th, dev, work: str) -> tuple[dict, dict]:
    """3p (a): the harness's clean two-process run, the kill-and-recover
    recipe and the clean rebalance recipe with every host on the card,
    against the harness's CPU oracles in this process. Returns (launches
    summed over the hosts, summary)."""
    oracle = th.run_oracle("cpu", with_rows=True)
    want = th.load_rows(oracle.pop("rows"))
    rb_oracle = th.run_rebalance_oracle("cpu", with_rows=True)
    rb_want = th.load_rows(rb_oracle.pop("rows"))
    hosts, moved, walls = [], 0, {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[f"{name}_s"] = time.perf_counter() - t
        return out

    # the clean and the kill recipe share nothing: run them side by side
    # (the rebalance recipe runs alone below, so its pause is its own)
    d, dk = os.path.join(work, "clean"), os.path.join(work, "kill")
    os.makedirs(d)
    os.makedirs(dk)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        clean = pool.submit(timed, "clean", th.spawn_distributed, d, device=dev.type)
        killed = pool.submit(timed, "kill", th.run_kill, dk, device=dev.type)
        procs, kill = clean.result(), killed.result()
    groups_of = th.agent_groups()
    for pid, res in enumerate(procs):
        check_mesh_host(res, f"clean p{pid}")
        hosts.append(res)
        moved += check_mesh_groups(th, res, mesh_rows(th, d, f"result.p{pid}"), oracle, want,
                                   f"clean p{pid}")
        owned = {int(g) for g in res["groups"]}
        other = th.N_STEPS * sum(1 for g in groups_of.values() if g not in owned)
        c = res["receiver"]
        check(c["frames_misrouted"] == c["frames_handoff"] == res["handoffs"] == other
              and c["handoff_errors"] == 0,
              f"3p clean p{pid}: misroutes {c['frames_misrouted']}, handoffs "
              f"{c['frames_handoff']}, want {other}")
        f = res["fetch"]
        check(f["n"] <= 3 * f["n_ingests"] and f["nonlocal"] == 0 and f["retraces"] == 0,
              f"3p clean p{pid}: fetches {f}")
    check(procs[0]["global_mesh"] == procs[1]["global_mesh"]
          == [[str(d) for d in th.host_devices(dev.type)]] * 2,
          f"3p: the pod-mesh statements {[r['global_mesh'] for r in procs]}")

    for name, res in (("p0", kill["p0"]), ("p1_gen1", kill["p1_gen1"]),
                      ("p1_gen2", kill["p1_gen2"])):
        check_mesh_host(res, f"kill {name}")
        hosts.append(res)
    moved += check_mesh_groups(th, kill["p0"], mesh_rows(th, dk, "result.p0"), oracle, want,
                               "kill p0")
    (g1,) = kill["p1_gen1"]["groups"]
    gen1, gen2 = kill["p1_gen1"]["groups"][g1], kill["p1_gen2"]["groups"][g1]
    r1 = mesh_rows(th, dk, "result.p1")[int(g1)]
    r2 = mesh_rows(th, dk, "result.p1.gen2")[int(g1)]
    moved += th.check_rows_close(r1["docs"][:gen1["ckpt_stream_len"]] + r2["docs"],
                                 want[int(g1)]["docs"], "3p kill: the combined stream")
    moved += th.check_rows_close(r1["blocks"][:gen1["ckpt_blocks_len"]] + r2["blocks"],
                                 want[int(g1)]["blocks"], "3p kill: the combined blocks")
    check(all(gen2["counters"][k] == oracle["groups"][g1]["counters"][k] for k in
              SHARD_COUNTERS), "3p kill: the recovered host's counters differ from the oracle's")

    d = os.path.join(work, "rebalance")
    os.makedirs(d)
    r0, r1 = timed("rebalance", th.spawn_hosts, th.rebalance_specs(d, device=dev.type))
    for pid, res in enumerate((r0, r1)):
        check_mesh_host(res, f"rebalance p{pid}")
        hosts.append(res)
        f = res["fetch"]
        check(f["n"] <= 3 * f["n_ingests"] and f["nonlocal"] == 0
              and all(a == b for a, b in res["caches"].values()),
              f"3p rebalance p{pid}: fetches {f}, census {res['caches']}")
    mv = str(th.MOVE_GROUP)
    rows0, rows1 = mesh_rows(th, d, "result.p0"), mesh_rows(th, d, "result.p1")
    moved += check_mesh_groups(th, r0, rows0, rb_oracle, rb_want, "rebalance p0", groups=["0"])
    for kind in ("docs", "blocks"):
        moved += th.check_rows_close(rows1[int(mv)][kind] + rows0[int(mv)][kind],
                                     rb_want[int(mv)][kind], f"3p rebalance: moved {kind}")
    check(all(r0["groups"][mv]["counters"][k] == rb_oracle["groups"][mv]["counters"][k]
              for k in SHARD_COUNTERS), "3p rebalance: the moved group's counters differ")
    n_move = sum(1 for g in groups_of.values() if g == th.MOVE_GROUP)
    fwd = n_move * (th.REROUTE_AT - th.REBALANCE_AT - 1)
    check(r1["sender"]["tx_frames"] == r0["handoff_rx"]["rx_frames"] == fwd
          and r1["sender"]["shed_frames"] == 0
          and r0["receiver"]["frames_held"] == r0["receiver"]["frames_redelivered"] == n_move,
          f"3p rebalance: wire {r1['sender']} / {r0['handoff_rx']}")
    launches = {k: sum(h["launches"][k] for h in hosts) for k in hosts[0]["launches"]}
    return launches, {
        "hosts": len(hosts), "walls_s": walls, "hist_counts_moved": moved,
        "init_s": [r["init_s"] for r in procs],
        "fetches_per_ingest": [r["fetch"]["n"] / r["fetch"]["n_ingests"] for r in procs],
        "misrouted": [r["receiver"]["frames_misrouted"] for r in procs],
        "handover_ms": {"release": r1["handover_ms"]["release"],
                        "adopt": r0["handover_ms"]["adopt"]},
        "handoff_frames": fwd, "held_redelivered": n_move,
        "launches_per_host": [h["launches"] for h in hosts]}


def mesh_full_width(th, dev, work: str) -> tuple[dict, dict]:
    """3p (b): two hosts at full width on the card, then one process
    serving both groups on the card over the same frames as their
    oracle. Returns (launches summed over the two hosts, summary)."""
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.parallel.topology import MeshTopology, free_coordinator_port

    d = os.path.join(work, "full")

    def specs():
        coord = f"127.0.0.1:{free_coordinator_port()}"
        return [{"argv": MESH_HOST_ARGV, "mode": "full",
                 "coordinator": coord, "num_processes": 2, "process_id": pid,
                 "device": dev.type, "workdir": d, "out": os.path.join(d, f"result.p{pid}.json")}
                for pid in range(2)]

    torch.cuda.empty_cache()
    os.makedirs(d)
    t = time.perf_counter()
    try:
        procs = th.spawn_hosts(specs(), timeout_s=MESH_HOST_TIMEOUT_S)
    except th.PortLost:
        for f in os.listdir(d):
            os.unlink(os.path.join(d, f))
        procs = th.spawn_hosts(specs(), timeout_s=MESH_HOST_TIMEOUT_S)
    hosts_s = time.perf_counter() - t
    for pid, res in enumerate(procs):
        check_mesh_host(res, f"full p{pid}")
        check(res["receiver"]["frames_misrouted"] == 0 and res["receiver"]["no_handler"] == 0,
              f"3p full p{pid}: receiver {res['receiver']}")
        f = res["fetch"]
        check(f["n"] <= 3 * f["n_ingests"] and f["nonlocal"] == 0, f"3p full p{pid}: {f}")

    # the oracle: one process, both groups, the same frames and pumps
    od = os.path.join(d, "oracle")
    os.makedirs(od)
    topo = MeshTopology.single(n_groups=2, devices_per_group=MESH_SHARDS,
                               devices=[dev] * (2 * MESH_SHARDS))
    runner = mesh_runner(th, topo, od)
    gen = SyntheticFlowGen(num_tuples=10_000, seed=0)
    t = time.perf_counter()
    for s in range(MESH_SECONDS):
        runner.dispatch_step(mesh_frames(gen, s, range(MESH_AGENTS)))
        runner.pump()
    runner.finish()
    oracle_s = time.perf_counter() - t
    oracle = runner.results()
    want = th.load_rows(runner.row_arrays())
    runner.close()
    del runner
    torch.cuda.empty_cache()
    moved = 0
    for pid, res in enumerate(procs):
        moved += check_mesh_groups(th, res, mesh_rows(th, d, f"result.p{pid}"), oracle, want,
                                   f"full p{pid}")
    check(sum(r["groups"][g]["counters"]["flow_in"] for r in procs for g in r["groups"])
          == MESH_SECONDS * BATCH, "3p full: the hosts did not ingest every row")
    rows = [r["rows_timed"] for r in procs]
    span = max(r["t_last"] for r in procs) - min(r["t_first"] for r in procs)
    launches = {k: sum(r["launches"][k] for r in procs) for k in procs[0]["launches"]}
    return launches, {
        "hosts": 2, "shards_per_group": MESH_SHARDS, "batch": BATCH,
        "seconds": MESH_SECONDS, "timed_seconds": MESH_SECONDS - 1, "agents": [r["agents"] for r in procs],
        "records_per_s": [n / sum(r["walls_s"]) for n, r in zip(rows, procs)],
        "aggregate_records_per_s": sum(rows) / span,
        "init_process_group_s": [r["init_s"] for r in procs],
        "fetches_per_ingest": [r["fetch"]["n"] / r["fetch"]["n_ingests"] for r in procs],
        "ingests": [r["fetch"]["n_ingests"] for r in procs],
        "profiled_ingest": [r["profile"] for r in procs],
        "frames_build_s": [r["frames_s"] for r in procs],
        "drain_s": [r["drain_s"] for r in procs], "hosts_wall_s": hosts_s,
        "oracle_s": oracle_s, "hist_counts_moved": moved,
        "launches_per_host": [r["launches"] for r in procs]}


def mesh_phase(dev, gpu: str) -> tuple[dict, dict, dict]:
    """Phase 3p: the multi-process deployment on the card, (a) at test
    size, (b) at full width. Returns (test-size launches, full-width
    launches, summary)."""
    import shutil
    import tempfile

    th = mesh_harness()
    work = tempfile.mkdtemp(prefix="chip_smoke_3p_")
    t = time.perf_counter()
    try:
        small_launches, small = mesh_test_size(th, dev, work)
        full_launches, full = mesh_full_width(th, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return small_launches, full_launches, {"gpu": gpu, "test_size": small, "full_width": full,
                                           "phase_s": time.perf_counter() - t}


def load_other_port(path: str):
    """The ops.segreduce and ops.sketch_fused modules of another checkout
    of this repo (for example the parent commit, unpacked with git
    archive), imported under their own package name; their kernels build
    from that checkout's sources into its own _build directory."""
    import importlib
    import importlib.util

    root = os.path.join(os.path.abspath(path), "deepflow_tpu_torch")
    name = "deepflow_tpu_torch_against"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(f"{name}.ops.segreduce"),
            importlib.import_module(f"{name}.ops.sketch_fused"))


def against(path: str, dev) -> dict:
    """A/B of this checkout's kernels against another checkout's, on the
    same card and inputs, in turns (other, this, this, other): per call,
    the device time of the kernel(s) alone, of everything the call
    launches, the launches, and the CUDA-event call time. The other
    checkout's sketch wrapper, where it predates the s_pos signature, takes
    the sorted lanes of its own (gathered here through s_pos, as its
    caller gathered them)."""
    from deepflow_tpu_torch.ops import segreduce, sketch_fused

    o_seg, o_sk = load_other_port(path)

    def turns(fns: dict, match: str) -> dict:
        res = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            d, n = device_time(fns[who], match)
            d_all, n_all = device_time(fns[who], None)
            res[who].append({"device_ms": d, "launches": n, "device_ms_all": d_all,
                             "launches_all": n_all, "ms": time_ms(fns[who])})
        return res

    out = {}
    for shape, o in kernel_operands(dev).items():
        for name in KERNELS:
            gather = name == "segreduce_gather"
            perm = o["perm"] if gather else None
            rows = o["rows"] if gather else o["rows"].index_select(0, o["perm"].long())
            args = (rows, o["seg"], o["cap"], o["first_pos"])
            fns = {"other": lambda a=args, p=perm: o_seg.sorted_segment_sum_max(*a, perm=p),
                   "this": lambda a=args, p=perm: segreduce.sorted_segment_sum_max(*a, perm=p)}
            out[f"{name}/{shape}"] = turns(fns, "segreduce")
            print(json.dumps({"phase": "against", "kernel": name, "shape": shape,
                              "result": out[f"{name}/{shape}"]}), flush=True)

    _, sk, kw = sketch_operands(dev)
    p = kw["s_pos"]
    old_kw = dict(tk_shape=kw["tk_shape"], s_slot=kw["s_win"] % RING, s_gid=kw["gid"][p],
                  s_reg=kw["reg"][p], s_rho=kw["rho"][p], s_mask=kw["mask"][p],
                  w_head=torch.where(kw["head"], kw["rw"], 0), rw=kw["rw"], s_hi=kw["s_hi"],
                  s_lo=kw["s_lo"], s_ia=kw["id_a"][p], s_ib=kw["id_b"][p])
    if "s_pos" in inspect.signature(o_sk.sketch_update_fused).parameters:
        old_kw = kw  # the other checkout takes this signature
    h, c = sk.hll.clone(), sk.cms.clone()
    fns = {"other": lambda: o_sk.sketch_update_fused(h, c, **old_kw),
           "this": lambda: sketch_fused.sketch_update_fused(h, c, **kw)}
    out["sketch_fused"] = turns(fns, "sketch_")
    out["sketch_fused"]["wrapper_host_ms"] = {
        who: [host_ms(fns[who]) for _ in range(2)] for who in ("other", "this")}
    print(json.dumps({"phase": "against", "kernel": "sketch_fused",
                      "result": out["sketch_fused"]}), flush=True)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--composed-twin":
        return composed_twin_main(json.loads(sys.argv[2]))  # 3q's CPU twin process
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 2
    from deepflow_tpu_torch.kernels import build

    dev = torch.device("cuda")
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-host":
        return mesh_host_main(json.loads(sys.argv[2]))  # a 3p host process
    gpu = device_line()
    name = torch.cuda.get_device_name(0)
    print(gpu)
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        against(sys.argv[2], dev)
        print(json.dumps({"gpu": gpu, "against": sys.argv[2]}))
        return 0
    t0 = time.perf_counter()

    def emit(obj: dict) -> None:
        """One phase's JSON line, with the seconds since the build began."""
        print(json.dumps({**obj, "t_s": round(time.perf_counter() - t0, 1)}), flush=True)

    build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    from deepflow_tpu_torch.utils.provenance import bench_provenance

    native_build = native_build_info()  # host C++: 3q's default decoder and queue
    emit({"phase": "device", "nvidia_smi": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "build_seconds": build.build_seconds, "native_build": native_build,
          "provenance": bench_provenance()})
    sk_cfg = sketch_config()

    # 2. kernel parity at the main-path shapes
    ops = kernel_operands(dev)
    results = {k: {shape: kernel_parity(k, o) for shape, o in ops.items()}
               for k in KERNELS}
    emit({"phase": "parity", "results": results})
    # 2b. the fused sketch update at the main-path shape
    sketch_res = sketch_kernel_parity(dev)
    emit({"phase": "sketch_parity", "result": sketch_res})

    # 3. main path, fused gather (the default)
    os.environ["DEEPFLOW_FUSED_GATHER"] = "1"
    reset_all_launch_counts()
    rate_gather, per_cycle_gather, prof, full_state = bench_cycle(dev, CYCLES,
                                                                  with_profile=True)
    run = pipeline_stream(dev, BATCH, list(range(6)))
    main_gather = all_launches()
    check_pipeline_run(run)
    check(len(run["docs"]) == 6, f"{len(run['docs'])} windows from 6 seconds of data")
    check(main_gather["segreduce_gather"] > 0 and main_gather["segreduce_sorted"] == 0
          and main_gather["sketch_fused"] == 0,
          f"fused-gather main path launches {main_gather}")
    emit({"phase": "profile", "cycle": prof})
    emit({"phase": "main_path", "fused_gather": True,
                      "launches": main_gather, "windows": len(run["docs"]),
                      "counters": run["counters"]})

    # 3b. main path through the pre-gathered launcher
    os.environ["DEEPFLOW_FUSED_GATHER"] = "0"
    reset_all_launch_counts()
    rate_sorted, per_cycle_sorted, _, _ = bench_cycle(dev, CYCLES // 2)
    main_sorted = all_launches()
    os.environ["DEEPFLOW_FUSED_GATHER"] = "1"
    check(main_sorted["segreduce_sorted"] > 0 and main_sorted["segreduce_gather"] == 0,
          f"pre-gathered main path launches {main_sorted}")

    # 3c. the sketch-on main path: the bench.py cycle, then L4Pipeline
    reset_all_launch_counts()
    rate_sketch, per_cycle_sketch, prof_sketch, _ = bench_cycle(dev, CYCLES,
                                                                with_profile=True,
                                                                sketch=sk_cfg)
    # the ingest of T0+4 (a 1-window advance) is profiled: the cascade
    # run's T0+41 ingest is the same work plus its tier step
    sk_run = pipeline_stream(dev, BATCH, list(range(6)), sketch=sk_cfg, profile_dt=4)
    main_sketch = all_launches()
    check(per_cycle_sketch == {"segreduce": 3, "sketch_fused": 4},
          f"sketch cycle launches {per_cycle_sketch}, want 3 segreduce + 4 sketch_fused")
    check(main_sketch["sketch_fused"] > 0 and main_sketch["segreduce_gather"] > 0,
          f"sketch main path launches {main_sketch}")
    check_pipeline_run(sk_run)
    blocks = sk_run["sketches"]
    counters = sk_run["counters"]
    check([b.window for b in blocks] == [T0 + s for s in range(6)],
          f"sketch blocks for windows {[b.window for b in blocks]}, want 6 seconds")
    check(sum(b.n_updates for b in blocks) == counters["sketch_rows"] > 0,
          "sketch blocks' n_updates do not sum to the sketch_rows counter")
    check(counters["sketch_shed"] == 0 and sk_run["sketch_blocks_dropped"] == 0,
          "the sketch plane shed rows or dropped blocks")
    check(max(sk_run["fetches"]) <= 3, f"host fetches per ingest {sk_run['fetches']}")
    distinct_err = []
    for b in blocks:
        exact = sk_run["clients"][b.window]
        distinct_err.append((b.distinct() - exact) / exact)
        check(abs(distinct_err[-1]) <= DISTINCT_RTOL,
              f"distinct() {b.distinct():.1f} vs exact {exact} for window {b.window}")
    emit({"phase": "profile_sketch", "cycle": prof_sketch})
    emit({"phase": "main_path_sketch", "launches": main_sketch,
          "ingest_t0_plus_4": sk_run["ingest_profile"],
                      "launches_per_cycle": per_cycle_sketch,
                      "fetches_per_ingest": sk_run["fetches"],
                      "distinct_rel_err": distinct_err,
                      "exact_clients": list(sk_run["clients"].values()),
                      "top3_first_window": blocks[0].topk(3),
                      "p50_rtt_first_window": blocks[0].quantile(0.5),
                      "counters": counters})

    # 3d. the merge fold: the bench.py cycle through fold_mode="merge",
    # whose stash must equal the full-fold cycle's row for row
    reset_all_launch_counts()
    rate_merge, per_cycle_merge, prof_merge, merge_state = bench_cycle(
        dev, CYCLES, with_profile=True, fold_mode="merge")
    main_merge = all_launches()
    check(main_merge["segreduce_gather"] > 0 and main_merge["sketch_fused"] == 0,
          f"merge cycle launches {main_merge}")
    for f in dataclasses.fields(merge_state):
        check(torch.equal(getattr(merge_state, f.name), getattr(full_state, f.name)),
              f"merge-fold stash lane {f.name} differs from the full fold's")
    emit({"phase": "merge_cycle", "launches": main_merge,
                      "launches_per_cycle": per_cycle_merge, "cycle": prof_merge,
                      "full_fold": prof["fold"], "stash_equal_to_full_fold": True})

    # 3e. the pool + merge main path: the bench.py cycle and L4Pipeline
    # with pooled sketch memory and the merge fold
    pool_cfg = pool_sketch_config()
    reset_all_launch_counts()
    rate_pool, per_cycle_pool, prof_pool, _ = bench_cycle(
        dev, CYCLES, with_profile=True, sketch=pool_cfg, fold_mode="merge")
    pool_run = pipeline_stream(dev, BATCH, list(range(6)), sketch=pool_cfg,
                               fold_mode="merge")
    main_pool = all_launches()
    check(main_pool["sketch_fused"] == 0 and main_pool["segreduce_gather"] > 0,
          f"pool + merge main path launches {main_pool}")
    check_pipeline_run(pool_run)
    check(same_docs(pool_run["docs"], run["docs"]),
          "pool + merge windows differ from the full-fold run's")
    p_counters = pool_run["counters"]
    check(p_counters["sketch_promotions"] >= 1, "no window promoted to the wide arena")
    check(max(pool_run["fetches"]) <= 3, f"host fetches per ingest {pool_run['fetches']}")
    slab_blocks = {b.window: b for b in blocks}
    spilled, pool_err = 0, []
    for b in pool_run["sketches"]:
        a = slab_blocks[b.window]
        if b.n_updates < a.n_updates:  # rows the pool could not seat
            spilled += a.n_updates - b.n_updates
            continue
        check(np.array_equal(a.hll, b.hll), f"pooled HLL differs from the slab's ({b.window})")
        exact = pool_run["clients"][b.window]
        pool_err.append((b.distinct() - exact) / exact)
        check(abs(pool_err[-1]) <= DISTINCT_RTOL,
              f"pooled distinct() {b.distinct():.1f} vs exact {exact} ({b.window})")
    check(pool_err and spilled == p_counters["sketch_pool_spill"]
          and sum(b.n_updates for b in pool_run["sketches"]) + spilled
          == p_counters["sketch_rows"], "pooled blocks do not account for every row")
    resident = {"slab": plane_bytes(sk_cfg, dev), "pool": plane_bytes(pool_cfg, dev)}
    emit({"phase": "profile_pool_merge", "cycle": prof_pool})
    emit({"phase": "main_path_pool_merge", "launches": main_pool,
                      "launches_per_cycle": per_cycle_pool,
                      "fetches_per_ingest": pool_run["fetches"],
                      "distinct_rel_err": pool_err, "spilled_rows": spilled,
                      "blocks": len(pool_run["sketches"]), "resident_bytes": resident,
                      "counters": p_counters})

    # 3f. the cascade main path: L4Pipeline with the slab sketch plane and
    # a minute + hour cascade over T0+34 … T0+45 and a drain. The advance
    # at T0+38 (hi = T0+36) appends one window's rows to the minute
    # tier; the one at T0+42 (hi = T0+40) closes the minute. Both run
    # under the profiler, and tier 0's inputs are kept for the timings;
    # the whole ingest of T0+41 (a 1-window advance) is profiled too
    from deepflow_tpu_torch.aggregator.cascade import CascadeConfig

    step_hi, close_hi = T0 + 36, T0 + 40
    reset_all_launch_counts()
    casc_run = pipeline_stream(
        dev, BATCH, CASCADE_SECONDS, sketch=sk_cfg, seed=0,
        cascade=CascadeConfig(intervals=CASCADE_INTERVALS, capacity=STASH_CAPACITY),
        profile_his=(step_hi, close_hi), capture_his=(step_hi, close_hi), profile_dt=41)
    main_cascade = all_launches()
    check(main_cascade["segreduce_gather"] > 0 and main_cascade["sketch_fused"] > 0,
          f"cascade main path launches {main_cascade}")
    casc_summary = check_cascade_run(casc_run, CASCADE_SECONDS)
    casc_timings = cascade_timings(casc_run, step_hi, close_hi)
    emit({"phase": "main_path_cascade", "launches": main_cascade,
          "stream_s": casc_run["seconds"], "ingest_t0_plus_41": casc_run["ingest_profile"],
                      "fetches_per_ingest": casc_run["fetches"], **casc_summary,
                      **casc_timings, "counters": casc_run["counters"]})

    # 3i. checkpoint round trip at the 3f widths (checkpoint_phase), then
    # 3j. kill and recover through the feeder runtime (recovery_phase)
    casc_cfg = CascadeConfig(intervals=CASCADE_INTERVALS, capacity=STASH_CAPACITY)
    main_ckpt, ckpt_summary = checkpoint_phase(dev, sk_cfg, casc_cfg, casc_run)
    emit({"phase": "checkpoint", "gpu": gpu, **ckpt_summary})
    del casc_run
    main_recovery_small, main_recovery_full, rec_summary = recovery_phase(dev, sk_cfg,
                                                                          casc_cfg)
    emit({"phase": "recovery", "gpu": gpu, **rec_summary})

    # 3k. the sharded path: BASELINE config 5 on 4 logical shards of the
    # card (sharded_phase)
    main_sharded, main_sharded_ckpt, main_sharded_casc, sharded_summary = sharded_phase(dev, gpu)
    emit({"phase": "sharded", **sharded_summary})
    torch.cuda.empty_cache()

    # 3l. the server deployment: receiver → decode → device enrichment →
    # columnar store → downsampler → SQL (server_phase)
    main_server, ds_parity, server_summary, plat, server_frames = server_phase(dev, gpu)
    emit({"phase": "server", **server_summary})
    torch.cuda.empty_cache()

    # 3m. the agent deployment: pcap replay → parse → FlowMap → L7 engine
    # → metric pipelines + minute flow logs → senders → the server's
    # metrics and flow-log ingesters over one store (agent_phase)
    main_agent, agent_summary = agent_phase(dev, gpu, plat)
    emit({"phase": "agent", **agent_summary})
    del plat
    torch.cuda.empty_cache()

    # 3n. self-observability: the standalone sketch functions card = CPU,
    # the multi-sort oracle, the ledger against the allocator, the
    # dogfood loop, telemetry() (selfobs_phase)
    main_selfobs, selfobs_summary = selfobs_phase(dev, sk_cfg)
    emit({"phase": "selfobs", "gpu": gpu, **selfobs_summary})
    torch.cuda.empty_cache()

    # 3o. window lineage on 3c's slab pipeline at full width (fetch parity
    # with the passive run, card = CPU on the records), and the doc feeder
    # with the push plane: events, standing queries, alert rules
    # (lineage_phase)
    main_lineage, lineage_summary = lineage_phase(dev, sk_cfg)
    emit({"phase": "lineage", **lineage_summary})
    torch.cuda.empty_cache()

    # 3p. the multi-process deployment: host processes over
    # MeshTopology.distributed sharing the card, at test size against the
    # CPU oracle and at full width against one process (mesh_phase)
    main_mesh_small, main_mesh_full, mesh_summary = mesh_phase(dev, gpu)
    emit({"phase": "multiprocess", **mesh_summary})
    torch.cuda.empty_cache()

    # 3q. the composed server: server.main.Server at 3l's width — its
    # resource plane, platform refresh, ingest, downsampling tick, REST,
    # debug, MCP and dfctl — against a CPU Server (composed_phase)
    main_composed, composed_summary = composed_phase(dev, gpu, server_frames)
    emit({"phase": "composed", **composed_summary})
    del server_frames
    torch.cuda.empty_cache()

    # 3r. the last slice's modules at test size: the rollup oracle against
    # the card's pipelines, eBPF sessions through them, and the fleet wire
    # pin with a publisher host on the card (remaining_phase)
    main_remaining, remaining_summary = remaining_phase(dev, gpu)
    emit({"phase": "remaining", **remaining_summary})

    # 3g. the counter ring and async drain at full width: the 3c stream,
    # 3 batches a second for T0 … T0+5, staged on the card once and
    # ingested by three pipelines in turn
    ring_seconds = [dt for dt in range(6) for _ in range(3)]
    staged = stage_stream(dev, ring_seconds)
    reset_all_launch_counts()
    profiled = (12, 13, 14, 15)
    oracle = ring_stream(dev, staged, sketch=sk_cfg, profile_at=profiled)
    ring = ring_stream(dev, staged, sketch=sk_cfg, profile_at=profiled, stats_ring=4)
    asy = ring_stream(dev, staged, sketch=sk_cfg, profile_at=profiled, async_drain=True)
    main_ring = all_launches()
    check(main_ring["segreduce_gather"] > 0 and main_ring["sketch_fused"] > 0,
          f"ring/async path launches {main_ring}")
    check_ring_async(oracle, ring, asy)
    ring_runs = {k: {"wall_s": r["wall_s"], "records_per_s": r["records_per_s"],
                     "device_idle_share_profiled": r["idle_share"], "fetches_18": r["fetches"],
                     "advances_18": r["advances"],
                     "profiled": {i: {f: p[f] for f in ("wall_ms", "device_busy_ms",
                                                        "kernel_launches", "copies")}
                                  for i, p in r["profiles"].items()}}
                 for k, r in (("sync", oracle), ("ring4", ring), ("async", asy))}
    emit({"phase": "ring_async", "launches": main_ring, "runs": ring_runs})
    del ring, asy

    # 3h. the live read: the K = 4 run with a forced snapshot after every
    # third ingest (after ingest 8 timed with CUDA events, after ingest 17
    # profiled: both fold the accumulator ring and read three windows),
    # then with pooled memory and the merge fold
    reset_all_launch_counts()
    live = ring_stream(dev, staged, sketch=sk_cfg, stats_ring=4, snapshot_every=3,
                       snapshot_how={8: "events", 17: "profile"})
    check_live_read(oracle, live)
    live_pool = ring_stream(dev, staged, sketch=pool_cfg, fold_mode="merge", stats_ring=4,
                            snapshot_every=3)
    main_live = all_launches()
    check(main_live["segreduce_gather"] > 0 and main_live["sketch_fused"] > 0,
          f"live read path launches {main_live}")
    check_live_read(oracle, live_pool)
    sides = {side for snap in live_pool["snapshots"] for side in snap.get("sides", ())}
    check(sides == {"compact", "wide"} and live_pool["counters"]["sketch_promotions"] >= 1,
          f"the pooled snapshots read the sides {sorted(sides)}")

    def snap_summary(snap):
        return {k: v for k, v in snap.items() if k != "snap"}

    live_summary = {"launches": main_live,
                    "slab": [snap_summary(x) for x in live["snapshots"]],
                    "pool": [snap_summary(x) for x in live_pool["snapshots"]],
                    "records_per_s_with_snapshots": {"slab": live["records_per_s"],
                                                     "pool": live_pool["records_per_s"]}}
    emit({"phase": "live_read", **live_summary})
    del staged, oracle, live, live_pool
    torch.cuda.empty_cache()

    # 4. card vs CPU on the same stream, exact; 4b with the sketch plane
    seconds = [0, 0, 1, 2, 1, 3, 4, 6, 3, 5, 8]  # the second 3 is late
    card = pipeline_stream(dev, SMALL_BATCH, seconds)
    host = pipeline_stream("cpu", SMALL_BATCH, seconds)
    check_card_vs_cpu(card, host)
    emit({"phase": "card_vs_cpu", "windows": len(card["docs"]),
                      "docs": card["counters"]["flushed_doc"]})
    card = pipeline_stream(dev, SMALL_BATCH, seconds, sketch=sk_cfg)
    host = pipeline_stream("cpu", SMALL_BATCH, seconds, sketch=sk_cfg)
    check_card_vs_cpu(card, host)
    moved = check_sketch_blocks_card_vs_cpu(card["sketches"], host["sketches"])
    emit({"phase": "card_vs_cpu_sketch", "windows": len(card["docs"]),
                      "blocks": len(card["sketches"]), "hist_counts_moved": moved})
    # 4c. pooled sketch memory and the merge fold, card vs CPU
    card = pipeline_stream(dev, SMALL_BATCH, seconds, sketch=pool_cfg, fold_mode="merge")
    host = pipeline_stream("cpu", SMALL_BATCH, seconds, sketch=pool_cfg, fold_mode="merge")
    check_card_vs_cpu(card, host)
    moved = check_sketch_blocks_card_vs_cpu(card["sketches"], host["sketches"],
                                            coarsen=pool_cfg.pool.hist_factor)
    check(card["counters"]["sketch_promotions"] >= 1, "4c: no promotion at 2^14 rows")
    emit({"phase": "card_vs_cpu_pool_merge", "windows": len(card["docs"]),
                      "blocks": len(card["sketches"]), "hist_counts_moved": moved,
                      "promotions": card["counters"]["sketch_promotions"],
                      "pool_spill": card["counters"]["sketch_pool_spill"]})
    # 4d. the cascade, card vs CPU: 2^16-row window and tier stashes, ~12k
    # docs a second. Seconds T0+34 … T0+45 cross the minute boundary with
    # one-window advances (the fifth finds the tier ring full:
    # fold+append); the jump to T0+140 flushes the three open windows,
    # more rows than the 2^15-row prefix (direct fold). Once with the full
    # fold and the slab plane, once with the merge fold and pooled memory
    small_casc = CascadeConfig(intervals=CASCADE_INTERVALS, capacity=TIER_SMALL)
    for label, cfg, mode, coarsen in (("slab_full", sk_cfg, "full", 1),
                                      ("pool_merge", pool_cfg, "merge",
                                       pool_cfg.pool.hist_factor)):
        kw = dict(sketch=cfg, fold_mode=mode, cascade=small_casc, capacity=TIER_SMALL,
                  tuples=TIER_SMALL_TUPLES)
        card = pipeline_stream(dev, SMALL_BATCH, CASCADE_SECONDS + [140], **kw)
        host = pipeline_stream("cpu", SMALL_BATCH, CASCADE_SECONDS + [140], **kw)
        if label == "slab_full":
            casc_host = host  # 4f's uninterrupted run
        check_card_vs_cpu(card, host)
        moved = check_sketch_blocks_card_vs_cpu(card["sketches"], host["sketches"],
                                                coarsen=coarsen)
        moved += check_sketch_blocks_card_vs_cpu(card["tier_sketches"],
                                                 host["tier_sketches"], coarsen=coarsen)
        branches = advance_branches(card["advances"])
        check(branches == advance_branches(host["advances"]), "4d: tier-step branches differ")
        check("fold_append" in branches and "direct" in branches,
              f"4d: the stream took the branches {branches}")
        check(card["cascade_lanes"][0] > 0 and card["cascade_lanes"][1] == 0,
              f"4d: cascade lanes {card['cascade_lanes']}")
        emit({"phase": f"card_vs_cpu_cascade_{label}",
                          "windows": len(card["docs"]), "tier_windows": len(card["tiers"]),
                          "tier_blocks": len(card["tier_sketches"]),
                          "hist_counts_moved": moved, "branches": branches,
                          "tier0_totals": [int(r["total"]) for r in card["advances"]],
                          "prefix": card["advances"][0]["prefix"],
                          "card_s": card["seconds"], "cpu_s": host["seconds"],
                          "cascade_lanes": card["cascade_lanes"]})

    # 4e. the counter ring with interleaved snapshots (slab + full fold,
    # pool + merge fold) and async drain, card vs CPU on the 4-series stream
    for label, cfg, mode, coarsen, wkw, every in (
            ("ring_slab_full", sk_cfg, "full", 1, dict(stats_ring=4), 2),
            ("ring_pool_merge", pool_cfg, "merge", pool_cfg.pool.hist_factor,
             dict(stats_ring=4), 2),
            ("async_slab_full", sk_cfg, "full", 1, dict(async_drain=True), None)):
        kw = dict(sketch=cfg, fold_mode=mode, window_kw=wkw, snapshot_every=every)
        card = pipeline_stream(dev, SMALL_BATCH, seconds, **kw)
        host = pipeline_stream("cpu", SMALL_BATCH, seconds, **kw)
        check_card_vs_cpu(card, host)
        moved = check_sketch_blocks_card_vs_cpu(card["sketches"], host["sketches"],
                                                coarsen=coarsen)
        if every:
            moved += check_snapshots_card_vs_cpu(card["snapshots"], host["snapshots"],
                                                 coarsen=coarsen)
        emit({"phase": f"card_vs_cpu_{label}", "windows": len(card["docs"]),
              "blocks": len(card["sketches"]), "snapshots": len(card["snapshots"]),
              "snapshot_windows": sum(len(x.windows) for x in card["snapshots"]),
              "hist_counts_moved": moved, "card_s": card["seconds"], "cpu_s": host["seconds"]})

    # 4f. checkpoints card = CPU (checkpoint_card_vs_cpu)
    emit({"phase": "card_vs_cpu_checkpoint",
          **checkpoint_card_vs_cpu(dev, sk_cfg, small_casc, casc_host)})
    del casc_host

    # 5. result lines
    kernels = []
    launches = {"segreduce_gather": (main_gather, per_cycle_gather),
                "segreduce_sorted": (main_sorted, per_cycle_sorted)}
    for k, replaces in KERNELS.items():
        shapes = results[k]
        pre = shapes["prereduce"]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[k][0][k],
            "launches_per_cycle": launches[k][1]["segreduce"],
            "parity": {"ok": all(r["parity_ok"] for r in shapes.values()),
                       "sum_rtol": SUM_RTOL, "max": "exact",
                       "against": "sorted_segment_sum_max_plain"},
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{f: pre[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library")},
            "shape": "prereduce", "fold": shapes["fold"], "merge_fold": shapes["merge_fold"],
            "tier_fold": shapes["tier_fold"],
            # the merge-fold cycle, the pool + merge main path and the
            # cascade main path, each with its counts zeroed before it and
            # read after it
            "launches_merge_cycles": main_merge[k], "launches_pool_merge": main_pool[k],
            "launches_cascade": main_cascade[k], "launches_ring_async": main_ring[k],
            "launches_live_read": main_live[k], "launches_checkpoint": main_ckpt[k],
            "launches_recovery_test_size": main_recovery_small[k],
            "launches_recovery_full_width": main_recovery_full[k],
            "launches_sharded": main_sharded[k],
            "launches_sharded_checkpoint": main_sharded_ckpt[k],
            "launches_sharded_cascade": main_sharded_casc[k],
            "launches_server": main_server[k], "launches_agent": main_agent[k],
            "launches_selfobs": main_selfobs[k], "launches_lineage": main_lineage[k],
            # 3p: summed over the host processes (each counts its own)
            "launches_multiprocess": main_mesh_full[k],
            "launches_multiprocess_test_size": main_mesh_small[k],
            "launches_composed": main_composed[k],
            "launches_remaining": main_remaining[k],
        })
    # the server path's downsample group-by (fused gather only)
    check(kernels[0]["name"] == "segreduce_gather", "kernels line order")
    kernels[0]["downsample"] = ds_parity
    kernels[0]["parity"]["ok"] = kernels[0]["parity"]["ok"] and ds_parity["parity_ok"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], ds_parity["max_abs_err"])
    sk_name, sk_replaces, sk_source = SKETCH_KERNEL
    kernels.append({
        "name": sk_name, "route": "cuda", "source": sk_source, "replaces": sk_replaces,
        "launches": main_sketch[sk_name],
        "launches_per_cycle": per_cycle_sketch[sk_name],
        "launches_pool_merge": main_pool[sk_name],
        "launches_cascade": main_cascade[sk_name],
        "launches_ring_async": main_ring[sk_name], "launches_live_read": main_live[sk_name],
        "launches_checkpoint": main_ckpt[sk_name],
        "launches_recovery_test_size": main_recovery_small[sk_name],
        "launches_recovery_full_width": main_recovery_full[sk_name],
        "launches_sharded": main_sharded[sk_name],
        "launches_sharded_checkpoint": main_sharded_ckpt[sk_name],
        "launches_sharded_cascade": main_sharded_casc[sk_name],
        "launches_server": main_server[sk_name], "launches_agent": main_agent[sk_name],
        "launches_selfobs": main_selfobs[sk_name],
        "launches_lineage": main_lineage[sk_name],
        "launches_multiprocess": main_mesh_full[sk_name],
        "launches_multiprocess_test_size": main_mesh_small[sk_name],
        "launches_composed": main_composed[sk_name],
        "launches_remaining": main_remaining[sk_name],
        "parity": {"ok": sketch_res["parity_ok"], "hll_cms": "exact",
                   "topk_lanes": "exact", "against": "sketch_update_fused_plain"},
        **{k: sketch_res[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "device_launches_per_call", "wrapper_host_ms")},
        "shape": {k: sketch_res[k] for k in ("rows", "live_rows", "heads", "hll_cells",
                                             "cms_cells", "buckets_hit", "bytes")},
    })
    print(json.dumps({"metric": "port_bench_cycle_records_per_sec",
                      "value": rate_gather, "value_pregather": rate_sorted,
                      "unit": "records/s", "gpu": gpu, "batch": BATCH,
                      "capacity": CAPACITY, "accum_batches": ACCUM_BATCHES,
                      "unique_cap": UNIQUE_CAP, "device_idle_share": prof["idle_share"],
                      "launches_per_cycle": prof["kernel_launches"]}))
    print(json.dumps({"metric": "port_bench_cycle_sketch_records_per_sec",
                      "value": rate_sketch, "unit": "records/s", "gpu": gpu,
                      "batch": BATCH, "device_idle_share": prof_sketch["idle_share"],
                      "launches_per_cycle": prof_sketch["kernel_launches"],
                      "sketch": dataclasses.asdict(sk_cfg)}))
    print(json.dumps({"metric": "port_bench_cycle_merge_records_per_sec",
                      "value": rate_merge, "value_pool_merge": rate_pool,
                      "unit": "records/s", "gpu": gpu, "batch": BATCH,
                      "device_idle_share": prof_merge["idle_share"],
                      "device_idle_share_pool_merge": prof_pool["idle_share"],
                      "launches_per_cycle": prof_merge["kernel_launches"],
                      "launches_per_cycle_pool_merge": prof_pool["kernel_launches"],
                      "launches_per_fold": {"merge": prof_merge["fold"]["kernel_launches"],
                                            "full": prof["fold"]["kernel_launches"]},
                      "sketch": dataclasses.asdict(pool_cfg)}))
    print(json.dumps({"metric": "port_ring_async_records_per_sec", "unit": "records/s",
                      "gpu": gpu, "batch": BATCH, "ingests": len(ring_seconds),
                      **{k: {f: r[f] for f in ("records_per_s", "wall_s",
                                               "device_idle_share_profiled", "fetches_18")}
                         for k, r in ring_runs.items()}}))
    timed = {x["ingest"]: x for x in live_summary["slab"]}
    print(json.dumps({"metric": "port_snapshot_ms", "value": timed[8]["ms"], "gpu": gpu,
                      "device_ms": timed[17]["device_ms"], "copy_ms": timed[17]["copy_ms"],
                      "launches": timed[17]["launches"],
                      "rows": timed[8]["rows"], "bytes": timed[8]["bytes"],
                      "windows": timed[8]["windows"], "fetches": timed[8]["fetches"]}))
    sh = sharded_summary
    print(json.dumps({"metric": "port_sharded_records_per_sec", "value": sh["records_per_s"],
                      "unit": "records/s", "gpu": gpu, "shards": SHARDS, "batch": BATCH,
                      "device_idle_share": sh["profiled_ingest"]["idle_share"],
                      "launches_per_ingest": sh["launches_per_ingest"],
                      "window_close_ms": sh["window_close_ms"],
                      "fetches_per_ingest": max(sh["fetches_per_ingest"]),
                      "drain_fetches": sh["drain_fetches"],
                      "checkpoint": {k: sh["checkpoint"][k] for k in (
                          "raw_bytes", "disk_bytes", "save_s", "load_s")}}))
    sv = server_summary
    print(json.dumps({"metric": "port_server_docs_per_sec", "value": sv["docs_per_s"],
                      "unit": "docs/s", "gpu": gpu, "docs": sv["docs"],
                      "workers": 4, "enrich_chunk": {k: sv["enrich_chunk"][k] for k in (
                          "device_ms", "kernel_launches", "wall_ms")},
                      "fetches_per_chunk": sv["fetches_per_chunk"],
                      "downsample": {k: sv["downsample"][k] for k in (
                          "rows_in", "rows_out", "wall_ms", "device_ms")},
                      "query_ms_median": sv["query_ms"]["median"]}))
    ag = agent_summary
    for metric, unit in (("packets", "packets/s"), ("requests", "requests/s")):
        print(json.dumps({"metric": f"port_agent_{metric}_per_sec",
                          "value": ag[f"{metric}_per_s"], "unit": unit, "gpu": gpu,
                          "packets": ag["packets"], "requests": ag["requests"],
                          "run_pcap_s": ag["run_pcap_s"], "fetches": ag["fetches"],
                          "stored_rows": ag["stored_rows"], "docs_written": ag["docs_written"]}))
    mf, ms = mesh_summary["full_width"], mesh_summary["test_size"]
    print(json.dumps({"metric": "port_multiprocess_records_per_sec",
                      "value": mf["aggregate_records_per_s"], "unit": "records/s", "gpu": gpu,
                      "hosts": 2, "per_host": mf["records_per_s"],
                      "init_process_group_s": mf["init_process_group_s"],
                      "fetches_per_ingest": mf["fetches_per_ingest"],
                      "idle_share_profiled_ingest": [p["idle_share"]
                                                     for p in mf["profiled_ingest"]],
                      "launches_profiled_ingest": [p["kernel_launches"]
                                                   for p in mf["profiled_ingest"]],
                      "handover_ms": ms["handover_ms"], "handoff_frames": ms["handoff_frames"]}))
    cs = composed_summary
    print(json.dumps({"metric": "port_composed_server_docs_per_sec", "value": cs["docs_per_s"],
                      "unit": "docs/s", "gpu": gpu, "docs": cs["docs"], "workers": 4,
                      "boot_s": cs["boot_s"], "refresh_platform_ms": cs["refresh_platform_ms"],
                      "downsample_tick_ms": cs["downsample_tick"]["wall_ms"],
                      "rest_query_ms_median": cs["rest_query_ms"]["median"],
                      "fetches_per_chunk": cs["fetches_per_chunk"],
                      "launches": cs["launches"],
                      "idle_share_downsample_tick": cs["downsample_tick"]["idle_share"]}))
    print(json.dumps({"phase": "profiler_gaps", "gaps": PROFILER_GAPS}))
    print(json.dumps({"gpu": gpu, "kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
