"""Wire-plane subprocess host for the port (the twin of
tests/wire_host.py; imports neither JAX nor the JAX package).

One REAL process playing a pipeline host: local store + event bus +
SubscriptionManager + a `WirePublisher` dialed into the parent test's
`FleetSubscriptionRouter`. The parent opens wire watchers FIRST (so
the router broadcasts the `sub` the moment this host says hello), this
host then drives a deterministic insert → WindowClosed schedule and
records, via a local callback watcher on the SAME subscription the
publisher serves, the ORACLE: exactly what a direct local subscription
delivered for every eval. The parent compares the router's merged
envelopes bit-exact against this oracle — same payload builder
(`result_to_jsonable`), so equality is plain `==` on parsed JSON.

The result file is rewritten ATOMICALLY after every step, so a host
the parent SIGKILLs mid-run (the kill-one-host leg) still leaves a
valid partial record behind. After its steps the host parks with the
publisher connected (heartbeating the uplink) until `stop_file`
appears — the parent owns the clock.

Spec (argv[1], JSON):
  host          label this publisher hellos as
  router        [ip, port] of the parent's FleetSubscriptionRouter
  seq_base      publisher sequence floor (respawned generation must
                start ABOVE its predecessor's or router dedup eats it)
  t0            first sample/window data time
  steps         number of insert+WindowClosed event batches
  value_base    sample value at step k is value_base + k
  step_sleep_s  pause between batches (lets the wire drain in order)
  alert_at      step index whose value also breaches the alert rule
                (-1 = no alert engine)
  out           result JSON path (atomic rewrite per step)
  stop_file     exit cleanly once this path exists
  device        the subscriptions' device (default "cpu"; "cuda:0" on
                the card)
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from deepflow_tpu_torch.integration.dfstats import (
    DEEPFLOW_SYSTEM_DB,
    DEEPFLOW_SYSTEM_TABLE,
    ensure_system_table,
)
from deepflow_tpu_torch.integration.formats import pack_tags
from deepflow_tpu_torch.querier.events import QueryEventBus, WindowClosed
from deepflow_tpu_torch.querier.live import LiveRegistry
from deepflow_tpu_torch.querier.subscribe import SubscriptionManager
from deepflow_tpu_torch.storage.store import ColumnarStore
from deepflow_tpu_torch.wire.publisher import WirePublisher, result_to_jsonable


def _insert(store, t: int, metric: str, value: float, labels: str) -> None:
    store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, {
        "time": np.asarray([t], np.uint32),
        "metric": np.asarray([metric], object),
        "labels": np.asarray([labels], object),
        "value": np.asarray([value], np.float64),
    })


def _dump(path: str, record: dict) -> None:
    tmp = path + ".tmp"
    Path(tmp).write_text(json.dumps(record, default=str))
    os.replace(tmp, path)  # atomic: a SIGKILL never leaves half a file


def main(spec: dict) -> None:
    host = spec["host"]
    store = ColumnarStore()
    ensure_system_table(store)
    bus = QueryEventBus(name=f"wire-{host}")
    # no connect_store_events: batches are published EXPLICITLY below,
    # so event_batches == steps == evals is exact, not wall-clock noisy
    device = spec.get("device", "cpu")
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False,
                               bus=bus, name=f"wire-{host}", device=device)
    alerts = None
    if int(spec.get("alert_at", -1)) >= 0:
        from deepflow_tpu_torch.querier.alerts import AlertEngine, AlertRule

        alerts = AlertEngine(store, live=LiveRegistry(), bus=bus,
                             name=f"wire-{host}", log_sink=False, device=device)
        alerts.add_rule(AlertRule(
            name="wire_hot", query="m", comparator=">",
            threshold=float(spec["value_base"]) + spec["alert_at"] - 0.5,
            for_s=0, lookback_s=2,
        ))
    pub = WirePublisher(
        (spec["router"][0], int(spec["router"][1])), host=host,
        subscriptions=subs, alerts=alerts,
        seq_base=int(spec.get("seq_base", 0)),
    )

    # wait for the router's `sub` (it broadcasts on our hello because
    # the parent's watchers are already attached)
    deadline = time.monotonic() + 30.0
    while not pub.active_queries():
        if time.monotonic() > deadline:
            _dump(spec["out"], {"host": host, "error": "no sub from router"})
            sys.exit(3)
        time.sleep(0.01)
    qid, sub = pub.active_queries()[0]

    oracle: list[dict] = []

    def oracle_cb(result, s):
        # the publisher's callback watcher was attached FIRST, so by the
        # time this runs the frame for this eval is already queued; both
        # see the identical result object of the ONE shared eval
        oracle.append({
            "now": int(s.last_now),
            "series": result_to_jsonable(result),
        })

    sub.watch(oracle_cb)

    t0 = int(spec["t0"])
    base = float(spec["value_base"])
    record = {
        "host": host, "query_id": qid, "pid": os.getpid(),
        "steps_done": 0, "oracle": oracle,
    }
    for k in range(int(spec["steps"])):
        _insert(store, t0 + k, "m", base + k, pack_tags({"src": host}))
        bus.publish(WindowClosed(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE,
                                 t0 + k))
        record["steps_done"] = k + 1
        record["evals"] = sub.evals
        record["event_batches"] = subs.get_counters()["event_batches"]
        record["publisher"] = pub.get_counters()
        _dump(spec["out"], record)
        time.sleep(float(spec.get("step_sleep_s", 0.05)))

    pub.flush(timeout_s=30.0)
    record["publisher"] = pub.get_counters()
    record["flushed"] = True
    _dump(spec["out"], record)

    # park connected until the parent says stop (keeps the uplink
    # alive so the parent can kill THIS process to exercise staleness)
    stop = Path(spec["stop_file"])
    deadline = time.monotonic() + 300.0
    while not stop.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    pub.close()
    record["publisher"] = pub.get_counters()
    record["stopped"] = True
    _dump(spec["out"], record)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
