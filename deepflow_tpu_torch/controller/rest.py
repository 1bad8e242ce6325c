"""Controller + querier REST API — the HTTP surface the reference spreads
across controller/http (resource/agent management, ~10k LoC of gin
routes), querier/router (POST /v1/query SQL, PromQL), and the pprof
listener on :9526 (cmd/server/main.go:53). One ThreadingHTTPServer over
the composition root:

  GET    /v1/health                      liveness + leader flag
  GET    /v1/agents                      receiver-tracked agent status
  GET    /v1/resources                   kinds summary
  GET    /v1/resources/<kind>            list
  POST   /v1/resources/<kind>            upsert {id, name, ...attrs}
  DELETE /v1/resources/<kind>/<id>       delete
  GET    /v1/datasources                 downsampler datasources
  POST   /v1/datasources                 add {base_table, interval, ...}
  DELETE /v1/datasources/<name>
  GET    /v1/counters                    self-telemetry snapshot
  POST   /v1/query                       {"sql": ...} → rows (querier)
  GET    /v1/prom?query=&time=           PromQL instant
  GET    /v1/prom/range?query=&start=&end=&step=   PromQL range
  GET    /v1/traces/<trace_id>           assembled trace tree
  GET    /v1/trace/window/<window_id>    window lineage tree
                                         (?interval=&service=&org= — the
                                         trace id derives from the
                                         window id, no lookup)
  GET    /v1/tracemap?start=&end=        service-edge aggregation
  GET    /v1/profile/device              device profiling plane: device
                                         ledger + step census
                                         (?analyze=0 skips analysis)
  GET    /v1/fleet/health                fleet fan-in status
  GET    /v1/fleet/hosts                 per-host roster + staleness
  GET    /v1/fleet/skew                  cross-host imbalance surfaces
  GET    /v1/watch?promql=|sql=|alerts=1 wire delivery lane:
                                         SSE stream off the push plane,
                                         one bounded watcher queue per
                                         connection (?span_s=&step=&db=
                                         &table=&scope=local|fleet&
                                         maxlen=&lease_s=&max_events=)
  GET    /v1/wire                        wire counters + live
                                         per-connection rows
  GET    /v1/profile/stacks              all live thread stacks (pprof
                                         goroutine-dump analog)
  GET    /v1/profile/cpu?seconds=N       folded stack samples (pprof
                                         profile analog; same folded
                                         format the profile ingester
                                         consumes)

Writes are leader-gated like the reference's controller (election.go):
a follower answers 421 with the leader hint.

Port copy of deepflow_tpu/controller/rest.py.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

MAX_BODY = 4 << 20


def _thread_stacks() -> dict[str, list[str]]:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(tid, 'thread')}-{tid}": traceback.format_stack(frame)
        for tid, frame in frames.items()
    }


def _sample_cpu(seconds: float, hz: float = 99.0) -> dict[str, int]:
    """Folded-stack sampler over all threads (the perf_profiler seat for
    the server itself; output feeds parse_folded/profile ingest)."""
    folded: dict[str, int] = {}
    deadline = time.monotonic() + seconds
    period = 1.0 / hz
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                parts.append(f.f_code.co_name)
                f = f.f_back
            stack = ";".join(reversed(parts))
            folded[stack] = folded.get(stack, 0) + 1
        time.sleep(period)
    return folded


def _q_time_range(q) -> tuple[int, int] | None:
    """start/end unix-second query params → store time_range (Grafana
    sends these on trace lookups and tracemap queries)."""
    if q.get("start") or q.get("end"):
        return (int(q.get("start") or 0), int(q.get("end") or (1 << 31)))
    return None


class RestServer:
    def __init__(self, server, *, host: str = "127.0.0.1", port: int = 0):
        self._df = server
        rest = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY:
                    raise ValueError("body too large")
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                try:
                    rest._get(self)
                except Exception as e:
                    self._json({"error": repr(e)}, 500)

            def do_POST(self):
                try:
                    rest._post(self)
                except Exception as e:
                    self._json({"error": repr(e)}, 500)

            def do_DELETE(self):
                try:
                    rest._delete(self)
                except Exception as e:
                    self._json({"error": repr(e)}, 500)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # -- leader gate ----------------------------------------------------
    def _is_leader(self) -> bool:
        el = getattr(self._df, "election", None)
        return el.is_leader() if el else True

    # -- GET -------------------------------------------------------------
    def _get(self, h) -> None:
        u = urlparse(h.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        parts = [p for p in u.path.split("/") if p]
        df = self._df
        if u.path == "/v1/health":
            h._json({"status": "ok", "leader": self._is_leader()})
        elif u.path == "/v1/agents":
            h._json(
                [
                    {
                        "agent_id": a.agent_id,
                        "org_id": a.org_id,
                        "team_id": a.team_id,
                        "addr": str(a.addr),
                        "first_seen": a.first_seen,
                        "last_seen": a.last_seen,
                        "frames": a.frames,
                        "bytes": a.bytes,
                    }
                    for a in df.receiver.agent_list()
                ]
            )
        elif u.path == "/v1/resources":
            h._json({k: len(v) for k, v in df.resources.iter_kinds()})
        elif len(parts) == 3 and parts[:2] == ["v1", "resources"]:
            h._json(
                [
                    {"id": r.id, "name": r.name, **r.attrs}
                    for r in df.resources.list(parts[2])
                ]
            )
        elif u.path == "/v1/datasources":
            # store-side downsampler jobs + the tiers the rollup cascade
            # serves natively on device — one listing so the
            # operator sees every granularity and who materializes it
            from ..server.datasource import list_cascade_tiers

            h._json(
                [
                    {
                        "name": d.name,
                        "base_table": d.base_table,
                        "interval": d.interval,
                        "retention_hours": d.retention_hours,
                        "served_by": "downsampler",
                    }
                    for d in df.downsampler.list()
                ]
                + list_cascade_tiers()
            )
        elif u.path == "/v1/counters":
            from ..utils.stats import default_collector

            h._json(
                [
                    {"module": p.module, "tags": p.tags, "fields": p.fields}
                    for p in default_collector.tick()
                ]
            )
        elif u.path == "/v1/query/catalog":
            # db_descriptions seat: tag + metric catalogs per table
            h._json(df.query.catalogs(q.get("table", "network")))
        elif u.path == "/v1/query/tables":
            h._json({db: sorted(df.store.tables(db)) for db in df.store.databases()})
        elif u.path == "/v1/prom":
            from ..querier.promql import query_instant

            h._json(
                query_instant(df.store, q["query"], int(q.get("time") or time.time()))
            )
        elif u.path == "/v1/prom/range":
            from ..querier.promql import query_range

            h._json(
                query_range(
                    df.store,
                    q["query"],
                    int(q["start"]),
                    int(q["end"]),
                    int(q.get("step") or 60),
                )
            )
        elif len(parts) == 4 and parts[:3] == ["v1", "trace", "window"]:
            # window lineage plane: the trace id is DERIVED
            # from (service, interval, window id) — no lookup table
            try:
                wid = int(parts[3])
            except ValueError:
                h._json({"error": "window id must be an integer"}, 400)
                return
            out = df.query_window_trace(
                wid,
                interval=int(q.get("interval") or 1),
                service=q.get("service") or None,
                org=int(q.get("org") or 1),
            )
            h._json(out if out is not None else {"error": "not found"},
                    200 if out is not None else 404)
        elif len(parts) == 3 and parts[:2] == ["v1", "traces"]:
            out = df.query_trace(parts[2], org=int(q.get("org") or 1))
            h._json(out if out is not None else {"error": "not found"},
                    200 if out is not None else 404)
        elif len(parts) == 3 and parts[:2] == ["api", "traces"]:
            # Tempo datasource shape (Grafana points here)
            from ..tracing.query import tempo_trace

            out = tempo_trace(
                df.store, parts[2], org=int(q.get("org") or 1),
                time_range=_q_time_range(q),
            )
            h._json(out if out is not None else {"error": "trace not found"},
                    200 if out is not None else 404)
        elif u.path == "/v1/tracemap":
            h._json(df.trace_map(time_range=_q_time_range(q), org=int(q.get("org") or 1)))
        elif u.path == "/v1/profile/device":
            # device profiling plane: the device-memory ledger (per
            # owner × plane bytes + watermarks, zero device fetches) and
            # the step-cost census (per step × bucket: the bytes bound,
            # logical sorts and first-dispatch wall time). The keys keep
            # the reference's names ("hbm", "hbm_totals").
            from ..profiling import default_census, default_ledger

            analyze = (q.get("analyze") or "1") not in ("0", "false")
            h._json({
                "hbm": default_ledger.snapshot(),
                "hbm_totals": default_ledger.get_counters(),
                "census": default_census.snapshot(analyze=analyze),
            })
        elif len(parts) == 3 and parts[:2] == ["v1", "fleet"]:
            # fleet telemetry pane: merged cross-host views
            # from the in-process FleetAggregator; 404 when the server
            # runs without the fleet plane enabled
            agg = getattr(df, "fleet", None)
            if agg is None:
                h._json({"error": "fleet plane not enabled"}, 404)
            elif parts[2] == "health":
                h._json(agg.health())
            elif parts[2] == "hosts":
                h._json(agg.hosts())
            elif parts[2] == "skew":
                h._json(agg.skew())
            else:
                h._json({"error": "not found"}, 404)
        elif u.path == "/v1/watch":
            # wire delivery lane: the hub owns the whole
            # SSE exchange — headers, per-result writes, heartbeats,
            # disconnect containment — on THIS handler thread
            hub = getattr(df, "wire", None)
            if hub is None:
                h._json({"error": "wire plane not enabled"}, 404)
            else:
                hub.serve_sse(h, q)
        elif u.path == "/v1/wire":
            hub = getattr(df, "wire", None)
            if hub is None:
                h._json({"error": "wire plane not enabled"}, 404)
            else:
                out = {
                    "counters": hub.get_counters(),
                    "connections": hub.connections(),
                }
                router = getattr(hub, "router", None)
                if router is not None:
                    out["router"] = router.get_counters()
                    out["router_hosts"] = router.hosts()
                    out["router_entries"] = router.entries()
                h._json(out)
        elif u.path == "/v1/profile/stacks":
            h._json(_thread_stacks())
        elif u.path == "/v1/profile/cpu":
            secs = min(float(q.get("seconds") or 1.0), 30.0)
            folded = _sample_cpu(secs)
            body = "\n".join(f"{k} {v}" for k, v in sorted(folded.items()))
            data = body.encode()
            h.send_response(200)
            h.send_header("Content-Type", "text/plain")
            h.send_header("Content-Length", str(len(data)))
            h.end_headers()
            h.wfile.write(data)
        else:
            h._json({"error": "not found"}, 404)

    # -- POST ------------------------------------------------------------
    def _post(self, h) -> None:
        u = urlparse(h.path)
        parts = [p for p in u.path.split("/") if p]
        df = self._df
        if u.path == "/v1/query":
            body = h._body()
            res = df.query.execute(body["sql"])
            h._json({"columns": res.columns, "rows": res.to_dicts()})
            return
        if not self._is_leader():
            h._json({"error": "not leader"}, 421)
            return
        if len(parts) == 3 and parts[:2] == ["v1", "resources"]:
            body = h._body()
            rid = int(body.pop("id"))
            name = str(body.pop("name", f"{parts[2]}-{rid}"))
            r = df.resources.put(parts[2], rid, name, **body)
            h._json({"id": r.id, "name": r.name, **r.attrs}, 201)
        elif u.path == "/v1/datasources":
            from ..server.datasource import DataSource

            body = h._body()
            ds = df.downsampler.add(DataSource(**body))
            h._json({"name": ds.name}, 201)
        else:
            h._json({"error": "not found"}, 404)

    # -- DELETE ----------------------------------------------------------
    def _delete(self, h) -> None:
        u = urlparse(h.path)
        parts = [p for p in u.path.split("/") if p]
        df = self._df
        if not self._is_leader():
            h._json({"error": "not leader"}, 421)
            return
        if len(parts) == 4 and parts[:2] == ["v1", "resources"]:
            ok = df.resources.delete(parts[2], int(parts[3]))
            h._json({"deleted": ok}, 200 if ok else 404)
        elif len(parts) == 3 and parts[:2] == ["v1", "datasources"]:
            df.downsampler.delete(parts[2])
            h._json({"deleted": True})
        else:
            h._json({"error": "not found"}, 404)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
