"""dfctl — the deepflow-ctl seat (cli/ctl/).

Commands mirror the reference CLI surface that applies to this build:

  dfctl server -f config.yaml            run the composed server
    [--device cuda]                      (its device work on --device)
  dfctl query  --store DIR "SQL"         SQL over a store
    [--device cuda]                      (aggregates reduce on --device)
  dfctl promql --store DIR "EXPR" -t T   PromQL instant query
  dfctl metrics --store DIR TABLE        metric catalog for a table
  dfctl tables --store DIR               db/table/row inventory
  dfctl flame  --store DIR --service S   flame tree JSON
  dfctl counters --port P [--module M]   live counter dump (debug UDP)
  dfctl agents --port P                  agent liveness (debug UDP)
  dfctl datasource ... (list/add)        downsampler management
  dfctl subscriptions --port P           push-plane standing queries:
                                         watcher counts + eval latency
  dfctl alerts --port P                  alert rules: state, value,
                                         last transition
  dfctl rest --port P METHOD PATH [JSON] controller REST (agent-group /
                                         domain / resource mgmt seats:
                                         resources, datasources, traces,
                                         tracemap, prom, profile)
  dfctl profile --port P device          device profiling plane: device
                                         ledger + step census
                                         (--no-analyze skips analysis;
                                         --json for machine output)
  dfctl fleet --port P health|hosts|skew fleet pane: merged
                                         cross-host status, per-host
                                         roster + staleness, skew
                                         surfaces (--json for machine
                                         output)
  dfctl watch --port P QUERY             wire delivery lane:
                                         stream push-plane results over
                                         GET /v1/watch as they arrive
                                         (--sql for SQL, --alerts for
                                         the notification topic, --json
                                         for raw events; reconnects
                                         with capped backoff)
  dfctl agent-group --port P ...         trisolaris group config/upgrade
  dfctl plugin --dir D list              L7 protocol plugin inventory
  dfctl trace --port P TRACE_ID          assembled trace tree (REST)
  dfctl trace --port P window WID        window lineage tree (
                                         the pipeline traced by its own
                                         trace engine; --interval for
                                         cascade tiers, --service)

Port copy of deepflow_tpu/cli.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _store(args):
    from .storage.store import ColumnarStore

    if not args.store:
        sys.exit("--store DIR is required for this command")
    return ColumnarStore(args.store)


def cmd_query(args):
    from .querier import QueryEngine

    r = QueryEngine(_store(args), device=args.device).execute(args.sql)
    print(json.dumps(r.to_dicts(), default=str, indent=None))


def cmd_promql(args):
    from .querier.promql import query_instant

    t = args.time or int(time.time())
    out = query_instant(_store(args), args.expr, t)
    print(json.dumps(out, default=str))


def cmd_metrics(args):
    from .querier.metrics import list_metrics

    print(json.dumps(list_metrics(args.table), indent=2))


def cmd_tables(args):
    store = _store(args)
    out = {db: {t: store.row_count(db, t) for t in store.tables(db)} for db in store.databases()}
    print(json.dumps(out, indent=2))


def cmd_flame(args):
    from .querier.profile import query_flame

    print(json.dumps(query_flame(_store(args), app_service=args.service)))


def cmd_debug(args, cmd: str, **extra):
    from .server.debug import debug_request

    print(json.dumps(debug_request(args.host, args.port, {"cmd": cmd, **extra}), indent=2))


def cmd_server(args):
    from .device import is_device_error
    from .server.main import Server
    from .utils.config import load_config

    cfg, unknown = load_config(args.config)
    for k in unknown:
        print(f"warning: unknown config key {k}", file=sys.stderr)
    srv = Server(cfg, device=args.device).start()
    print(
        f"server up: receiver tcp/udp :{srv.receiver.tcp_port}/:{srv.receiver.udp_port} "
        f"debug :{srv.debug.port} trisolaris :{srv.trisolaris.port}"
    )
    try:
        while True:
            time.sleep(10)
            try:
                srv.tick()
            except Exception as e:
                if not is_device_error(e):  # a host fault must not take the server down
                    print(f"tick error: {e!r}", flush=True)
                    continue
                # a CUDA error is sticky: every later tick would fail the
                # same way, so the command ends instead of spinning
                print(f"tick error on the device, stopping: {e!r}", file=sys.stderr,
                      flush=True)
                try:
                    srv.stop()
                except Exception as stop_exc:
                    print(f"stop after the device error: {stop_exc!r}", file=sys.stderr,
                          flush=True)
                sys.exit(1)
    except KeyboardInterrupt:
        srv.stop()


def cmd_rest(args):
    import urllib.request

    url = f"http://{args.host}:{args.port}{args.path}"
    data = args.body.encode() if args.body else None
    req = urllib.request.Request(url, data=data, method=args.method.upper())
    try:
        with urllib.request.urlopen(req) as r:
            body = r.read()
    except urllib.error.HTTPError as e:
        body = e.read()
    print(body.decode())


def cmd_trace(args):
    import urllib.parse
    import urllib.request

    if args.trace_id == "window":
        # window lineage plane: `dfctl trace window <id>`
        # serves the pipeline's own trace tree for one window
        if args.window_id is None:
            sys.exit("usage: dfctl trace window WINDOW_ID [--interval N] "
                     "[--service S]")
        q = {"interval": str(args.interval)}
        if args.service:
            q["service"] = args.service
        url = (
            f"http://{args.host}:{args.port}/v1/trace/window/"
            f"{args.window_id}?{urllib.parse.urlencode(q)}"
        )
    else:
        url = f"http://{args.host}:{args.port}/v1/traces/{args.trace_id}"
    try:
        with urllib.request.urlopen(url) as r:
            body = r.read()
    except urllib.error.HTTPError as e:
        body = e.read()
    print(json.dumps(json.loads(body), indent=2))


def _render_table(rows, columns=None):
    """Minimal aligned text table over a list of row dicts — the human
    faces of `dfctl profile`/`dfctl fleet` (pass --json for the
    machine shape dashboards consume)."""
    rows = [dict(r) for r in rows]
    if not rows:
        return "(no rows)"
    if columns is None:
        columns = []
        for r in rows:
            for k in r:
                if k not in columns:
                    columns.append(k)
    def cell(r, c):
        v = r.get(c, "")
        return json.dumps(v) if isinstance(v, (dict, list)) else str(v)
    widths = {
        c: max(len(c), *(len(cell(r, c)) for r in rows)) for c in columns
    }
    lines = ["  ".join(c.ljust(widths[c]) for c in columns)]
    lines.append("  ".join("-" * widths[c] for c in columns))
    for r in rows:
        lines.append("  ".join(cell(r, c).ljust(widths[c]) for c in columns))
    return "\n".join(lines)


def _render_kv(d):
    return "\n".join(f"{k}: {v}" for k, v in d.items())


def cmd_profile(args):
    """Device profiling plane: `dfctl profile device` pulls
    the device-memory ledger + step census over the controller REST surface.
    Human tables by default; --json emits the raw machine shape."""
    import urllib.request

    if args.what != "device":
        sys.exit(f"unknown profile target {args.what!r}")
    analyze = "0" if args.no_analyze else "1"
    with urllib.request.urlopen(
        f"http://{args.host}:{args.port}/v1/profile/device?analyze={analyze}"
    ) as r:
        out = json.loads(r.read())
    if args.json:
        print(json.dumps(out, separators=(",", ":"), default=str))
        return
    print("# hbm ledger")
    print(_render_table(out.get("hbm", [])))
    print("\n# hbm totals")
    print(_render_kv(out.get("hbm_totals", {})))
    census = out.get("census", {})
    entries = census.pop("entries", None) if isinstance(census, dict) else None
    print("\n# step census")
    if isinstance(census, dict):
        print(_render_kv(census))
    else:
        print(json.dumps(census, indent=2))
    if isinstance(entries, list) and entries:
        print(_render_table(entries))


def cmd_fleet(args):
    """Fleet pane: `dfctl fleet health|hosts|skew` pulls the
    aggregator's merged cross-host views over REST. Human tables by
    default; --json emits the raw machine shape."""
    import urllib.request

    url = f"http://{args.host}:{args.port}/v1/fleet/{args.what}"
    try:
        with urllib.request.urlopen(url) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        if args.json:
            print(body.decode())
        else:
            sys.exit(f"fleet {args.what}: HTTP {e.code} {body.decode()}")
        return
    if args.json:
        print(json.dumps(out, separators=(",", ":"), default=str))
        return
    if args.what == "hosts":
        print(_render_table(
            out,
            columns=["host", "groups", "epoch", "frames", "age_s",
                     "stale", "hbm_bytes"],
        ))
    else:
        print(_render_kv(out))


def _watch_render(event) -> list[str]:
    """Human lines for one wire event: one line per series row for
    local PromQL payloads, merged per-host rows for fleet envelopes,
    a one-liner for alerts/staleness — anything else prints compact."""
    if isinstance(event, list):  # local promql lane: list of series
        out = []
        for s in event:
            if not isinstance(s, dict):
                out.append(json.dumps(s, default=str))
                continue
            metric = s.get("metric", {})
            values = s.get("values", [])
            t, v = (values[-1] if values else ("-", "-"))
            flag = " partial" if s.get("partial") else ""
            out.append(f"{json.dumps(metric, sort_keys=True)} t={t} v={v}{flag}")
        return out or ["(empty result)"]
    if isinstance(event, dict):
        kind = event.get("type") or ("alert" if "rule" in event else None)
        if kind == "result":  # fleet merged envelope
            out = []
            for s in event.get("merged", []):
                metric = s.get("metric", {}) if isinstance(s, dict) else {}
                values = s.get("values", []) if isinstance(s, dict) else []
                t, v = (values[-1] if values else ("-", "-"))
                flag = " partial" if isinstance(s, dict) and s.get("partial") else ""
                out.append(
                    f"{json.dumps(metric, sort_keys=True)} t={t} v={v}{flag}"
                )
            stale = [
                h for h, hs in event.get("hosts", {}).items() if hs.get("stale")
            ]
            if stale:
                out.append(f"! stale hosts: {', '.join(sorted(stale))}")
            return out or ["(empty merged result)"]
        if kind == "staleness":
            return [f"! host {event.get('host')} went stale"]
        if kind == "alert" or "rule" in event:
            return [
                f"ALERT {event.get('state')} rule={event.get('rule')} "
                f"value={event.get('value')} host={event.get('host', 'local')}"
            ]
    return [json.dumps(event, default=str)]


def cmd_watch(args):
    """Streaming client for the wire lane: connects to /v1/watch,
    prints rows as they arrive, reconnects with capped backoff when
    the stream drops (server restart, network blip) — a dashboard in
    40 lines of stdlib."""
    import urllib.error
    import urllib.parse
    import urllib.request

    q: dict[str, str] = {}
    if args.alerts:
        q["alerts"] = "1"
    elif args.sql:
        q["sql"] = args.query
    else:
        q["promql"] = args.query
    q["span_s"] = str(args.span)
    q["step"] = str(args.step)
    q["db"] = args.db
    q["table"] = args.table
    if args.scope:
        q["scope"] = args.scope
    if args.max_events:
        q["max_events"] = str(args.max_events)
    url = (f"http://{args.host}:{args.port}/v1/watch?"
           + urllib.parse.urlencode(q))
    backoff, seen = 0.5, 0
    while True:
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as r:
                backoff = 0.5  # a live stream resets the backoff
                for raw in r:
                    if not raw.startswith(b"data: "):
                        continue  # heartbeat / comment lines
                    event = json.loads(raw[6:])
                    if args.json:
                        print(json.dumps(event, separators=(",", ":"),
                                         default=str), flush=True)
                    else:
                        for line in _watch_render(event):
                            print(line, flush=True)
                    seen += 1
                    if args.max_events and seen >= args.max_events:
                        return
            if args.max_events and seen >= args.max_events:
                return
        except KeyboardInterrupt:
            return
        except urllib.error.HTTPError as e:
            # 4xx = the query itself is bad — retrying won't fix it
            sys.exit(f"watch: HTTP {e.code} {e.read().decode()}")
        except (urllib.error.URLError, OSError, TimeoutError):
            pass
        print(f"# stream dropped; reconnecting in {backoff:.1f}s",
              file=sys.stderr, flush=True)
        time.sleep(backoff)
        backoff = min(backoff * 2, args.max_backoff)


def cmd_agent_group(args):
    """Trisolaris group management over the sync socket (line-JSON):
    the deepflow-ctl agent-group/agent-group-config seat."""
    import base64
    import socket

    if args.action == "set-config":
        # configs are set through the REST/debug plane in-process; over
        # the wire we print the payload the server operator applies
        print(json.dumps({"group": args.group, "config": json.loads(args.value)}))
        return
    req = {"agent_id": args.agent_id, "config_rev": 0, "platform_version": 0}
    if args.action == "upgrade":
        req = {"type": "upgrade", "agent_id": args.agent_id}
    with socket.create_connection((args.host, args.port), timeout=5) as s:
        f = s.makefile("rwb")
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        resp = json.loads(f.readline())
    if args.action == "upgrade" and "package_b64" in resp:
        resp["package_bytes"] = len(base64.b64decode(resp.pop("package_b64")))
    print(json.dumps(resp, indent=2))


def cmd_plugin(args):
    from .agent.l7.plugins import load_plugins

    loaded = load_plugins(args.dir)
    print(json.dumps([{"protocol": p, "name": n} for p, n in loaded], indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="dfctl")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("server")
    sp.add_argument("-f", "--config", default=None)
    sp.add_argument("--device", default="cuda",
                    help="torch device of the server's device work (default cuda)")
    sp.set_defaults(fn=cmd_server)

    for name, fn, extra in (
        ("query", cmd_query, [("sql",)]),
        ("promql", cmd_promql, [("expr",)]),
        ("metrics", cmd_metrics, [("table",)]),
        ("tables", cmd_tables, []),
        ("flame", cmd_flame, []),
    ):
        sp = sub.add_parser(name)
        sp.add_argument("--store", default="")
        for a in extra:
            sp.add_argument(*a)
        if name == "promql":
            sp.add_argument("-t", "--time", type=int, default=0)
        if name == "query":
            sp.add_argument("--device", default="cuda",
                            help="torch device the aggregates reduce on (default cuda)")
        if name == "flame":
            sp.add_argument("--service", required=True)
        sp.set_defaults(fn=fn)

    for name in ("counters", "agents", "datasources", "subscriptions",
                 "alerts", "ping"):
        sp = sub.add_parser(name)
        sp.add_argument("--host", default="127.0.0.1")
        sp.add_argument("--port", type=int, required=True)
        if name == "counters":
            sp.add_argument("--module", default=None)
        sp.set_defaults(
            fn=lambda a, _n=name: cmd_debug(
                a, _n, **({"module": a.module} if _n == "counters" and a.module else {})
            )
        )

    sp = sub.add_parser("rest")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("method")
    sp.add_argument("path")
    sp.add_argument("body", nargs="?", default=None)
    sp.set_defaults(fn=cmd_rest)

    sp = sub.add_parser("trace")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("trace_id",
                    help="a trace id, or the literal 'window' followed "
                         "by a window id (window lineage tree)")
    sp.add_argument("window_id", nargs="?", default=None)
    sp.add_argument("--interval", type=int, default=1,
                    help="tier interval seconds for 'window' (default 1)")
    sp.add_argument("--service", default=None,
                    help="lineage service name (default tpu.pipeline)")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("profile")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("what", choices=["device"])
    sp.add_argument("--no-analyze", action="store_true",
                    help="skip the census analysis")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output (compact JSON)")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("fleet")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("what", choices=["health", "hosts", "skew"])
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output (compact JSON)")
    sp.set_defaults(fn=cmd_fleet)

    sp = sub.add_parser("watch")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("query", nargs="?", default="",
                    help="PromQL expression (or SQL with --sql); "
                         "omit with --alerts")
    sp.add_argument("--sql", action="store_true",
                    help="treat QUERY as SQL instead of PromQL")
    sp.add_argument("--alerts", action="store_true",
                    help="stream alert notifications instead of a query")
    sp.add_argument("--json", action="store_true",
                    help="raw event JSON, one object per line")
    sp.add_argument("--span", type=int, default=60,
                    help="range span seconds (default 60)")
    sp.add_argument("--step", type=int, default=1,
                    help="range step seconds (default 1)")
    sp.add_argument("--db", default="deepflow_system")
    sp.add_argument("--table", default="deepflow_system")
    sp.add_argument("--scope", default="",
                    choices=["", "local", "fleet"],
                    help="local store or fleet router (default auto)")
    sp.add_argument("--max-events", type=int, default=0,
                    help="exit after N events (0 = stream forever)")
    sp.add_argument("--timeout", type=float, default=300.0,
                    help="socket timeout seconds (default 300)")
    sp.add_argument("--max-backoff", type=float, default=30.0,
                    help="reconnect backoff cap seconds (default 30)")
    sp.set_defaults(fn=cmd_watch)

    sp = sub.add_parser("agent-group")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("action", choices=["sync", "upgrade", "set-config"])
    sp.add_argument("--agent-id", type=int, default=0)
    sp.add_argument("--group", default="default")
    sp.add_argument("--value", default="{}")
    sp.set_defaults(fn=cmd_agent_group)

    sp = sub.add_parser("plugin")
    sp.add_argument("--dir", required=True)
    sp.add_argument("action", choices=["list"])
    sp.set_defaults(fn=cmd_plugin)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except BrokenPipeError:  # `dfctl ... | head` is normal usage
        sys.stderr.close()


if __name__ == "__main__":
    main()
