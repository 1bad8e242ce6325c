"""MCP server — the LLM tool-calling surface over the querier.

The reference runs a streamable-HTTP Model Context Protocol server
exposing DeepFlow data to LLM agents (server/mcp/mcp.go:42-74; one
registered tool, analyzeProfileData). This build speaks the same MCP
JSON-RPC 2.0 wire protocol (initialize / tools/list / tools/call over
`POST /mcp`) and registers the full query surface:

  query_sql        DeepFlow-SQL against the columnar store
  query_promql     PromQL instant queries
  query_trace      one trace id → assembled service tree
  trace_map        service-edge aggregation over a time range
  analyze_profile  flame-tree summary for an app_service (the
                   analyzeProfileData seat)

No external MCP SDK (nothing may be installed); the protocol subset is
hand-rolled — it is three JSON-RPC methods.

Port copy of deepflow_tpu/server/mcp.py.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PROTOCOL_VERSION = "2024-11-05"
MAX_BODY_BYTES = 4 << 20


def _tool(name, description, params, required=()):
    return {
        "name": name,
        "description": description,
        "inputSchema": {
            "type": "object",
            "properties": params,
            "required": list(required),
        },
    }


_S = {"type": "string"}
_I = {"type": "integer"}

TOOLS = [
    _tool(
        "query_sql",
        "Run a DeepFlow SQL query (SELECT ... FROM <table> ...) against "
        "the telemetry store and return rows as JSON.",
        {"sql": _S}, ("sql",),
    ),
    _tool(
        "query_promql",
        "Evaluate a PromQL instant query at a unix-seconds timestamp.",
        {"promql": _S, "time": _I}, ("promql",),
    ),
    _tool(
        "query_trace",
        "Fetch the assembled distributed-trace service tree for a trace id.",
        {"trace_id": _S, "org": _I}, ("trace_id",),
    ),
    _tool(
        "trace_map",
        "Aggregate service-to-service call edges over all traces in a "
        "time range (unix seconds).",
        {"start_time": _I, "end_time": _I, "org": _I},
    ),
    _tool(
        "list_catalog",
        "List the queryable tags and metrics of a table (name, type, "
        "unit, allowed operators) — the db_descriptions catalog.",
        {"table": _S}, ("table",),
    ),
    _tool(
        "analyze_profile",
        "Summarize continuous-profiling data for an app service: top "
        "stacks by self time from the flame tree.",
        {"app_service": _S, "start_time": _I, "end_time": _I},
        ("app_service",),
    ),
]


class MCPServer:
    """Streamable-HTTP MCP endpoint bound to a running Server's planes."""

    def __init__(self, server, *, host: str = "127.0.0.1", port: int = 0):
        self._df = server
        self.counters = {"requests": 0, "tool_calls": 0, "errors": 0}
        # ThreadingHTTPServer handles requests concurrently; dict += is a
        # non-atomic read-modify-write (same stance as receiver.py)
        self._clock = threading.Lock()
        mcp = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                if self.path.rstrip("/") not in ("", "/mcp"):
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self.send_error(413)
                    return
                try:
                    req = json.loads(self.rfile.read(n))
                except (ValueError, UnicodeDecodeError):
                    self._reply({"jsonrpc": "2.0", "id": None,
                                 "error": {"code": -32700, "message": "parse error"}})
                    return
                self._reply(mcp.handle(req))

            def _reply(self, obj):
                if obj is None:  # notification → 202, no body
                    self.send_response(202)
                    self.end_headers()
                    return
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # -- protocol -------------------------------------------------------
    def _count(self, key: str) -> None:
        with self._clock:
            self.counters[key] += 1

    def handle(self, req: dict) -> dict | None:
        self._count("requests")
        rid = req.get("id")
        method = req.get("method", "")
        if method.startswith("notifications/"):
            return None
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": "deepflow-tpu mcp server", "version": "1.0.0"},
                }
            elif method == "tools/list":
                result = {"tools": TOOLS}
            elif method == "tools/call":
                p = req.get("params", {})
                result = self._call(p.get("name", ""), p.get("arguments", {}) or {})
            elif method == "ping":
                result = {}
            else:
                return {"jsonrpc": "2.0", "id": rid,
                        "error": {"code": -32601, "message": f"unknown method {method}"}}
        except Exception as e:  # tool errors surface as MCP tool results
            self._count("errors")
            return {
                "jsonrpc": "2.0",
                "id": rid,
                "result": {
                    "content": [{"type": "text", "text": f"error: {e}"}],
                    "isError": True,
                },
            }
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    # -- tools ----------------------------------------------------------
    def _call(self, name: str, args: dict) -> dict:
        self._count("tool_calls")
        df = self._df
        if name == "query_sql":
            res = df.query.execute(args["sql"])
            out = res.to_dicts()
        elif name == "query_promql":
            from ..querier.promql import query_instant

            out = query_instant(
                df.store, args["promql"], int(args.get("time") or 0) or None
            )
        elif name == "query_trace":
            out = df.query_trace(args["trace_id"], org=int(args.get("org") or 1))
            if out is None:
                out = {"error": "trace not found"}
        elif name == "trace_map":
            tr = None
            if args.get("start_time") or args.get("end_time"):
                tr = (int(args.get("start_time") or 0),
                      int(args.get("end_time") or (1 << 31)))
            out = df.trace_map(time_range=tr, org=int(args.get("org") or 1))
        elif name == "list_catalog":
            out = df.query.catalogs(args["table"])
        elif name == "analyze_profile":
            from ..querier.profile import query_flame

            tr = None
            if args.get("start_time") or args.get("end_time"):
                tr = (int(args.get("start_time") or 0),
                      int(args.get("end_time") or (1 << 31)))
            out = query_flame(
                df.store, app_service=args["app_service"], time_range=tr
            )
        else:
            raise ValueError(f"unknown tool {name}")
        return {
            "content": [{"type": "text", "text": json.dumps(out, default=str)}],
            "isError": False,
        }

    def get_counters(self):
        with self._clock:
            return dict(self.counters)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
