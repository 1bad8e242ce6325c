"""Wire delivery plane — the million-watcher product surface (port
copy of deepflow_tpu/wire).

The push plane evaluates once per event batch and fans out to N
bounded watcher queues; the lease machinery reaps abandoned ones; the
handoff transport moves framed bytes between hosts at-least-once; the
fleet plane carries the host→aggregator fan-in. This package is the layer that turns all of that into a
surface dashboards actually connect to:

  * `frame`     — the DFPUSH lane: control (`hello`/`sub`/`unsub`) and
    data (`result`/`alert`) frames on the existing framed-TCP ABI.
  * `hub`       — `WireHub`: SSE streams off the RestServer
    (`GET /v1/watch`), a framed-TCP `WireListener`, and in-process
    streams, all mapped onto the EXISTING bounded `Watcher` queues
    (per-client flow control, lease renewal on delivery, counted
    drops/reaps/disconnects).
  * `router`    — `FleetSubscriptionRouter`: ONE upstream subscription
    per distinct query fleet-wide; merges per-host results
    (flushed-supersedes-partial, at-least-once dedup, counted
    staleness) and fans the merged eval to N wire clients.
  * `publisher` — `WirePublisher`: the pipeline host's duplex uplink —
    answers the router's control plane with local subscriptions and
    pushes every eval (and alert notification) upstream.

Watcher count scales with aggregator processes; fan-out cost stays
O(evals), never O(watchers × hosts).
"""

from .frame import (
    PUSH_FRAME_VERSION,
    PUSH_MSG_TYPE,
    PushFrame,
    decode_push_frame,
    encode_push_frame,
    normalize_query_spec,
    query_id_for,
)
from .hub import DEFAULT_LEASE_S, WireConnection, WireHub, WireListener
from .publisher import WirePublisher, result_to_jsonable
from .router import FleetSubscriptionRouter

__all__ = [
    "PUSH_FRAME_VERSION",
    "PUSH_MSG_TYPE",
    "PushFrame",
    "decode_push_frame",
    "encode_push_frame",
    "normalize_query_spec",
    "query_id_for",
    "DEFAULT_LEASE_S",
    "WireConnection",
    "WireHub",
    "WireListener",
    "WirePublisher",
    "result_to_jsonable",
    "FleetSubscriptionRouter",
]
