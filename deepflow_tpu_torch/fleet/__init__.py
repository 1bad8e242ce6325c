"""Fleet telemetry plane — cross-host observability fan-in (port of
deepflow_tpu/fleet; plain Python, no device work).

Hosts export one compact summary frame per collector tick
(`FleetExporter` + `FleetSink`, framed-TCP on the handoff stance); a
`FleetAggregator` merges them in the summary domain and serves one
queryable pane (store rows with host/group labels, merged log-hists,
worst-rolled alerts, skew surfaces).
"""

from .aggregator import DEFAULT_RATE_FIELD, FleetAggregator
from .frame import (
    FLEET_MSG_TYPE,
    FRAME_VERSION,
    FleetFrame,
    decode_fleet_frame,
    encode_fleet_frame,
)
from .sink import AGGREGATOR_PEER, FleetExporter, FleetSink

__all__ = [
    "AGGREGATOR_PEER",
    "DEFAULT_RATE_FIELD",
    "FLEET_MSG_TYPE",
    "FRAME_VERSION",
    "FleetAggregator",
    "FleetExporter",
    "FleetFrame",
    "FleetSink",
    "decode_fleet_frame",
    "encode_fleet_frame",
]
