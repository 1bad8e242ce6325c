"""L7 protocol inference, parsing, and session pairing — the
protocol_logs seat (agent/src/flow_generator/protocol_logs/).

Port copy of deepflow_tpu/agent/l7/__init__.py.
"""

from .parsers import L7Message, infer_protocol, parse_payload
from .engine import L7Engine

__all__ = ["L7Message", "infer_protocol", "parse_payload", "L7Engine"]
