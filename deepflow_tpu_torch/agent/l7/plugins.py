"""Custom L7 protocol plugins — the Wasm / shared-object plugin seat.

Port copy of deepflow_tpu/agent/l7/plugins.py.

The reference loads operator-supplied protocol parsers as Wasm modules
or shared objects (agent/src/plugin/, ~4.9k LoC) exposing the same
check/parse interface as built-ins. The Python-native equivalent: a
plugin directory of modules each declaring

    PROTOCOL  = <int id>        # a datamodel.code.L7Protocol value or
                                # a custom id ≥ 200
    def check_payload(payload: bytes, port: int = 0) -> bool
    def parse_payload(payload: bytes) -> parsers.L7Message | None

`load_plugins(dir)` imports every module and registers it into the
shared parser registry (parsers.register_parser — the same seat the
wave-2 parsers use), so plugin protocols flow through inference, the
L7 engine, flow logs, and RED metrics with zero further wiring.
"""

from __future__ import annotations

import ctypes
import importlib.util
import sys
from pathlib import Path

from .parsers import register_parser

# operator protocol ids live above every built-in (l7_protocol.rs
# reserves the custom range the same way)
CUSTOM_PROTOCOL_BASE = 200


def load_plugins(plugin_dir: str | Path) -> list[tuple[int, str]]:
    """Import and register every plugin; returns [(protocol_id, name)].

    Python modules (*.py) and native shared objects (*.so, the C ABI
    below) register through the same seat. A broken plugin is skipped
    (one bad operator module must not take down the agent), mirroring
    the reference's plugin-load error stance.
    """
    loaded = []
    d = Path(plugin_dir)
    if not d.is_dir():
        return loaded
    for path in sorted(d.glob("*.py")):
        name = f"deepflow_l7_plugin_{path.stem}"
        try:
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            proto = int(mod.PROTOCOL)
            check = mod.check_payload
            parse = mod.parse_payload
        except Exception:
            sys.modules.pop(name, None)
            continue
        if proto < CUSTOM_PROTOCOL_BASE:
            continue  # a plugin must never shadow a built-in parser
        register_parser(proto, check, parse)
        loaded.append((proto, path.stem))
    for path in sorted(d.glob("*.so")):
        try:
            proto, check, parse = _load_so_plugin(path)
        except Exception:
            continue
        if proto < CUSTOM_PROTOCOL_BASE:
            continue
        register_parser(proto, check, parse)
        loaded.append((proto, path.stem))
    return loaded


# ---------------------------------------------------------------------------
# native shared-object plugin ABI (the reference's plugin/shared_obj
# seat, agent/src/plugin/shared_obj/: operators compile a C parser once
# and every agent loads it). Contract — three exported symbols:
#
#   int df_protocol(void);
#       // protocol id (>= 200 for custom protocols)
#   int df_check(const unsigned char *payload, int len, int port);
#       // 1 when the payload is this protocol
#   int df_parse(const unsigned char *payload, int len,
#                struct df_l7_info *out);
#       // 1 on success, filling `out`:
#   struct df_l7_info {
#       int  msg_type;         // 0 request / 1 response / 2 session
#       int  status;           // 1 ok / 3 client err / 4 server err
#       int  status_code;
#       unsigned int request_id;
#       char request_type[64];     // NUL-terminated
#       char request_resource[256];
#       char request_domain[256];
#       char endpoint[256];
#   };


class _DfL7Info(ctypes.Structure):
    _fields_ = [
        ("msg_type", ctypes.c_int),
        ("status", ctypes.c_int),
        ("status_code", ctypes.c_int),
        ("request_id", ctypes.c_uint),
        ("request_type", ctypes.c_char * 64),
        ("request_resource", ctypes.c_char * 256),
        ("request_domain", ctypes.c_char * 256),
        ("endpoint", ctypes.c_char * 256),
    ]


def _load_so_plugin(path: Path):
    from .parsers import MSG_REQUEST, MSG_RESPONSE, L7Message

    lib = ctypes.CDLL(str(path))
    lib.df_protocol.restype = ctypes.c_int
    lib.df_check.restype = ctypes.c_int
    lib.df_check.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.df_parse.restype = ctypes.c_int
    lib.df_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_DfL7Info)
    ]
    proto = int(lib.df_protocol())

    def check(payload: bytes, port: int = 0) -> bool:
        return bool(lib.df_check(payload, len(payload), int(port)))

    def parse(payload: bytes):
        info = _DfL7Info()
        if not lib.df_parse(payload, len(payload), ctypes.byref(info)):
            return None
        # 2 (session) pairs like a request that already carries its
        # response status — the engine's FIFO pairing closes it
        mt = MSG_RESPONSE if int(info.msg_type) == 1 else MSG_REQUEST
        return L7Message(
            protocol=proto,
            msg_type=mt,
            status=int(info.status) or 1,
            status_code=int(info.status_code),
            request_id=int(info.request_id),
            request_type=info.request_type.decode(errors="replace"),
            request_resource=info.request_resource.decode(errors="replace"),
            request_domain=info.request_domain.decode(errors="replace"),
            endpoint=info.endpoint.decode(errors="replace"),
        )

    return proto, check, parse
