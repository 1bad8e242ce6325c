"""ctypes bindings for the native runtime (port copy of
deepflow_tpu/native/__init__.py, with its own copy of the C++ sources in
deepflow_tpu_torch/native/src/).

Provides the C++ twins of the Python implementations:

  * OverwriteQueue  — byte-blob ring with overwrite-oldest backpressure
    (reference: server/libs/queue/queue.go:43-260).
  * decode_documents — the DecodePB hot loop (libs/app/codec.go:28) as
    native SoA decode; must agree exactly with
    deepflow_tpu_torch.ingest.codec.DocumentDecoder (pinned by
    tests/test_torch_native.py).
  * split_messages — frame-body splitter.

The shared object builds at first use, with the host's C++ compiler:

    g++ -O3 -fPIC -std=c++17 -shared -pthread src/queue.cc src/decode.cc \\
        -o deepflow_tpu_torch/_build/libdfnative-<hash>.so

(`$CXX` in place of `g++` when set, as the reference's Makefile takes
it), keyed by a hash of the sources, the compiler and the flags, written
to a temporary file and moved into place with `os.replace`, so processes
building at once never load a half-written library. If the build fails
the importer degrades gracefully and callers fall back to the Python
codec (`native_available()` gates the choice; `build_error()` says
why).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..datamodel.code import CODE_OF_ID, MeterId
from ..datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA, USAGE_METER
from ..ingest.codec import (
    APP_METER_LAYOUT,
    DecodedBatch,
    FLOW_METER_LAYOUT,
    USAGE_METER_LAYOUT,
    StringDict,
    _hash_str,
)

_T = TAG_SCHEMA

SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = ("queue.cc", "decode.cc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

# Must match `enum Slot` in deepflow_tpu_torch/native/src/decode.cc.
_SLOT_NAMES = (
    "code_id",
    "meter_id",
    "global_thread_id",
    "agent_id",
    "is_ipv6",
    "ip0_w0",
    "ip0_w1",
    "ip0_w2",
    "ip0_w3",
    "ip1_w0",
    "ip1_w1",
    "ip1_w2",
    "ip1_w3",
    "l3_epc_id",
    "l3_epc_id1",
    "mac0_hi",
    "mac0_lo",
    "mac1_hi",
    "mac1_lo",
    "direction",
    "tap_side",
    "protocol",
    "acl_gid",
    "server_port",
    "tap_port",
    "tap_type",
    "l7_protocol",
    "gpid0",
    "gpid1",
    "endpoint_hash",
    "biz_type",
    "signal_source",
    "pod_id",
)

_lib = None
_build_error: str | None = None
_load_lock = threading.Lock()
#: how the library was obtained: compiler name, seconds, library path
build_info: dict = {}


def library_path(compiler: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join((os.path.basename(compiler),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libdfnative-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    compiler = os.environ.get("CXX") or "g++"
    out = library_path(compiler)
    build_info.update(compiler=os.path.basename(compiler), seconds=0.0, path=str(out))
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(
            [compiler, *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    build_info["seconds"] = time.perf_counter() - t0
    return out


def _load():
    with _load_lock:
        if _lib is None and _build_error is None:
            _load_locked()


def _load_locked():
    global _lib, _build_error
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError) as e:
        # CalledProcessError's str() omits captured stderr — keep the
        # compiler diagnostics so failures stay debuggable.
        stderr = getattr(e, "stderr", None)
        _build_error = f"{e}: {stderr.strip()}" if stderr else str(e)
        return

    lib.dfq_new.restype = ctypes.c_void_p
    lib.dfq_new.argtypes = [ctypes.c_uint32]
    lib.dfq_destroy.argtypes = [ctypes.c_void_p]
    lib.dfq_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.dfq_gets.restype = ctypes.c_uint32
    lib.dfq_gets.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
        ctypes.c_int32,
    ]
    lib.dfq_free_blob.argtypes = [ctypes.c_void_p]
    lib.dfq_close.argtypes = [ctypes.c_void_p]
    lib.dfq_overwritten.restype = ctypes.c_uint64
    lib.dfq_overwritten.argtypes = [ctypes.c_void_p]
    lib.dfq_len.restype = ctypes.c_uint32
    lib.dfq_len.argtypes = [ctypes.c_void_p]

    lib.df_split_messages.restype = ctypes.c_int32
    lib.df_decode_documents.restype = ctypes.c_int32
    _lib = lib


def native_available() -> bool:
    _load()
    return _lib is not None


def build_error() -> str | None:
    _load()
    return _build_error


# ---------------------------------------------------------------------------
# queue


class OverwriteQueue:
    """Bounded byte-blob queue; overwrites oldest on overflow."""

    def __init__(self, capacity: int):
        _load()
        if _lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._q = _lib.dfq_new(capacity)
        self.capacity = capacity
        self._closed = False

    def put(self, blob: bytes):
        _lib.dfq_put(self._q, blob, len(blob))

    def gets(self, max_items: int = 256, timeout_ms: int = 0) -> list[bytes]:
        ptrs = (ctypes.c_void_p * max_items)()
        lens = (ctypes.c_uint32 * max_items)()
        n = _lib.dfq_gets(self._q, ptrs, lens, max_items, timeout_ms)
        out = []
        for i in range(n):
            out.append(ctypes.string_at(ptrs[i], lens[i]))
            _lib.dfq_free_blob(ptrs[i])
        return out

    def close(self):
        self._closed = True
        _lib.dfq_close(self._q)

    def __len__(self) -> int:
        return _lib.dfq_len(self._q)

    @property
    def closed(self) -> bool:
        # host-side flag: close() is a host decision and the C ring
        # keeps serving gets() after close — same API face as the
        # Python twin (ingest/queues.py)
        return self._closed

    @property
    def overwritten(self) -> int:
        return _lib.dfq_overwritten(self._q)

    def get_counters(self) -> dict:
        """Countable face — mirrors PyOverwriteQueue.get_counters."""
        return {
            "depth": len(self),
            "capacity": self.capacity,
            "overwritten": self.overwritten,
            "closed": int(self._closed),
        }

    def __del__(self):
        if _lib is not None and getattr(self, "_q", None):
            _lib.dfq_destroy(self._q)
            self._q = None


# ---------------------------------------------------------------------------
# decoder tables (built once)


def _tag_col_table() -> np.ndarray:
    out = np.full(len(_SLOT_NAMES), -1, dtype=np.int32)
    for slot, name in enumerate(_SLOT_NAMES):
        out[slot] = _T.index(name)
    return out


def _meter_map(layout: dict, schema, flat: bool) -> np.ndarray:
    out = np.full(32 if flat else 256, -1, dtype=np.int32)
    for name, (sub, fid) in layout.items():
        idx = fid if flat else (sub << 5) | fid
        out[idx] = schema.index(name)
    return out


_TAG_COL = _tag_col_table()
_ENDPOINT_HASH_COL = _T.index("endpoint_hash")
_FLOW_MAP = _meter_map(FLOW_METER_LAYOUT, FLOW_METER, flat=False)
_USAGE_MAP = _meter_map(USAGE_METER_LAYOUT, USAGE_METER, flat=True)
_APP_MAP = _meter_map(APP_METER_LAYOUT, APP_METER, flat=False)
_CODES = np.array([int(v) for v in CODE_OF_ID.values()], dtype=np.uint64)
_CODE_IDS = np.array([int(k) for k in CODE_OF_ID.keys()], dtype=np.uint32)
_SCHEMA_OF_ID = {
    int(MeterId.FLOW): FLOW_METER,
    int(MeterId.USAGE): USAGE_METER,
    int(MeterId.APP): APP_METER,
}
_M_COLS = max(s.num_fields for s in _SCHEMA_OF_ID.values())


def _c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeDocumentDecoder:
    """Drop-in twin of ingest.codec.DocumentDecoder backed by C++."""

    def __init__(self):
        _load()
        if _lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self.decode_errors = 0
        self.unknown_codes = 0  # folded into code_id==0 rows natively

    def decode(self, messages: list[bytes]) -> dict[int, DecodedBatch]:
        n = len(messages)
        if n == 0:
            return {}
        buf = b"".join(messages)
        lens = np.array([len(m) for m in messages], dtype=np.uint32)
        offs = np.zeros(n, dtype=np.uint64)
        np.cumsum(lens[:-1], out=offs[1:])
        return self._decode_buffer(buf, offs, lens)

    def decode_parts(
        self, parts: list[tuple[bytes, list[tuple[int, int]]]]
    ) -> dict[int, DecodedBatch]:
        """Zero-slice path: [(frame body, [(msg offset, len), ...])] →
        batches. The bodies concatenate once; per-message offsets shift
        by each body's base — no per-message bytes objects (the r5
        host-path fix: split_messages + b"".join re-copied every doc)."""
        total = sum(len(sp) for _, sp in parts)
        if total == 0:
            return {}
        buf = b"".join(b for b, _ in parts)
        offs = np.empty(total, dtype=np.uint64)
        lens = np.empty(total, dtype=np.uint32)
        i = 0
        base = 0
        for body, spans in parts:
            k = len(spans)
            if k:
                a = np.asarray(spans, dtype=np.uint64)
                offs[i:i + k] = a[:, 0] + base
                lens[i:i + k] = a[:, 1].astype(np.uint32)
                i += k
            base += len(body)
        return self._decode_buffer(buf, offs, lens)

    def _decode_buffer(self, buf: bytes, offs, lens) -> dict[int, DecodedBatch]:
        n = len(offs)
        arr = np.frombuffer(buf, dtype=np.uint8)

        tags = np.zeros((n, _T.num_fields), dtype=np.uint32)
        meters = np.zeros((n, _M_COLS), dtype=np.float32)
        ts = np.zeros(n, dtype=np.uint32)
        flags = np.zeros(n, dtype=np.uint32)
        meter_ids = np.zeros(n, dtype=np.uint8)
        str_offs = np.zeros((n, 3), dtype=np.uint64)
        str_lens = np.zeros((n, 3), dtype=np.uint32)
        str_order = np.zeros((n, 3), dtype=np.uint8)
        status = np.zeros(n, dtype=np.uint8)

        _lib.df_decode_documents(
            _c(arr),
            _c(offs),
            _c(lens),
            ctypes.c_uint32(n),
            _c(_TAG_COL),
            ctypes.c_uint32(_T.num_fields),
            _c(_FLOW_MAP),
            _c(_USAGE_MAP),
            _c(_APP_MAP),
            _c(_CODES),
            _c(_CODE_IDS),
            ctypes.c_uint32(len(_CODES)),
            ctypes.c_uint32(_M_COLS),
            _c(tags),
            _c(meters),
            _c(ts),
            _c(flags),
            _c(meter_ids),
            _c(str_offs),
            _c(str_lens),
            _c(str_order),
            _c(status),
        )
        self.decode_errors += int((status != 0).sum())

        strings = StringDict()
        out: dict[int, DecodedBatch] = {}
        ok = status == 0
        # intern string slices in *message order* — ids must match the
        # Python decoder exactly even when meter types interleave; within a
        # row in the order each string field first appeared. Only rows that
        # actually carry strings pay the Python loop (L4 batches carry none
        # and skip it entirely).
        sid_all = np.zeros((n, 3), dtype=np.uint32)
        for i in np.nonzero(ok & (str_order != 0).any(axis=1))[0]:
            for j in sorted(np.nonzero(str_order[i])[0], key=lambda j: str_order[i, j]):
                off, ln = int(str_offs[i, j]), int(str_lens[i, j])
                raw = buf[off : off + ln]
                text = raw.decode(errors="replace")
                sid_all[i, j] = strings.intern(text)
                if j == 2 and text.encode() != raw:
                    # the Python decoder hashes the replaced text
                    tags[i, _ENDPOINT_HASH_COL] = _hash_str(text)
        for meter_id, schema in _SCHEMA_OF_ID.items():
            mask = ok & (meter_ids == meter_id)
            if not mask.any():
                continue
            rows = np.nonzero(mask)[0]
            service_ids = sid_all[rows]
            out[meter_id] = DecodedBatch(
                meter_id=meter_id,
                meter_schema=schema,
                tags=tags[rows],
                meters=meters[rows, : schema.num_fields],
                timestamp=ts[rows],
                flags=flags[rows],
                strings=strings,
                service_ids=service_ids,
            )
        return out


def split_messages(body: bytes) -> list[bytes]:
    """Native frame-body splitter (falls back via caller choice)."""
    _load()
    if _lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    arr = np.frombuffer(body, dtype=np.uint8)
    max_msgs = max(1, len(body) // 4)
    offs = np.zeros(max_msgs, dtype=np.uint64)
    lens = np.zeros(max_msgs, dtype=np.uint32)
    n = _lib.df_split_messages(
        _c(arr), ctypes.c_uint32(len(body)), _c(offs), _c(lens), ctypes.c_uint32(max_msgs)
    )
    if n < 0:
        raise ValueError("malformed frame body")
    return [body[int(offs[i]) : int(offs[i]) + int(lens[i])] for i in range(n)]
