"""The port's native runtime (deepflow_tpu_torch/native/: its own copy of
the C++ decoder and queue, built at first use into
deepflow_tpu_torch/_build/) — the eight cases of tests/test_native.py on
the port, and the cross-package checks:

  * the port's native decoder against the reference's Python
    `DocumentDecoder` on the same messages, seeded corrupt ones included
    (byte flips and truncations): equal batches and equal error counts;
  * the port's native `OverwriteQueue` against the reference's
    `PyOverwriteQueue` on one seeded put/gets schedule;
  * the port's `FlowMetricsIngester` with `prefer_native` on and off
    storing the same rows.

Nothing here skips: a failed build fails every test, with
`build_error()` in the message."""

from __future__ import annotations

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deepflow_tpu.ingest.codec import DocumentDecoder as RefDocumentDecoder
from deepflow_tpu.ingest.queues import PyOverwriteQueue as RefPyOverwriteQueue
from deepflow_tpu.ingest.replay import SyntheticAppGen
from deepflow_tpu_torch import native
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, L7Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.datamodel.code import CodeId, DocumentFlag, MeterId
from deepflow_tpu_torch.datamodel.schema import APP_METER, TAG_SCHEMA
from deepflow_tpu_torch.ingest.codec import DocumentDecoder, encode_docbatch, encode_document
from deepflow_tpu_torch.ingest.framing import (
    FlowHeader,
    MessageType,
    encode_frame,
    split_message_spans,
    split_messages as py_split,
)
from deepflow_tpu_torch.ingest.queues import new_queue
from deepflow_tpu_torch.ingest.receiver import Receiver
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.server.flow_metrics import FlowMetricsIngester
from deepflow_tpu_torch.server.metrics_tables import DocStoreWriter
from deepflow_tpu_torch.storage.store import ColumnarStore

CPU = torch.device("cpu")
T0 = 1_700_000_000


@pytest.fixture(autouse=True)
def _built():
    assert native.native_available(), f"native build failed: {native.build_error()}"


@pytest.fixture(scope="module")
def msgs():
    """L4 and L7 docs of the port's pipelines on the CPU, encoded."""
    out = []
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=512),
                      device=CPU)
    gen = SyntheticFlowGen(num_tuples=50, seed=4)
    for db in pipe.ingest(FlowBatch.from_records(gen.records(400, T0))) + pipe.drain():
        out += encode_docbatch(db)
    pipe7 = L7Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=512),
                       device=CPU)
    gen7 = SyntheticAppGen(num_services=10, seed=4)
    for db in pipe7.ingest(FlowBatch.from_records(gen7.records(300, T0), APP_METER)) + \
            pipe7.drain():
        out += encode_docbatch(db)
    return out


def _assert_decodes_equal(a, b):
    assert set(a) == set(b)
    for mid in a:
        x, y = a[mid], b[mid]
        for k in ("tags", "meters", "timestamp", "flags", "service_ids"):
            gx, gy = getattr(x, k), getattr(y, k)
            assert gx.dtype == gy.dtype and gx.shape == gy.shape, k
            assert np.array_equal(gx, gy, equal_nan=gx.dtype.kind == "f"), k
        assert x.strings.values == y.strings.values


# -- the cases of tests/test_native.py, on the port ----------------------------

def test_native_decoder_matches_python(msgs):
    assert len(msgs) > 100
    py = DocumentDecoder()
    nat = native.NativeDocumentDecoder()
    _assert_decodes_equal(py.decode(msgs), nat.decode(msgs))
    assert nat.decode_errors == py.decode_errors == 0


def test_native_decoder_strings():
    tags = np.zeros(TAG_SCHEMA.num_fields, dtype=np.uint32)
    tags[TAG_SCHEMA.index("meter_id")] = int(MeterId.APP)
    tags[TAG_SCHEMA.index("code_id")] = int(CodeId.SINGLE_IP_PORT_APP)
    meters = np.zeros(APP_METER.num_fields, dtype=np.float32)
    msg = encode_document(
        5, tags, meters, strings={"app_service": "svc-b", "endpoint": "/pay", "app_instance": "i-1"}
    )
    py = DocumentDecoder().decode([msg, msg])
    nat = native.NativeDocumentDecoder().decode([msg, msg])
    _assert_decodes_equal(py, nat)
    # endpoint hash identical across implementations
    j = TAG_SCHEMA.index("endpoint_hash")
    assert py[int(MeterId.APP)].tags[0, j] == nat[int(MeterId.APP)].tags[0, j] != 0


def test_native_decoder_corrupt_counted():
    nat = native.NativeDocumentDecoder()
    out = nat.decode([b"\x0a\xff\xff", b"garbage!"])
    assert out == {}
    assert nat.decode_errors == 2


def test_native_split_messages():
    parts = [b"a", b"bb" * 50, b""]
    frame = encode_frame(FlowHeader(msg_type=3), parts)
    body = frame[19:]
    assert native.split_messages(body) == py_split(body) == parts
    with pytest.raises(ValueError):
        native.split_messages(body[:-1])


def test_overwrite_queue_basics():
    q = native.OverwriteQueue(4)
    for i in range(3):
        q.put(bytes([i]))
    assert len(q) == 3
    assert q.gets(2) == [b"\x00", b"\x01"]
    assert q.gets(10) == [b"\x02"]
    assert q.gets(10, timeout_ms=10) == []


def test_overwrite_queue_sheds_oldest():
    q = native.OverwriteQueue(4)
    for i in range(10):
        q.put(bytes([i]))
    assert q.overwritten == 6
    # oldest shed; newest 4 retained in order
    assert q.gets(10) == [bytes([i]) for i in range(6, 10)]


def test_overwrite_queue_threaded():
    q = native.OverwriteQueue(1 << 12)
    n = 2000

    def producer():
        for i in range(n):
            q.put(i.to_bytes(4, "little"))

    threads = [threading.Thread(target=producer) for _ in range(4)]
    for t in threads:
        t.start()
    got = 0
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        items = q.gets(256, timeout_ms=200)
        if not items and not any(t.is_alive() for t in threads) and len(q) == 0:
            break
        got += len(items)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    # conservation: every item was either consumed or counted as shed
    assert got + q.overwritten == 4 * n


def test_native_decode_parts_matches_decode(msgs):
    """decode_parts (the ingester's zero-slice path) agrees with decode()
    across multi-frame drains, base-offset shifts and empty bodies."""
    bodies = []
    cut1, cut2 = len(msgs) // 3, 2 * len(msgs) // 3
    for chunk in (msgs[:cut1], msgs[cut1:cut2], [], msgs[cut2:]):
        bodies.append(encode_frame(FlowHeader(msg_type=3), chunk)[19:])
    parts = [(b, split_message_spans(b)) for b in bodies]
    want = native.NativeDocumentDecoder().decode(msgs)
    _assert_decodes_equal(native.NativeDocumentDecoder().decode_parts(parts), want)
    _assert_decodes_equal(DocumentDecoder().decode_parts(parts), want)


# -- the port's native code against the reference's Python code ---------------

def _corrupt(msgs, seed):
    """Seeded damage: a byte flipped, a tail cut, a byte inserted, a
    message replaced by random bytes; a quarter of the messages left whole."""
    rng = np.random.default_rng(seed)
    out = []
    for m in msgs:
        kind = int(rng.integers(5))
        b = bytearray(m)
        if kind == 0 and b:
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        elif kind == 1 and b:
            del b[int(rng.integers(len(b))):]
        elif kind == 2:
            b.insert(int(rng.integers(len(b) + 1)), int(rng.integers(256)))
        elif kind == 3:
            b = bytearray(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_decoder_equals_reference_python_decoder(msgs, seed):
    """The port's native decoder and the reference's Python decoder on the
    same messages, whole (seed 0) and corrupted (seeds 1, 2)."""
    batch = msgs if seed == 0 else _corrupt(msgs, seed)
    ref = RefDocumentDecoder()
    nat = native.NativeDocumentDecoder()
    _assert_decodes_equal(nat.decode(batch), ref.decode(batch))
    assert nat.decode_errors == ref.decode_errors
    if seed:
        assert ref.decode_errors > 0


def test_native_queue_equals_reference_python_queue():
    """One seeded schedule of puts and gets over a small capacity: the
    same items come out in the same order, with the same overwrite
    counts and depths."""
    rng = np.random.default_rng(7)
    nat, ref = native.OverwriteQueue(16), RefPyOverwriteQueue(16)
    assert type(new_queue(16)) is native.OverwriteQueue
    k = 0
    for _ in range(300):
        if rng.random() < 0.6:
            for _ in range(int(rng.integers(1, 8))):
                blob = k.to_bytes(4, "little") * int(rng.integers(1, 4))
                nat.put(blob)
                ref.put(blob)
                k += 1
        else:
            n = int(rng.integers(1, 12))
            assert nat.gets(n, timeout_ms=0) == ref.gets(n, timeout_ms=0)
        assert len(nat) == len(ref)
        assert nat.get_counters() == ref.get_counters()
    assert ref.overwritten > 0
    nat.close()
    ref.close()
    assert nat.get_counters() == ref.get_counters()


def _store_rows(prefer_native: bool, frames):
    """Frames through a port FlowMetricsIngester into a fresh store."""
    recv = Receiver()
    store = ColumnarStore()
    writer = DocStoreWriter(store, writer_args={"flush_interval_s": 0.05})
    ing = FlowMetricsIngester(recv, writer, n_workers=1, prefer_native=prefer_native)
    try:
        assert ing._use_native is prefer_native
        assert isinstance(ing.queues[0], native.OverwriteQueue) is prefer_native
        for f in frames:
            ing.queues[0].put(f)
        total = sum(len(py_split(f[19:])) for f in frames)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            c = ing.get_counters()
            if c["docs_in"] == total and writer.counters["rows"] == c["docs_written"]:
                break
            time.sleep(0.02)
        writer.flush()
        writer._app_tags.flush()
        counters = ing.get_counters()
    finally:
        ing.stop()
        writer.stop()
    tables = {(db, t): store.scan(db, t) for db in store.databases() for t in store.tables(db)}
    return counters, tables


def _canonical(cols: dict) -> dict:
    names = sorted(cols)
    keys = [np.unique(np.asarray(cols[k]), return_inverse=True)[1] for k in names]
    order = np.lexsort(keys[::-1])
    return {k: np.asarray(cols[k])[order] for k in names}


def test_ingester_native_and_python_store_the_same_rows(msgs):
    app = [encode_document(T0 + i, np.where(np.arange(TAG_SCHEMA.num_fields)
                                            == TAG_SCHEMA.index("meter_id"),
                                            int(MeterId.APP), 0).astype(np.uint32),
                           np.full(APP_METER.num_fields, i, np.float32),
                           int(DocumentFlag.PER_SECOND_METRICS),
                           strings={"app_service": f"svc-{i % 3}", "endpoint": "/e"})
           for i in range(5)]
    docs = msgs + app
    # one frame, so one decode batch: the app_service sidecar's time is its
    # batch's first APP doc's, and how frames group into batches depends
    # on the decoder's speed
    frames = [encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1,
                                      organization_id=1), docs)]
    c_nat, t_nat = _store_rows(True, frames)
    c_py, t_py = _store_rows(False, frames)
    assert c_nat == c_py and c_nat["docs_written"] == len(docs)
    assert sorted(t_nat) == sorted(t_py) and len(t_nat) >= 2
    for key in t_py:
        a, b = _canonical(t_nat[key]), _canonical(t_py[key])
        assert sorted(a) == sorted(b), key
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (key, k)
    assert ("flow_tag", "app_service") in t_nat


def test_build_lands_in_the_ports_build_directory(tmp_path, monkeypatch):
    """The library is keyed by a hash of the sources, compiler and flags,
    under deepflow_tpu_torch/_build/; a fresh build goes through a
    temporary file that `os.replace` moves into place."""
    assert native.BUILD_DIR == Path(native.__file__).resolve().parent.parent / "_build"
    assert native.BUILD_DIR.parent.name == "deepflow_tpu_torch"
    loaded = Path(native.build_info["path"])
    assert loaded.parent == native.BUILD_DIR and loaded.is_file()
    assert re.fullmatch(r"libdfnative-[0-9a-f]{16}\.so", loaded.name)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "build_info", {})
    out = native._build()
    assert out.name == loaded.name  # same sources, compiler and flags
    assert [p.name for p in tmp_path.iterdir()] == [out.name]
    assert native.build_info["seconds"] > 0


def _raw_app_doc(minifield: list[tuple[int, bytes]], meter_subs: list[tuple[int, bytes]]):
    """An APP Document built field by field: LEN minifield entries, and
    one AppTraffic submessage holding LEN meter values."""
    from deepflow_tpu_torch.ingest.codec import pb_bytes, pb_varint

    mf = bytearray()
    for field, b in minifield:
        pb_bytes(mf, field, b)
    tag = bytearray()
    pb_bytes(tag, 1, bytes(mf))
    pb_varint(tag, 2, 0)
    sub = bytearray()
    for fid, b in meter_subs:
        pb_bytes(sub, fid, b)
    inner = bytearray()
    pb_bytes(inner, 1, bytes(sub))
    meter = bytearray()
    pb_varint(meter, 1, int(MeterId.APP))
    pb_bytes(meter, 4, bytes(inner))
    doc = bytearray()
    pb_varint(doc, 1, T0)
    pb_bytes(doc, 2, bytes(tag))
    pb_bytes(doc, 3, bytes(meter))
    return bytes(doc)


def test_native_decoder_edge_documents_equal_reference():
    """Strings out of field order and an endpoint that is not UTF-8
    (interned and hashed as Python decodes them), and meter values sent
    as text, which Python's float() reads or refuses."""
    docs = [
        _raw_app_doc([(25, b"\xff\xfe/x"), (23, b"svc")], [(1, b"12"), (2, b" 1_5.5e1 ")]),
        _raw_app_doc([(24, b"i-2"), (23, b"svc-2"), (24, b"i-3")], [(3, b"-InFinity")]),
        _raw_app_doc([], [(1, b"nan"), (2, b".5")]),
        _raw_app_doc([], [(1, b"1__2")]),
        _raw_app_doc([], [(1, b"0x10")]),
        _raw_app_doc([(23, b"")], [(2, b"1e")]),
    ]
    ref = RefDocumentDecoder()
    nat = native.NativeDocumentDecoder()
    got, want = nat.decode(docs), ref.decode(docs)
    _assert_decodes_equal(got, want)
    assert nat.decode_errors == ref.decode_errors == 3
    app = got[int(MeterId.APP)]
    # first-occurrence order within a row, the last value of a field
    assert app.strings.values == ["\ufffd\ufffd/x", "svc", "i-3", "svc-2"]
    assert app.meters[0, :2].tolist() == [12.0, 155.0] and np.isinf(app.meters[1, 2])
