"""The port's misroute-handoff transport (deepflow_tpu_torch/ingest/
handoff.py) against the reference's: the six cases of
tests/test_handoff.py on the port's classes — real sockets, chaos-
scripted transport loss at the `handoff.send` seam, the counted-shed
contract on every loss lane — each with the port's counters equal to the
reference's on the same script, and the wire across packages in both
directions: a port sender into a reference receiver and the reverse,
frames byte-equal at the far queue."""

from __future__ import annotations

import socket
import time

import pytest

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu.ingest import handoff as ref_handoff
from deepflow_tpu.ingest import queues as ref_queues
from deepflow_tpu.ingest import receiver as ref_receiver
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.ingest import handoff, queues, receiver
from deepflow_tpu_torch.ingest.framing import MessageType

# (handoff, queues, receiver, chaos) of each package
PORT = (handoff, queues, receiver, chaos)
REF = (ref_handoff, ref_queues, ref_receiver, ref_chaos)


def _frame(agent_id: int = 3, pkg=PORT) -> bytes:
    if pkg is PORT:
        from deepflow_tpu_torch.feeder import encode_flowbatch_frames
        from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    else:
        from deepflow_tpu.feeder import encode_flowbatch_frames
        from deepflow_tpu.ingest.replay import SyntheticFlowGen

    fb = SyntheticFlowGen(num_tuples=8, seed=9).flow_batch(4, 1_700_000_000)
    (raw,) = encode_flowbatch_frames(fb, agent_id=agent_id)
    return raw


def _await(cond, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rx_pair(pkg):
    """A started HandoffReceiver of `pkg` feeding its Receiver with one
    ungrouped TAGGEDFLOW handler queue."""
    ho, qs, rxm, _ = pkg
    rx = rxm.Receiver()
    q = qs.PyOverwriteQueue(64)
    rx.register_handler(MessageType.TAGGEDFLOW, [q])
    hr = ho.HandoffReceiver(rx)
    hr.start()
    return rx, hr, q


def _stable(c: dict) -> dict:
    """Sender counters that do not depend on thread timing."""
    return {k: c[k] for k in ("tx_frames", "tx_bytes", "shed_frames", "peers")}


def test_sender_delivers_frames_verbatim_over_the_wire():
    def run(pkg):
        ho = pkg[0]
        rx, hr, q = _rx_pair(pkg)
        sender = ho.HandoffSender({0: ("127.0.0.1", hr.port)})
        try:
            frames = [_frame(a) for a in (3, 5, 9)]
            for raw in frames:
                sender.send(0, raw)
            assert sender.flush(20.0)
            _await(lambda: hr.get_counters()["rx_frames"] == 3, "3 rx frames")
            # verbatim: the receiving dispatch saw the SAME bytes
            assert [q.gets(1, timeout_ms=100)[0] for _ in frames] == frames
            c = sender.get_counters()
            assert c["tx_frames"] == 3
            assert c["shed_frames"] == 0 and c["send_errors"] == 0
            assert hr.get_counters()["bad_frames"] == 0
            # rx accounting is the handoff lane's own, not the front door's
            assert rx.counters["frames_handoff"] == 0
            return _stable(c), hr.get_counters()
        finally:
            sender.close(1.0)
            hr.stop()

    assert run(PORT) == run(REF)


def test_chaos_injected_send_fault_reconnects_and_resends():
    """A scripted fault at the `handoff.send` seam behaves like a broken
    pipe: counted send error + reconnect, the in-flight frame resent —
    at-least-once, zero shed."""
    def run(pkg):
        ho, _, _, ch = pkg
        rx, hr, q = _rx_pair(pkg)
        sender = ho.HandoffSender({0: ("127.0.0.1", hr.port)})
        plan = ch.FaultPlan().add(ch.FaultRule(
            site=ch.SITE_HANDOFF_SEND, error=ch.InjectedFault, at=(0, 2),
        ))
        ch.install(plan)
        try:
            for raw in (_frame(3), _frame(5)):
                sender.send(0, raw)
            assert sender.flush(30.0)
            _await(lambda: hr.get_counters()["rx_frames"] == 2, "2 rx frames")
            c = sender.get_counters()
            assert c["tx_frames"] == 2
            assert c["send_errors"] == 2 and c["reconnects"] == 2
            assert c["shed_frames"] == 0  # the faults cost retries, not loss
            assert plan.injected[ch.SITE_HANDOFF_SEND] == 2
            return c
        finally:
            ch.uninstall()
            sender.close(1.0)
            hr.stop()

    port, ref = run(PORT), run(REF)
    assert {k: port[k] for k in port if k != "connected"} \
        == {k: ref[k] for k in ref if k != "connected"}


def test_unknown_peer_raises_and_counts_shed():
    def run(pkg):
        ho = pkg[0]
        sender = ho.HandoffSender({})
        try:
            with pytest.raises(ho.HandoffUnreachable, match="no handoff peer"):
                sender.send(7, b"x")
            assert sender.get_counters()["shed_frames"] == 1
            return sender.get_counters()
        finally:
            sender.close(0.1)

    assert run(PORT) == run(REF)


def test_unreachable_peer_sheds_counted_on_shutdown():
    """A peer that never answers: frames queue, the writer backs off and
    shutdown sheds every undelivered frame COUNTED."""
    def run(pkg):
        ho = pkg[0]
        sender = ho.HandoffSender(
            {0: ("127.0.0.1", _closed_port())}, connect_timeout_s=0.2
        )
        try:
            for _ in range(3):
                sender.send(0, _frame())
            assert not sender.flush(0.3)  # cannot drain: the peer is down
        finally:
            sender.close(0.2)
        _await(
            lambda: sender.get_counters()["shed_frames"] == 3,
            "3 counted shed", timeout_s=10.0,
        )
        assert sender.get_counters()["send_errors"] >= 1
        assert sender.get_counters()["tx_frames"] == 0
        return _stable(sender.get_counters())

    assert run(PORT) == run(REF)


def test_bounded_queue_overwrite_sheds_oldest_counted():
    def run(pkg):
        ho = pkg[0]
        sender = ho.HandoffSender(
            {0: ("127.0.0.1", _closed_port())},
            queue_capacity=2, connect_timeout_s=0.2,
        )
        try:
            for _ in range(6):
                sender.send(0, _frame())
            # capacity 2 (+ at most 1 in flight): the rest overwrote oldest
            shed = sender.get_counters()["shed_frames"]
            assert shed >= 3
        finally:
            sender.close(0.2)
        # after the shutdown every one of the 6 frames is a counted shed
        _await(lambda: sender.get_counters()["shed_frames"] == 6, "6 counted shed",
               timeout_s=10.0)
        return _stable(sender.get_counters())

    assert run(PORT) == run(REF)


def test_send_racing_close_counts_shed_on_closed_queue():
    """A send that lands put() on a CLOSED queue (racing close()) counts
    a shed and raises, exactly like the pre-check path."""
    def run(pkg):
        ho = pkg[0]
        sender = ho.HandoffSender(
            {0: ("127.0.0.1", _closed_port())}, connect_timeout_s=0.2
        )
        try:
            sender._peers[0].queue.close()
            with pytest.raises(ho.HandoffUnreachable, match="closed mid-send"):
                sender.send(0, _frame())
            assert sender.get_counters()["shed_frames"] == 1
            return sender.get_counters()["shed_frames"]
        finally:
            sender.close(0.2)

    assert run(PORT) == run(REF)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_handoff_wire_crosses_packages_byte_equal(direction):
    """The handoff wire is one ABI: a port HandoffSender delivers into a
    reference HandoffReceiver's Receiver and the reverse, every frame
    arriving byte-equal to what the other package's encoder framed, with
    equal tx/rx counts on both ends."""
    send_pkg, recv_pkg = (PORT, REF) if direction == "port_to_ref" else (REF, PORT)
    frames = [_frame(a, send_pkg) for a in (3, 5, 9, 11)]
    # the two packages frame the same batch to the same bytes
    assert frames == [_frame(a, recv_pkg) for a in (3, 5, 9, 11)]
    rx, hr, q = _rx_pair(recv_pkg)
    sender = send_pkg[0].HandoffSender({0: ("127.0.0.1", hr.port)})
    try:
        for raw in frames:
            sender.send(0, raw)
        assert sender.flush(20.0)
        _await(lambda: hr.get_counters()["rx_frames"] == len(frames), "rx frames")
        assert [q.gets(1, timeout_ms=100)[0] for _ in frames] == frames
        sc, rc = sender.get_counters(), hr.get_counters()
        assert sc["tx_frames"] == rc["rx_frames"] == len(frames)
        assert sc["tx_bytes"] == rc["rx_bytes"] == sum(map(len, frames))
        assert sc["shed_frames"] == rc["bad_frames"] == 0
        # the far receiver's own dispatch delivered them all to the queue
        assert rx.get_counters()["no_handler"] == 0
    finally:
        sender.close(1.0)
        hr.stop()
