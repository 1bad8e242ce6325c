"""Agent daemon composition — the trident.rs wiring seat.

Port copy of deepflow_tpu/agent/main.py.

The reference's trident.rs builds, per capture engine: dispatcher →
FlowMap → {QuadrupleGenerator/Collector, FlowAggr, L7 log} chains, one
UniformSender per output type, config sync, and self-monitoring
(trident.rs:1748-1781 lists every sender). This composes the same
pipeline graph from this package's pieces:

  packet source (pcap replay / crafted batches; live capture has no
  seat in this container) → parse_packets → FlowMap (L4 state) +
  L7Engine (protocol logs) → per-second tick:
    * L4 emissions → DualGranularityPipeline (1s+1m metric docs)
      → METRICS sender
    * L4 emissions → minute FlowAggr → TAGGEDFLOW sender
    * L7 sessions → PROTOCOLLOG sender + L7 AppMeter pipeline → METRICS
  plus AgentSyncClient (config/platform/NTP/upgrade) and the stats loop
  shipping DFSTATS.

`Agent.run_pcap()` replays a capture; `step()` is the injectable
unit tests drive.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..aggregator.fanout import FanoutConfig
from ..aggregator.pipeline import DualGranularityPipeline, L7Pipeline, PipelineConfig
from ..aggregator.window import WindowConfig
from ..datamodel.batch import FlowBatch
from ..datamodel.code import DocumentFlag
from ..device import resolve_device
from ..flowlog.aggr import MinuteAggr, ThrottlingQueue
from ..flowlog.codec import encode_rows
from ..ingest.codec import encode_docbatch
from ..ingest.framing import MessageType
from ..ingest.sender import UniformSender
from .dispatcher import Dispatcher, DispatcherConfig
from ..utils.stats import StatsCollector
from .bridge import emissions_to_flow_batch
from .flow_map import FlowMap, FlowTimeouts
from .policy import (
    ACTION_DROP,
    ACTION_PCAP,
    PolicyLabeler,
    PolicyMeterAggregator,
    pcap_frames,
)
from .possible import PossibleHostTable
from .l7.engine import L7Engine
from .packet import CaptureFilter, parse_packets


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    agent_id: int = 1
    organization_id: int = 1
    servers: tuple = (("127.0.0.1", 20033),)
    flow_capacity: int = 1 << 14
    batch_size: int = 1 << 12
    l4_log_throttle: int = 10_000
    compression: str | int = "auto"
    metrics_window: WindowConfig = WindowConfig(capacity=1 << 14)
    # dispatcher BPF seat: evaluated as one vectorized mask per batch
    capture_filter: CaptureFilter | None = None
    # policy plane (labeler.rs seat): ACLs in priority order; DROP
    # removes packets pre-FlowMap, PCAP ships RAW_PCAP frames
    acls: tuple = ()
    # possible-host activity tracking (utils/possible_host.rs seat):
    # when on, is_active_host comes from observed traffic instead of
    # the all-active default, enabling inactive-IP aggregation
    track_host_activity: bool = False
    # dispatcher flavor (dispatcher/mod.rs DispatcherFlavor): local /
    # mirror / analyzer orientation — see agent/dispatcher.py
    dispatcher: DispatcherConfig | None = None


def _compact(buf: np.ndarray, p, retain: np.ndarray):
    """Drop rows from the capture batch (capture-filter / policy-drop
    compaction): slice the snap buffer and every PacketBatch field."""
    return buf[retain], dataclasses.replace(
        p, **{f.name: getattr(p, f.name)[retain] for f in dataclasses.fields(p)}
    )


class Agent:
    """The agent's graph. Its device state (FlowMap, the metric pipelines,
    the minute aggregator) lives on `device` (default CUDA; raises
    without it)."""

    def __init__(self, config: AgentConfig = AgentConfig(), *, senders=None, device=None):
        c = config
        self.config = c
        self.device = resolve_device(device)
        self.dispatcher = (
            Dispatcher(c.dispatcher) if c.dispatcher is not None else None
        )
        self.flow_map = FlowMap(
            capacity=c.flow_capacity, batch_size=c.batch_size,
            agent_id=c.agent_id, dispatcher=self.dispatcher, device=self.device,
        )
        self.l7 = L7Engine(agent_id=c.agent_id)
        fanout = FanoutConfig(agent_id=c.agent_id)
        pipe_cfg = PipelineConfig(
            fanout=fanout, window=c.metrics_window, batch_size=c.batch_size
        )
        self.metrics = DualGranularityPipeline(pipe_cfg, device=self.device)
        self.l7_metrics = L7Pipeline(pipe_cfg, device=self.device)
        self.flow_aggr = MinuteAggr(batch_size=4 * c.batch_size, device=self.device)
        self.l4_throttle = ThrottlingQueue(c.l4_log_throttle)

        self._default_senders = senders is None
        if senders is not None:
            self.senders = senders  # test seam: {msg_type: sender-like}
        else:
            self.senders = {
                mt: UniformSender(
                    list(c.servers),
                    mt,
                    agent_id=c.agent_id,
                    organization_id=c.organization_id,
                    compression=c.compression,
                )
                for mt in (
                    MessageType.METRICS,
                    MessageType.TAGGEDFLOW,
                    MessageType.PROTOCOLLOG,
                    MessageType.AGENT_LOG,
                )
                + ((MessageType.RAW_PCAP,) if c.acls else ())
            }
        self.policy = PolicyLabeler(list(c.acls)) if c.acls else None
        self.policy_meters = (
            PolicyMeterAggregator(agent_id=c.agent_id) if c.acls else None
        )
        self.possible_hosts = PossibleHostTable() if c.track_host_activity else None
        self.counters = {
            "batches": 0, "packets": 0, "docs_sent": 0, "logs_sent": 0,
            "packets_filtered": 0, "packets_dropped_policy": 0, "pcap_sent": 0,
        }

    # -- pipeline step ---------------------------------------------------
    def step(self, buf: np.ndarray, lengths, ts_s, ts_us) -> None:
        """One capture batch through the whole graph."""
        p = parse_packets(buf, lengths, ts_s, ts_us)
        if self.config.capture_filter is not None:
            keep = self.config.capture_filter.mask(p)
            filtered = p.valid & ~keep
            if filtered.any():
                # drop filtered rows from the batch entirely — FlowMap's
                # invalid_packets counter must keep meaning "capture
                # garbage", not operator policy
                self.counters["packets_filtered"] += int(filtered.sum())
                buf, p = _compact(buf, p, ~filtered)
        if self.policy is not None:
            acl_id, action = self.policy.match(p)
            self.policy_meters.update(p, acl_id, action, self.policy.last_forward)
            pcap_idx = np.nonzero(action == ACTION_PCAP)[0]
            if pcap_idx.size:
                frames = pcap_frames(buf, p, pcap_idx, acl_id)
                if self._send(MessageType.RAW_PCAP, frames):
                    self.counters["pcap_sent"] += len(frames)
            dropped = action == ACTION_DROP
            if dropped.any():
                self.counters["packets_dropped_policy"] += int(dropped.sum())
                buf, p = _compact(buf, p, ~dropped)
        self.counters["batches"] += 1
        self.counters["packets"] += int(p.valid.sum())
        self.flow_map.inject(p)

        # L7: protocol logs + RED metrics from the same packets
        log_batch, app_batch = self.l7.process(buf, p)
        if log_batch.size:
            self._send(MessageType.PROTOCOLLOG, encode_rows(log_batch))
            self.counters["logs_sent"] += log_batch.size
        if app_batch.valid.any():
            for db in self.l7_metrics.ingest(app_batch):
                self._send_docs(db, self.l7_metrics.flags)

        # L4 tick at the batch's max second: emissions feed metrics + logs
        now = int(np.max(np.asarray(ts_s))) if len(np.asarray(ts_s)) else 0
        if self.policy_meters is not None:
            usage = self.policy_meters.flush(now)
            if usage is not None:
                # traffic_policy docs are minute-granularity (NONE =
                # not PER_SECOND; the dual pipeline has
                # no separate minute sub-pipeline to borrow flags from)
                self._send_docs(usage, DocumentFlag.NONE)
        emissions = self.flow_map.tick(now)
        if emissions.size:
            self._ingest_l4(emissions)
            for sampled in self.l4_throttle.drain():
                self._send(MessageType.TAGGEDFLOW, encode_rows(sampled))

    def _ingest_l4(self, emissions) -> None:
        """Emission rows → dual-granularity metric docs + minute flow
        logs. Chunked: a drain tick can emit more rows than one pipeline
        batch (the stash flushes whole windows at once)."""
        fb = emissions_to_flow_batch(emissions, possible=self.possible_hosts)
        bs = self.config.batch_size
        for off in range(0, fb.size, bs):
            chunk = FlowBatch(
                tags={k: v[off : off + bs] for k, v in fb.tags.items()},
                meters=fb.meters[off : off + bs],
                valid=fb.valid[off : off + bs],
            )
            for flags, db in self.metrics.ingest(chunk):
                self._send_docs(db, flags)
        for minute_batch in self.flow_aggr.ingest(emissions):
            self.l4_throttle.put(minute_batch)

    def _send_docs(self, db, flags) -> None:
        msgs = encode_docbatch(db, flags=int(flags))
        self._send(MessageType.METRICS, msgs)
        self.counters["docs_sent"] += db.size

    def _send(self, mt: MessageType, msgs: list[bytes]) -> bool:
        s = self.senders.get(mt)
        if s is not None and msgs:
            s.send(msgs)
            return True
        return False

    def apply_dynamic_config(self, cfg: dict) -> None:
        """Apply a trisolaris-pushed dynamic config overlay. Today the
        live-reloadable knobs are the ACL table ("acls": FlowAcl dicts —
        the reference's flow_acls push) and the l4 log throttle."""
        from .policy import acls_from_config

        if "acls" in cfg:
            acls = acls_from_config(cfg["acls"])
            self.policy = PolicyLabeler(list(acls)) if acls else None
            if acls and self.policy_meters is None:
                self.policy_meters = PolicyMeterAggregator(agent_id=self.config.agent_id)
            # a pushed PCAP ACL needs the RAW_PCAP lane even though the
            # static config had none (default sender set is acl-gated)
            if (
                acls
                and self._default_senders
                and MessageType.RAW_PCAP not in self.senders
            ):
                c = self.config
                self.senders[MessageType.RAW_PCAP] = UniformSender(
                    list(c.servers), MessageType.RAW_PCAP,
                    agent_id=c.agent_id, organization_id=c.organization_id,
                    compression=c.compression,
                )
            self.counters["config_reloads"] = self.counters.get("config_reloads", 0) + 1
        if "l4_log_throttle" in cfg:
            self.l4_throttle.throttle = int(cfg["l4_log_throttle"])

    def ship_log(self, line: str, severity: int = 6) -> None:
        """Forward one agent log line to the server's AGENT_LOG lane
        (droplet-message type 18 → application_log table); RFC 3164
        <PRI> prefix carries the severity."""
        self._send(MessageType.AGENT_LOG, [f"<{8 + severity}>{line}".encode()])

    # -- capture sources -------------------------------------------------
    def run_live(self, interface: str = "lo", *, duration_s: float | None = None,
                 snap: int = 192, ring: bool = False) -> dict:
        """Live AF_PACKET capture → the same graph as replay (the
        dispatcher seat when the container grants CAP_NET_RAW).
        `ring=True` uses the TPACKET_V3 mmap block ring (the
        recv_engine/af_packet fast path) instead of per-packet recv."""
        from .capture import AfPacketCapture, AfPacketRingCapture

        cls = AfPacketRingCapture if ring else AfPacketCapture
        cap = cls(
            interface, snap=snap, batch_size=self.config.batch_size
        )
        try:
            for buf, lengths, ts_s, ts_us in cap.batches(duration_s=duration_s):
                self.step(buf, lengths, ts_s, ts_us)
        finally:
            cap.close()
        # drain like run_pcap: open flows + buffered windows must flush
        # when a bounded capture ends, or the session tail is lost
        stats = self.drain()
        return dict(stats, capture=dict(cap.counters))

    def run_pcap(self, path, *, batch_size: int | None = None) -> dict:
        """Replay a capture file through the graph (the dispatcher seat —
        this container has no live AF_PACKET/XDP; replay is the source)."""
        from .pcap import pcap_batches

        for buf, lengths, ts_s, ts_us in pcap_batches(
            path, batch_size=batch_size or self.config.batch_size
        ):
            self.step(buf, lengths, ts_s, ts_us)
        return self.drain()

    def drain(self) -> dict:
        """Flush everything (shutdown): final tick far in the future,
        pipeline drains, sender close left to the caller."""
        emissions = self.flow_map.tick(1 << 31)
        if emissions.size:
            self._ingest_l4(emissions)
        if self.policy_meters is not None:
            usage = self.policy_meters.flush(1 << 31)
            if usage is not None:
                # minute-granularity, same flag stance as the tick path
                self._send_docs(usage, DocumentFlag.NONE)
        for flags, db in self.metrics.drain():
            self._send_docs(db, flags)
        for db in self.l7_metrics.drain():
            self._send_docs(db, self.l7_metrics.flags)
        for batch in self.flow_aggr.drain():
            self.l4_throttle.put(batch)
        for sampled in self.l4_throttle.drain():
            self._send(MessageType.TAGGEDFLOW, encode_rows(sampled))
        return dict(self.counters)

    def close(self) -> None:
        for s in self.senders.values():
            if hasattr(s, "close"):
                s.close()
