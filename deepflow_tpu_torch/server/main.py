"""Server composition root — the cmd/server/main.go seat.

One process wiring every plane the way the reference boots
(main.go:31-40: controller.Start → ingester.Start → querier.Start):
config → store → controller (resources, tagrecorder, trisolaris,
election) → receiver + ingesters (flow metrics, flow logs,
integrations) → downsampler → debug endpoint → query engine.
`Server.start()` brings it all up; `tick()` drives the periodic work
(tagrecorder sync, downsampler, stats) so tests and the CLI can step
time deterministically; `stop()` tears down in reverse.

Port copy of deepflow_tpu/server/main.py. The server's device work —
the enrichment platform state, the downsampler's rollups and the SQL,
subscription and alert reductions — runs on `device` (default CUDA;
raises without it).
"""

from __future__ import annotations

import os
import time

from ..controller.cloud import CloudTask
from ..device import resolve_device
from ..controller.election import LeaderElection
from ..controller.genesis import GenesisStore
from ..controller.rebalance import AnalyzerBalancer
from ..controller.recorder import Recorder
from ..controller.resources import ResourceDB
from ..controller.prom_labels import PrometheusLabelRegistry
from ..controller.rest import RestServer
from ..controller.tagrecorder import TagRecorder
from ..controller.trisolaris import TrisolarisService
from ..flowlog.server import FlowLogIngester
from ..ingest.receiver import Receiver
from ..querier import QueryEngine
from ..querier.translation import Translator
from ..server.datasource import DataSource, Downsampler
from ..server.debug import DebugServer
from ..server.events import EventIngester
from ..server.exporters import ExporterHub, FileExporter, OtlpExporter, RemoteWriteExporter


def build_exporters(specs) -> list:
    """Config-driven sink construction (the reference's
    exporters/config seat): each spec is {"kind": ..., kwargs...}.
    Unknown kinds raise at boot — a misconfigured sink must not
    silently drop telemetry."""
    out = []
    for spec in specs or ():
        spec = dict(spec)
        kind = spec.pop("kind", None)
        if "data_sources" in spec:
            spec["data_sources"] = tuple(spec["data_sources"])
        if kind == "kafka":
            from ..server.kafka_exporter import KafkaExporter

            out.append(KafkaExporter(**spec))
        elif kind == "otlp":
            out.append(OtlpExporter(**spec))
        elif kind == "prom_rw":
            if "metrics" in spec:
                spec["metrics"] = tuple(spec["metrics"])
            out.append(RemoteWriteExporter(**spec))
        elif kind == "jsonl":
            out.append(FileExporter(**spec))
        else:
            raise ValueError(f"unknown exporter kind {kind!r}")
    return out
from ..server.flow_metrics import FlowMetricsIngester
from ..server.integration import IntegrationIngester
from ..server.mcp import MCPServer
from ..server.metrics_tables import DocStoreWriter
from ..storage.issu import upgrade as issu_upgrade
from ..storage.monitor import StoreMonitor
from ..storage.store import ColumnarStore
from ..tracing.builder import TraceTreeBuilder
from ..utils.config import ServerConfig, load_config
from ..utils.stats import default_collector


class Server:
    def __init__(self, config: ServerConfig | None = None, *, exporters=None, lease_path=None,
                 device=None):
        self.config = config or load_config(None)[0]
        self.device = resolve_device(device)
        self.exporters = (
            exporters if exporters is not None
            else build_exporters(self.config.exporters)
        )
        self.lease_path = lease_path
        self.started = False

    def start(self) -> "Server":
        cfg = self.config
        self.store = ColumnarStore(cfg.storage.root)
        # in-service schema upgrade before anything touches tables
        # (ckissu.go:51 boot ordering)
        self.issu_report = issu_upgrade(self.store)
        self.resources = ResourceDB()
        self.translator = Translator(self.store)
        self.tagrecorder = TagRecorder(self.resources, self.store, translator=self.translator)
        # resource plane: discovery sources → recorder → ResourceDB.
        # Genesis fills from agent sync payloads; cloud sources attach
        # via add_cloud_source(). Resource-change events ride the event
        # plane once the event ingester is up (sink bound below).
        self._resource_events: list = []
        self.recorder = Recorder(self.resources, event_sink=self._resource_events.append)
        # id stability across restarts (MySQL seat): without this, a
        # rebooted recorder re-allocates ids and the persisted tag
        # dictionaries alias onto the wrong resources
        self._recorder_state_path = (
            os.path.join(cfg.storage.root, "recorder_ids.json")
            if cfg.storage.root
            else None
        )
        if self._recorder_state_path:
            self.recorder.load(self._recorder_state_path)
        self._was_leader = False
        self.genesis = GenesisStore()
        self.balancer = AnalyzerBalancer()
        self._analyzer_ip = cfg.receiver.host or "127.0.0.1"
        self.balancer.register(self._analyzer_ip)
        self.cloud_tasks: list[CloudTask] = []
        self.trisolaris = TrisolarisService(
            self.resources, genesis=self.genesis, balancer=self.balancer
        )
        # holder must be unique ACROSS processes — heap addresses collide
        self.election = (
            LeaderElection(self.lease_path, holder=f"server-{os.getpid()}-{id(self):x}")
            if self.lease_path
            else None
        )
        self._platform_version = self.resources.version

        self.receiver = Receiver(
            host=cfg.receiver.host,
            tcp_port=cfg.receiver.tcp_port,
            udp_port=cfg.receiver.udp_port,
        )
        self.receiver.start()

        writer_args = {
            "batch_size": cfg.storage.writer_batch_size,
            "flush_interval_s": cfg.storage.writer_flush_s,
        }
        # push query plane: store mutations publish on the
        # process-wide event bus → eager result-cache invalidation; the
        # subscription manager and alert engine evaluate standing
        # queries on those events. The doc writer registers its pending
        # rows as live sources (ROADMAP item (a)): the server-layer
        # network/application families answer range-ending-now queries
        # with partial rows instead of going dark for a flush interval.
        from ..querier.alerts import AlertEngine
        from ..querier.events import connect_store_events, default_event_bus
        from ..querier.live import default_live_registry
        from ..querier.subscribe import SubscriptionManager

        self.event_bus = default_event_bus
        connect_store_events(self.store, self.event_bus)
        self.subscriptions = SubscriptionManager(
            self.store, bus=self.event_bus, name="server", device=self.device
        )
        self.alerts = AlertEngine(self.store, bus=self.event_bus, name="server",
                                  device=self.device)
        if cfg.alert_rules:
            # rule persistence: alert rules load
            # from the config-named file at boot — a malformed rule
            # fails the boot loudly rather than dropping the page
            self.alerts.load_rules(cfg.alert_rules)
        # device profiling plane: each collector tick that
        # lands profiling rows publishes a ProfileSnapshot, so standing
        # queries / span-latency alert rules over deepflow_system
        # re-evaluate at the sample tick instead of waiting for a poll
        from ..profiling import profile_tick_sink

        self._profile_sink = profile_tick_sink(self.event_bus)
        default_collector.add_sink(self._profile_sink)

        self.exporter_hub = ExporterHub(self.exporters) if self.exporters else None
        self.doc_writer = DocStoreWriter(
            self.store,
            partition_s=cfg.storage.partition_s,
            ttl_hours=cfg.storage.ttl_hours,
            writer_args=writer_args,
            exporter_hub=self.exporter_hub,
            live_registry=default_live_registry,
        )
        # the enrichment state lives on the server's device; the
        # flow-metrics and flow-log workers run where it is
        platform_state = self.resources.build_platform_table(cfg.region_id).build(
            device=self.device)
        self.flow_metrics = FlowMetricsIngester(
            self.receiver,
            self.doc_writer,
            platform_state=platform_state,
            n_workers=cfg.ingester.n_decoders,
            queue_capacity=cfg.ingester.queue_capacity,
            batch_size=cfg.ingester.batch_size,
            disable_second_write=cfg.ingester.disable_second_write,
            prefer_native=cfg.ingester.prefer_native,
        )
        self.flow_log = FlowLogIngester(
            self.receiver,
            self.store,
            platform_state=platform_state,
            l4_throttle=cfg.ingester.l4_throttle,
            l7_throttle=cfg.ingester.l7_throttle,
            writer_args=writer_args,
        )
        self.trace_builder = TraceTreeBuilder(self.store, writer_args=writer_args)
        # restart-safe: ids re-load from the persisted dictionaries so
        # encoded rows never alias onto re-allocated ids
        self.prom_labels = PrometheusLabelRegistry.load(self.store)
        self.integration = IntegrationIngester(
            self.receiver, self.store, writer_args=writer_args,
            trace_builder=self.trace_builder,
            prom_labels=self.prom_labels,
        )
        self.events = EventIngester(self.receiver, self.store, writer_args=writer_args)
        self.downsampler = Downsampler(self.store, device=self.device)
        self.debug = DebugServer(
            context={
                "store": self.store,
                "trisolaris": self.trisolaris,
                "downsampler": self.downsampler,
                "subscriptions": self.subscriptions,
                "alerts": self.alerts,
            }
        )
        self.monitor = StoreMonitor(
            self.store, max_bytes=cfg.storage.max_disk_bytes or None
        )
        self.query = QueryEngine(self.store, translator=self.translator, device=self.device)
        # fleet telemetry fan-in (opt-in): the aggregator listener lands
        # per-host frames in THIS server's deepflow_system store, so the
        # SQL/PromQL/alert planes serve fleet-wide queries with
        # host/group labels and REST grows /v1/fleet/*
        self.fleet = None
        if cfg.fleet.enabled:
            from ..fleet import FleetAggregator

            self.fleet = FleetAggregator(
                host=cfg.fleet.listen_host,
                port=cfg.fleet.listen_port,
                store=self.store,
                bus=self.event_bus,
                expiry_s=cfg.fleet.expiry_s,
            ).start()
        # wire delivery plane: the SSE lane off the REST server maps
        # each /v1/watch connection onto a bounded watcher queue; the
        # optional router turns this process into the fleet fan-out
        # aggregator (pipeline hosts' WirePublishers dial in), and the
        # optional TCP listener serves the framed variant
        self.wire = None
        self.wire_router = None
        self.wire_tcp = None
        if cfg.wire.enabled:
            from ..wire import FleetSubscriptionRouter, WireHub, WireListener

            if cfg.wire.router_enabled:
                self.wire_router = FleetSubscriptionRouter(
                    host=cfg.wire.router_host, port=cfg.wire.router_port,
                ).start()
            self.wire = WireHub(
                self.subscriptions, alerts=self.alerts,
                router=self.wire_router, bus=self.event_bus,
                lease_s=cfg.wire.lease_s, maxlen=cfg.wire.queue_maxlen,
                name="server",
            )
            if cfg.wire.tcp_enabled:
                self.wire_tcp = WireListener(
                    self.wire, host=cfg.wire.tcp_host,
                    port=cfg.wire.tcp_port,
                ).start()
        self.mcp = MCPServer(self)  # LLM tool surface (mcp.go seat)
        self.rest = RestServer(self)  # controller/querier REST + pprof seat
        if self.election:
            self.election.start()
        self.started = True
        return self

    # -- periodic work (the reference's internal tickers) ---------------
    def tick(self, now: int | None = None) -> dict:
        now = int(time.time()) if now is None else now
        leader = self.election.is_leader() if self.election else True
        if leader and not self._was_leader and self._recorder_state_path:
            # promoted follower: re-read the id maps the previous leader
            # saved, or the first reconcile would re-allocate live ids
            self.recorder.load(self._recorder_state_path)
        self._was_leader = leader
        did = {"leader": leader, "tagrecorder": False, "downsampled": 0, "platform": False}
        # enrichment follows resources, every node (the periodic
        # PlatformInfoTable refresh — not leader-gated in the reference)
        if self.resources.version != self._platform_version:
            self.refresh_platform()
            did["platform"] = True
        did["traces_closed"] = self.trace_builder.tick()
        did["monitor"] = self.monitor.check(now)
        # alert `for`-durations must mature even when a watched table
        # goes quiet (no events BECAUSE traffic stopped is itself an
        # alertable condition) — the wall-clock evaluation lane
        self.alerts.tick(now)
        # abandoned dashboard watchers (missed lease renewals) reap on
        # the tick as well as on event batches — a quiet store must not
        # keep dead clients' queues alive forever
        self.subscriptions.reap()
        # ...and the wire plane's own topics (alert watchers, fleet
        # router entries, stream records) sweep on the same cadence
        if self.wire is not None:
            self.wire.reap()
        # this process IS the local analyzer — its liveness follows the
        # tick, every node (remote analyzers heartbeat via their own sync)
        self.balancer.heartbeat(self._analyzer_ip)
        if leader:
            did["tagrecorder"] = self.tagrecorder.sync()
            did["downsampled"] = self.downsampler.process(now)
            # discovery: cloud sources + the genesis inventory reconcile
            # into ResourceDB; change events land in the event table.
            # Source errors are non-fatal (CloudTask._loop's stance) —
            # one flaky apiserver must not take the server down.
            for task in self.cloud_tasks:
                task.safe_poll()
            cs = self.recorder.reconcile(self.genesis.domain, self.genesis.snapshot())
            did["resource_changes"] = cs.total + sum(
                t.last_change.total for t in self.cloud_tasks if t.last_change
            )
            self._drain_resource_events()
            self.balancer.rebalance()
            if self._recorder_state_path and self.recorder.dirty:
                self.recorder.save(self._recorder_state_path)
        default_collector.tick()
        return did

    def add_cloud_source(self, source) -> "CloudTask":
        """Attach a cloud discovery source (KubernetesGather /
        FileReaderPlatform); polled on the leader tick."""
        task = CloudTask(source, self.recorder)
        self.cloud_tasks.append(task)
        return task

    def _drain_resource_events(self) -> None:
        """Resource-change events → the event table (the reference's
        eventapi → event ingester path, in-process here)."""
        import json as _json

        from ..ingest.framing import FlowHeader, MessageType

        # FIFO: a create+delete pair for a churned uid shares the same
        # int-second timestamp, so write order is the only order
        events, self._resource_events[:] = list(self._resource_events), []
        for ev in events:
            self.events._event(
                1,
                FlowHeader(msg_type=int(MessageType.K8S_EVENT)),
                _json.dumps(
                    {
                        "time": ev["time"],
                        "event_type": ev["type"],
                        "resource_type": ev["resource_type"],
                        "resource_name": ev["instance"],
                    }
                ).encode(),
                MessageType.K8S_EVENT,
            )

    def query_trace(self, trace_id: str, org: int = 1):
        from ..tracing.query import query_trace

        return query_trace(self.store, trace_id, org=org)

    def query_window_trace(self, window_idx: int, *, interval: int = 1,
                           service: str | None = None, org: int = 1):
        """Window lineage plane: the assembled trace tree of
        one pipeline window — exported spans from the store when
        present, else live from a registered LineageTracker."""
        from ..tracing.lineage import DEFAULT_SERVICE, query_window_trace

        return query_window_trace(
            self.store, window_idx, interval=interval,
            service=service or DEFAULT_SERVICE, org=org,
        )

    def trace_map(self, time_range=None, org: int = 1):
        from ..tracing.query import trace_map

        return trace_map(self.store, time_range=time_range, org=org)

    def refresh_platform(self) -> None:
        """Resource changes → new enrichment generation (the periodic
        PlatformInfoTable refresh, grpc_platformdata.go:147)."""
        state = self.resources.build_platform_table(self.config.region_id).build(
            device=self.device)
        self.flow_metrics.platform_state = state
        self.flow_log.platform_state = state
        self._platform_version = self.resources.version

    def add_datasource(self, **kw) -> DataSource:
        return self.downsampler.add(DataSource(**kw))

    def stop(self) -> None:
        if not self.started:
            return
        if self.election:
            self.election.stop()
        self.flow_metrics.stop()
        self.flow_log.stop()
        self.integration.stop()
        self.events.stop()
        self.trace_builder.stop()
        self.mcp.stop()
        # wire teardown BEFORE rest.stop(): close() flips the hub's
        # closing flag so in-flight SSE handler threads end their
        # streams instead of spinning on heartbeats into dead sockets
        if self.wire is not None:
            self.wire.close()
        if self.wire_tcp is not None:
            self.wire_tcp.stop()
        if self.wire_router is not None:
            self.wire_router.stop()
        self.rest.stop()
        if self.fleet is not None:
            self.fleet.stop()
        self.doc_writer.flush()
        self.doc_writer.stop()
        if self.exporter_hub is not None:
            self.exporter_hub.stop()
        self.debug.stop()
        self.trisolaris.stop()
        self.receiver.stop()
        # detach the push plane from the PROCESS-WIDE bus: a stopped
        # server's managers must not keep evaluating against its store
        # when another server (tests, restarts) publishes
        self.subscriptions.close()
        self.alerts.close()
        default_collector.remove_sink(self._profile_sink)
        self.store.set_mutation_hook(None)
        self.started = False
