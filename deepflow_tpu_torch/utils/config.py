"""Server configuration — one YAML file → typed per-module configs.
Port copy of deepflow_tpu/utils/config.py; PyYAML is imported only to
parse YAML text, so mappings and JSON files load without it.

The reference's server reads a single `/etc/server.yaml` into per-module
`config.Config` structs with yaml tags + validation
(server/ingester/config/config.go); the agent adds a dynamic layer pushed
over gRPC. Here every module config is a frozen dataclass with defaults;
`load_config` overlays a YAML mapping (unknown keys are collected and
reported, not silently dropped) and validates ranges.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any


class ConfigError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    host: str = "127.0.0.1"
    tcp_port: int = 20033
    udp_port: int = 20033


@dataclasses.dataclass(frozen=True)
class IngesterConfig:
    n_decoders: int = 2
    queue_capacity: int = 1 << 16
    batch_size: int = 256
    disable_second_write: bool = False
    prefer_native: bool = True
    # flow_log per-second throttle (ingester.flow_log throttler; 0 = off)
    l4_throttle: int = 50000
    l7_throttle: int = 50000


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    root: str = ""  # "" = in-memory store
    partition_s: int = 3600
    ttl_hours: int = 168
    writer_batch_size: int = 1 << 15
    writer_flush_s: float = 1.0
    # disk watermark for ckmonitor-style priority drops (0 = unlimited)
    max_disk_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    stash_capacity: int = 1 << 16
    batch_size: int = 4096
    window_delay_s: int = 2  # quadruple_generator delay_seconds analog
    second_enabled: bool = True
    minute_enabled: bool = True


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    num_services: int = 1 << 10
    hll_precision: int = 14
    cms_depth: int = 4
    cms_width: int = 1 << 16
    hist_bins: int = 128
    hist_vmin: float = 1.0
    hist_gamma: float = 1.08


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet telemetry fan-in (deepflow_tpu/fleet): when enabled the
    server runs a FleetAggregator listener and the REST /v1/fleet pane
    goes live; hosts point their FleetSink at (listen_host,
    listen_port)."""

    enabled: bool = False
    listen_host: str = "127.0.0.1"
    listen_port: int = 0  # 0 = ephemeral (tests); fixed in production
    # host quiet longer than this is EXPIRED from merged views (counted,
    # last-seen stamp retained on the hosts pane)
    expiry_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Wire delivery plane (deepflow_tpu/wire). The SSE lane
    (`GET /v1/watch`) is always on when `enabled` — it rides the
    existing RestServer. `tcp_*` gates the framed-TCP variant listener;
    `router_*` gates the aggregator-side FleetSubscriptionRouter that
    pipeline hosts' WirePublishers dial into."""

    enabled: bool = True
    lease_s: float = 30.0  # default watcher lease for wire clients
    queue_maxlen: int = 64  # default per-client bounded queue
    tcp_enabled: bool = False
    tcp_host: str = "127.0.0.1"
    tcp_port: int = 0  # 0 = ephemeral (tests); fixed in production
    router_enabled: bool = False
    router_host: str = "127.0.0.1"
    router_port: int = 0


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    receiver: ReceiverConfig = ReceiverConfig()
    ingester: IngesterConfig = IngesterConfig()
    storage: StorageConfig = StorageConfig()
    aggregator: AggregatorConfig = AggregatorConfig()
    sketch: SketchConfig = SketchConfig()
    fleet: FleetConfig = FleetConfig()
    wire: WireConfig = WireConfig()
    region_id: int = 0
    log_level: str = "info"
    # exporter sink specs (exporters/config seat): list of mappings,
    # each {"kind": "kafka"|"otlp"|"prom_rw"|"jsonl", ...kind kwargs,
    # "data_sources": [table prefixes]} — built by
    # server.main.build_exporters at boot
    exporters: tuple = ()
    # path to a YAML/JSON alert-rules file (querier/alerts.py
    # save_rules/load_rules shape) loaded at boot — rules survive a
    # restart; a malformed file fails the boot LOUDLY
    alert_rules: str = ""


def _overlay(cls, defaults, data: dict[str, Any], path: str, unknown: list[str]):
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            unknown.append(f"{path}{key}")
            continue
        cur = getattr(defaults, key)
        if value is None:
            # explicit YAML null (`key:` with no value) keeps the default
            continue
        if dataclasses.is_dataclass(cur):
            if not isinstance(value, dict):
                raise ConfigError(f"{path}{key}: expected mapping")
            kwargs[key] = _overlay(type(cur), cur, value, f"{path}{key}.", unknown)
        else:
            if isinstance(cur, tuple) and isinstance(value, list):
                value = tuple(value)  # YAML sequences arrive as lists
            if cur is not None and not isinstance(
                value, (type(cur), int) if isinstance(cur, float) else type(cur)
            ):
                raise ConfigError(
                    f"{path}{key}: expected {type(cur).__name__}, got {type(value).__name__}"
                )
            kwargs[key] = type(cur)(value) if cur is not None else value
    return dataclasses.replace(defaults, **kwargs)


def _validate(cfg: ServerConfig) -> None:
    checks = [
        (cfg.ingester.n_decoders >= 1, "ingester.n_decoders must be >= 1"),
        (cfg.storage.partition_s >= 1, "storage.partition_s must be >= 1"),
        (cfg.aggregator.stash_capacity > 0, "aggregator.stash_capacity must be > 0"),
        (1 <= cfg.sketch.hll_precision <= 18, "sketch.hll_precision out of range [1,18]"),
        (cfg.sketch.hist_gamma > 1.0, "sketch.hist_gamma must be > 1"),
        (0 <= cfg.receiver.tcp_port <= 65535, "receiver.tcp_port out of range"),
        (cfg.fleet.expiry_s > 0, "fleet.expiry_s must be > 0"),
        (0 <= cfg.fleet.listen_port <= 65535, "fleet.listen_port out of range"),
        (cfg.wire.lease_s > 0, "wire.lease_s must be > 0"),
        (cfg.wire.queue_maxlen >= 1, "wire.queue_maxlen must be >= 1"),
        (0 <= cfg.wire.tcp_port <= 65535, "wire.tcp_port out of range"),
        (0 <= cfg.wire.router_port <= 65535, "wire.router_port out of range"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ConfigError(msg)


def _parse_text(text: str):
    """JSON text parses with the standard library; anything else is YAML
    (a JSON document is also YAML, so the result is the same)."""
    import json

    try:
        return json.loads(text)
    except ValueError:
        import yaml

        return yaml.safe_load(text)


def load_config(source: str | Path | dict | None = None) -> tuple[ServerConfig, list[str]]:
    """Build a ServerConfig from a YAML file path, mapping, or None
    (pure defaults). Returns (config, unknown_keys)."""
    if source is None:
        data: dict = {}
    elif isinstance(source, dict):
        data = source
    else:
        text = Path(source).read_text()
        data = _parse_text(text) or {}
        if not isinstance(data, dict):
            raise ConfigError("top-level config must be a mapping")
    unknown: list[str] = []
    cfg = _overlay(ServerConfig, ServerConfig(), data, "", unknown)
    _validate(cfg)
    return cfg, unknown
