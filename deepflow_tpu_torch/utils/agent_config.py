"""Agent-config migration — the server/agent_config/migrator.go seat.

The reference carries agent YAML across schema generations: the old
flat trident keys and the current nested sections both upgrade to one
canonical shape via `upgrade_from` annotations (migrator.go:42
newUpgrader; migrator_conv.go rename tables). Same job here, targeting
this build's flat dynamic-config schema (the dict
Agent.apply_dynamic_config consumes): operators can feed either an
old-generation flat YAML or a current nested one, and group-config
pushes normalize on the way in (TrisolarisService.set_group_config).

Unknown keys pass through untouched (agents ignore what they don't
know); every rename is reported in the notes so operators see exactly
what the migrator did.

Port copy of deepflow_tpu/utils/agent_config.py.
"""

from __future__ import annotations

# old/foreign dotted path → canonical flat key. Left side matches both
# generations of the reference schema (flat trident keys and the nested
# 6.6+ sections); right side is this build's AgentConfig field space.
_RENAMES = {
    # identity / control plane
    "vtap_id": "agent_id",
    # declaration order matters: within one target the OLDER generation
    # comes first so the newer alias wins conflicts (pass-1 invariant)
    "controller_ips": "servers",
    "global.communication.controller_ip": "servers",
    # resource shape
    "flow_count_limit": "flow_capacity",
    "processors.flow_log.tunning.concurrent_flow_limit": "flow_capacity",
    "batch_size": "batch_size",
    # throttles
    "l4_log_collect_nps_threshold": "l4_log_throttle",
    "processors.flow_log.throttles.l4_throttle": "l4_log_throttle",
    # capture plane
    "tap_interface_regex": "capture_interface_regex",
    "inputs.cbpf.af_packet.interface_regex": "capture_interface_regex",
    "capture_bpf": "capture_filter",
    "inputs.cbpf.af_packet.extra_bpf_filter": "capture_filter",
    # transport
    "compressor_socket_type": "compression",
    "outputs.flow_log.compression": "compression",
    # policy
    "flow_acls": "acls",
}


def _flatten(doc: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in doc.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) and path not in _RENAMES:
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def migrate_agent_config(doc: dict) -> tuple[dict, list[str]]:
    """Normalize an agent config of any supported generation into the
    flat canonical schema. Returns (config, notes); notes record every
    rename applied (migrator.go's 'has been upgraded to' warnings)."""
    flat = _flatten(doc or {})
    out: dict = {}
    notes: list[str] = []
    # pass 1: renamed aliases, walked in _RENAMES declaration order —
    # within one canonical target the older-generation key is declared
    # first, so when BOTH generations appear the newer alias wins
    # deterministically (never YAML key order)
    for path, target in _RENAMES.items():
        if path not in flat:
            continue
        value = flat[path]
        if target in out and out[target] != value:
            notes.append(f"conflict on {target!r}: newer alias {path!r} wins")
        out[target] = value
        if target != path:
            notes.append(f"{path!r} upgraded to {target!r}")
    # pass 2: canonical / unknown keys — an explicit canonical key
    # deterministically WINS over any leftover alias (dict order must
    # never decide which value an agent receives)
    for path, value in flat.items():
        if path in _RENAMES:
            continue
        if path in out and out[path] != value:
            notes.append(f"canonical {path!r} overrides a renamed alias")
        out[path] = value
    return out, notes
