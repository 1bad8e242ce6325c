"""The server's configuration in the port: `utils.config.load_config`
and `utils.agent_config.migrate_agent_config` against the reference's on
the same inputs, and the composed server booting where PyYAML is absent
(the card's host lists no PyYAML; mappings and JSON load without it)."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from deepflow_tpu.controller.resources import ResourceDB as RefResourceDB
from deepflow_tpu.controller.trisolaris import TrisolarisService as RefTrisolaris
from deepflow_tpu.utils import agent_config as ref_agent_config
from deepflow_tpu.utils import config as ref_config
from deepflow_tpu_torch.controller.resources import ResourceDB
from deepflow_tpu_torch.controller.trisolaris import TrisolarisService
from deepflow_tpu_torch.utils import agent_config
from deepflow_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent

YAML_TEXT = (
    "ingester:\n  n_decoders: 8\n  mystery: 1\nstorage:\n  ttl_hours: 24\n"
    "sketch:\n  hll_precision: 12\nexporters:\n  - kind: jsonl\n    path: /x\n"
    "fleet:\n  enabled: true\n  expiry_s: 5\n"
)


def _load_both(source):
    got, got_unknown = config.load_config(source)
    want, want_unknown = ref_config.load_config(source)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got_unknown == want_unknown
    return got, got_unknown


def test_config_defaults_and_yaml_overlay(tmp_path):
    cfg, unknown = _load_both(None)
    assert cfg == config.ServerConfig() and unknown == []
    f = tmp_path / "server.yaml"
    f.write_text(YAML_TEXT)
    cfg, unknown = _load_both(f)
    assert cfg.ingester.n_decoders == 8 and cfg.storage.ttl_hours == 24
    assert cfg.sketch.hll_precision == 12 and cfg.fleet.expiry_s == 5.0
    assert cfg.exporters == ({"kind": "jsonl", "path": "/x"},)
    assert unknown == ["ingester.mystery"]
    assert cfg.receiver.tcp_port == 20033  # untouched modules keep defaults


def test_config_json_file_and_mapping_agree(tmp_path):
    doc = {"receiver": {"tcp_port": 0, "udp_port": 0}, "wire": {"enabled": False},
           "storage": {"writer_flush_s": 0.5, "root": "/data"}, "region_id": 3,
           "exporters": [{"kind": "jsonl", "path": "/x"}], "bogus": {"a": 1}}
    f = tmp_path / "server.json"
    f.write_text(json.dumps(doc))
    from_file, unknown = _load_both(f)
    from_map, _ = _load_both(doc)
    assert from_file == from_map and unknown == ["bogus"]
    assert from_file.storage.writer_flush_s == 0.5 and not from_file.wire.enabled


def test_config_null_keeps_default():
    cfg, _ = _load_both({"receiver": {"tcp_port": None}, "storage": {"root": None}})
    assert cfg.receiver.tcp_port == 20033 and cfg.storage.root == ""


@pytest.mark.parametrize("doc", [
    {"sketch": {"hll_precision": 25}},
    {"ingester": {"n_decoders": 0}},
    {"ingester": {"n_decoders": "four"}},
    {"receiver": "not-a-mapping"},
    {"fleet": {"expiry_s": 0}},
    {"wire": {"queue_maxlen": 0}},
], ids=["hll", "decoders", "decoders-type", "mapping", "fleet-expiry", "wire-maxlen"])
def test_config_validation_errors_equal(doc):
    with pytest.raises(config.ConfigError) as got:
        config.load_config(doc)
    with pytest.raises(ref_config.ConfigError) as want:
        ref_config.load_config(doc)
    assert str(got.value) == str(want.value)


def test_config_top_level_must_be_a_mapping(tmp_path):
    f = tmp_path / "list.yaml"
    f.write_text("- 1\n- 2\n")
    with pytest.raises(config.ConfigError, match="mapping"):
        config.load_config(f)
    with pytest.raises(ref_config.ConfigError, match="mapping"):
        ref_config.load_config(f)


MIGRATOR_CASES = {
    "old-generation": {
        "vtap_id": 7, "tap_interface_regex": "eth.*",
        "l4_log_collect_nps_threshold": 5000, "flow_count_limit": 65536,
        "custom_knob": 3,
    },
    "new-generation": {
        "inputs": {"cbpf": {"af_packet": {"interface_regex": "ens.*"}}},
        "processors": {"flow_log": {"throttles": {"l4_throttle": 900}}},
        "flow_acls": [{"id": 1, "action": "drop"}],
    },
    "canonical-wins-a": {"l4_log_throttle": 700, "l4_log_collect_nps_threshold": 5000},
    "canonical-wins-b": {"l4_log_collect_nps_threshold": 5000, "l4_log_throttle": 700},
    "alias-precedence-a": {
        "flow_count_limit": 1000,
        "processors": {"flow_log": {"tunning": {"concurrent_flow_limit": 2000}}}},
    "alias-precedence-b": {
        "processors": {"flow_log": {"tunning": {"concurrent_flow_limit": 2000}}},
        "flow_count_limit": 1000},
    "servers-alias": {"controller_ips": ["10.0.0.1"],
                      "global": {"communication": {"controller_ip": ["10.0.0.2"]}}},
}

MIGRATOR_EXPECT = {
    "old-generation": {"agent_id": 7, "capture_interface_regex": "eth.*",
                       "l4_log_throttle": 5000, "flow_capacity": 65536, "custom_knob": 3},
    "new-generation": {"capture_interface_regex": "ens.*", "l4_log_throttle": 900,
                       "acls": [{"id": 1, "action": "drop"}]},
    "canonical-wins-a": {"l4_log_throttle": 700},
    "canonical-wins-b": {"l4_log_throttle": 700},
    "alias-precedence-a": {"flow_capacity": 2000},
    "alias-precedence-b": {"flow_capacity": 2000},
    "servers-alias": {"servers": ["10.0.0.2"]},
}


@pytest.mark.parametrize("case", sorted(MIGRATOR_CASES))
def test_agent_config_migrator_equal(case):
    doc = MIGRATOR_CASES[case]
    got, got_notes = agent_config.migrate_agent_config(json.loads(json.dumps(doc)))
    want, want_notes = ref_agent_config.migrate_agent_config(json.loads(json.dumps(doc)))
    assert got == want and got_notes == want_notes
    for k, v in MIGRATOR_EXPECT[case].items():
        assert got[k] == v, k
    if case == "old-generation":
        assert any("upgraded" in n for n in got_notes)
    if case.startswith("canonical-wins"):
        assert any("overrides" in n for n in got_notes)


def test_trisolaris_migrates_group_config_equal():
    out = []
    for db_cls, svc_cls in ((ResourceDB, TrisolarisService), (RefResourceDB, RefTrisolaris)):
        svc = svc_cls(db_cls())
        try:
            svc.set_group_config("default", {"l4_log_collect_nps_threshold": 1234})
            out.append(svc.handle_sync({"agent_id": 1, "config_rev": 0,
                                        "platform_version": 0}))
        finally:
            svc.stop()
    got, want = out
    assert got["config"]["l4_log_throttle"] == 1234
    got.pop("server_time_us"), want.pop("server_time_us")  # wall clock
    assert got == want


_NO_YAML_PROBE = r"""
import json, sys, tempfile
sys.modules["yaml"] = None  # any `import yaml` now raises ImportError
from deepflow_tpu_torch.server.main import Server
from deepflow_tpu_torch.utils.config import load_config
path = tempfile.mktemp(suffix=".json")
open(path, "w").write(json.dumps({"receiver": {"tcp_port": 0, "udp_port": 0},
                                  "wire": {"enabled": False}}))
cfg, unknown = load_config(path)
assert load_config({"receiver": {"tcp_port": 0, "udp_port": 0},
                    "wire": {"enabled": False}})[0] == cfg
srv = Server(cfg, device="cpu").start()
try:
    did = srv.tick(now=1_700_000_000)
    out = {"leader": did["leader"], "port": srv.receiver.tcp_port > 0,
           "device": str(srv.device)}
finally:
    srv.stop()
try:
    import yaml  # noqa: F401
    out["yaml"] = "importable"
except ImportError:
    out["yaml"] = "blocked"
print(json.dumps(out))
"""


def test_server_boots_without_yaml():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _NO_YAML_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"leader": True, "port": True, "device": "cpu", "yaml": "blocked"}
