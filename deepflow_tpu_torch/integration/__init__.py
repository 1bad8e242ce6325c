"""Integration adapters (port of deepflow_tpu/integration/): the packed
dynamic-tag strings (`formats.pack_tags` / `unpack_tags`) and the
self-telemetry loop into `deepflow_system` (`dfstats`)."""
