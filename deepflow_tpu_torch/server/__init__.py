"""The composed server (port of deepflow_tpu/server): the composition
root (`main.Server`), the flow-metrics ingester, table routing and
writer, the downsampler, the event, integration and exporter planes, and
the debug and MCP endpoints."""
