"""The server's flow-metrics path: ingester, table routing and writer,
downsampler (port of deepflow_tpu/server, the parts that path runs)."""
