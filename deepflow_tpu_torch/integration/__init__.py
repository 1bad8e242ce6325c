"""Third-party telemetry integration (port of deepflow_tpu/integration/):
agent-side HTTP intake (`collector`, the integration_collector.rs seat),
the wire decoders shared with the server-side ingesters (`formats`,
`trace_imports`: ext_metrics / prometheus / profile / OTel / SkyWalking /
Datadog), and the self-telemetry loop into `deepflow_system` (`dfstats`)."""
