"""Control plane (port of deepflow_tpu/controller): resource registry
(MySQL seat), tagrecorder (SmartEncoding dictionary materialization),
trisolaris-style agent and ingester sync, leader election, cloud and
genesis discovery, the REST surface, and the analyzer balancer with the
shard-group planner (`controller.rebalance`), which decides the moves
that `parallel.rebalance.GroupRebalancer` executes on the hosts."""
