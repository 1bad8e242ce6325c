"""Control plane (port of deepflow_tpu/controller): for now the
analyzer balancer and the shard-group planner (`controller.rebalance`),
which decide the moves that `parallel.rebalance.GroupRebalancer`
executes on the hosts."""
