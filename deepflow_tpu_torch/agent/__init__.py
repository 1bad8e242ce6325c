"""Agent data plane: vectorized packet parsing (dispatcher seat) and the
device-resident FlowMap (flow_generator seat) — the port of
deepflow_tpu/agent/, with the FlowMap's state on an explicit device.
"""
