"""Flow-log plane: L4 flow logs (minute-merged TaggedFlows) and L7
request logs, with throttled sampling — the port of
deepflow_tpu/flowlog/, with the minute merge on an explicit device.
"""
