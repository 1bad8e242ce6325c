"""Host-to-device upload rate of stage() in the window: the bytes
span `stage.upload` carried over its host time (the three pageable
copies of upload_flow_batch), GB/s."""

from benchmark.span_delta import gbps


def read(run):
    return gbps(run.ctx, "stage.upload")
