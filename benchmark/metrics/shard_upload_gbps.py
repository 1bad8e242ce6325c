"""Host-to-device upload rate of the sharded stage() in the window: the
bytes the per-card `shard.upload` spans carried over their host time
(each card's pageable copies of upload_flow_batch), GB/s."""

from benchmark.span_delta import gbps


def read(run):
    return gbps(run.ctx, "shard.upload")
