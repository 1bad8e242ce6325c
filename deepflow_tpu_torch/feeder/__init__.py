"""Feeder runtime — multi-queue fan-in, shape-bucketed coalescing,
deterministic shedding and the frame journal between the overwrite
queues and a port pipeline or sharded window manager (port of
deepflow_tpu/feeder; see runtime.py)."""

from .flowframe import (
    decode_flowframe_body,
    encode_flowbatch_body,
    encode_flowbatch_frames,
    peek_rows,
)
from .journal import FrameJournal, read_journal
from .runtime import (
    FeederConfig,
    FeederRuntime,
    FlowChunk,
    FrameCodecBase,
    PipelineFeedSink,
    ShardedFeedSink,
)

__all__ = [
    "FeederConfig",
    "FeederRuntime",
    "FlowChunk",
    "FrameCodecBase",
    "FrameJournal",
    "PipelineFeedSink",
    "ShardedFeedSink",
    "decode_flowframe_body",
    "encode_flowbatch_body",
    "encode_flowbatch_frames",
    "peek_rows",
    "read_journal",
]
