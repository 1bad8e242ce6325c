from .code import (
    Code,
    CodeId,
    Direction,
    DocumentFlag,
    L7Protocol,
    MeterId,
    SignalSource,
    TapSide,
)
from .schema import (
    APP_METER,
    FLOW_METER,
    USAGE_METER,
    MergeOp,
    MeterSchema,
    TAG_SCHEMA,
    TagSchema,
)
from .batch import FlowBatch, DocBatch

__all__ = [
    "Code",
    "CodeId",
    "Direction",
    "DocumentFlag",
    "L7Protocol",
    "MeterId",
    "SignalSource",
    "TapSide",
    "MergeOp",
    "MeterSchema",
    "TagSchema",
    "FLOW_METER",
    "APP_METER",
    "USAGE_METER",
    "TAG_SCHEMA",
    "FlowBatch",
    "DocBatch",
]
