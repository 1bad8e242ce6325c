"""Query plane: DeepFlow-SQL subset engine over the columnar store — the
server/querier seat (engine/clickhouse/clickhouse.go:117); port of
deepflow_tpu/querier. The push-mode layers (event bus, subscriptions,
alerts) and PromQL are not ported yet."""

from .engine import QueryEngine, Result

__all__ = ["QueryEngine", "Result"]
