"""Query plane: DeepFlow-SQL subset engine over the columnar store — the
server/querier seat (engine/clickhouse/clickhouse.go:117); port of
deepflow_tpu/querier — plus the push-mode layers: QueryEventBus
(events.py), query subscriptions (subscribe.py), the alerting rule
engine (alerts.py), and the PromQL subset (promql.py)."""

from .engine import QueryEngine, Result

__all__ = [
    "QueryEngine",
    "Result",
    "QueryEventBus",
    "SubscriptionManager",
    "AlertEngine",
    "AlertRule",
]


def __getattr__(name):  # lazy: keep bare-engine imports light
    if name == "QueryEventBus":
        from .events import QueryEventBus

        return QueryEventBus
    if name == "SubscriptionManager":
        from .subscribe import SubscriptionManager

        return SubscriptionManager
    if name in ("AlertEngine", "AlertRule"):
        from . import alerts

        return getattr(alerts, name)
    raise AttributeError(name)
