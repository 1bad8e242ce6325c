"""Query executor — the CHEngine seat (clickhouse.go:117 ExecuteQuery);
port of deepflow_tpu/querier/engine.py.

The reference translates DeepFlow-SQL to ClickHouse SQL and lets CK
execute; here the engine *is* the executor, running directly over the
columnar store: partition-pruned scans (time-range conjuncts hoisted
from WHERE), vectorized row filters, group-by via factorized keys +
segmented SUM/MAX/MIN reductions on the engine's device
(`_segment_reduce`), derived-metric expansion (metrics.py), and
query-time tag translation (translation.py — the dictGet seat).

The reference reduces with `jax.ops.segment_*` while JAX runs with
64-bit types off, so its aggregates are float32 even though it hands
them float64 values: inputs round to float32, sums, means, minima and
maxima are float32, and `Any()`'s row index loses precision past 2^24
rows. The port reduces in float32 the same way, so both engines give
the same answers.

Aggregate functions: Sum Max Min Avg Count Uniq. Scalar helpers:
interval(time, N) → N-second bucket (toStartOfInterval analog),
name(col) → dictionary translation of a tag id column.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device

from .metrics import (
    datasource_interval,
    expand,
    expand_row,
    is_delay,
    list_metrics,
    metric_type,
)
from .sqlparse import (
    BinOp,
    Func,
    Ident,
    InList,
    Literal,
    Query,
    Show,
    SQLError,
    UnaryOp,
    parse,
)
from .translation import Translator

# row→group reducers (view/function.go FUNCTION_*)
_AGG_FUNCS = {
    "sum", "max", "min", "avg", "aavg", "count", "uniq", "uniqexact",
    "countdistinct", "percentile", "percentileexact", "stddev", "spread",
    "rspread", "apdex", "last", "any", "topk", "histogram",
}
# group-level math wrappers that force aggregation even over bare columns
_AGG_WRAPPERS = {"persecond", "percentage", "derivative", "nonnegativederivative"}


@dataclasses.dataclass
class Result:
    columns: list[str]
    values: dict[str, np.ndarray]
    # live read plane: True when open-window partial rows
    # from a registered live source contributed to this result — the
    # values for the open span may still grow until the window closes
    # and its flushed rows supersede the partials (stale=false,
    # partial=true in the reference's result-marker terms)
    partial: bool = False

    @property
    def rows(self) -> int:
        return len(next(iter(self.values.values()))) if self.values else 0

    def to_dicts(self) -> list[dict]:
        return [
            {c: self.values[c][i].item() if hasattr(self.values[c][i], "item") else self.values[c][i] for c in self.columns}
            for i in range(self.rows)
        ]


class QueryEngine:
    def __init__(self, store, translator: Translator | None = None,
                 *, live=None, cache=None, device=None):
        from .live import default_live_registry, default_query_cache

        self.store = store
        # aggregates reduce here (default CUDA; raises without it)
        self.device = resolve_device(device)
        self.translator = translator or Translator(store)
        # live read plane: open-window overlay providers and
        # the repeated-dashboard result cache (None = process defaults;
        # cache=False disables caching for this engine)
        self.live = default_live_registry if live is None else live
        if cache is None or cache is True:
            self.cache = default_query_cache
        elif cache is False:
            self.cache = None
        else:
            self.cache = cache

    # -- public ---------------------------------------------------------
    def resolve_query_table(self, sql: str) -> tuple[str, str]:
        """The (db, table) a statement will read, without executing it —
        the push plane's event-routing key: a SQL subscription resolves
        once here and then re-evaluates only when events name its
        table (querier/subscribe.py)."""
        q = parse(sql)
        if isinstance(q, Show):
            raise SQLError("SHOW statements have no subscribable table")
        trange = _time_range(q.where) if q.where is not None else None
        return self._resolve_table(q.table, step=_requested_step(q), trange=trange)

    def execute(self, sql: str) -> Result:
        q = parse(sql)
        if isinstance(q, Show):
            return self._run_show(q)
        # the hoisted time range drives partition pruning, the live
        # overlay AND live-aware tier selection — computed before
        # resolution (it reads only the raw WHERE AST)
        trange = _time_range(q.where) if q.where is not None else None
        db, table = self._resolve_table(
            q.table, step=_requested_step(q), trange=trange
        )
        key = token = None
        if self.cache is not None:
            from .live import cache_token

            key = ("sql", sql, db, table, getattr(self.store, "uid", id(self.store)))
            # token BEFORE evaluation: a pipeline provider's epoch() may
            # take the rate-limited snapshot the evaluation then reads
            token = cache_token(self.store, db, table, self.live)
            hit = self.cache.lookup(key, token)
            if hit is not None:
                return hit
        res = self._execute_resolved(q, db, table, trange)
        if self.cache is not None:
            self.cache.store(key, token, res)
        return res

    def _execute_resolved(self, q: Query, db: str, table: str, trange) -> Result:
        schema = self.store.schema(db, table)
        colnames = set(schema.column_names())

        # expand derived metrics in select/order (WHERE stays raw columns)
        # output names come from the pre-expansion AST (rrt_avg stays
        # "rrt_avg", not its Sum()/Sum() expansion)
        q = dataclasses.replace(
            q,
            select=tuple(
                dataclasses.replace(
                    it,
                    expr=self._expand(table, it.expr),
                    alias=it.alias or _expr_name(it.expr),
                )
                for it in q.select
            ),
            # ORDER BY keeps the pre-expansion expr: resolution first
            # matches select-output names, then expands for evaluation
            order_by=tuple(q.order_by),
            having=self._expand(table, q.having) if q.having is not None else None,
        )

        # GROUP BY / HAVING may name a select alias ("group by time_120",
        # "having cnt > 5", clickhouse_test.go:60) — substitute the
        # aliased expression
        alias_map = {it.alias: it.expr for it in q.select
                     if it.alias and it.alias not in colnames}
        q = dataclasses.replace(
            q,
            group_by=tuple(
                alias_map[e.name]
                if isinstance(e, Ident) and e.name in alias_map
                else self._expand(table, e)
                for e in q.group_by
            ),
            having=(_subst_aliases(q.having, alias_map)
                    if q.having is not None else None),
        )

        has_agg = bool(q.group_by) or q.having is not None or any(
            _has_aggregate(it.expr) for it in q.select
        )

        aliases = {it.alias for it in q.select if it.alias}
        needed = set()
        for it in q.select:
            _collect_idents(it.expr, needed)
        for e in q.group_by:
            _collect_idents(e, needed)
        for e, _ in q.order_by:
            _collect_idents(self._expand(table, e), needed)
        if q.where is not None:
            _collect_idents(q.where, needed)
        if q.having is not None:
            _collect_idents(q.having, needed)
        if has_agg:
            # Last/Derivative/Counter_Avg need the time axis
            needed.add(schema.time_column)
        star = "*" in needed
        needed.discard("*")
        # ORDER BY may reference select output names; real columns stay
        needed -= aliases - colnames
        unknown = needed - colnames
        if unknown:
            raise SQLError(f"unknown columns for {table}: {sorted(unknown)}")

        if star:
            scan_cols = None  # SELECT * reads everything
        elif needed:
            scan_cols = sorted(needed)
        else:
            scan_cols = [schema.time_column]  # SELECT Count(): cheapest column
        cols = self.store.scan(db, table, time_range=trange, columns=scan_cols)
        n = len(next(iter(cols.values()))) if cols else 0

        # open-window overlay: append live partial rows when
        # a provider is registered and serves every scanned column. The
        # WHERE mask applies to them identically; the result is marked
        # partial iff any live row survived it.
        n_store = n
        if self.live.has(db, table) and cols:
            lo, hi = trange if trange is not None else (0, 1 << 62)
            lv = self.live.columns(db, table, lo, hi)
            if lv is not None and all(k in lv for k in cols):
                lt = np.asarray(lv[schema.time_column], np.int64)
                sel = (lt >= lo) & (lt < hi)
                if sel.any():
                    cols = {
                        k: np.concatenate(
                            [np.asarray(cols[k]), np.asarray(lv[k])[sel]]
                        )
                        for k in cols
                    }
                    n = n_store + int(sel.sum())

        ctx = _EvalCtx(cols, n, table, self.translator)
        mask = None
        if q.where is not None:
            mask = np.asarray(ctx.eval(q.where), bool)
            ctx = ctx.masked(mask)
        partial = bool(
            mask[n_store:].any() if mask is not None else n > n_store
        )

        if has_agg:
            res = self._run_aggregate(q, ctx, table, schema, trange)
        else:
            res = self._run_plain(q, ctx, schema)
        res.partial = partial
        return res

    # -- helpers --------------------------------------------------------
    def _touches_open(self, db: str, table: str, trange) -> bool:
        """Does a query over `trange` reach into the open span a live
        provider serves? Unbounded upper ranges always do; bounded ones
        only when they extend past the provider's first open second."""
        if not self.live.has(db, table):
            return False
        if trange is None or trange[1] >= (1 << 61):
            return True
        of = self.live.open_from(db, table)
        return of is not None and trange[1] > of

    def _resolve_table(
        self, name: str, step: int | None = None, trange=None
    ) -> tuple[str, str]:
        # accept db.table / table.granularity / bare table
        cand = name.replace(".", "_")
        parts = name.split(".", 1)
        for db in self.store.databases():
            if parts[0] == db and len(parts) == 2:
                t = parts[1].replace(".", "_")
                if t in self.store.tables(db):
                    return db, t
            if cand in self.store.tables(db):
                return db, cand
        # tier selection: a BARE family name ("network")
        # resolves to the coarsest granularity table that satisfies the
        # query's interval step, so month-scale range queries read the
        # cascade's bounded 1m/1h tiers instead of replaying 1s rows.
        # Explicit granularities ("network.1s") never reroute — they
        # resolved above. When the range touches the open
        # span, a LIVE-covered tier beats a coarser one without
        # coverage (the coarser rows would miss the freshest seconds
        # the overlay exists to serve).
        from .translation import TIER_SUFFIX_S, select_datasource_tier

        for db in self.store.databases():
            avail = {}
            for suffix, s in TIER_SUFFIX_S.items():
                t = f"{cand}_{suffix}"
                if t in self.store.tables(db):
                    avail[t] = s
            live_set = {
                t for t in avail if self._touches_open(db, t, trange)
            }
            pick = select_datasource_tier(avail, step, live_tables=live_set)
            if pick is not None:
                return db, pick
        raise SQLError(f"no such table {name!r}")

    def _expand(self, table: str, expr, in_agg: bool = False):
        if isinstance(expr, Ident):
            if not in_agg:
                sub = expand(table, expr.name)
                if sub is not None:
                    return sub
            # row-level derived (Sum(byte) → SUM(byte_tx + byte_rx), and
            # bare `byte` on log tables)
            sub = expand_row(table, expr.name)
            if sub is not None:
                return sub
        elif isinstance(expr, BinOp):
            return BinOp(expr.op, self._expand(table, expr.left, in_agg),
                         self._expand(table, expr.right, in_agg))
        elif isinstance(expr, UnaryOp):
            return UnaryOp(expr.op, self._expand(table, expr.operand, in_agg))
        elif isinstance(expr, Func) and expr.name in _AGG_FUNCS:
            return Func(expr.name, tuple(self._expand(table, a, True) for a in expr.args))
        elif isinstance(expr, Func):
            return Func(expr.name, tuple(self._expand(table, a, in_agg) for a in expr.args))
        return expr

    def _run_plain(self, q: Query, ctx: "_EvalCtx", schema) -> Result:
        items = []
        for it in q.select:
            if isinstance(it.expr, Ident) and it.expr.name == "*":
                items += [(c, Ident(c)) for c in schema.column_names() if c in ctx.cols]
            else:
                items.append((it.alias or _expr_name(it.expr), it.expr))
        values = {name: np.asarray(ctx.eval(e)) for name, e in items}
        values = {k: (np.broadcast_to(v, (ctx.n,)) if v.ndim == 0 else v) for k, v in values.items()}
        # ORDER BY resolves select output names first, then raw columns
        order = [
            (values[_expr_name(e)] if _expr_name(e) in values else np.asarray(ctx.eval(e)), d)
            for e, d in q.order_by
        ]
        idx = _order_index(order, ctx.n)
        idx = idx[q.offset : None if q.limit is None else q.offset + q.limit]
        return Result([n for n, _ in items], {k: v[idx] for k, v in values.items()})

    def _run_aggregate(self, q: Query, ctx: "_EvalCtx", table: str,
                       schema=None, trange=None) -> Result:
        # group keys → factorized codes
        key_names = [_expr_name(e) for e in q.group_by]
        key_arrays = [np.asarray(ctx.eval(e)) for e in q.group_by]
        if key_arrays:
            codes = [np.unique(a, return_inverse=True) for a in key_arrays]
            stacked = np.stack([c[1] for c in codes], axis=1)
            uniq_rows, gid = np.unique(stacked, axis=0, return_inverse=True)
            ngroups = uniq_rows.shape[0]
            key_values = {
                name: codes[j][0][uniq_rows[:, j]] for j, name in enumerate(key_names)
            }
        else:
            gid = np.zeros(ctx.n, np.int64)
            ngroups = 1
            key_values = {}

        # time axis for Derivative/PerSecond/Counter_Avg: the group key
        # built from interval(time, N) (or bare time), plus the partition
        # id formed by every OTHER group key
        group_interval = None
        time_key = None
        for e in q.group_by:
            nm = _expr_name(e)
            if isinstance(e, Func) and e.name == "interval" and len(e.args) == 2:
                group_interval = int(e.args[1].value)
                time_key = nm
            elif isinstance(e, Ident) and e.name == (schema.time_column if schema else "time"):
                time_key = nm
        if time_key is not None and len(key_names) > 1:
            others = [j for j, nm in enumerate(key_names) if nm != time_key]
            partition = np.unique(uniq_rows[:, others], axis=0, return_inverse=True)[1]
        else:
            partition = np.zeros(ngroups, np.int64)
        env = _AggEnv(
            table=table,
            ds_interval=datasource_interval(table),
            trange=trange,
            group_interval=group_interval,
            time_column=schema.time_column if schema else "time",
            group_times=(None if time_key is None
                         else np.asarray(key_values[time_key], np.int64)),
            partition=partition,
        )
        agg_ctx = _AggCtx(ctx, gid, ngroups, env, self.device)

        items = [(it.alias or _expr_name(it.expr), it.expr) for it in q.select]
        values: dict[str, np.ndarray] = {}
        for name, e in items:
            if name in key_values:
                values[name] = key_values[name]
            elif _expr_name(e) in key_values:  # aliased group expr
                values[name] = key_values[_expr_name(e)]
            else:
                v = np.asarray(agg_ctx.eval(e))
                values[name] = np.broadcast_to(v, (ngroups,)) if v.ndim == 0 else v

        keep = np.ones(ngroups, bool)
        if q.having is not None:
            keep = np.broadcast_to(
                np.asarray(agg_ctx.eval(q.having), bool), (ngroups,)
            )
        order = []
        for e, d in q.order_by:
            nm = _expr_name(e)
            if nm in values:
                order.append((values[nm], d))
            elif nm in key_values:
                order.append((key_values[nm], d))
            else:
                order.append((np.asarray(agg_ctx.eval(self._expand(table, e))), d))
        idx = _order_index(order, ngroups)
        idx = idx[keep[idx]]
        idx = idx[q.offset : None if q.limit is None else q.offset + q.limit]
        return Result([n for n, _ in items], {k: np.asarray(v)[idx] for k, v in values.items()})

    def _run_show(self, q: Show) -> Result:
        """SHOW tables / metrics / tags — catalog rows as a result set."""
        if q.what == "tables":
            rows = [
                {"db": db, "table": t}
                for db in sorted(self.store.databases())
                for t in sorted(self.store.tables(db))
            ]
            cols = ["db", "table"]
        else:
            # resolve db-qualified names the way SELECT does, and make
            # unknown tables error instead of returning an empty catalog
            _, bare = self._resolve_table(q.table)
            cat = self.catalogs(bare)
            rows = cat["metrics"] if q.what == "metrics" else cat["tags"]
            rows = [
                {k: (", ".join(v) if isinstance(v, list) else v)
                 for k, v in r.items()}
                for r in rows
            ]
            cols = list(rows[0].keys()) if rows else ["name"]
        values = {
            c: np.asarray([r.get(c, "") for r in rows]) for c in cols
        }
        return Result(cols, values)

    def catalogs(self, table: str) -> dict:
        """db_descriptions seat: tag + metric catalogs for one table."""
        from .metrics import metric_catalog, tag_catalog

        schema = None
        try:
            db, t = self._resolve_table(table)
            schema = self.store.schema(db, t)
        except (SQLError, KeyError):
            pass
        return {
            "table": table,
            "metrics": metric_catalog(table, schema),
            "tags": tag_catalog(table, schema),
        }

    def metrics(self, table: str) -> dict[str, str]:
        return list_metrics(table)


# -- evaluation contexts ----------------------------------------------------


class _EvalCtx:
    """Row-level vectorized evaluation over scanned columns."""

    def __init__(self, cols: dict[str, np.ndarray], n: int, table: str, translator):
        self.cols = cols
        self.n = n
        self.table = table
        self.translator = translator

    def masked(self, mask: np.ndarray) -> "_EvalCtx":
        return _EvalCtx(
            {k: v[mask] for k, v in self.cols.items()},
            int(mask.sum()),
            self.table,
            self.translator,
        )

    def eval(self, e):
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Ident):
            if e.name not in self.cols:
                raise SQLError(f"unknown column {e.name!r}")
            return self.cols[e.name]
        if isinstance(e, UnaryOp):
            v = self.eval(e.operand)
            return ~np.asarray(v, bool) if e.op == "not" else -np.asarray(v)
        if isinstance(e, InList):
            v = np.asarray(self.eval(e.expr))
            vals = [x.value for x in e.values]
            if v.dtype.kind in "US":
                m = np.isin(v, np.asarray(vals, dtype=v.dtype))
            else:
                m = np.isin(v, np.asarray(vals))
            return ~m if e.negated else m
        if isinstance(e, BinOp):
            l, r = self.eval(e.left), self.eval(e.right)
            return _binop(e.op, l, r)
        if isinstance(e, Func):
            return self._func(e)
        raise SQLError(f"cannot evaluate {e!r}")

    def _func(self, e: Func):
        if e.name == "interval":
            if len(e.args) != 2 or not isinstance(e.args[1], Literal):
                raise SQLError("interval(col, seconds)")
            v = np.asarray(self.eval(e.args[0]), np.int64)
            step = int(e.args[1].value)
            return (v // step * step).astype(np.uint32)
        if e.name == "name":
            if len(e.args) != 1 or not isinstance(e.args[0], Ident):
                raise SQLError("name(tag_column)")
            col = e.args[0].name
            return self.translator.translate(self.table, col, np.asarray(self.eval(e.args[0])))
        if e.name in ("k8s_label", "k8s_annotation", "k8s_env"):
            # k8s_label(pod_id_col, 'key') → per-row label value (the
            # reference's `k8s.label.<key>` custom tag)
            if len(e.args) != 2 or not isinstance(e.args[1], Literal):
                raise SQLError(f"{e.name}(pod_id_column, 'key')")
            ids = np.asarray(self.eval(e.args[0]))
            return self.translator.k8s_meta(
                e.name.removeprefix("k8s_"), str(e.args[1].value), ids
            )
        if e.name in _AGG_FUNCS or e.name in _AGG_WRAPPERS:
            raise SQLError(f"aggregate {e.name}() outside aggregation context")
        raise SQLError(f"unknown function {e.name!r}")


@dataclasses.dataclass
class _AggEnv:
    """Time/typing context the group-level functions need (the view
    layer's Time struct, function.go GetInterval)."""

    table: str
    ds_interval: int
    trange: tuple[int, int] | None  # [lo, hi) from WHERE
    group_interval: int | None  # interval(time, N) step in GROUP BY
    time_column: str
    group_times: np.ndarray | None  # [ngroups] time bucket per group
    partition: np.ndarray  # [ngroups] series id from non-time group keys


class _AggCtx:
    """Aggregate evaluation: aggregates reduce rows → groups, everything
    above them is per-group arithmetic. Delay-type metrics get the
    reference's ignore-zero treatment (AVGIf/MAXIf(x > 0)); Avg on a
    counter divides the range sum by range/ds-interval (Counter_Avg)."""

    def __init__(self, row_ctx: _EvalCtx, gid: np.ndarray, ngroups: int,
                 env: _AggEnv | None, device: torch.device):
        self.row = row_ctx
        self.device = device
        self.gid = gid
        self.ngroups = ngroups
        self.env = env or _AggEnv("", 1, None, None, "time", None,
                                  np.zeros(ngroups, np.int64))

    def eval(self, e):
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Func) and e.name in _AGG_FUNCS:
            return self._agg(e)
        if isinstance(e, Func) and e.name in _AGG_WRAPPERS:
            return self._wrapper(e)
        if isinstance(e, BinOp):
            return _binop(e.op, self.eval(e.left), self.eval(e.right))
        if isinstance(e, UnaryOp):
            v = self.eval(e.operand)
            return ~np.asarray(v, bool) if e.op == "not" else -np.asarray(v)
        if isinstance(e, Func):
            raise SQLError(f"scalar function {e.name}() above aggregates is unsupported")
        if isinstance(e, Ident):
            raise SQLError(
                f"column {e.name!r} must appear in GROUP BY or inside an aggregate"
            )
        raise SQLError(f"cannot evaluate {e!r}")

    # -- helpers ---------------------------------------------------------
    def _masked_gid(self, v: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Rows failing `mask` get an out-of-range gid → dropped."""
        return np.where(mask, self.gid, self.ngroups)

    def _delay_arg(self, a) -> bool:
        return isinstance(a, Ident) and is_delay(self.env.table, a.name)

    def _sum(self, v, gid=None):
        return _segment_reduce(v, self.gid if gid is None else gid, self.ngroups + 1,
                               "sum", self.device)[: self.ngroups]

    def _mean(self, v, gid):
        s = self._sum(v, gid)
        c = self._sum(np.ones_like(v, np.float64), gid)
        return s / np.maximum(c, 1)

    def _minmax(self, v, gid, op):
        r = _segment_reduce(v, gid, self.ngroups + 1, op, self.device)[: self.ngroups]
        return np.where(np.isfinite(r), r, 0.0)

    def _n_intervals(self) -> float:
        """Counter_Avg divisor: how many datasource rows one output
        bucket spans (GetInterval, view/function.go:866-885)."""
        env = self.env
        ds = max(1, env.ds_interval)
        if env.group_interval:
            return max(1.0, env.group_interval / ds)
        if env.trange is not None and env.trange[1] < (1 << 61):
            lo, hi = env.trange
            return max(1.0, (hi - lo) / ds)
        t = self.row.cols.get(env.time_column)
        if t is not None and len(t):
            return max(1.0, (float(np.max(t)) - float(np.min(t))) / ds + 1)
        return 1.0

    def _series_seconds(self) -> float:
        env = self.env
        if env.group_interval:
            return float(env.group_interval)
        if env.trange is not None and env.trange[1] < (1 << 61):
            return float(max(1, env.trange[1] - env.trange[0]))
        return float(max(1, env.ds_interval))

    # -- group-level math wrappers --------------------------------------
    def _wrapper(self, e: Func):
        if e.name == "persecond":
            if len(e.args) != 1:
                raise SQLError("PerSecond() takes one argument")
            inner = self._auto_agg(e.args[0])
            return np.asarray(self.eval(inner)) / self._series_seconds()
        if e.name == "percentage":
            if not 1 <= len(e.args) <= 2:
                raise SQLError("Percentage() takes one or two arguments")
            a = np.asarray(self.eval(self._auto_agg(e.args[0])), np.float64)
            b = (np.asarray(self.eval(self._auto_agg(e.args[1])), np.float64)
                 if len(e.args) == 2 else np.float64(1.0))
            return np.divide(a, b, out=np.zeros(np.broadcast(a, b).shape),
                             where=np.asarray(b) != 0) * 100.0
        # nonNegativeDerivative over the time axis, partitioned by the
        # other group keys (view/function.go NonNegativeDerivativeFunction)
        if len(e.args) != 1:
            raise SQLError("Derivative() takes one argument")
        env = self.env
        if env.group_times is None:
            raise SQLError("Derivative() needs interval(time, N) or time in GROUP BY")
        v = np.asarray(self.eval(self._auto_agg(e.args[0])), np.float64)
        v = np.broadcast_to(v, (self.ngroups,))
        t = env.group_times
        out = np.zeros(self.ngroups, np.float64)
        order = np.lexsort((t, env.partition))
        sp, st, sv = env.partition[order], t[order], v[order]
        same = np.concatenate([[False], sp[1:] == sp[:-1]])
        dt = np.maximum(np.concatenate([[1], st[1:] - st[:-1]]), 1)
        d = np.concatenate([[0.0], sv[1:] - sv[:-1]]) / dt
        out[order] = np.where(same, np.maximum(d, 0.0), 0.0)
        return out

    def _auto_agg(self, a):
        """Bare column/row expr inside a wrapper defaults to Sum —
        PerSecond(byte) ≡ PerSecond(Sum(byte))."""
        return a if _has_aggregate(a) else Func("sum", (a,))

    # -- aggregates ------------------------------------------------------
    def _agg(self, e: Func):
        if e.name == "count":
            return self._sum(np.ones(len(self.gid), np.float64))
        if e.name in ("percentile", "percentileexact"):
            # Percentile(col, p) — CK quantile analog, per group
            if len(e.args) != 2:
                raise SQLError("percentile() takes (column, p)")
            v = np.asarray(self.row.eval(e.args[0])).astype(np.float64)
            p = float(np.asarray(self.row.eval(e.args[1])).reshape(-1)[0])
            if not 0 <= p <= 100:
                raise SQLError(f"percentile p out of range: {p}")
            gid = (self._masked_gid(v, v > 0)
                   if self._delay_arg(e.args[0]) else self.gid)
            out = np.zeros(self.ngroups, np.float64)
            order = np.argsort(gid, kind="stable")
            sg = gid[order]
            sv = v[order]
            starts = np.searchsorted(sg, np.arange(self.ngroups))
            ends = np.searchsorted(sg, np.arange(self.ngroups) + 1)
            for g in range(self.ngroups):
                if ends[g] > starts[g]:
                    out[g] = np.percentile(sv[starts[g]:ends[g]], p)
            return out
        if e.name == "apdex":
            # Apdex(delay, T): (satisfied + tolerating/2) / total over
            # x > 0, in [0, 1] (view/function.go ApdexFunction)
            if len(e.args) != 2:
                raise SQLError("Apdex() takes (column, threshold)")
            v = np.asarray(self.row.eval(e.args[0])).astype(np.float64)
            thr = float(np.asarray(self.row.eval(e.args[1])).reshape(-1)[0])
            pos = v > 0
            gid = self._masked_gid(v, pos)
            sat = self._sum((pos & (v <= thr)).astype(np.float64))
            tol = self._sum((pos & (v > thr) & (v <= 4 * thr)).astype(np.float64))
            tot = self._sum(pos.astype(np.float64))
            return np.divide(sat + tol / 2, tot, out=np.zeros_like(tot), where=tot > 0)
        if e.name == "topk":
            if len(e.args) != 2:
                raise SQLError("TopK() takes (column, k)")
            v = np.asarray(self.row.eval(e.args[0]))
            k = int(np.asarray(self.row.eval(e.args[1])).reshape(-1)[0])
            return self._per_group_json(
                v, lambda vals: [x.item() if hasattr(x, "item") else x
                                 for x, _ in _top_frequent(vals, k)])
        if e.name == "histogram":
            if len(e.args) != 2:
                raise SQLError("Histogram() takes (column, bins)")
            v = np.asarray(self.row.eval(e.args[0])).astype(np.float64)
            bins = int(np.asarray(self.row.eval(e.args[1])).reshape(-1)[0])

            def hist(vals):
                vals = vals[vals > 0]
                if not len(vals):
                    return []
                cnt, edges = np.histogram(vals, bins=max(1, bins))
                return [[float(edges[i]), float(edges[i + 1]), int(cnt[i])]
                        for i in range(len(cnt))]

            return self._per_group_json(v, hist)
        if len(e.args) != 1:
            raise SQLError(f"{e.name}() takes one argument")
        v = np.asarray(self.row.eval(e.args[0]))
        if e.name in ("uniq", "uniqexact", "countdistinct"):
            pairs = np.stack([self.gid, np.unique(v, return_inverse=True)[1]], axis=1)
            uniq = np.unique(pairs, axis=0)
            return np.bincount(uniq[:, 0], minlength=self.ngroups).astype(np.float64)
        if e.name == "any":
            first = self._minmax(np.arange(len(v), dtype=np.float64), self.gid,
                                 "amin").astype(np.int64)
            return v[np.clip(first, 0, max(0, len(v) - 1))] if len(v) else v
        if e.name == "last":
            # argMax(x, time) (FUNCTION_LAST)
            t = self.row.cols.get(self.env.time_column)
            key = (np.asarray(t, np.float64) if t is not None
                   else np.arange(len(v), dtype=np.float64))
            order = np.lexsort((key, self.gid))
            sg = self.gid[order]
            starts = np.searchsorted(sg, np.arange(self.ngroups))
            ends = np.searchsorted(sg, np.arange(self.ngroups) + 1)
            res = np.zeros(self.ngroups, v.dtype if v.dtype.kind != "U" else object)
            for g in range(self.ngroups):
                if ends[g] > starts[g]:
                    res[g] = v[order[ends[g] - 1]]
            return res
        v = v.astype(np.float64)
        delay = self._delay_arg(e.args[0])
        gid = self._masked_gid(v, v > 0) if delay else self.gid
        if e.name == "sum":
            return self._sum(v)
        if e.name == "aavg":
            return self._mean(v, gid)
        if e.name == "avg":
            # Counter_Avg only for counter metrics (incl. expressions
            # whose every leaf column is a counter, e.g. the expanded
            # byte_tx + byte_rx); anything untyped averages arithmetically
            leaves: set = set()
            _collect_idents(e.args[0], leaves)
            types = {metric_type(self.env.table, n) for n in leaves}
            if leaves and types == {"counter"}:
                # Counter_Avg: sum over the range / expected row count
                return self._sum(v) / self._n_intervals()
            return self._mean(v, gid)  # Delay_Avg seat: AVGIf(x, x>0)
        if e.name == "max":
            return self._minmax(v, gid, "amax")
        if e.name == "min":
            return self._minmax(v, gid, "amin")
        if e.name == "spread":
            return (self._minmax(v, gid, "amax")
                    - self._minmax(v, gid, "amin"))
        if e.name == "rspread":
            mx = self._minmax(v, gid, "amax") + 1e-15
            mn = self._minmax(v, gid, "amin") + 1e-15
            return mx / mn
        if e.name == "stddev":
            m = self._mean(v, gid)
            m2 = self._mean(v * v, gid)
            return np.sqrt(np.maximum(m2 - m * m, 0.0))
        raise SQLError(f"unknown aggregate {e.name!r}")

    def _per_group_json(self, v: np.ndarray, fn) -> np.ndarray:
        import json as _json

        order = np.argsort(self.gid, kind="stable")
        sg = self.gid[order]
        starts = np.searchsorted(sg, np.arange(self.ngroups))
        ends = np.searchsorted(sg, np.arange(self.ngroups) + 1)
        out = np.empty(self.ngroups, object)
        for g in range(self.ngroups):
            out[g] = _json.dumps(fn(v[order[starts[g]:ends[g]]]))
        return out


def _segment_reduce(v: np.ndarray, gid: np.ndarray, num_segments: int, op: str,
                    device: torch.device) -> np.ndarray:
    """The reference's `jax.ops.segment_{sum,max,min}` under 32-bit JAX:
    `v` rounds to float32 and reduces in float32 on `device` ("sum",
    "amax" or "amin"); an empty segment holds 0, -inf or +inf. Returns
    the [num_segments] float32 result on the host."""
    x = torch.from_numpy(np.asarray(v, np.float64).astype(np.float32)).to(device)
    ids = torch.from_numpy(np.asarray(gid, np.int64)).to(device)
    if op == "sum" and x.is_cuda:
        # float32 sums depend on their order. On the card, index_add_'s
        # atomics and a 1-wide index_put_ (a warp-parallel kernel) reorder
        # a segment's rows; a 2-wide index_put_ with accumulate takes the
        # sort-based kernel that adds them one by one in row order — the
        # CPU's and the reference's order, bit for bit
        # (tests/test_torch_cuda.py pins it)
        out = torch.zeros((num_segments, 2), dtype=torch.float32, device=device)
        out.index_put_((ids,), torch.stack([x, torch.zeros_like(x)], dim=1), accumulate=True)
        out = out[:, 0]
    elif op == "sum":
        out = torch.zeros(num_segments, dtype=torch.float32, device=device)
        out.index_add_(0, ids, x)
    else:
        fill = float("-inf") if op == "amax" else float("inf")
        out = torch.full((num_segments,), fill, dtype=torch.float32, device=device)
        out.scatter_reduce_(0, ids, x, op, include_self=False)
    return out.cpu().numpy()


def _subst_aliases(e, alias_map: dict):
    if isinstance(e, Ident) and e.name in alias_map:
        return alias_map[e.name]
    if isinstance(e, BinOp):
        return BinOp(e.op, _subst_aliases(e.left, alias_map),
                     _subst_aliases(e.right, alias_map))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, _subst_aliases(e.operand, alias_map))
    if isinstance(e, Func):
        return Func(e.name, tuple(_subst_aliases(a, alias_map) for a in e.args))
    if isinstance(e, InList):
        return InList(_subst_aliases(e.expr, alias_map), e.values, e.negated)
    return e


def _top_frequent(vals: np.ndarray, k: int):
    uniq, counts = np.unique(vals, return_counts=True)
    order = np.argsort(-counts, kind="stable")[: max(0, k)]
    return [(uniq[i], int(counts[i])) for i in order]


# -- small shared helpers ---------------------------------------------------


def _order_index(order: list[tuple[np.ndarray, str]], n: int) -> np.ndarray:
    """Stable multi-key sort index; strings factorize to codes so DESC
    is a plain negation for every key type."""
    idx = np.arange(n)
    for arr, direction in reversed(order):
        arr = np.asarray(arr)
        if arr.dtype.kind in "US":
            arr = np.unique(arr, return_inverse=True)[1]
        key = -arr.astype(np.float64) if direction == "desc" else arr
        idx = idx[np.argsort(key[idx], kind="stable")]
    return idx


def _binop(op: str, l, r):
    if op == "and":
        return np.asarray(l, bool) & np.asarray(r, bool)
    if op == "or":
        return np.asarray(l, bool) | np.asarray(r, bool)
    if op in ("+", "-", "*", "/", "%"):
        l = np.asarray(l, np.float64) if not np.isscalar(l) else l
        r = np.asarray(r, np.float64) if not np.isscalar(r) else r
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return np.divide(l, r, out=np.zeros(np.broadcast(l, r).shape), where=np.asarray(r) != 0)
        return np.mod(l, r)
    # comparisons — strings compare as strings
    larr, rarr = np.asarray(l), np.asarray(r)
    if larr.dtype.kind in "US" or rarr.dtype.kind in "US":
        larr, rarr = larr.astype(str), rarr.astype(str)
    else:
        larr, rarr = larr.astype(np.float64), rarr.astype(np.float64)
    return {
        "=": larr == rarr,
        "!=": larr != rarr,
        "<": larr < rarr,
        ">": larr > rarr,
        "<=": larr <= rarr,
        ">=": larr >= rarr,
    }[op]


def _collect_idents(e, out: set):
    if isinstance(e, Ident):
        out.add(e.name)
    elif isinstance(e, BinOp):
        _collect_idents(e.left, out)
        _collect_idents(e.right, out)
    elif isinstance(e, UnaryOp):
        _collect_idents(e.operand, out)
    elif isinstance(e, InList):
        _collect_idents(e.expr, out)
    elif isinstance(e, Func):
        for a in e.args:
            _collect_idents(a, out)


def _has_aggregate(e) -> bool:
    if isinstance(e, Func):
        return (e.name in _AGG_FUNCS or e.name in _AGG_WRAPPERS
                or any(_has_aggregate(a) for a in e.args))
    if isinstance(e, BinOp):
        return _has_aggregate(e.left) or _has_aggregate(e.right)
    if isinstance(e, UnaryOp):
        return _has_aggregate(e.operand)
    return False


def _expr_name(e) -> str:
    if isinstance(e, Ident):
        return e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Func):
        return f"{e.name}({', '.join(_expr_name(a) for a in e.args)})"
    if isinstance(e, BinOp):
        return f"{_expr_name(e.left)} {e.op} {_expr_name(e.right)}"
    if isinstance(e, UnaryOp):
        return f"{e.op}{_expr_name(e.operand)}"
    if isinstance(e, InList):
        return f"{_expr_name(e.expr)} in (...)"
    return str(e)


def _requested_step(q: Query) -> int | None:
    """The query's time-bucket step from a GROUP BY interval(time, N)
    (pre-expansion AST; GROUP BY may name a select alias of the
    interval expression) — the tier-selection input: a query bucketing
    at ≥60s never needs sub-minute rows."""
    aliases = {it.alias: it.expr for it in q.select if it.alias}
    for e in q.group_by:
        if isinstance(e, Ident):
            e = aliases.get(e.name, e)
        if (
            isinstance(e, Func)
            and e.name == "interval"
            and len(e.args) == 2
            and isinstance(e.args[1], Literal)
        ):
            try:
                return int(e.args[1].value)
            except (TypeError, ValueError):
                return None
    return None


def _time_range(where) -> tuple[int, int] | None:
    """Hoist time >=/>/<=/< conjuncts (AND chains only) for partition
    pruning; the full WHERE still runs as a row mask."""
    lo, hi = None, None

    def walk(e):
        nonlocal lo, hi
        if isinstance(e, BinOp) and e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if (
            isinstance(e, BinOp)
            and isinstance(e.left, Ident)
            and e.left.name == "time"
            and isinstance(e.right, Literal)
        ):
            v = int(e.right.value)
            if e.op in (">=", ">"):
                lo = v if lo is None else max(lo, v)
            elif e.op == "<":
                hi = v if hi is None else min(hi, v)
            elif e.op == "<=":
                hi = v + 1 if hi is None else min(hi, v + 1)
            elif e.op == "=":
                lo = v if lo is None else max(lo, v)
                hi = v + 1 if hi is None else min(hi, v + 1)

    walk(where)
    if lo is None and hi is None:
        return None
    return (lo or 0, hi if hi is not None else 1 << 62)
