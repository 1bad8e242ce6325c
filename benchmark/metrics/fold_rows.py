"""Mean live rows a fold reduced (live stash rows + live ring rows),
from the counter block's fold_rows lane, over the window's calls."""


def read(run):
    ctx = run.ctx
    rows = [r for r in ctx.fold_rows if r]
    return sum(rows) / len(rows) if rows else None
