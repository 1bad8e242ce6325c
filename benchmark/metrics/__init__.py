"""One reader per metric of BENCHMARK.json: `read(run)` returns the
metric's value from a finished `harness.Run` (what it recorded is in
`run.ctx`), or None when the run recorded nothing it could read."""
