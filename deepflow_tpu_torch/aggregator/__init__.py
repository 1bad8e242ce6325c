"""Windowed rollup: fanout, stash, window manager, pipelines."""
