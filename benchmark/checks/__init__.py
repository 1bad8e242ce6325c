"""Correctness checks: one module per kind of system under test, named
by a configuration's `check` key. Each exposes `collect(run)`, called
after every call and after the drain, and `check_run(run)`."""
