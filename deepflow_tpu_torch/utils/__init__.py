"""Host-only utilities: the retry policy and the stage-span tracer."""
