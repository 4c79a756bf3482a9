"""Per-layer metrics: one reader each, found by the metric's name.  A
reader's ``read(ctx)`` takes the traced run's summary (``harness.trace_ctx``)
and returns the number, or None where it finds nothing to read."""
