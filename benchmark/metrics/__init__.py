"""Per-layer metric readers, one module a family: ``<family>.py`` serves every
metric whose name starts with ``<family>`` before the first dot.  Each has
``read(ctx) -> float | None``; ``ctx`` is ``benchmark.run.Context``.  A
reader that finds nothing to read returns ``None`` and the metric is left out
of the result line."""
