"""One reader per metric, found by the metric's name (``spec.reader``).

A reader is ``read(run) -> float | None`` over a finished run (``run.Run``);
None leaves the metric out of the result line.  A per-layer reader that
finds nothing to read returns None, never 0."""
