"""One reader a per-layer metric: ``perfbench/metrics/<metric>.py`` defines
``read(trace) -> float | None`` over a ``harness.TraceData``; None where the
run holds nothing to read, and the metric is then left out of the line."""
