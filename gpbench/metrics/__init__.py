"""Per-layer metric readers, one file a metric (metrics/<metric>.py):
`read(ctx) -> float | None`, ctx a harness.runner.Context. A reader that
finds nothing to read returns None, and the metric is left out."""
