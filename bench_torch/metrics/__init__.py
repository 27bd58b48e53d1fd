"""Per-layer metric readers, one file each, named as the metric: a
`read(readings)` that returns the metric's value, or None where the
readings hold nothing for it (the harness then leaves the metric out).

The readings a driver gives: `summary` (harness.trace.TraceSummary of
the traced window), and, by driver, `frames` and `calls` traced,
`b1_bytes_per_launch`, `b3_operations`, `service_before` and
`service_after` (RenderService.snapshot() around the window).
"""
