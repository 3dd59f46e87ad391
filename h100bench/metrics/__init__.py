"""Per-layer metric readers: metrics/<name>.py defines read(readings) ->
a number, or None where its run has nothing to read (the harness then
leaves the metric out of the line)."""
