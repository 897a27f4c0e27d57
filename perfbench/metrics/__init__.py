"""Per-layer metric readers: ``metrics/<metric>.py`` defines ``read(run)``
(``run`` a ``harness.RunData``) and returns the metric's value, or None
where the run holds nothing to read (never 0 for a share of a peak)."""
