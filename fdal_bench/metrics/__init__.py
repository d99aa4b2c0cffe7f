"""One reader a metric: ``read(run)`` takes a ``window.Run`` and returns the
metric's value, or None where the run holds nothing to read it from."""
