"""Each metric's reader, one module a metric named as in
``BENCHMARK.json``: ``read(run) -> float | None``, ``run`` a
``harness.Run``. A reader that finds nothing to read returns None, and the
metric is left out of the result."""
