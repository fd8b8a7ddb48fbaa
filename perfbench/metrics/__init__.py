"""One reader a per-layer metric, found by the metric's name in
``BENCHMARK.json``: ``read(run)`` returns the value, or None where the run
holds nothing to read."""
