"""The benchmark's own code: lookup by name, traffic, the timed loop, the
trace reduction and the result line. It holds no name of a cell, a
configuration or a metric: those come from ``BENCHMARK.json`` and the files
under ``benchmark/`` that carry them."""
