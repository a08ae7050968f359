"""The benchmark of ``map_oxidize_tpu_torch``: ``run.py`` runs one cell of
``BENCHMARK.json`` once; ``bench.py`` finds each cell's files by name."""
