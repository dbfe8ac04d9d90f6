"""The port's benchmark: ``BENCHMARK.json`` at the root names its cells,
``run.py`` runs one, and every configuration, traffic mix, route,
per-layer metric, kernel work model and limit lives in a file of its own
here, found by its name."""
