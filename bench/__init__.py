"""The benchmark of the port (``repro_torch``): ``BENCHMARK.json``'s cells,
run by ``bench/run.py``."""
