"""The benchmark of ``mpmavatar_tpu_torch`` on an NVIDIA GPU: one cell per
run, found by name in ``BENCHMARK.json`` (``python -m benchmark.run``)."""
