"""The benchmark of ``rtnr_tpu_torch`` on an NVIDIA H100: one cell a run
(``run.py``), its files found by name from ``BENCHMARK.json``
(``harness.py``), and the plain reference that decides ``correct``
(``reference/``)."""
