"""The benchmark of ``esme_tpu_torch`` on the NVIDIA H100.

``h100_bench/run.py`` runs one cell of ``BENCHMARK.json`` once
(:mod:`.harness`). What belongs to one configuration, traffic mix or
metric lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names a loop in :mod:`.drivers`), ``cells/<workload>.json`` (the limits of
the check) and ``metrics/<metric>.py`` (a reader).
"""
