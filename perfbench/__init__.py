"""The benchmark of cdlrm_tpu_torch: one cell of BENCHMARK.json a run.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root. Every configuration, traffic mix,
per-layer metric and limit sits in a file of its own, found by the names
that BENCHMARK.json gives (``configs/``, ``traffic/``, ``metrics/``,
``limits/``); the plain reference that decides ``correct`` is under
``reference/`` and imports nothing of the program.
"""
