"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: wall-clock serving through ``Engine`` under arriving traffic.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output.  Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``metrics/<metric>.py``,
``layouts/<architecture>.py`` and ``reference/<architecture>.py``: a new
architecture enters by files, and the shared harness names none.  Nothing
here imports JAX or the JAX package ``repro``; ``reference/`` imports
nothing of ``repro_torch``.
"""
