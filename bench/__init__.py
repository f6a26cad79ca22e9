"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
See ``bench/README.md``.
"""
