"""The benchmark of ``tpu_amg_torch`` on one NVIDIA H100.

``python -m amgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints its result as the
last line of standard output (``amgbench/README.md``).
"""
