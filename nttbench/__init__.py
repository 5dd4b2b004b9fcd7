"""The benchmark of the PyTorch / CUDA port, ``ntt_tpu_torch``, on the H100.

    python3 -m nttbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line; see
``harness`` for what a run does and ``PERF.md`` for the cells and metrics.
Nothing here imports JAX or the JAX package; only ``systems/`` imports
the program.
"""
