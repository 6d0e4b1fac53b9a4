"""The benchmark of the PyTorch / CUDA port (``ptbxl_torch``) on one H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
the cells, metrics and bounds are in ``BENCHMARK.json`` at the checkout's
root, and PERF.md says why each is there.  Nothing here imports the JAX
package or JAX, and ``benchmark/reference/`` imports nothing of the program.
"""
