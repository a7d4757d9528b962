"""The benchmark harness of bn254_tpu_torch: generic code that runs the cells
that BENCHMARK.json names, from the data files under ``benchmark/``."""
