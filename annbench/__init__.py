"""annbench: the benchmark of the PyTorch/CUDA IVFADC engine
(`ivfadc_tpu_torch`) on one NVIDIA H100.

`python3 annbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
Everything a cell needs is found by name: `configs/`, `traffic/`,
`workloads/`, `drivers/`, `metrics/` and `layers/`. Nothing here imports
JAX or the JAX package.
"""
