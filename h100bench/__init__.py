"""H100 benchmark of edgegraph3d_tpu_torch: one cell of BENCHMARK.json per
run of `python3 h100bench/run.py` (README.md)."""
