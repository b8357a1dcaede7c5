"""gpzbench: the benchmark of gpz_tpu_torch on one NVIDIA H100 (run.py)."""
