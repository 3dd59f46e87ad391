"""The benchmark of tpukzg_torch on one NVIDIA H100 (see run.py)."""
