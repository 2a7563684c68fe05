"""Benchmark of the PyTorch/CUDA port ``archnemesis_tpu_torch`` (see README.md)."""
