"""Measurement tools of the port, each run as ``python -m
archnemesis_tpu_torch.tools.<name>`` on a CUDA card."""
