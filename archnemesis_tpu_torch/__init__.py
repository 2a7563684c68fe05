"""PyTorch/CUDA port of the archnemesis_tpu radiative-transfer framework.

The package mirrors the JAX package's layout (``core/``, ``io/``, ``ops/``,
``rt/``, ``utils/``, ``forward.py``) and module names. It imports ``torch``
and numpy only. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; nothing moves to the CPU by itself.
"""
