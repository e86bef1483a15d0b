"""instantir_tpu_torch — the PyTorch/CUDA port of ``instantir_tpu`` for NVIDIA Hopper.

A package of its own: it imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``instantir_tpu``. Every Pallas kernel of the JAX package that the
ported path runs is a hand-written CUDA kernel under ``csrc/``, built at first
use by ``kernels.py``.
"""
