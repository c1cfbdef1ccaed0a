"""PyTorch/CUDA port of ml_mdm_tpu for NVIDIA Hopper (H100).

The JAX package ``ml_mdm_tpu`` is the reference this package is held to;
the layout mirrors it (``ops/``, ``models/``, ``samplers.py``,
``diffusion.py``, ``utils/``). This package imports torch and never JAX.
Hand kernels live in ``ops/`` (Triton) and ``csrc/`` (CUDA C++) and are
built on the machine with the card at first use.
"""
