"""ab_opt_tpu_torch — the PyTorch/CUDA port of ab_opt_tpu for NVIDIA Hopper.

The JAX package ``ab_opt_tpu`` is the reference this port is held against;
the port imports nothing of it (it keeps its own copy of the constants it
needs in ``constants.py``). The TPU kernels on the ported paths are
hand-written CUDA C++ in ``csrc/`` with their wrappers and plain PyTorch
versions in ``ops/``: the fused GABlock forward (sampling) and the IPA
attention forward and backward (training).
"""

__version__ = '0.2.0'
