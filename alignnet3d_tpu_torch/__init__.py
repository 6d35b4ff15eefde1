"""AlignNet-3D on PyTorch and CUDA: the port of ``alignnet3d_tpu``.

The JAX package ``alignnet3d_tpu`` is the reference; this package holds
its PyTorch counterparts, module for module (``ops/``, ``models/``,
``icp/``, ``evaluation/``, ``serving.py``, ``api.py``), and reuses the JAX
package's jax-free host modules (config, geometry, data) by import. It
never imports jax, flax or optax.

Every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (sm_90a) under ``csrc/``, built with ``nvcc`` at first
use (``ops/_build.py``). Each has a plain PyTorch twin in the same module:
a CPU tensor goes through the twin, a CUDA tensor through the kernel.

Ported so far: the serving path of the PointNet model, i.e.
``api.Aligner.align`` with the BN-folded forward, flip resolution,
gated network refinement and constrained point-to-point ICP.
"""

__version__ = "0.1.0"
