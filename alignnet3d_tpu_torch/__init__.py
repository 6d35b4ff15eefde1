"""AlignNet-3D on PyTorch and CUDA: the port of ``alignnet3d_tpu``.

The JAX package ``alignnet3d_tpu`` is the reference; this package holds
its PyTorch counterparts, module for module (``ops/``, ``models/``,
``icp/``, ``evaluation/``, ``serving.py``, ``api.py``), and its own copies
of the numpy host code it needs (``config.py``, ``geometry.py``,
``data/``). It imports nothing of the JAX package, and never jax, flax,
optax or msgpack: ``checkpoint.py`` reads and writes the JAX package's
flax checkpoints itself.

Every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (sm_90a) under ``csrc/``, built with ``nvcc`` at first
use (``ops/_build.py``). Each has a plain PyTorch twin in the same module:
a CPU tensor goes through the twin, a CUDA tensor through the kernel.

Ported: the serving path of the PointNet and the DGCNN models
(``api.Aligner``, int8 included), their training path
(``training/trainer.py``, bf16 and unstacked Siamese included), data-
parallel training over several processes (``parallel/``), the eval-time
refinement stack with the CLI, the residual-alignment task, checkpoints of
both packages (``checkpoint.py``), the classical baselines, export, the
dataset generators and the host tools; everything of the JAX package but
its TPU-only code.
"""

__version__ = "0.1.0"
