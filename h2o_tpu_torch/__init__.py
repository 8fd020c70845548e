"""h2o_tpu_torch — the PyTorch/CUDA port of ``h2o_tpu``, one slice at a time.

The JAX package ``h2o_tpu`` stays the reference; this package mirrors its
module layout so each port module sits at the same relative path as its
counterpart, and never imports ``jax`` or anything of ``h2o_tpu``.

Scope so far: GBM (bernoulli and gaussian) on numeric and categorical
features, trained and scored end to end — ``Frame``/``Vec`` on torch
tensors, quantile and per-level bin edges and int8/int16 bin codes, the tree
engine's level loop over the level-histogram kernel (flat or width-bucketed
plans, ``backend/kernels/hist.py``, CUDA C++ in ``csrc/level_hist.cu``),
categorical set splits, and binomial/regression metrics.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` on a machine without a GPU raises.
Kernel wrappers dispatch on the tensor's device: the plain PyTorch version
for a CPU tensor, the hand-written kernel for a CUDA tensor.
"""

from .frame.frame import Frame
from .frame.vec import Vec
from .models.gbm import GBM, GBMModel, GBMParameters

__all__ = ["Frame", "Vec", "GBM", "GBMModel", "GBMParameters"]
