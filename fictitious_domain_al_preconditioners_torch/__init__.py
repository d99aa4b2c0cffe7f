"""PyTorch port of the fictitious-domain / DLM solver with augmented-Lagrangian
block preconditioners, for CUDA (Hopper) cards.

The JAX package ``fictitious_domain_al_preconditioners_tpu`` beside this one is
the reference; this package mirrors its layout (``core``, ``ops``,
``precond``, ``parallel``, ``models``, ``utils``) and never imports jax.

Precision policy: float32 matrix products and convolutions run in full float32
(no TF32).  Problems work in float64 on the CPU (parity with the reference)
and in float32 on CUDA, unless a dtype is given explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from . import core, models, ops, parallel, precond, utils  # noqa: E402

__version__ = "0.1.0"
__all__ = ["core", "models", "ops", "parallel", "precond", "utils",
           "__version__"]
