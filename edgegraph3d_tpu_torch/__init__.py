"""edgegraph3d_tpu_torch — the PyTorch / CUDA port of edgegraph3d_tpu.

Same pipeline, same module layout as the JAX package (which stays the
reference): plain functions on torch tensors, with the hot device
programs of the stage-3 main path written by hand in CUDA C++ for
Hopper (`csrc/*.cu`, built with nvcc at first use, see `kernels.py`).
Every hand kernel keeps a plain-torch version with the same semantics
in the module that calls it; the kernel wrapper takes the plain version
only for tensors on the CPU.

The package never imports jax or edgegraph3d_tpu.
"""

import torch as _torch

# f32 geometry must stay f32: TF32 keeps ~10 mantissa bits, which is
# pixel-level error at 1600 px frames.  Pinned package-wide, the
# counterpart of the reference's jax_default_matmul_precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from edgegraph3d_tpu_torch.config import EdgeGraphConfig  # noqa: E402

__all__ = ["EdgeGraphConfig"]
