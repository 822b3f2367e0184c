"""The port's device rule: entry points and public library functions
default to "cuda" and never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA GPU is "
                           "available (pass device='cpu' explicitly)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
