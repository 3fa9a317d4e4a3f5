"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def strict_f32() -> None:
    """Make every f32 product true f32, as on the JAX side (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """``None`` means the card: ``cuda``, or a ``RuntimeError`` when there is
    none — nothing carries on quietly on the CPU.  A CUDA device also turns
    TF32 off (``strict_f32``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available; pass device='cpu' to run on the "
                               f"CPU")
        strict_f32()
    return device
