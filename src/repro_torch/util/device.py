"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib

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


def rank_device(rank: int, device: "str | torch.device | None" = None
                ) -> torch.device:
    """The device of process ``rank``: for ``None`` or ``"cuda"`` the card
    ``cuda:{rank % device_count}`` (several ranks share a card when there
    are more ranks than cards), with TF32 off in this process — TF32 is
    per-process state, so every rank turns it off for itself.  Without a
    card it raises, as ``resolve_device`` does; ``"cpu"`` is the CPU."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available; "
                               f"pass device='cpu' to run on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return resolve_device(device)


@contextlib.contextmanager
def shapes_only():
    """Within: tensors made only for their shapes (whole ``meta`` trees
    that a placement's specs are derived from) are made outside the active
    dispatch modes, so that a memory tracker, the op trace or a FLOP
    counter over a step does not count them as the step's work."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield
