"""PyTorch/CUDA port of the community-ADMM GCN system in ``repro``.

Same module map as ``repro``; imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (``util.device.resolve_device``).
"""
