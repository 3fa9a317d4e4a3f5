"""Activation-sharding hints of src/repro/sharding/hints.py: not ported.

The reference's ``sharding_hints(mesh, moe_a2a=...)`` context pins the
attention and MoE activations' shardings under XLA's SPMD partitioner and
gates its expert-parallel all-to-all dispatch (``moe.apply_moe_a2a``).
The port places tensors per rank itself; the tensor-parallel placement
these hints serve and the all-to-all dispatch are ROADMAP A.5 items 1 and
2.  Without a mesh the reference's hints are identities, as the port's
models are.
"""
from __future__ import annotations


def sharding_hints(mesh, moe_a2a: bool = False):
    """Refuses: the port has no sharding hints yet."""
    raise NotImplementedError(
        "sharding_hints (and the apply_moe_a2a dispatch it gates) are "
        "ROADMAP A.5 item 1; the hint_* functions of the tensor-parallel "
        "placement are A.5 item 2")
