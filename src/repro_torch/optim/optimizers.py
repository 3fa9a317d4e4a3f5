"""First-order optimizers over trees of tensors (``repro.optim.optimizers``).

The paper's §4.2 comparison methods — GD, Adam, Adagrad, Adadelta — plus
momentum and AdamW, with the reference's update rules term for term (eps
placement, f32 moments, bias correction); ``torch.optim`` differs in these
details.  ``init(params)`` makes the state; ``update(grads, state,
params)`` returns the *delta* to add to each parameter and the new state.

``params`` is any tree of ``util.tree``: a tuple of tensors (the GCN
baselines) or a language model's nested dicts, whose state then has the
reference's structure and key paths (Adam ``{"m": tree, "v": tree, "t":
int32}``, SGD ``()``).  ``update`` writes each new moment over the old one,
leaf by leaf, instead of building a second state beside the first (20 GB
of Adam moments for a 2.5 B-parameter model): the reference's expressions,
so its numbers, and the state passed in is consumed.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.util.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, vel, params=None):
        vel = tree_map(lambda v, g: v.copy_(beta * v + g), vel, grads)
        return tree_map(lambda v: -lr * v, vel), vel

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with f32 moments (params may be bf16 — deltas cast back)."""

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        first = next(iter(leaves(params)), None)
        dev = first.device if first is not None else None
        return {"m": tree_map(f32, params), "v": tree_map(f32, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: m_.copy_(b1 * m_ + (1 - b1) * g.float()),
                     state["m"], grads)
        v = tree_map(lambda v_, g: v_.copy_(b2 * v_ + (1 - b2) * g.float()
                                            * g.float()), state["v"], grads)
        tf = t.to(torch.float32)
        mh_scale = 1.0 / (1 - b1 ** tf)
        vh_scale = 1.0 / (1 - b2 ** tf)

        def delta(m_, v_, p=None):
            d = -lr * (m_ * mh_scale) / (torch.sqrt(v_ * vh_scale) + eps)
            if weight_decay and p is not None:
                d = d - lr * weight_decay * p.float()
            return d.to(p.dtype) if p is not None else d

        deltas = (tree_map(delta, m, v) if params is None
                  else tree_map(delta, m, v, params))
        return deltas, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, acc, params=None):
        acc = tree_map(lambda a, g: a.copy_(a + g * g), acc, grads)
        deltas = tree_map(lambda g, a: -lr * g / (torch.sqrt(a) + eps),
                          grads, acc)
        return deltas, acc

    return Optimizer(init, update)


def adadelta(lr: float = 1.0, rho: float = 0.95,
             eps: float = 1e-6) -> Optimizer:
    def init(params):
        return {"acc_g": _zeros(params), "acc_d": _zeros(params)}

    def update(grads, state, params=None):
        acc_g = tree_map(lambda a, g: a.copy_(rho * a + (1 - rho) * g * g),
                         state["acc_g"], grads)
        deltas = tree_map(
            lambda g, ag, ad: -lr * g * torch.sqrt(ad + eps)
            / torch.sqrt(ag + eps), grads, acc_g, state["acc_d"])
        acc_d = tree_map(lambda a, d: a.copy_(rho * a + (1 - rho) * d * d),
                         state["acc_d"], deltas)
        return deltas, {"acc_g": acc_g, "acc_d": acc_d}

    return Optimizer(init, update)


def _adamw(lr: float, **kw) -> Optimizer:
    return adam(lr, weight_decay=kw.pop("weight_decay", 0.1), **kw)


_REGISTRY: dict[str, Callable[..., Optimizer]] = {
    "gd": sgd, "sgd": sgd, "momentum": momentum, "adam": adam,
    "adamw": _adamw, "adagrad": adagrad, "adadelta": adadelta,
}


def make(name: str, lr: float, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {list(_REGISTRY)}")
    return _REGISTRY[name](lr, **kwargs)
