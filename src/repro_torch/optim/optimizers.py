"""First-order optimizers over tuples of tensors (``repro.optim.optimizers``).

The paper's §4.2 comparison methods — GD, Adam, Adagrad, Adadelta — plus
momentum and AdamW, with the reference's update rules term for term (eps
placement, f32 moments, bias correction); ``torch.optim`` differs in these
details.  ``init(params)`` makes the state; ``update(grads, state, params)``
returns the *delta* to add to each parameter and the new state.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

Tensors = Sequence[torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[..., tuple[tuple[torch.Tensor, ...], Any]]


def _zeros(params: Tensors) -> tuple[torch.Tensor, ...]:
    return tuple(torch.zeros_like(p) for p in params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tuple(-lr * g for g in grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, vel, params=None):
        vel = tuple(beta * v + g for v, g in zip(vel, grads))
        return tuple(-lr * v for v in vel), vel

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with f32 moments (params may be bf16 — deltas cast back)."""

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = params[0].device if len(params) else None
        return {"m": tuple(f32(p) for p in params),
                "v": tuple(f32(p) for p in params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tuple(b1 * m_ + (1 - b1) * g.float()
                  for m_, g in zip(state["m"], grads))
        v = tuple(b2 * v_ + (1 - b2) * g.float() * g.float()
                  for v_, g in zip(state["v"], grads))
        tf = t.to(torch.float32)
        mh_scale = 1.0 / (1 - b1 ** tf)
        vh_scale = 1.0 / (1 - b2 ** tf)

        def delta(m_, v_, p):
            d = -lr * (m_ * mh_scale) / (torch.sqrt(v_ * vh_scale) + eps)
            if weight_decay and p is not None:
                d = d - lr * weight_decay * p.float()
            return d.to(p.dtype) if p is not None else d

        ps = (None,) * len(m) if params is None else params
        deltas = tuple(delta(m_, v_, p) for m_, v_, p in zip(m, v, ps))
        return deltas, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, acc, params=None):
        acc = tuple(a + g * g for a, g in zip(acc, grads))
        deltas = tuple(-lr * g / (torch.sqrt(a) + eps)
                       for g, a in zip(grads, acc))
        return deltas, acc

    return Optimizer(init, update)


def adadelta(lr: float = 1.0, rho: float = 0.95,
             eps: float = 1e-6) -> Optimizer:
    def init(params):
        return {"acc_g": _zeros(params), "acc_d": _zeros(params)}

    def update(grads, state, params=None):
        acc_g = tuple(rho * a + (1 - rho) * g * g
                      for a, g in zip(state["acc_g"], grads))
        deltas = tuple(-lr * g * torch.sqrt(ad + eps) / torch.sqrt(ag + eps)
                       for g, ag, ad in zip(grads, acc_g, state["acc_d"]))
        acc_d = tuple(rho * a + (1 - rho) * d * d
                      for a, d in zip(state["acc_d"], deltas))
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
