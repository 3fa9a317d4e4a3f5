"""ADMM subproblem solvers (paper §3 + Appendix A), global (full-graph) form.

The port's counterpart of ``repro.core.subproblems``.  All updates are
Jacobi-style as in Algorithm 1: every ``W_l`` update reads ``Z^k``, every
``Z_l`` update reads ``W^{k+1}`` and ``Z^k``, then the dual ``U`` ascends.
The majorize-minimize step of eq. (2)/(8) doubles its curvature (τ for W,
θ for Z) until ``P(x_new; τ) ≥ φ(x_new)``.

Each ``lax.while_loop`` of the reference is a host loop with the same
acceptance test, and gradients come from autograd.  Products with Ã keep the
reference's association, ``(Ã @ Z) @ W``; ``admm_iteration`` computes each
``Ã @ Z`` that the line-search probes would recompute unchanged (same
operands, same value) once per step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core import gcn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    nu: float = 1e-3        # ν — penalty on intermediate-layer constraints
    rho: float = 1e-3       # ρ — augmented-Lagrangian penalty, last layer
    tau_init: float = 1.0   # initial curvature for backtracking
    backtrack_growth: float = 2.0
    max_backtracks: int = 30
    fista_iters: int = 8    # inner FISTA iterations for the Z_L prox problem
    # relative acceptance slack: P(x⁺;τ) ≥ φ(x⁺) − tol·|φ| guards against
    # reduction-order float noise when ∇φ ≈ 0 (exact ties at initialization)
    backtrack_rtol: float = 1e-6


class ADMMState(NamedTuple):
    weights: tuple[Tensor, ...]   # W_1..W_L
    zs: tuple[Tensor, ...]        # Z_1..Z_L (auxiliary activations)
    u: Tensor                     # U — dual for the Z_L constraint
    taus: tuple[Tensor, ...]      # warm-started τ_l (0-dim f32)
    thetas: tuple[Tensor, ...]    # warm-started θ_l (0-dim f32)


def init_state(cfg: gcn.GCNConfig, admm: ADMMConfig, a_tilde: Tensor,
               z0: Tensor, generator: torch.Generator) -> ADMMState:
    """Glorot weights from ``generator`` and Z from the forward pass."""
    ws = gcn.init_weights(cfg, generator, a_tilde.device)
    zs = gcn.forward(cfg, a_tilde, z0, ws)
    u = torch.zeros_like(zs[-1])

    def scalar():
        return torch.tensor(admm.tau_init, dtype=torch.float32,
                            device=a_tilde.device)
    return ADMMState(tuple(ws), tuple(zs), u, tuple(scalar() for _ in ws),
                     tuple(scalar() for _ in zs))


def stale_weights(ages: np.ndarray, stale_decay: float) -> np.ndarray:
    """d_r = stale_decay ** age_r (float32): the damping of a neighbour's
    consensus terms after ``age_r`` rounds without a resample.  Age 0 gives
    exactly 1.0, so a full batch reproduces the undamped objective."""
    base = np.float32(stale_decay)
    return np.power(base, np.asarray(ages).astype(np.float32))


def value_and_grad(fn: Callable[[Tensor], Tensor], x: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """``fn(x)`` and the gradient of ``fn(x).sum()`` (per-lane values keep
    their shape: the lanes are separable, as ``jax.grad`` of the sum)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        val = fn(xg)
        (grad,) = torch.autograd.grad(val.sum(), xg)
    return val.detach(), grad


# ---------------------------------------------------------------------------
# φ objectives (paper §3 definitions)
# ---------------------------------------------------------------------------

def _phi_hidden(admm: ADMMConfig, f: Callable, agg: Tensor, w: Tensor,
                z: Tensor) -> Tensor:
    r = z - f(agg @ w)
    return 0.5 * admm.nu * torch.sum(r * r)


def _phi_last(admm: ADMMConfig, agg: Tensor, w: Tensor, z: Tensor,
              u: Tensor) -> Tensor:
    r = z - agg @ w
    return torch.sum(u * r) + 0.5 * admm.rho * torch.sum(r * r)


def phi_hidden(admm: ADMMConfig, f: Callable, a_tilde: Tensor, w: Tensor,
               z_prev: Tensor, z: Tensor) -> Tensor:
    """φ(W_l, Z_{l-1}, Z_l) = ν/2 ‖Z_l − f(Ã Z_{l-1} W_l)‖²  (l < L)."""
    return _phi_hidden(admm, f, a_tilde @ z_prev, w, z)


def phi_last(admm: ADMMConfig, a_tilde: Tensor, w: Tensor, z_prev: Tensor,
             z: Tensor, u: Tensor) -> Tensor:
    """φ(W_L, Z_{L-1}, Z_L, U) = ⟨U, Z_L − ÃZ_{L-1}W_L⟩ + ρ/2‖·‖²."""
    return _phi_last(admm, a_tilde @ z_prev, w, z, u)


# ---------------------------------------------------------------------------
# Quadratic-approximation backtracking step (eq. 2 / eq. 8-10)
# ---------------------------------------------------------------------------

def backtracking_step(obj: Callable[[Tensor], Tensor], x: Tensor,
                      tau0: Tensor, admm: ADMMConfig,
                      psum: "Callable[[Tensor], Tensor] | None" = None
                      ) -> tuple[Tensor, Tensor]:
    """One majorize-minimize step: x⁺ = x − ∇obj(x)/τ with τ doubled until
    P(x⁺; τ) = obj(x) − ‖∇obj‖²/(2τ) ≥ obj(x⁺).  Returns (x⁺, accepted τ).
    The warm start shrinks τ once (optimistic), then grows to acceptance.

    With ``psum`` (the reference's ``backtracking_step_psum``) ``obj`` is
    a shard's local objective: its value and gradient are psum-ed, and so
    is every probe's objective, so that every shard takes the same τ."""
    if psum is None:
        def psum(v):
            return v
    val, grad = value_and_grad(obj, x)
    val, grad = psum(val), psum(grad)
    g_sq = torch.sum(grad * grad)
    tau = torch.clamp(tau0 / admm.backtrack_growth, min=1e-8)
    with torch.no_grad():
        for _ in range(admm.max_backtracks):
            with trace.span("admm.probe", site="backtracking"):
                bound = val - 0.5 * g_sq / tau
                tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
                if not trace.decide(bound + tol < psum(obj(x - grad / tau)),
                                    "backtracking"):
                    break
            tau = tau * admm.backtrack_growth
    return x - grad / tau, tau


# ---------------------------------------------------------------------------
# ψ objectives for Z updates (Appendix A, global form)
# ---------------------------------------------------------------------------

def _psi(cfg: gcn.GCNConfig, admm: ADMMConfig, a_tilde: Tensor,
         agg_below: Tensor, w_l: Tensor, w_next: Tensor,
         zs: Sequence[Tensor], u: Tensor, l: int) -> Callable[[Tensor], Tensor]:
    f = gcn.activation_fn(cfg.activation)
    num_layers = cfg.num_layers
    target1 = f(agg_below @ w_l)           # constant in z

    def psi(z):
        # self-reconstruction term (this layer's constraint)
        r1 = z - target1
        val = 0.5 * admm.nu * torch.sum(r1 * r1)
        if l + 1 < num_layers:            # eq. (5): next layer is hidden
            r2 = zs[l] - f(a_tilde @ z @ w_next)
            val = val + 0.5 * admm.nu * torch.sum(r2 * r2)
        else:                             # eq. (6): next layer is the last
            r2 = zs[num_layers - 1] - a_tilde @ z @ w_next
            val = val + torch.sum(u * r2) + 0.5 * admm.rho * torch.sum(r2 * r2)
        return val

    return psi


def make_psi(cfg: gcn.GCNConfig, admm: ADMMConfig, a_tilde: Tensor,
             z0: Tensor, weights: Sequence[Tensor], zs: Sequence[Tensor],
             u: Tensor, l: int) -> Callable[[Tensor], Tensor]:
    """Objective for Z_l (1-indexed layer l = idx+1), l < L.  Eq. (5)/(6)."""
    z_below = z0 if l == 1 else zs[l - 2]
    return _psi(cfg, admm, a_tilde, a_tilde @ z_below, weights[l - 1],
                weights[l], zs, u, l)


def fista_last_z(admm: ADMMConfig, b: Tensor, u: Tensor, labels: Tensor,
                 mask: Tensor, z_init: Tensor,
                 denom: "Tensor | None" = None) -> Tensor:
    """Solve eq. (7): argmin_Z R(Z,Y) + ⟨U, Z−B⟩ + ρ/2‖Z−B‖² with FISTA:
    Nesterov-accelerated gradient with per-iteration Lipschitz backtracking.
    ``denom`` overrides the CE normalizer."""
    lab = labels.long()[..., None]

    def obj(z):
        r = z - b
        if denom is None:
            ce = gcn.masked_cross_entropy(z, labels, mask)
        else:
            logp = torch.log_softmax(z, dim=-1)
            nll = -torch.gather(logp, -1, lab)[..., 0]
            ce = torch.sum(nll * mask) / denom
        return ce + torch.sum(u * r) + 0.5 * admm.rho * torch.sum(r * r)

    dev = z_init.device
    z = y = z_init
    t = torch.tensor(1.0, dtype=torch.float32, device=dev)
    lip = torch.tensor(admm.rho + 1.0, dtype=torch.float32, device=dev)
    for _ in range(admm.fista_iters):
        val_y, g = value_and_grad(obj, y)
        g_sq = torch.sum(g * g)
        with torch.no_grad():
            for _ in range(admm.max_backtracks):
                # descent lemma test: obj(z_new) ≤ obj(y) − ‖g‖²/(2L) (+ rtol)
                bound = val_y - 0.5 * g_sq / lip
                tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
                if not bool(obj(y - g / lip) > bound + tol):
                    break
                lip = lip * admm.backtrack_growth
            z_new = y - g / lip
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            y = z_new + ((t - 1.0) / t_new) * (z_new - z)
            z, t, lip = z_new, t_new, lip * 0.9
    return z


# ---------------------------------------------------------------------------
# One full ADMM iteration (Algorithm 1), global form
# ---------------------------------------------------------------------------

@torch.no_grad()
def admm_iteration(cfg: gcn.GCNConfig, admm: ADMMConfig, a_tilde: Tensor,
                   z0: Tensor, labels: Tensor, mask: Tensor,
                   state: ADMMState) -> ADMMState:
    f = gcn.activation_fn(cfg.activation)
    num_layers = cfg.num_layers
    ws, zs, u, taus, thetas = state
    # Ã Z_{l-1}^k for every layer input: read by the W objectives, the ψ
    # targets and the FISTA centre, all with Z^k
    aggs = [a_tilde @ z for z in (z0,) + tuple(zs[:-1])]

    # ---- Line 3: update W_l for all l in parallel (Jacobi, reads Z^k) ----
    new_ws, new_taus = [], []
    for l in range(num_layers):
        if l < num_layers - 1:
            def obj(w, agg=aggs[l], z=zs[l]):
                return _phi_hidden(admm, f, agg, w, z)
        else:
            def obj(w, agg=aggs[l], z=zs[l]):
                return _phi_last(admm, agg, w, z, u)
        w_new, tau = backtracking_step(obj, ws[l], taus[l], admm)
        new_ws.append(w_new)
        new_taus.append(tau)

    # ---- Line 4: update Z_{l} for all l in parallel (reads W^{k+1}, Z^k) --
    new_zs, new_thetas = [], []
    for l in range(1, num_layers):          # hidden layers: eq. (8)-(10)
        psi = _psi(cfg, admm, a_tilde, aggs[l - 1], new_ws[l - 1], new_ws[l],
                   zs, u, l)
        z_new, theta = backtracking_step(psi, zs[l - 1], thetas[l - 1], admm)
        new_zs.append(z_new)
        new_thetas.append(theta)
    # last layer: FISTA prox (eq. 7)
    b = aggs[num_layers - 1] @ new_ws[-1]
    new_zs.append(fista_last_z(admm, b, u, labels, mask, zs[-1]))
    new_thetas.append(thetas[-1])

    # ---- Line 5: dual ascent (eq. 3) ----
    z_pen_new = new_zs[num_layers - 2] if num_layers >= 2 else z0
    residual = new_zs[-1] - a_tilde @ z_pen_new @ new_ws[-1]
    new_u = u + admm.rho * residual

    return ADMMState(tuple(new_ws), tuple(new_zs), new_u, tuple(new_taus),
                     tuple(new_thetas))


@torch.no_grad()
def lagrangian_value(cfg: gcn.GCNConfig, admm: ADMMConfig, a_tilde: Tensor,
                     z0: Tensor, labels: Tensor, mask: Tensor,
                     state: ADMMState) -> Tensor:
    """ℒ_ρ(W, Z, U) — eq. (1), for convergence monitoring."""
    f = gcn.activation_fn(cfg.activation)
    ws, zs, u = state.weights, state.zs, state.u
    val = gcn.masked_cross_entropy(zs[-1], labels, mask)
    z_prev = z0
    for l in range(cfg.num_layers - 1):
        r = zs[l] - f(a_tilde @ z_prev @ ws[l])
        val = val + 0.5 * admm.nu * torch.sum(r * r)
        z_prev = zs[l]
    r = zs[-1] - a_tilde @ z_prev @ ws[-1]
    return val + torch.sum(u * r) + 0.5 * admm.rho * torch.sum(r * r)
