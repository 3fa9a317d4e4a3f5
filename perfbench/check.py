"""The comparison that decides ``correct``.

The program's first steps are judged against the plain reference
(``reference.py``), each step from the program's own state before it: a
free-running reference would part from the program within three steps for
a reason that is not a fault.  In the first step the hidden layer's
iterates and the weights do not move (Z starts as the forward pass, so
their objectives' gradients are round-off), and the line searches there
decide on round-off, so a τ or θ one doubling apart in the first step
would set every later step apart.  The start, which this skips, is checked
by itself (``init_err``).

Numbers, each with a limit in the cell's workload file:

* ``init_err``: the program's first iterates against the reference's own
  (Glorot weights from the seed, Z from the forward pass, U = 0): the
  worst leaf's ||P - R|| / ||R||.
* ``agg_err``: every aggregation the program's first steps launched,
  against Ã times the same input in node order: max |P - R| / max |R|,
  the worst call; each call is matched to the reference's aggregate of
  its width that it is nearest.
* ``iter_err``: each step's new iterates against the reference's step
  from the same state: the worst leaf's ||P_k - R_k|| / ||R_k - S_k-1||,
  over the leaves that the reference moves by more than ``MOVE`` of
  their norm (U from zero always counts).  A leaf that moves less moves
  by round-off (in the first step every hidden Z and W).
* ``loss_err``: each step's training loss (mean cross-entropy of Z_L over
  the training nodes) against the reference step's: |l_P - l_R| / |l_R|.
* ``w_rank_diff`` (ranks): the ranks whose weights after the window are
  not bit-equal to rank 0's.
"""
from __future__ import annotations

import math

import torch

import reference as ref

MOVE = 1e-4


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.double()))


def _leaves(st) -> list:
    """[(name, tensor)] of a state (``reference.State`` or a dict)."""
    get = (lambda k: st[k]) if isinstance(st, dict) else \
        (lambda k: getattr(st, k))
    out = [(f"W{l + 1}", w) for l, w in enumerate(get("weights"))]
    out += [(f"Z{l + 1}", z) for l, z in enumerate(get("zs"))]
    out.append(("U", get("u")))
    return out


def as_state(d: dict, device) -> ref.State:
    def mv(xs):
        return [x.to(device) for x in xs]
    return ref.State(mv(d["weights"]), mv(d["zs"]), d["u"].to(device),
                     mv(d["taus"]), mv(d["thetas"]))


def init_err(p: ref.Problem, prog0: dict, seed: int) -> float:
    r0 = ref.init_state(p, seed)
    worst = 0.0
    for (name, a), (_, b) in zip(_leaves(prog0), _leaves(r0)):
        a = a.to(b.device)
        nb = _norm(b)
        err = _norm(a - b) / nb if nb > 0 else (0.0 if _norm(a) == 0
                                                else math.inf)
        worst = max(worst, err)
    return worst


def train_loss(p: ref.Problem, z_last: torch.Tensor) -> float:
    logp = torch.log_softmax(z_last.double(), dim=-1)
    nll = -torch.gather(logp, -1, p.labels[:, None])[:, 0]
    return float(torch.sum(nll * p.train.double()) / p.denom.double())


def agg_err(p: ref.Problem, before: ref.State, after: ref.State,
            calls: list) -> float:
    """``calls``: [(node ids, rows)] of one step's aggregations."""
    with torch.no_grad():
        inputs = [p.x] + list(before.zs[:-1]) + [after.zs[-2]]
        wants = [ref.aggregate(p, z) for z in inputs]
    worst = 0.0
    for nodes, rows in calls:
        idx = torch.as_tensor(nodes, device=p.x.device)
        rows = rows.to(p.x.device)
        best = math.inf
        for want in wants:
            if want.shape[1] != rows.shape[1]:
                continue
            w = want[idx]
            best = min(best, float((rows - w).abs().max() / w.abs().max()))
        worst = max(worst, best)
    return worst


def step_numbers(p: ref.Problem, before: ref.State, after: ref.State
                 ) -> dict:
    """iter_err and loss_err of one program step."""
    want, _ = ref.iteration(p, before)
    iter_e = 0.0
    for (_, pa), (_, ra), (_, sa) in zip(_leaves(after), _leaves(want),
                                         _leaves(before)):
        d = _norm(ra - sa)
        ns = _norm(sa)
        if d == 0 or (ns > 0 and d <= MOVE * ns):
            continue
        iter_e = max(iter_e, _norm(pa - ra) / d)
    lp, lr = train_loss(p, after.zs[-1]), train_loss(p, want.zs[-1])
    return {"iter_err": iter_e, "loss_err": abs(lp - lr) / abs(lr)}


def judge(p: ref.Problem, seed: int, states: list, calls: list) -> dict:
    """All numbers of a run: ``states`` the program's iterates in node
    order before its first step and after each of the next, ``calls`` per
    step its aggregations [(node ids, rows)]."""
    dev = p.x.device
    out = {"init_err": init_err(p, states[0], seed), "agg_err": 0.0,
           "iter_err": 0.0, "loss_err": 0.0}
    for k in range(1, len(states)):
        before, after = as_state(states[k - 1], dev), as_state(states[k], dev)
        if calls[k - 1]:
            out["agg_err"] = max(out["agg_err"],
                                 agg_err(p, before, after, calls[k - 1]))
        else:
            out["agg_err"] = math.inf       # no aggregation to judge
        for key, val in step_numbers(p, before, after).items():
            out[key] = max(out[key], val)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        val = numbers.get(name)
        good = val is not None and math.isfinite(val) and val <= limit
        ok = ok and good
        shown[name] = {"value": val, "limit": limit}
    return ok, shown
