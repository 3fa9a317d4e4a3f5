"""Plain float32 reference of one Parallel ADMM iteration (Algorithm 1 of
arXiv:2112.09335), written from the paper's equations in node order.

It imports only numpy and torch.  From the shared inputs (the graph, the
community assignment and the seed) it works out everything again itself:
the normalised adjacency Ã = (D+I)^-1/2 (A+I) (D+I)^-1/2 as a sparse
matrix of its nonzeros, each community's nodes and its neighbour
communities, the Glorot weights and the first iterates (the GCN's forward
pass).  Community m owns the nodes whose id is m; its neighbours N_m are
the communities with an edge into m, m included.

One iteration from (W, Z, U, τ, θ):

* W update, every layer from Z^k (eq. 2): one majorise-minimise step on
  the whole graph's objective, τ halved as a warm start and doubled until
  the quadratic bound holds.
* Z update, every hidden layer and every community on its own (eq. 5/6 and
  8-10): the community's own residual plus the terms of its neighbours'
  rows, in which its block of Z is replaced by the candidate, with a θ
  search of its own.
* Z_L, every community on its own: FISTA with Lipschitz backtracking on
  cross-entropy + <U, Z - B> + ρ/2 ||Z - B||² (eq. 7).
* U += ρ (Z_L - Ã Z_{L-1} W_L) (eq. 3).

Each product with Ã keeps the association (Ã Z) W and runs over Ã's
nonzeros (CSR), so that no N x N matrix is formed: the reference judges a
graph whose dense Ã would not fit on the card.  The acceptance tests
carry the relative slack ``backtrack_rtol`` of the configuration.  With
``tf32=True`` every matrix product runs in TF32 instead: that is the
control, the precision one step below the configuration's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Admm:
    nu: float
    rho: float
    tau_init: float
    backtrack_growth: float
    max_backtracks: int
    fista_iters: int
    backtrack_rtol: float


@dataclasses.dataclass
class State:
    """Iterates in node order: weights[l] (C_l, C_l+1); zs[l] (N, C_l+1);
    u (N, C_L); taus[l] 0-dim; thetas[l] (M,)."""
    weights: list
    zs: list
    u: Tensor
    taus: list
    thetas: list


@dataclasses.dataclass
class Problem:
    dims: tuple
    admm: Admm
    a: Tensor                # (N, N) Ã, sparse CSR
    x: Tensor                # (N, C0) features
    labels: Tensor           # (N,) int64
    train: Tensor            # (N,) f32 0/1
    denom: Tensor            # 0-dim: number of training nodes
    lanes: list              # per community: its node ids (ascending)
    rows: list               # per community: node ids of N_m's communities
    coupling: list           # per community: Ã[rows_m][:, lanes_m], CSR
    tf32: bool = False

    @property
    def num_parts(self) -> int:
        return len(self.lanes)


def adjacency_entries(num_nodes: int, edges: np.ndarray, device
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """(rows, cols, values) of Ã's nonzeros from an edge list, on
    ``device``, in row-major order: each edge once in each direction
    however often the list repeats it, a self loop of the list dropped
    before the degree is taken, d = (row sum + 1)^-1/2, and each value
    a_ij · d_i · d_j with the unit diagonal."""
    n = int(num_nodes)
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64),
                        device=device).reshape(-1, 2)
    u, v = e[:, 0], e[:, 1]
    # each entry (i, j) by its row-major key i · N + j, each key once: a
    # self loop of the list is the diagonal's own key
    loops = torch.arange(n, device=device) * (n + 1)
    key = torch.unique(torch.cat([u * n + v, v * n + u, loops]))
    rows, cols = key // n, key % n
    # a row's entries: its row sum in A plus the unit diagonal
    d = torch.rsqrt(torch.bincount(rows, minlength=n).to(torch.float32))
    # a_ij = 1: (a_ij · d_i) · d_j is d_i · d_j, rounded once
    return rows, cols, d[rows] * d[cols]


def _csr(rows: Tensor, cols: Tensor, values: Tensor, shape) -> Tensor:
    """A CSR matrix of ``shape`` from row-major entries."""
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow, cols, values, tuple(shape),
                                   check_invariants=True)


def normalized_adjacency(num_nodes: int, edges: np.ndarray,
                         device) -> Tensor:
    """Ã from an edge list, on ``device``, as a sparse CSR matrix."""
    n = int(num_nodes)
    return _csr(*adjacency_entries(n, edges, device), (n, n))


def _block(rows: Tensor, cols: Tensor, values: Tensor, keep_rows: Tensor,
           keep_cols: Tensor) -> Tensor:
    """Ã[keep_rows][:, keep_cols] (boolean masks over the nodes) as CSR,
    its rows and columns in node order."""
    kept = keep_rows[rows] & keep_cols[cols]
    row_at = torch.cumsum(keep_rows.to(torch.int64), 0) - 1
    col_at = torch.cumsum(keep_cols.to(torch.int64), 0) - 1
    shape = (int(keep_rows.sum()), int(keep_cols.sum()))
    return _csr(row_at[rows[kept]], col_at[cols[kept]], values[kept], shape)


def build_problem(graph, part: np.ndarray, dims, admm: Admm, device,
                  tf32: bool = False) -> Problem:
    n = graph.num_nodes
    part = np.asarray(part)
    m = int(part.max()) + 1
    entries = adjacency_entries(n, graph.edges, device)
    a = _csr(*entries, (n, n))
    e = np.asarray(graph.edges)
    nbr = np.eye(m, dtype=bool)
    nbr[part[e[:, 0]], part[e[:, 1]]] = True
    nbr[part[e[:, 1]], part[e[:, 0]]] = True
    lanes, rows, coupling = [], [], []
    for c in range(m):
        in_lane, in_rows = part == c, nbr[c][part]
        lanes.append(torch.as_tensor(np.flatnonzero(in_lane), device=device))
        rows.append(torch.as_tensor(np.flatnonzero(in_rows), device=device))
        coupling.append(_block(*entries,
                               torch.as_tensor(in_rows, device=device),
                               torch.as_tensor(in_lane, device=device)))
    return Problem(
        dims=tuple(dims), admm=admm, a=a,
        x=torch.as_tensor(graph.features, device=device),
        labels=torch.as_tensor(graph.labels.astype(np.int64), device=device),
        train=torch.as_tensor(graph.train_mask.astype(np.float32),
                              device=device),
        denom=torch.tensor(float(graph.train_mask.sum()), device=device),
        lanes=lanes, rows=rows, coupling=coupling, tf32=tf32)


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``tf32``) or in true float32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _tf32(x: Tensor) -> Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), with the
    gradient passed straight through: the rounding cuBLAS applies to a
    product's operands, for the control on a device without TF32."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def mm(p: Problem, a: Tensor, b: Tensor) -> Tensor:
    """a @ b in the problem's precision.  A dense product's control TF32 is
    emulated on the CPU by rounding the operands, and on the card
    ``precision`` sets it.  A sparse ``a`` (Ã or a block of it) runs in
    float32 on every device (cuSPARSE does not follow ``allow_tf32``), so
    the control rounds its values and ``b`` itself."""
    if a.layout == torch.sparse_csr:
        if p.tf32:
            a = torch.sparse_csr_tensor(
                a.crow_indices(), a.col_indices(), _tf32(a.values()),
                a.shape, check_invariants=True)
            b = _tf32(b)
        return a @ b
    if p.tf32 and a.device.type == "cpu":
        return _tf32(a) @ _tf32(b)
    return a @ b


def aggregate(p: Problem, z: Tensor) -> Tensor:
    """Ã Z."""
    with precision(p.tf32):
        return mm(p, p.a, z)


def glorot(dims, seed: int) -> list:
    """Glorot-normal weights drawn on the host from ``seed``: W_l is
    sqrt(2 / (C_l + C_l+1)) times a standard normal (C_l, C_l+1) draw, in
    layer order from one generator."""
    gen = torch.Generator().manual_seed(int(seed))
    out = []
    for c_in, c_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((c_in, c_out), generator=gen, dtype=torch.float32)
        out.append(math.sqrt(2.0 / (c_in + c_out)) * w)
    return out


def init_state(p: Problem, seed: int) -> State:
    """Glorot weights, Z from the forward pass, U = 0, τ and θ at
    ``tau_init``."""
    dev = p.x.device
    ws = [w.to(dev) for w in glorot(p.dims, seed)]
    zs, z = [], p.x
    with precision(p.tf32):
        for l, w in enumerate(ws):
            z = mm(p, mm(p, p.a, z), w)
            if l < len(ws) - 1:
                z = torch.relu(z)
            zs.append(z)
    t0 = p.admm.tau_init
    return State(ws, zs, torch.zeros_like(zs[-1]),
                 [torch.tensor(t0, device=dev) for _ in ws],
                 [torch.full((p.num_parts,), t0, device=dev) for _ in zs])


def _value_and_grad(fn, x: Tensor):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        val = fn(xg)
        (grad,) = torch.autograd.grad(val, xg)
    return val.detach(), grad


def _search(accepted, step: Tensor, admm: Admm) -> Tensor:
    """The first of step, 2 step, 4 step, ... that ``accepted`` takes (at
    most ``max_backtracks`` doublings)."""
    for _ in range(admm.max_backtracks):
        if bool(accepted(step)):
            break
        step = step * admm.backtrack_growth
    return step


def mm_step(obj, x: Tensor, step0: Tensor, admm: Admm
            ) -> tuple[Tensor, Tensor]:
    """x - ∇obj/s for the first s from max(step0 / growth, 1e-8) upward
    with obj(x - ∇obj/s) <= obj(x) - ||∇obj||² / (2 s) + slack."""
    val, grad = _value_and_grad(obj, x)
    g_sq = torch.sum(grad * grad)

    def accepted(s):
        bound = val - 0.5 * g_sq / s
        tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
        return obj(x - grad / s) <= bound + tol

    step = torch.clamp(step0 / admm.backtrack_growth, min=1e-8)
    with torch.no_grad():
        step = _search(accepted, step, admm)
    return x - grad / step, step


def fista(p: Problem, c: int, b: Tensor, u: Tensor, z0: Tensor) -> Tensor:
    """Eq. (7) on community c's rows by FISTA with Lipschitz backtracking
    (the constant starts at ρ + 1 and shrinks by 0.9 after each step)."""
    admm, lane = p.admm, p.lanes[c]
    lab, mask = p.labels[lane][:, None], p.train[lane]

    def obj(z):
        nll = -torch.gather(torch.log_softmax(z, dim=-1), -1, lab)[:, 0]
        r = z - b
        return (torch.sum(nll * mask) / p.denom + torch.sum(u * r)
                + 0.5 * admm.rho * torch.sum(r * r))

    dev = z0.device
    z = y = z0
    t = torch.tensor(1.0, device=dev)
    lip = torch.tensor(admm.rho + 1.0, device=dev)
    for _ in range(admm.fista_iters):
        val, g = _value_and_grad(obj, y)
        g_sq = torch.sum(g * g)

        def accepted(s, y=y, g=g, val=val, g_sq=g_sq):
            bound = val - 0.5 * g_sq / s
            tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
            return obj(y - g / s) <= bound + tol

        with torch.no_grad():
            lip = _search(accepted, lip, admm)
            z_new = y - g / lip
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            y = z_new + ((t - 1.0) / t_new) * (z_new - z)
            z, t, lip = z_new, t_new, lip * 0.9
    return z


@torch.no_grad()
def iteration(p: Problem, s: State) -> tuple[State, dict]:
    """One ADMM iteration from ``s``; also returns the aggregates it
    formed: {"in": [Ã Z_l^k for the layer inputs], "pen": Ã Z_{L-1}^{k+1}}."""
    with precision(p.tf32):
        return _iteration(p, s)


def _iteration(p: Problem, s: State) -> tuple[State, dict]:
    admm, n_l = p.admm, len(p.dims) - 1
    f = torch.relu
    inputs = [p.x] + list(s.zs[:-1])
    aggs = [mm(p, p.a, z) for z in inputs]

    # W update (Line 3): every layer from Z^k
    new_ws, new_taus = [], []
    for l in range(n_l):
        agg, z = aggs[l], s.zs[l]
        if l < n_l - 1:
            def obj(w, agg=agg, z=z):
                r = z - f(mm(p, agg, w))
                return 0.5 * admm.nu * torch.sum(r * r)
        else:
            def obj(w, agg=agg, z=z):
                r = z - mm(p, agg, w)
                return torch.sum(s.u * r) + 0.5 * admm.rho * torch.sum(r * r)
        w, tau = mm_step(obj, s.weights[l], s.taus[l], admm)
        new_ws.append(w)
        new_taus.append(tau)

    # Z update (Line 4): every hidden layer, community by community, from
    # W^{k+1} and Z^k
    new_zs, new_thetas = [], []
    for l in range(1, n_l):
        target = f(mm(p, aggs[l - 1], new_ws[l - 1]))
        relay = mm(p, aggs[l], new_ws[l])         # each row's Ã Z_l W_{l+1}
        z_out = s.zs[l - 1].clone()
        thetas = s.thetas[l - 1].clone()
        for c in range(p.num_parts):
            lane, rows, blk = p.lanes[c], p.rows[c], p.coupling[c]
            z_c, t_c = target[lane], s.zs[l - 1][lane]
            q, nxt = relay[rows], s.zs[l][rows]
            w_next = new_ws[l]
            u_rows = s.u[rows]

            def obj(z, z_c=z_c, t_c=t_c, q=q, nxt=nxt, blk=blk,
                    w_next=w_next, u_rows=u_rows, l=l):
                r1 = z - z_c
                val = 0.5 * admm.nu * torch.sum(r1 * r1)
                pre = q + mm(p, blk, mm(p, z - t_c, w_next))
                if l + 1 < n_l:
                    r2 = nxt - f(pre)
                    return val + 0.5 * admm.nu * torch.sum(r2 * r2)
                r2 = nxt - pre
                return (val + torch.sum(u_rows * r2)
                        + 0.5 * admm.rho * torch.sum(r2 * r2))

            z_new, theta = mm_step(obj, t_c, s.thetas[l - 1][c], admm)
            z_out[lane] = z_new
            thetas[c] = theta
        new_zs.append(z_out)
        new_thetas.append(thetas)

    # Z_L: FISTA, community by community
    b = mm(p, aggs[n_l - 1], new_ws[-1])
    z_last = s.zs[-1].clone()
    for c in range(p.num_parts):
        lane = p.lanes[c]
        z_last[lane] = fista(p, c, b[lane], s.u[lane], s.zs[-1][lane])
    new_zs.append(z_last)
    new_thetas.append(s.thetas[-1].clone())

    # dual ascent (Line 5)
    pen = mm(p, p.a, new_zs[n_l - 2]) if n_l >= 2 else aggs[0]
    u = s.u + admm.rho * (new_zs[-1] - mm(p, pen, new_ws[-1]))
    out = State(new_ws, new_zs, u, new_taus, new_thetas)
    return out, {"in": aggs, "pen": pen}
