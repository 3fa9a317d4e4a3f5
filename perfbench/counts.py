"""What one Parallel ADMM iteration needs, counted from its inputs: the
operations and bytes of an aggregation Ã Z by the nonzeros of Ã, and the
useful operations of the whole iteration.  Nothing here depends on how
the program stores Ã (dense community blocks, ELL slots or anything
else): a kernel that skips zeros is held to the same count as one that
multiplies them.

``admm_iteration_flops`` is derived once from the iteration of
``reference.py`` (the paper's Algorithm 1) and frozen.  It counts every
site once: each product with Ã by nonzeros (2 · nnz · width), each dense
product by its shape (2 · rows · inner · outer), each elementwise site at
a fixed number of operations per element.  A line search counts its
objective and gradient and its first probe; the probes after the first
repeat the same work at another step size and are not counted, as a
recomputation is not counted in a model-FLOPs share.  For the same
reason Ã X is not counted: neither Ã nor the features X change from one
iteration to the next, so the product is needed once, not each step.
"""
from __future__ import annotations

F32 = 4            # bytes of a float32 value
INDEX = 4          # bytes of an int32 column index or row pointer

# operations per element of the elementwise sites (forward; a gradient
# costs the same again)
EW_HIDDEN = 5      # f(P), z - f(P), its square, the sum, the scale
EW_LAST = 6        # z - P, u * r, r * r, two sums, the scale
EW_COUPLE = 6      # the Z objective's residuals and sums per row
EW_CE = 20         # log-softmax, the picked term, the masked sum, <U, r>, ρ/2 r²
EW_STEP = 3        # x - g / s and its norm


def aggregation(rows: int, nnz: int, width: int) -> tuple[float, float]:
    """(FLOPs, bytes) of Ã Z over ``rows`` output rows that hold ``nnz``
    nonzeros of Ã, Z ``width`` wide: a multiply and an add per nonzero and
    column; Z's rows read once, the output written once, each nonzero's
    value and column index and each row's pointer read once."""
    flops = 2.0 * nnz * width
    nbytes = (2.0 * rows * width * F32 + nnz * (F32 + INDEX)
              + (rows + 1) * INDEX)
    return flops, nbytes


def step_aggregation_widths(dims) -> list[int]:
    """The widths of the products with Ã one iteration needs: Ã Z_l for
    every layer input that changes (Z_1 ... Z_{L-1}; Ã X is the same in
    every iteration) and Ã Z_{L-1}^{k+1} for the dual update."""
    dims = list(dims)
    return dims[1:-1] + [dims[-2]]


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bw: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bw)


def aggregation_bound_s(rows: int, nnz: int, dims, peak_flops: float,
                        peak_bw: float) -> float:
    """Σ of the bounds of one iteration's aggregations."""
    return sum(bound_s(*aggregation(rows, nnz, w), peak_flops, peak_bw)
               for w in step_aggregation_widths(dims))


def admm_iteration_flops(n: int, nnz: int, dims, coupling_rows: int,
                         fista_iters: int) -> float:
    """Useful FLOPs of one iteration on N = ``n`` nodes, Ã with ``nnz``
    nonzeros, layer widths ``dims`` = (C_0, ..., C_L), and
    ``coupling_rows`` = Σ over communities m of the rows of m's neighbour
    communities (the rows each Z objective sums over)."""
    c = list(dims)
    n_l = len(c) - 1
    total = 0.0
    # products with Ã: every layer input but X, and the dual's Ã Z_{L-1}^{k+1}
    for w in step_aggregation_widths(c):
        total += aggregation(n, nnz, w)[0]
    # W update of each layer: objective, gradient, first probe
    for l in range(n_l):
        gemm = 2.0 * n * c[l] * c[l + 1]
        ew = (EW_HIDDEN if l < n_l - 1 else EW_LAST) * n * c[l + 1]
        total += 3 * (gemm + ew) + EW_STEP * c[l] * c[l + 1]
    # Z update of each hidden layer l (width C_l), next layer C_{l+1}
    for l in range(1, n_l):
        total += 2.0 * n * c[l - 1] * c[l] + n * c[l]         # target
        total += 2.0 * n * c[l] * c[l + 1]                    # relay
        obj = (2.0 * n * c[l] * c[l + 1]                      # (z - Z) W
               + 2.0 * nnz * c[l + 1]                         # Ã_{r,m} ·
               + EW_COUPLE * (n * c[l] + coupling_rows * c[l + 1]))
        total += 3 * obj + EW_STEP * n * c[l]
    # Z_L: B = Ã Z_{L-1} W_L, then FISTA's iterations
    total += 2.0 * n * c[-2] * c[-1]
    total += fista_iters * (3 * EW_CE + 2 * EW_STEP) * n * c[-1]
    # dual: (Ã Z_{L-1}^{k+1}) W_L and U + ρ (Z_L - ·)
    total += 2.0 * n * c[-2] * c[-1] + 3.0 * n * c[-1]
    return total
