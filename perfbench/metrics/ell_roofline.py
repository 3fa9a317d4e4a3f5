"""ell_roofline: the least time the card needs for the aggregations of the
traced steps, over the device time of the ELL kernels that did them
(profiler trace).  The need is counted from the inputs: 2 · nnz(Ã) ·
width operations, and Z read once, the output written once and each
nonzero's value and index read once (``counts.aggregation``), whatever
the kernel multiplies; Ã X, the same in every step, is not needed again
(``counts.step_aggregation_widths``).  Silent where no ELL kernel ran."""
import counts

KERNEL = "ell_spmm_kernel"


def read(run):
    tr, peaks = run["trace"], run["peaks"]
    if tr is None or peaks is None:
        return None
    spent = sum(s for name, (_, s) in tr["kernels"].items() if KERNEL in name)
    if spent <= 0:
        return None
    g = run["graph"]
    need = tr["steps"] * counts.aggregation_bound_s(
        g["n"], g["nnz"], run["dims"], peaks["fp32_flops"],
        peaks["hbm_bytes_per_s"])
    return 100.0 * need / spent
