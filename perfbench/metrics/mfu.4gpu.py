"""mfu.4gpu: the useful operations of one Parallel ADMM iteration
(``counts.admm_iteration_flops``, the whole graph's) over epoch_ms.4gpu
times the FP32 peak of all the cards the ranks use."""
import counts


def read(run):
    if run["peaks"] is None:
        return None
    g = run["graph"]
    flops = counts.admm_iteration_flops(g["n"], g["nnz"], run["dims"],
                                        g["coupling_rows"],
                                        run["fista_iters"])
    epoch = run["window_s"] / run["steps"]
    return 100.0 * flops / (epoch * run["chips"] * run["peaks"]["fp32_flops"])
