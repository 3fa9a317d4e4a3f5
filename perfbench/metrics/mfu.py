"""mfu: the useful operations of one Parallel ADMM iteration
(``counts.admm_iteration_flops``) over epoch_ms times the card's FP32
peak (the configuration computes in float32 with TF32 off)."""
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
