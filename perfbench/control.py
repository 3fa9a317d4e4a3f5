"""Readings that set the limits of ``correct``: the control and the faults,
at a cell's own size, one seed after another.  The benchmark's own runs
never run this.

    python3 perfbench/control.py --workload <cell> --mode tf32 \
        --seeds 11 12 13
    python3 perfbench/control.py --workload <cell> --mode half_batch \
        --seeds 11 12 13

``tf32``: the reference put in the program's place, every product in
TF32 (the precision one step below the configuration's float32 with TF32
off): its own first iterates, its own three steps and its own
aggregates, judged by ``check.judge`` against the float32 reference as
the program is.  A fault mode (``faults.FAULTS``): the program with that
fault planted, through the whole run with a one-second window.  Prints a
JSON line per seed and, last, each number's least and largest reading.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import check  # noqa: E402
import driver  # noqa: E402
import faults  # noqa: E402
import reference  # noqa: E402


def control_numbers(spec: dict, seed: int, device, tf32: bool = True
                    ) -> dict:
    """The reference in ``tf32`` in the program's place, judged."""
    cfg, wl = spec["config"], spec["workload"]
    graph, part = driver.make_inputs(cfg, wl, seed)
    s = driver.seed_int(seed)
    admm = driver.admm_of(cfg)
    want = reference.build_problem(graph, part, cfg["layer_dims"], admm,
                                   device)
    ctl = reference.build_problem(graph, part, cfg["layer_dims"], admm,
                                  device, tf32=tf32)
    st = reference.init_state(ctl, s)
    ids = np.arange(graph.num_nodes)

    def host(x):
        return {"weights": [w.cpu() for w in x.weights],
                "zs": [z.cpu() for z in x.zs], "u": x.u.cpu(),
                "taus": [t.cpu() for t in x.taus],
                "thetas": [t.cpu() for t in x.thetas]}
    states, calls = [host(st)], []
    for _ in range(wl["checked_steps"]):
        st, aggs = reference.iteration(ctl, st)
        calls.append([(ids, a.cpu()) for a in aggs["in"] + [aggs["pen"]]])
        states.append(host(st))
    del ctl
    return check.judge(want, s, states, calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=["tf32"] + sorted(faults.FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = driver.cell_spec(ROOT, args.workload)
    readings = []
    for seed in args.seeds:
        t = time.time()
        if args.mode == "tf32":
            nums = control_numbers(spec, seed, torch.device(args.device))
        else:
            res = driver.execute(spec, seed, 1.0, False, time.time(),
                                 hook=faults.FAULTS[args.mode],
                                 log=lambda s: print(s, file=sys.stderr))
            nums = {k: v["value"] for k, v in res["checks"].items()}
        readings.append(nums)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "seconds": time.time() - t,
                          "numbers": nums}), flush=True)
    span = {k: [min(r[k] for r in readings), max(r[k] for r in readings)]
            for k in readings[0]}
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "seeds": args.seeds, "least_largest": span}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
