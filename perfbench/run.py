"""The benchmark of ``repro_torch``'s Parallel ADMM GCN trainer: one run of
one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell's workload, configuration and
metrics are found by name (``BENCHMARK.json``, ``perfbench/workloads/``,
``perfbench/configs/``, ``perfbench/metrics/``).  Needs as many CUDA cards
as the cell asks for.  The last line of standard output is the result as
one JSON object; the numbers compared, each with its limit, are the last
lines of standard error.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
sys.path.insert(0, str(ROOT / "src"))

# Python's bytecode goes to a cache inside the checkout, at a fixed path,
# also where the environment says not to write it beside the sources: only
# a checkout's first run then compiles the modules that it imports (torch's
# take seconds).  Processes it spawns inherit the setting.
PYCACHE = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
sys.pycache_prefix = PYCACHE
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE

import torch  # noqa: E402

T_TORCH = time.time()

import driver  # noqa: E402

T_HARNESS = time.time()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {ROOT}: run from the root of a "
              f"checkout", file=sys.stderr)
        return 2
    spec = driver.cell_spec(ROOT, args.workload)
    chips = spec["entry"]["chips"]
    t = time.time()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards; {torch.cuda.device_count()} "
              f"available", file=sys.stderr)
        return 3
    # the parts of the start, shown beside the other spans
    marks = {"start.import_torch": T_TORCH - T_START,
             "start.import_harness": T_HARNESS - T_TORCH,
             "start.cuda_check": time.time() - t}
    result = driver.execute(spec, args.seed, args.seconds,
                            bool(args.trace), T_START,
                            log=lambda s: print(s, file=sys.stderr),
                            marks=marks)
    banned = result.pop("banned")
    if banned:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(banned), file=sys.stderr)
        return 4
    for line in driver.verdict_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
