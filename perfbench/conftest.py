"""Shared set-up of the benchmark's own tests (``python -m pytest
perfbench``): the harness's modules and ``src`` on the path, and the
cells at a size a CPU test holds."""
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cell whose files are here but that BENCHMARK.json does not run yet
# (PERF.md, Open questions): its spec is the one-card Computers cell's with
# its own workload file
HELD_BACK = {"computers-admm-4gpu": "computers-admm-1gpu"}


def small_spec(cell: str, nodes: int = 400, dims=None) -> dict:
    """The cell's spec with its graph cut to ``nodes`` nodes (and, with
    ``dims``, other widths): what the CPU tests run."""
    import driver
    spec = driver.cell_spec(ROOT, HELD_BACK.get(cell, cell))
    if cell in HELD_BACK:
        spec["workload"] = json.loads(
            (HERE / "workloads" / f"{cell}.json").read_text())
    g = spec["config"]["graph"]
    g.update(nodes=nodes, avg_degree=16.0, train=nodes // 4,
             test=nodes // 4)
    if dims is not None:
        spec["config"]["layer_dims"] = list(dims)
        g["features"], g["classes"] = dims[0], dims[-1]
    return spec
