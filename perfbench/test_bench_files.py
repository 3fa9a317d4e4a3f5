"""Every configuration, workload and metric file of BENCHMARK.json is found
by name and keeps to the allowed characters; the harness loads no module
of JAX or of the JAX package; a directory that holds only the benchmark
refuses to run."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(entry):
    assert NAME.match(entry["name"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert 1 <= len(entry["source"]) <= 200
    assert cfg["layer_dims"][0] == cfg["graph"]["features"]
    assert cfg["layer_dims"][-1] == cfg["graph"]["classes"]


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_workload_file(entry):
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key])
    assert entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    wl = json.loads((HERE / "workloads" / f"{entry['name']}.json")
                    .read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert wl["processes"] in (1, entry["chips"])
    assert set(wl["limits"]) >= {"init_err", "agg_err", "iter_err"}


@pytest.mark.parametrize("entry", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_file(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    import driver
    assert callable(driver.reader(entry["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if "moves" in entry:
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
        assert set(entry["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert not banned & set(_imports(path))


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "counts.py"):
        assert "repro_torch" not in set(_imports(HERE / name))


def test_loaded_modules_hold_no_jax():
    code = ("import sys; sys.path[:0] = ['perfbench', 'src']; "
            "import driver, control, faults, program; "
            "import repro_torch.core.parallel, repro_torch.launch.mesh; "
            "print(driver.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_refuses_to_run_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
