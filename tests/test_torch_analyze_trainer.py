"""The port's trainer analysis against the JAX package's.

One subprocess (JAX needs ``XLA_FLAGS`` before it is imported) builds the
reference's ``launch/analyze.py`` trainers on four forced host devices and
writes each one's ``trainer_expectations``; the port builds the same
configs over four loopback shards of the CPU.  Every expectation the
reference computes from host data is equal, the kernel entries' tables
too (the port's packed tables hold row offsets where the reference's hold
8-row offsets: equal after ``// 8`` on live slots).

Then, on the port alone: one recorded step of every config has zero error
findings, and the rules that fire are the reference's report's
(``BENCH_analysis.json``, written by the reference's CLI) under the id map;
the p2p proof fires on the all-gather trainer's trace held to the p2p
trainer's expectations; the fused rule fires on the unfused trainer held to
the fused contract; the minibatch schedule rule fires against the full
plan; a held state fails the donation rule; and the serving hit and halo
paths are collective-free.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import analysis
from repro_torch.analysis.trace import record
from repro_torch.launch import analyze

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = [c["name"] for c in analyze.FULL_CONFIGS]
SPECS = {c["name"]: c for c in analyze.FULL_CONFIGS}

_WORKER = r"""
import json, sys
import numpy as np
from repro.analysis import trainer_expectations
from repro.launch import analyze

def plain(v):
    if isinstance(v, (tuple, list)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v

out = {}
for spec in analyze.FULL_CONFIGS:
    exp = trainer_expectations(analyze._build_trainer(spec))
    kernels = exp.pop("kernels", None)
    exp = plain(exp)
    if kernels is not None:
        exp["kernels"] = [{"name": k["spec"].name,
                           "scalars": plain(dict(k["scalars"]))}
                          for k in kernels]
    out[spec["name"]] = exp
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("WORKER_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "expectations.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(path)],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=600)
    assert "WORKER_OK" in proc.stdout, proc.stdout + proc.stderr
    return json.loads(path.read_text())


def _plain(v):
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


@pytest.mark.parametrize("name", NAMES)
def test_expectations_equal_the_reference(reference, name):
    ref = reference[name]
    exp = analysis.trainer_expectations(
        analyze.build_trainer(SPECS[name], "cpu"))
    kernels = exp.pop("kernels", None)
    ref_kernels = ref.pop("kernels", None)
    assert _plain(exp) == ref
    assert (kernels is None) == (ref_kernels is None)
    for ours, theirs in zip(kernels or (), ref_kernels or ()):
        assert ours["spec"].name == theirs["name"]
        got = {k: np.asarray(v) for k, v in ours["scalars"].items()}
        want = {k: np.asarray(v) for k, v in theirs["scalars"].items()}
        if "ell_offsets8" in want:
            off, live = got.pop("ell_offsets"), got["ell_mask"] != 0
            assert (off[live] % 8 == 0).all()
            got["ell_offsets8"] = np.where(live, off // 8, 0)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(kernels or ()) == len(ref_kernels or ())


@pytest.fixture(scope="module")
def reports():
    out = {r.config: r for r in analyze.run_configs(analyze.FULL_CONFIGS,
                                                    "cpu")}
    out.update({r.config: r for r in analyze.run_serving_configs(
        device="cpu")})
    return out


@pytest.mark.parametrize("name", NAMES + analyze.SERVE_CONFIGS)
def test_zero_error_findings_and_the_references_rules_fire(reports, name):
    rep = reports[name]
    assert not rep.errors(), rep.summary()
    assert len(rep.rules_run) == len(analysis.all_rules())
    ref = next(r for r in json.loads(
        (ROOT / "BENCH_analysis.json").read_text())["reports"]
        if r["config"] == name)
    assert {analysis.reference_id(f.rule) for f in rep.findings} == {
        f["rule"] for f in ref["findings"]}


def test_cli_writes_its_report(tmp_path):
    out = tmp_path / "a.json"
    assert analyze.main(["--quick", "--device", "cpu", "--config",
                         "p2p_packed", "--config", "serve_hit", "--out",
                         str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["errors"] == 0 and blob["n_shards"] == analyze.N_SHARDS
    assert [r["config"] for r in blob["reports"]] == ["p2p_packed",
                                                      "serve_hit"]


def test_p2p_proof_fires_on_the_allgather_trace():
    """The all-gather trainer's step held to the p2p trainer's contract
    trips exactly the transport rules; the p2p step passes them."""
    p2p = analyze.build_trainer(SPECS["p2p_bucketed"], "cpu")
    ag = analyze.build_trainer(SPECS["allgather_bucketed"], "cpu")
    rep = analysis.analyze_trainer(p2p, config="p2p-proof")
    assert analysis.no_findings(rep, rule="collective/no-allgather-under-p2p")
    assert analysis.no_findings(rep, rule="collective/permute-schedule")
    with record() as tape:
        ag.step()
    bad = analysis.analyze_trace(tape, analysis.trainer_expectations(p2p))
    assert bad.findings_for("collective/no-allgather-under-p2p")
    assert bad.findings_for("collective/permute-schedule")
    assert bad.findings_for("collective/payload-budget")


def test_fused_rule_fires_on_the_unfused_step():
    fu = analyze.build_trainer(SPECS["p2p_fused"], "cpu")
    un = analyze.build_trainer(SPECS["p2p_packed"], "cpu")
    tape, exp = analysis.record_step(un)
    assert not exp["fused"]
    held = dict(exp, fused=True,
                fused_max_agg_handoffs=fu.cfg.num_layers)
    hits = analysis.analyze_trace(tape, held).findings_for(
        "memory/fused-no-intermediate")
    assert hits and hits[0].details["count"] == fu.cfg.num_layers + 1
    tape_f, exp_f = analysis.record_step(fu)
    from repro_torch.analysis.rules.memory import fused_agg_handoffs
    assert len(fused_agg_handoffs(tape_f, exp_f["n_pad"])) == \
        fu.cfg.num_layers


def test_minibatch_step_runs_the_sampled_sub_plan():
    mb = analyze.build_trainer(SPECS["p2p_minibatch"], "cpu")
    tape, exp = analysis.record_step(mb)
    sub = {frozenset(r) for r in exp["round_pairs"]}
    full = {frozenset(r.pairs) for r in mb._plan.rounds}
    assert sub != full
    assert not analysis.analyze_trace(tape, exp).errors()
    wrong = dict(exp, round_pairs=[tuple(r.pairs) for r in mb._plan.rounds])
    assert analysis.analyze_trace(tape, wrong).findings_for(
        "collective/permute-schedule")


def test_a_held_state_fails_the_donation_rule():
    tr = analyze.build_trainer(SPECS["p2p_packed"], "cpu")
    held = tr.state                                   # noqa: F841
    rep = analysis.analyze_trainer(tr)
    hits = rep.findings_for("memory/donated-inputs")
    assert [f.details["expected"] for f in hits] == [".zs", ".u"]
    assert hits[0].details["undonated"] == ["[0].zs[0]", "[0].zs[1]"]


def test_serving_traces_are_collective_free():
    srv = analyze.build_server("cpu")
    hit, halo = srv.hit_path_trace(bucket=64), srv.halo_path_trace(layer=1)
    assert {e.kind for e in hit} == {"op"}
    assert max(t.shape[0] for t in hit.tensors().values()) < \
        srv.dl.plane_rows
    assert {e.kind for e in halo} == {"op", "kernel"}
    assert [e.name for e in halo.of_kind("kernel")] == [
        "community_spmm_ell_packed"]
    # a transport inside either would trip the rule
    with record() as tape:
        from repro_torch.core import messages
        import torch
        messages.allgather(torch.ones(2, 4, 3))
    assert analysis.analyze_trace(tape, {"expect_zero_collectives": True}
                                  ).findings_for(
        "collective/zero-collectives")
