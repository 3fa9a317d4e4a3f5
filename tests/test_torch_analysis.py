"""repro_torch.analysis unit tests: each rule fires on a deliberately
broken trace and stays silent on the blessed pattern — every case of
tests/test_analysis.py (and the packed-state and fused rule cases of
tests/test_packed_state.py and tests/test_fused.py), on hand-built op
traces in place of canned HLO, and on real launch specs in place of
Pallas kernel specs.  The registry maps one to one onto the reference's
rule ids, and a report's JSON has the reference's shape.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import analysis as janalysis
from repro.analysis import findings as jfindings
from repro_torch import analysis
from repro_torch.analysis.findings import Finding, Severity, Waiver, \
    apply_waivers
from repro_torch.analysis.rules.kernel import (SMEM_BYTES,
                                               check_copy_alignment,
                                               check_kernel_bounds,
                                               check_kernel_smem)
from repro_torch.analysis.rules.memory import fused_agg_handoffs
from repro_torch.analysis.rules.precision import check_trace_precision
from repro_torch.analysis.trace import Event, TensorMeta, Trace, record
from repro_torch.kernels import community_spmm as cs


def T(i, shape, dtype="float32", device="cpu"):
    return TensorMeta(i, tuple(shape), dtype, device)


def op(name, ins=(), outs=(), **kw):
    return Event("op", name, tuple(ins), tuple(outs), **kw)


def lint(events, **exp):
    return analysis.analyze_trace(Trace(list(events)), exp)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_lists_all_families():
    rules = analysis.all_rules()
    assert {r.family for r in rules} == {"collective", "memory",
                                          "precision", "kernel"}
    assert len({r.id for r in rules}) == len(rules)
    assert all(r.doc for r in rules), "every rule carries a docstring"


def test_rule_ids_map_one_to_one_onto_the_reference():
    ours = {analysis.reference_id(r.id) for r in analysis.all_rules()}
    assert ours == {r.id for r in janalysis.all_rules()}
    assert len(ours) == len(analysis.all_rules())
    # the catalogue in the package docstring names every rule
    for r in analysis.all_rules():
        assert r.id in analysis.__doc__, r.id


def test_rules_skip_on_empty_context():
    for tape in (None, Trace()):
        rep = analysis.analyze_trace(tape, expectations={})
        assert rep.findings == []
        assert len(rep.rules_run) == len(analysis.all_rules())


# ---------------------------------------------------------------------------
# collective rules
# ---------------------------------------------------------------------------


def _allgather():
    return Event("allgather", "allgather", (T(0, (8, 16, 4)),),
                 (T(1, (8, 16, 4)),),
                 info={"rounds": (((), 8, 2048),), "itemsize": 4})


def _exchange(*pair_sets, rows=4, nbytes=64):
    return Event("exchange", "exchange", (T(0, (8, 16, 4)),),
                 (T(1, (4, 2, 16, 4)),),
                 info={"rounds": tuple((p, rows, nbytes) for p in pair_sets),
                       "itemsize": 4})


def test_no_allgather_fires_only_under_p2p():
    bad = lint([_allgather()], transport="p2p")
    assert bad.findings_for("collective/no-allgather-under-p2p")
    ok = lint([_allgather()], transport="allgather")
    assert not ok.findings_for("collective/no-allgather-under-p2p")


def test_zero_collectives():
    for ev in (_allgather(), _exchange(((0, 1),)),
               Event("shard_sum", "shard_sum", (T(0, ()),), (T(1, ()),))):
        assert lint([ev], expect_zero_collectives=True).findings_for(
            "collective/zero-collectives")
    assert not lint([op("mm", [T(0, (2, 2))], [T(1, (2, 2))])],
                    expect_zero_collectives=True).findings


def test_permute_schedule_matches_host_plan():
    ev = _exchange(((0, 1), (1, 0)))
    ok = lint([ev], round_pairs=[((0, 1), (1, 0))])
    assert not ok.findings_for("collective/permute-schedule")
    # a round the host never scheduled, and a scheduled round that never
    # ran, are both errors
    bad = lint([ev], round_pairs=[((0, 1),), ((1, 0),)])
    msgs = [f.message for f in bad.findings_for(
        "collective/permute-schedule")]
    assert any("not in the host plan" in m for m in msgs)
    assert any("never ran" in m for m in msgs)
    none = lint([op("neg", [T(0, (2,))], [T(1, (2,))])],
                round_pairs=[((0, 1),)])
    assert none.findings_for("collective/permute-schedule")


def test_permute_count_is_a_warning():
    ev = _exchange(((0, 1),), ((1, 0),))
    assert not lint([ev, ev], round_pairs=[((0, 1),), ((1, 0),)],
                    num_gathers=2).findings
    hits = lint([ev], round_pairs=[((0, 1),), ((1, 0),)],
                num_gathers=2).findings_for("collective/permute-count")
    assert hits and hits[0].severity == Severity.WARNING


def test_payload_budget_counts_every_shards_allgather_copy():
    ev = _exchange(((0, 1),), ((1, 0),), nbytes=64)
    assert not lint([ev], collective_budget_bytes=128).findings
    assert lint([ev], collective_budget_bytes=127).findings_for(
        "collective/payload-budget")
    # one all-gather copy of 2048 B reaches each of 4 shards
    assert lint([_allgather()], collective_budget_bytes=8191,
                n_shards=4).findings_for("collective/payload-budget")
    assert not lint([_allgather()], collective_budget_bytes=8192,
                    n_shards=4).findings


def test_allreduce_payload_budget():
    ev = Event("shard_sum", "shard_sum", (T(0, (8, 8)), T(1, (8, 8))),
               (T(2, (8, 8)),))
    assert not lint([ev], allreduce_max_bytes=4096).findings
    assert lint([ev], allreduce_max_bytes=16).findings_for(
        "collective/allreduce-payload")


# ---------------------------------------------------------------------------
# memory rules
# ---------------------------------------------------------------------------


def test_dense_adjacency_intermediate_is_flagged():
    exp = {"n_pad": 16, "lanes": 1, "max_deg": 2, "m_total": 4,
           "n_shards": 1}
    # a computed (4, 16, 16) block stack: 4 blocks > lanes x max_deg = 2
    events = [op("expand", [T(0, (4, 16, 16))], [T(1, (4, 16, 16))])]
    hits = lint(events, **exp).findings_for("memory/no-dense-adjacency")
    assert len(hits) == 1 and hits[0].location == "tensor#1"
    # the input itself is within the full-M ELL store bound (4 x 2 = 8)
    assert not any(f.location == "tensor#0" for f in hits)
    # with 2 shards stacked the computed bound is 2 x 1 x 2 = 4: silent
    assert not lint(events, **dict(exp, n_shards=2)).findings
    # the dense baseline waives the pattern wholesale
    assert not lint(events, **dict(exp, dense_adjacency_allowed=True)
                    ).findings_for("memory/no-dense-adjacency")


def test_packed_resident_state_rule_fires_on_blocked_stacks():
    exp = {"n_pad": 16, "state_packed": True, "packed_rows_bound": 4,
           "n_shards": 1}
    bad = [op("neg", [T(0, (8, 16, 7))], [T(1, (8, 16, 7))])]
    hits = lint(bad, **exp).findings_for("memory/packed-resident-state")
    assert len(hits) == 1 and hits[0].location == "tensor#1"
    assert hits[0].severity == Severity.ERROR
    ok = [op("neg", [T(0, (4, 16, 7))], [T(1, (4, 16, 7))])]
    assert not lint(ok, **exp).findings
    # two shards' receive views stacked: 8 rows allowed
    assert not lint(bad, **dict(exp, n_shards=2)).findings
    assert not lint(bad, **dict(exp, state_packed=False)).findings


def _agg(i, out_id, n_pad=16, c=8):
    spec = cs.ell_packed_spec(2, 2, n_pad, c, 64)
    return Event("kernel", "community_spmm_ell_packed",
                 (T(100 + i, (2, 2, n_pad, n_pad)), T(200 + i, (64, c))),
                 (T(out_id, (2, n_pad, c)),),
                 info={"spec": spec, "route": "plain", "tables": {}})


def test_fused_handoffs_count_distinct_stacks():
    n_pad = 16
    # stack 10 reaches two products through views (counted once); stack 11
    # through the overlap's add; stack 12 feeds no product
    events = [_agg(0, 10), _agg(1, 11), _agg(2, 12),
              op("view", [T(10, (2, 16, 8))], [T(20, (32, 8))]),
              op("mm", [T(20, (32, 8)), T(30, (8, 4))], [T(40, (32, 4))]),
              op("t", [T(20, (32, 8))], [T(21, (8, 32))]),
              op("mm", [T(21, (8, 32)), T(41, (32, 4))], [T(42, (8, 4))]),
              op("add", [T(11, (2, 16, 8)), T(12, (2, 16, 8))],
                 [T(13, (2, 16, 8))]),
              op("_unsafe_view", [T(13, (2, 16, 8))], [T(22, (32, 8))]),
              op("mm", [T(22, (32, 8)), T(30, (8, 4))], [T(43, (32, 4))]),
              # a product's output is no stack: relu of it reaches an mm
              op("relu", [T(40, (32, 4))], [T(44, (32, 4))]),
              op("mm", [T(44, (32, 4)), T(31, (4, 4))], [T(45, (32, 4))])]
    found = fused_agg_handoffs(Trace(events), n_pad)
    assert len(found) == 2
    exp = {"n_pad": n_pad, "fused": True, "fused_max_agg_handoffs": 2,
           "m_total": 2, "max_deg": 2}
    assert not lint(events, **exp).findings
    hits = lint(events, **dict(exp, fused_max_agg_handoffs=1)
                ).findings_for("memory/fused-no-intermediate")
    assert hits and hits[0].details["count"] == 2
    assert not lint(events, **dict(exp, fused=False,
                                   fused_max_agg_handoffs=1)).findings


def test_hbm_budget_and_host_transfer():
    big = [op("exp", [T(0, (1024, 1024))], [T(1, (1024, 1024))])]
    assert lint(big, hbm_intermediate_budget=1 << 20).findings_for(
        "memory/hbm-intermediate-budget")
    assert not lint(big, hbm_intermediate_budget=1 << 23).findings
    # an input over the budget is no intermediate
    assert not lint([op("sum", [T(0, (1024, 1024))], [T(1, ())])],
                    hbm_intermediate_budget=1 << 20).findings

    read = op("_local_scalar_dense", [T(0, ())], host_read=True)
    assert lint([read]).findings_for("memory/host-transfer")
    assert not lint([dataclasses.replace(read, probe="lane-search")]
                    ).findings


def test_recorded_host_reads_are_marked_only_inside_decide():
    from repro_torch.analysis import trace
    x = torch.ones(3)
    with record() as tape:
        trace.decide(x.sum() > 0, "probe")
        bool(x.sum() > 0)
    reads = [e for e in tape if e.host_read]
    assert [e.probe for e in reads] == ["probe", None]
    assert len(lint(tape.events).findings_for("memory/host-transfer")) == 1


def test_no_full_graph_tensors():
    events = [op("index_select", [T(0, (120, 4)), T(1, (64,), "int32")],
                 [T(2, (64, 4))])]
    assert lint(events, full_graph_rows=120).findings_for(
        "memory/no-full-graph-tensors")
    assert not lint(events, full_graph_rows=121).findings


def test_donated_inputs_rule():
    exp = {"expect_donated": (".zs", ".u"),
           "args_donated": {"[0].zs[0]": True, "[0].zs[1]": False,
                            "[0].u": True, "[0].taus[0]": False}}
    hits = lint([], **exp).findings_for("memory/donated-inputs")
    assert len(hits) == 1 and ".zs" in hits[0].message
    assert not lint([], expect_donated=(".zs",),
                    args_donated={"[0].zs[0]": True}).findings
    # a stale expectation (no matching path at all) is a warning
    stale = lint([], expect_donated=(".zq",),
                 args_donated={"[0].zs[0]": True}).findings
    assert stale and stale[0].severity == Severity.WARNING


# ---------------------------------------------------------------------------
# precision rules
# ---------------------------------------------------------------------------


def test_bf16_dot_without_f32_accumulate_is_flagged():
    a, b = T(0, (8, 8), "bfloat16"), T(1, (8, 8), "bfloat16")
    bad = lint([op("mm", [a, b], [T(2, (8, 8), "bfloat16")])])
    assert bad.findings_for("precision/bf16-dot-accumulate")
    # a kernel over bf16 blocks that declares f32 accumulation is blessed
    spec = cs.ell_spec(2, 2, 16, 8, 4, block_bytes=2)
    ev = Event("kernel", spec.name, (T(3, (2, 2, 16, 16), "bfloat16"),),
               (T(4, (2, 16, 8)),), info={"spec": spec, "tables": {}})
    assert not lint([ev]).findings
    narrow = dataclasses.replace(ev, info={
        "spec": dataclasses.replace(spec, accumulate="bfloat16"),
        "tables": {}})
    assert lint([narrow]).findings_for("precision/bf16-dot-accumulate")


def test_bf16_reduce_is_a_warning():
    hits = lint([op("sum", [T(0, (8,), "bfloat16")],
                    [T(1, (), "bfloat16")])]).findings
    assert [f.rule for f in hits] == ["precision/bf16-reduce",
                                      "precision/trace-dataflow"]
    assert all(f.severity == Severity.WARNING for f in hits)


def test_f64_leak_is_flagged_unless_allowed():
    events = [op("_to_copy", [T(0, (4,))], [T(1, (4,), "float64")])]
    assert lint(events).findings_for("precision/no-f64")
    assert not lint(events, allow_f64=True).findings


def test_trace_dataflow_catches_missing_f32_accumulate():
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    with record() as bad:
        a @ a                                       # bf16 accumulate
    findings = check_trace_precision(bad)
    assert any(f.rule == "precision/trace-dataflow"
               and f.severity == Severity.ERROR for f in findings)
    with record() as good:
        a.float() @ a.float()
    assert not check_trace_precision(good)
    with record() as wide:
        torch.ones(3) + torch.ones(3, dtype=torch.float64)
    assert check_trace_precision(wide)
    assert not check_trace_precision(wide, allow_f64=True)


# ---------------------------------------------------------------------------
# kernel rules (grid corners, live table values, shared memory, copies)
# ---------------------------------------------------------------------------


def test_grid_that_misses_the_output_is_flagged():
    spec = cs.ell_spec(2, 2, 256, 256, 8)
    assert not check_kernel_bounds(spec)
    for grid in ((spec.grid[0] - 1,) + spec.grid[1:],
                 (spec.grid[0], spec.grid[1] + 1, spec.grid[2])):
        findings = check_kernel_bounds(dataclasses.replace(spec, grid=grid))
        assert findings and findings[0].rule == "kernel/index-bounds"


def test_oob_table_values_are_flagged():
    # 6 communities but an ELL index pointing at community 9
    spec = cs.ell_spec(2, 2, 16, 16, 6)
    good = {"ell_indices": np.array([[0, 5], [1, 2]], np.int32),
            "ell_mask": np.ones((2, 2), np.int32),
            "row_counts": np.full((2,), 16, np.int32),
            "nbr_counts": np.full((2, 2), 16, np.int32)}
    assert not check_kernel_bounds(spec, good)
    bad = dict(good, ell_indices=np.array([[0, 9], [1, 2]], np.int32))
    findings = check_kernel_bounds(spec, bad)
    assert findings and findings[0].rule == "kernel/index-bounds"
    assert "out of range" in findings[0].message
    assert findings[0].details["index"] == 9
    # a masked slot's index is never read
    masked = dict(bad, ell_mask=np.array([[1, 0], [1, 1]], np.int32))
    assert not check_kernel_bounds(spec, masked)


def test_packed_offsets_past_the_plane_are_flagged():
    # a 64-row plane: slot rows [off, off + nbr_counts) must end inside
    spec = cs.ell_packed_spec(1, 2, 16, 8, 64)
    tables = {"ell_offsets": np.array([[0, 48]], np.int32),
              "ell_mask": np.ones((1, 2), np.int32),
              "row_counts": np.array([16], np.int32),
              "nbr_counts": np.array([[16, 16]], np.int32)}
    assert not check_kernel_bounds(spec, tables)
    over = dict(tables, nbr_counts=np.array([[16, 17]], np.int32))
    hits = check_kernel_bounds(spec, over)
    assert hits and hits[0].details == {
        "table": "ell_offsets", "index": 48, "rows": 17, "extent": [64, 8],
        "bad_slots": 1}
    # the rule reads a trace's kernel events with their device tables
    ev = Event("kernel", spec.name, (), (T(0, (1, 16, 8)),), info={
        "spec": spec, "tables": {k: torch.as_tensor(v)
                                 for k, v in over.items()}})
    assert lint([ev]).findings_for("kernel/index-bounds")


def test_over_budget_smem_spec_is_flagged():
    spec = cs.ell_spec(3, 3, 4584, 1000, 3)       # the 104 KB ring
    assert not check_kernel_smem(spec)
    findings = check_kernel_smem(spec, limit=1 << 16)
    assert findings and findings[0].rule == "kernel/smem-budget"
    # the fused kernel's aggregate chunks outgrow a block at wide C_in
    wide = cs.ell_fused_spec(1, 2, 64, 8 * 128 * 14, 8, 128)
    assert wide.smem_bytes > SMEM_BYTES
    assert lint([], kernels=[{"spec": wide}]).findings_for(
        "kernel/smem-budget")


@pytest.mark.parametrize("k,d,n_pad,c,bb", [
    (2, 2, 256, 256, 4), (4, 3, 512, 64, 4), (1, 1, 128, 128, 2),
    (3, 3, 4584, 767, 4), (3, 3, 4584, 1000, 4), (3, 3, 4584, 10, 4),
    (1, 16, 864, 1000, 2)])
def test_spec_shared_memory_is_the_layouts(k, d, n_pad, c, bb):
    """Parity: a spec's shared memory and geometry are ``ell_layout``'s
    (the stage ring) and ``fused_smem_bytes``'s, and fit the card."""
    lay = cs.ell_layout(k, n_pad, c, bb, 16, 16)
    for spec in (cs.ell_spec(k, d, n_pad, c, k, block_bytes=bb),
                 cs.ell_packed_spec(k, d, n_pad, c, k * n_pad,
                                    block_bytes=bb)):
        assert spec.smem_bytes == lay["smem_bytes"] <= SMEM_BYTES
        assert spec.grid == lay["grid"] and spec.threads == lay["threads"]
        assert spec.layout_words()[:5] == (lay["bm"], lay["bn"], lay["tm"],
                                           lay["tn"], lay["stages"])
    f = cs.ell_fused_spec(k, d, n_pad, c, c, k * n_pad, block_bytes=bb)
    assert f.smem_bytes == cs.fused_smem_bytes(c) <= SMEM_BYTES
    assert f.grid == cs.fused_grid(k, n_pad, c)
    assert f.layout_words() == (cs.fused_cluster(c)[0], 32, f.smem_bytes)


def test_real_kernel_specs_pass_all_kernel_rules():
    d = cs.spmm_spec(8, 8, 256, 256)
    assert not check_kernel_bounds(d, {"mask": np.ones((8, 8), np.int32)})
    assert not check_kernel_smem(d) and not check_copy_alignment(d)
    e = cs.ell_spec(2, 3, 256, 256, 8)
    tables = {"ell_indices": np.zeros((2, 3), np.int32),
              "ell_mask": np.ones((2, 3), np.int32),
              "row_counts": np.full((2,), 256, np.int32),
              "nbr_counts": np.full((2, 3), 256, np.int32)}
    assert not check_kernel_bounds(e, tables)
    assert not check_kernel_smem(e) and not check_copy_alignment(e)


def test_copy_alignment_warns_on_unaligned_rows():
    # C = 767: 3,068-byte Z rows force 4-byte copies on the 128 x 128 tile
    bad = cs.ell_spec(3, 3, 4584, 767, 3,
                      z_align=cs.copy_align(0, 4 * 767))
    findings = check_copy_alignment(bad)
    assert len(findings) == 1 and findings[0].severity == Severity.WARNING
    assert findings[0].location == "community_spmm_ell:z_all"
    # the narrow tile copies 4 bytes by design: no warning at C = 10
    assert not check_copy_alignment(cs.ell_spec(
        3, 3, 4584, 10, 3, z_align=cs.copy_align(0, 40)))
    # bf16 blocks of an odd row length copy 2 bytes
    odd = cs.ell_spec(1, 1, 65, 64, 1, block_bytes=2,
                      a_align=cs.copy_align(0, 130))
    assert [f.location for f in check_copy_alignment(odd)] == [
        "community_spmm_ell:ell_blocks"]


# ---------------------------------------------------------------------------
# findings / report plumbing
# ---------------------------------------------------------------------------


def test_waiver_mutes_matching_configs_only():
    f = Finding("memory/no-dense-adjacency", Severity.ERROR, "boom")
    w = Waiver("memory/no-dense-adjacency", "dense baseline",
               when={"compressed": False})
    kept, waived = apply_waivers([f], {"compressed": False}, [w])
    assert not kept and len(waived) == 1
    kept, waived = apply_waivers([f], {"compressed": True}, [w])
    assert len(kept) == 1 and not waived


def test_no_findings_severity_threshold():
    warn = Finding("precision/bf16-reduce", Severity.WARNING, "w")
    err = Finding("precision/no-f64", Severity.ERROR, "e")
    assert analysis.no_findings([warn], min_severity=Severity.ERROR)
    assert not analysis.no_findings([warn])
    assert not analysis.no_findings([warn, err], rule="precision/no-f64",
                                    min_severity=Severity.ERROR)
    assert analysis.no_findings([err], rule="precision/bf16-reduce")


def test_report_json_round_trip():
    rep = lint([op("_to_copy", [T(0, (4,))], [T(1, (4,), "float64")])],
               n_pad=8)
    rep.config = "rt"
    with pytest.raises(AssertionError):
        rep.assert_no_findings()
    blob = json.loads(rep.to_json())
    assert blob["config"] == "rt"
    assert blob["findings"][0]["rule"] == "precision/no-f64"
    assert blob["findings"][0]["severity"] == "error"
    assert blob["expectations"]["n_pad"] == 8


def test_report_json_has_the_reference_shape():
    def build(mod):
        f = mod.Finding("memory/no-dense-adjacency", mod.Severity.ERROR,
                        "boom", location="x", details={"shape": (4, 16)})
        w = mod.Finding("kernel/copy-alignment", mod.Severity.WARNING, "w")
        return mod.Report(config="c", expectations={
            "round_pairs": [((0, 1),)], "expect_donated": (".zs", ".u"),
            "n_pad": 16, "obj": object}, findings=[f], waived=[w],
            rules_run=["a", "b"])
    ours, ref = build(analysis.findings), build(jfindings)
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert ours.summary() == ref.summary()
