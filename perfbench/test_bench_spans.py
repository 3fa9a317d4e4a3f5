"""The join of the program's span log with a device timeline
(``spans.py``): on synthetic spans and device intervals, then one small
run of a cell on the CPU."""
import time

import pytest
import torch

import spans
from conftest import small_spec
from repro_torch.analysis import trace


def test_complement_leaves_the_gaps():
    assert spans.complement([(2, 3), (5, 7)], 0, 10) == [(0, 2), (3, 5),
                                                          (7, 10)]
    assert spans.complement([(0, 10)], 0, 10) == []
    assert spans.complement([], 1, 4) == [(1, 4)]


def test_innermost_splits_at_every_boundary():
    # 0: [1, 9], its children 1: [2, 4] and 2: [5, 8], 2's child 3: [6, 7]
    segs = spans.innermost([(1, 9, 0), (2, 4, 1), (5, 8, 2), (6, 7, 3)],
                           0, 10)
    assert segs == [(0, 1, -1), (1, 2, 0), (2, 4, 1), (4, 5, 0), (5, 6, 2),
                    (6, 7, 3), (7, 8, 2), (8, 9, 0), (9, 10, -1)]


def test_innermost_clips_to_the_window():
    segs = spans.innermost([(-5, 3, 0), (8, 20, 1)], 0, 10)
    assert segs == [(0, 3, 0), (3, 8, -1), (8, 10, 1)]


def test_idle_is_filed_under_the_innermost_span():
    segs = spans.innermost([(1, 9, 0), (2, 4, 1), (5, 8, 2), (6, 7, 3)],
                           0, 10)
    # one idle stretch across four spans' boundaries, one outside them all
    filed = spans.file_idle(segs, [(3, 6.5), (9.5, 10)])
    assert filed == pytest.approx({1: 1.0, 0: 1.0, 2: 1.0, 3: 0.5,
                                   -1: 0.5})


def _log(step_spans):
    """A span log of hand-made spans [(name, start, end)] in µs, opened
    in order (each inside the last one still open)."""
    log = trace.SpanLog()
    log.anchor = (0, 0)
    ends = []
    for name, a, b in step_spans:
        while ends and ends[-1] <= a:
            log.close(ends.pop() * 1000)
        log.open(name, a * 1000)
        ends.append(b)
    while ends:
        log.close(ends.pop() * 1000)
    return log


def test_join_by_name_and_outside():
    log = _log([("admm.step", 10, 50), ("admm.w_update", 12, 30),
                ("admm.probe", 14, 20), ("host.read", 16, 20),
                ("admm.probe", 22, 28), ("admm.step", 60, 90),
                ("admm.probe", 65, 80)])
    log.count("host_reads.backtracking", 3)
    busy = [(0, 16), (20, 22), (40, 62), (70, 100)]
    out = spans.join(log, busy, 0, 100, lambda t: t * 1e-3,
                     launches=[11, 55, 66, 95])
    assert out["steps"] == 2
    rows = out["by_span"]
    assert rows["admm.probe"]["count"] == 3
    # idle: [16, 20] under host.read, [22, 28] a probe, [28, 30] W,
    # [30, 40] and [62, 65] the step, [65, 70] a probe
    assert rows["host.read"]["idle_s"] == pytest.approx(4e-6)
    assert rows["admm.probe"]["idle_s"] == pytest.approx(11e-6)
    assert rows["admm.probe"]["idle_in_s"] == pytest.approx(15e-6)
    assert rows["admm.w_update"]["idle_s"] == pytest.approx(2e-6)
    assert rows["admm.step"]["idle_s"] == pytest.approx(13e-6)
    assert rows["admm.step"]["idle_in_s"] == pytest.approx(30e-6)
    assert out["idle_s"] == pytest.approx(30e-6)
    assert out["idle_outside_s"] == 0.0
    assert out["idle_filed_s"] + out["idle_outside_s"] == \
        pytest.approx(out["idle_s"])
    assert rows["admm.step"]["self_s"] + rows["admm.w_update"]["self_s"] \
        + rows["admm.probe"]["self_s"] + rows["host.read"]["self_s"] == \
        pytest.approx(rows["admm.step"]["host_s"])
    assert (out["launches"], out["launches_in_steps"]) == (4, 2)
    per = spans.per_step(out)
    assert per["admm.probe"]["count"] == 1.5


def test_join_leaves_out_steps_outside_the_window():
    log = _log([("admm.step", 10, 20), ("admm.step", 30, 40)])
    out = spans.join(log, [], 25, 50, lambda t: t * 1e-3)
    assert out["steps"] == 1
    assert out["idle_outside_s"] == pytest.approx(15e-6)
    assert out["by_span"]["admm.step"]["idle_s"] == pytest.approx(10e-6)


@pytest.mark.parametrize("cell", ["photo-admm-1gpu"])
def test_run_of_a_cell_on_the_cpu(cell):
    spec = small_spec(cell, nodes=200, dims=(12, 16, 4))
    spec["workload"]["trace_seconds"] = 0.05
    torch.manual_seed(0)
    t = time.time()
    out = spans.run_cell(spec, 2**31 + 77, 0.5, True, torch.device("cpu"))
    assert time.time() - t < 120
    j = out["joined"]
    assert j["steps"] == out["traced"]["steps"] >= 5
    assert j["idle_filed_s"] + j["idle_outside_s"] == \
        pytest.approx(j["idle_s"], rel=1e-9)
    assert out["host_reads_a_step"] >= 11
    assert set(out["by_span_ms"]) >= {"admm.step", "admm.w_update",
                                      "admm.z_update", "admm.z_last",
                                      "admm.u_update", "admm.probe",
                                      "host.read"}
    assert set(out["layout_spans_s"]) >= {
        "layout", "layout.partition_quality", "layout.community",
        "layout.device_layout", "layout.community_data",
        "layout.first_iterates", "layout.plan"}
    assert out["window"]["steps_off"] > 0 and out["window"]["steps_on"] > 0
    plain = out["window_by_span_ms"]
    assert plain["admm.step"]["count"] == 1.0
    assert sum(r["self_ms"] for r in plain.values()) == \
        pytest.approx(plain["admm.step"]["host_ms"])
    assert trace.SPANS is None
    lines = spans.show(out)
    assert lines[0].startswith(cell)
