"""The port's roofline module against the JAX package's.

``model_flops``, ``analytic_hbm_bytes`` and ``fused_agg_traffic`` are
exactly equal on every registered architecture × input shape (the same
arithmetic on the same config values); ``roofline_terms`` is equal when
the reference's own device constants (``repro.launch.mesh``) are passed
in, and otherwise prices the card's published figures; ``peaks`` names
the three H100 variants and refuses another card.  ``trace_census``
counts a recorded trace's products and transport bytes.
"""
import inspect
import re

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro_torch.analysis import trace
from repro_torch.configs import registry
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.core import messages
from repro_torch.launch import roofline

CASES = [(arch, shape) for arch in registry.list_archs()
         for shape in INPUT_SHAPES]


@pytest.mark.parametrize("arch,shape", CASES)
def test_model_flops_and_hbm_floor_equal_the_reference(arch, shape):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    s, js = INPUT_SHAPES[shape], J_SHAPES[shape]
    assert roofline.model_flops(cfg, s, s.step) == jroof.model_flops(
        jcfg, js, js.step)
    for chips in (1, 256, 512):
        assert roofline.analytic_hbm_bytes(cfg, s, s.step, chips) == \
            jroof.analytic_hbm_bytes(jcfg, js, js.step, chips)


@pytest.mark.parametrize("rows,sites,itemsize", [
    (4 * 4584, [(767, 1000), (1000, 10)], 4), (96, [(8, 8)] * 4, 2),
    (0, [], 4)])
def test_fused_agg_traffic_equals_the_reference(rows, sites, itemsize):
    assert roofline.fused_agg_traffic(rows, sites, itemsize) == \
        jroof.fused_agg_traffic(rows, sites, itemsize)


@pytest.mark.parametrize("args,exposed", [
    ((197e12, 1.0, 1.0), None), ((1.0, 819e9 * 5, 1.0), None),
    ((1.0, 1.0, 50e9 * 3), None), ((3e12, 2e9, 8e8), 1e8)])
def test_roofline_terms_at_the_reference_constants(args, exposed):
    got = roofline.roofline_terms(*args, exposed, peak_flops=jmesh.PEAK_FLOPS,
                                  hbm_bw=jmesh.HBM_BW, link_bw=jmesh.ICI_BW)
    assert got == jroof.roofline_terms(*args, exposed)


def test_roofline_terms_default_to_the_card():
    _, bf16, hbm = roofline.peaks()
    t = roofline.roofline_terms(bf16, hbm * 2, roofline.LINK_BW / 2)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (
        1.0, 2.0, 0.5)
    assert t["dominant"] == "memory_s"
    # the overlap model and the roofline share one home for the figures
    assert messages.PEAK_FLOPS == roofline.FP32_PEAK == 67e12
    assert messages.LINK_BW == roofline.LINK_BW == 450e9


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67e12, 989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 756e12, 2.0e12)),
    ("NVIDIA H100 NVL", (60e12, 835e12, 3.9e12))])
def test_peaks_per_variant(name, want):
    assert roofline.peaks(name) == want


def test_peaks_refuse_another_card():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks("NVIDIA A100-SXM4-80GB")


def test_bound_is_the_larger_time():
    assert roofline.bound(67e9, 1.0, 67e12, 3.35e12) == (1.0, "operations")
    assert roofline.bound(1.0, 3.35e9, 67e12, 3.35e12) == (1.0, "bytes")


def test_no_tpu_figure_in_the_module():
    src = inspect.getsource(roofline)
    assert not re.search(r"(?<![0-9.])(197e12|819e9|50e9)", src)


def test_trace_census_counts_products_and_wire():
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    with trace.record() as tape:
        a @ b
        messages.allgather(torch.ones(2, 8, 3), comm_bf16=True)
    c = roofline.trace_census(tape)
    assert c.flops == 2 * 4 * 5 * 3
    assert c.collectives["allgather"] == {"count": 1, "bytes": 2 * 8 * 3 * 2}
    assert c.collective_bytes == 96 and c.ops >= 1
    assert np.isclose(c.hbm_bytes, sum(
        t.nbytes for e in tape.of_kind("op") for t in e.inputs + e.outputs))
