"""The control, the reference put in the program's place one precision
below the configuration's (TF32 for float32 with TF32 off), fails the
comparison: on the CPU with TF32 emulated by rounding every product's
operands, on the card (``cuda`` marker) with TF32 itself."""
import pytest
import torch

import check
import control
from conftest import small_spec

CELLS = ["computers-admm-1gpu", "photo-admm-1gpu", "computers-admm-4gpu"]


def _fails(spec, numbers) -> bool:
    ok, _ = check.verdict(numbers, spec["workload"]["limits"])
    return not ok


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    spec = small_spec(cell, nodes=400)
    got = control.control_numbers(spec, 2**31 + 5, torch.device("cpu"))
    assert _fails(spec, got)
    # on both numbers the precision moves
    lim = spec["workload"]["limits"]
    assert got["agg_err"] > lim["agg_err"]
    assert got["iter_err"] > lim["iter_err"]


def test_reference_in_float32_passes_its_own_comparison():
    spec = small_spec("computers-admm-1gpu", nodes=400)
    got = control.control_numbers(spec, 3, torch.device("cpu"), tf32=False)
    assert not _fails(spec, got)
    assert got["agg_err"] == 0 and got["iter_err"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = small_spec(cell, nodes=2000)
    got = control.control_numbers(spec, 11, torch.device("cuda"))
    assert _fails(spec, got)
