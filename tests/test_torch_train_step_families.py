"""``Model.train_step`` against the reference for the second half of
``configs.list_archs()``; the check and its tolerances:
tests/test_torch_train_step.py."""
import pytest

from test_torch_train_step import ARCHS, FIRST_HALF, check_train_step


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in FIRST_HALF])
def test_train_step_gradients_match_reference(arch, accum):
    check_train_step(arch, accum)
