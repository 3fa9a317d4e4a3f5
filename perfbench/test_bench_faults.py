"""A run with the timed path broken underneath comes out not correct: the
harness driven on the CPU (its look for a card skipped), each fault that
the cell can have planted in the program (``faults.py``), the cells over
four ranks on gloo.  A sound run comes out correct."""
import time

import pytest

import driver
import faults
from conftest import small_spec

ONE = ["computers-admm-1gpu", "photo-admm-1gpu"]
FOUR = ["computers-admm-4gpu"]
CASES = ([(c, f) for c in ONE for f in ("unchanged", "half_batch",
                                         "altered")]
         + [(c, f) for c in FOUR for f in ("unchanged", "half_batch",
                                           "altered", "no_exchange")])


@pytest.fixture(autouse=True)
def restore_program():
    """The one-card faults patch the program in this process: undo it."""
    from repro_torch.core import messages
    from repro_torch.kernels import ops
    saved = [(ops, n, getattr(ops, n)) for n in
             ("community_spmm_ell", "community_spmm_ell_packed")]
    saved.append((messages.ProcessTransport, "_land",
                  messages.ProcessTransport._land))
    yield
    for obj, name, val in saved:
        setattr(obj, name, val)


def run(cell, hook=None, nodes=400):
    spec = small_spec(cell, nodes=nodes)
    return driver.execute(spec, 2**31 + 41, 0.3, False, time.time(),
                          device="cpu", backend="gloo", hook=hook,
                          log=lambda s: None)


@pytest.mark.parametrize("cell", ONE + FOUR)
def test_sound_run_is_correct(cell):
    # the limits hold from about this size up (the loss's rounding grows
    # as the training nodes get fewer)
    res = run(cell, nodes=1500)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    res = run(cell, faults.FAULTS[fault])
    assert not res["correct"], res["checks"]
