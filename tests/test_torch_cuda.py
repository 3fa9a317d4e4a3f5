"""The port's CUDA kernel and trainer on the card (skipped without one).

Imports torch, numpy and the port only, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same CUDA
tensors (max |diff| ≤ 1e-6 · max |ref| with f32 blocks, 1e-5 with bf16); the
trainer's kernel path against its plain path at one shared state.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import gcn, graph
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.kernels import community_spmm, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(seed, m_z, k, max_deg, n_pad, c, counts, device):
    """Random ELL operands: padding slots (mask 0) point anywhere in range;
    with ``counts`` the row counts are ragged, below n_pad."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((k, max_deg), np.float32)
    for r in range(k):
        mask[r, : 1 + r % max_deg] = 1.0
    out = [rng.normal(size=(k, max_deg, n_pad, n_pad)).astype(np.float32),
           rng.integers(0, m_z, size=(k, max_deg)).astype(np.int32), mask,
           rng.normal(size=(m_z, n_pad, c)).astype(np.float32), None, None]
    if counts:
        out[4] = rng.integers(1, n_pad + 1, size=k).astype(np.int32)
        out[5] = (rng.integers(0, n_pad + 1, size=(k, max_deg))
                  * (mask > 0)).astype(np.int32)
    return [None if x is None else torch.as_tensor(x, device=device)
            for x in out]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m_z,k,max_deg,n_pad,c,counts", [
    (6, 6, 3, 64, 32, False),
    (8, 2, 4, 64, 48, True),
    (4, 4, 1, 128, 128, False),
    (5, 5, 5, 72, 20, True),
    (3, 3, 3, 131, 67, True),
])
def test_kernel_matches_plain_version(cuda_device, m_z, k, max_deg, n_pad, c,
                                      counts, bf16):
    args = _operands(0, m_z, k, max_deg, n_pad, c, counts, cuda_device)
    if bf16:
        args[0] = args[0].to(torch.bfloat16)
    before = community_spmm.launches
    got = ops.community_spmm_ell(*args)
    torch.cuda.synchronize()
    assert community_spmm.launches == before + 1
    want = ref.community_spmm_ell_einsum(*args)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= (1e-5 if bf16 else 1e-6) * scale


def test_kernel_refuses_a_live_index_out_of_range(cuda_device):
    """The launcher reads no index values from the device; the range check
    of live slots runs once, on the kernel's operands, before any launch."""
    args = _operands(1, 3, 2, 2, 16, 4, False, cuda_device)
    community_spmm.check_indices(args[1], args[2], 3)
    args[1][0, 0] = 7
    with pytest.raises(IndexError, match="outside z_all"):
        community_spmm.check_indices(args[1], args[2], 3)


def test_trainer_kernel_path_matches_plain_path(cuda_device):
    g, _ = graph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    tr = ParallelADMMTrainer(gcn.GCNConfig((16, 32, g.num_classes)),
                             ADMMConfig(nu=1e-3, rho=1e-3), g, 8, seed=0,
                             config=TrainerConfig.packed(use_kernel=True))
    assert tr.device.type == "cuda"
    for _ in range(5):
        tr.step()
    community_spmm.launches = 0
    tr.step()
    assert community_spmm.launches == tr.cfg.num_layers + 1
    got, want = tr.objectives(use_kernel=True), tr.objectives(use_kernel=False)
    for (va, ga), (vb, gb) in zip(got["w"] + got["z"],
                                  want["w"] + want["z"]):
        assert float((va - vb).abs().max()) <= 1e-5 * float(vb.abs().max())
        assert float((ga - gb).abs().max()) <= 1e-5 * float(gb.abs().max())
    log = tr.train(2)
    assert all(np.isfinite(log.lagrangian)) and all(np.isfinite(log.residual))
