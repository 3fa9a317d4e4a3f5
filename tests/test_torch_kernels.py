"""ELL aggregation of the PyTorch port against the JAX package.

The port's plain versions (``repro_torch.kernels.ref``) are held against
the reference's jnp oracle on random operands, and against the Pallas
kernel body itself in interpret mode on layout-valid operands (pad rows
zero, as in every real layout: the Pallas kernel guards rows at tile
granularity where the oracle and the CUDA kernel guard them exactly).
Tolerance: max |diff| ≤ 1e-6 · max |ref| with f32 blocks, 1e-5 with bf16
blocks (the same upcast values, summed in another order).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against the plain version (skipped without a card), and
``chip_smoke.py`` does so at the trainer's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.kernels import ref as jref
from repro.kernels.community_spmm import community_spmm_ell as pallas_ell
from repro_torch.kernels import build, community_spmm, ops, ref


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _random_operands(seed, m_z, k, max_deg, n_pad, c, counts):
    """Random ELL operands with real padding slots (mask 0, index anywhere
    in range) and, with ``counts``, ragged row counts below n_pad."""
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(k, max_deg, n_pad, n_pad)).astype(np.float32)
    idx = rng.integers(0, m_z, size=(k, max_deg)).astype(np.int32)
    mask = np.zeros((k, max_deg), np.float32)
    for r in range(k):
        mask[r, : 1 + r % max_deg] = 1.0
    z = rng.normal(size=(m_z, n_pad, c)).astype(np.float32)
    if not counts:
        return blocks, idx, mask, z, None, None
    rows = rng.integers(1, n_pad + 1, size=k).astype(np.int32)
    nbrs = (rng.integers(0, n_pad + 1, size=(k, max_deg))
            * (mask > 0)).astype(np.int32)
    return blocks, idx, mask, z, rows, nbrs


def _port(*ops_args):
    return [None if x is None else torch.as_tensor(x) for x in ops_args]


def _jax(*ops_args):
    return [None if x is None else jnp.asarray(x) for x in ops_args]


CASES = [  # m_z, k, max_deg, n_pad, c, counts
    (6, 6, 3, 64, 32, False),
    (8, 2, 4, 64, 48, True),
    (4, 4, 1, 128, 128, False),
    (5, 5, 5, 72, 20, True),
    (3, 3, 3, 40, 10, True),
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m_z,k,max_deg,n_pad,c,counts", CASES)
def test_plain_versions_match_reference_oracle(m_z, k, max_deg, n_pad, c,
                                               counts, bf16):
    blocks, idx, mask, z, rows, nbrs = _random_operands(
        0, m_z, k, max_deg, n_pad, c, counts)
    jb = jnp.asarray(blocks, jnp.bfloat16) if bf16 else jnp.asarray(blocks)
    want = jref.community_spmm_ell_einsum(jb, *_jax(idx, mask, z, rows, nbrs))
    tb = torch.as_tensor(blocks).to(torch.bfloat16 if bf16 else torch.float32)
    tol = 1e-5 if bf16 else 1e-6
    args = _port(idx, mask, z, rows, nbrs)
    _close(ref.community_spmm_ell_einsum(tb, *args), want, tol)
    _close(ref.community_spmm_ell_ref(tb, *args), want, tol)
    # the CPU dispatch runs the plain version, bit for bit
    np.testing.assert_array_equal(
        ops.community_spmm_ell(tb, *args).numpy(),
        ref.community_spmm_ell_einsum(tb, *args).numpy())


def _layout_operands(bf16: bool, c: int):
    """ELL operands of a real ragged (bucketed) layout: pad rows are zero
    in the blocks and in Z, so the tile-granular Pallas guards and the
    exact guards of the port agree."""
    g, part = jgraph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    lay = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                        compressed=True, pad_mode="bucketed")
    csr = lay.compress()
    rows, nbrs = csr.ell_row_counts()
    x = np.random.default_rng(1).normal(
        size=(g.num_nodes, c)).astype(np.float32)
    z = lay.pack(x)                          # rows past sizes are zero
    assert (rows < lay.n_pad).any()
    return csr.ell_blocks, csr.ell_indices, csr.ell_mask, z, rows, nbrs


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [4, 32])
def test_plain_version_matches_pallas_kernel_interpret(bf16, c):
    blocks, idx, mask, z, rows, nbrs = _layout_operands(bf16, c)
    jb = jnp.asarray(blocks, jnp.bfloat16) if bf16 else jnp.asarray(blocks)
    want = pallas_ell(jb, *_jax(idx, mask, z, rows, nbrs), interpret=True)
    tb = torch.as_tensor(blocks).to(torch.bfloat16 if bf16 else torch.float32)
    got = ops.community_spmm_ell(tb, *_port(idx, mask, z, rows, nbrs))
    _close(got, want, 1e-5 if bf16 else 1e-6)


def test_masked_slot_contributes_nothing():
    """A padding slot (mask 0) adds nothing, whatever block and index it
    holds; without the mask it would."""
    blocks, idx, mask, z, _, _ = _random_operands(3, 4, 3, 3, 32, 8, False)
    t = _port(blocks, idx, mask, z)
    out = ops.community_spmm_ell(*t)
    full = ops.community_spmm_ell(t[0], t[1], torch.ones_like(t[2]), t[3])
    assert float((out - full).abs().max()) > 1e-3
    moved = t[1].clone()
    moved[t[2] == 0] = (moved[t[2] == 0] + 1) % 4
    np.testing.assert_array_equal(
        ops.community_spmm_ell(t[0], moved, t[2], t[3]).numpy(), out.numpy())


def test_launcher_refuses_cpu_tensors():
    """The kernel's own wrapper launches on CUDA tensors or raises: it never
    computes anything on the CPU (the dispatch in ``ops`` does that)."""
    blocks, idx, mask, z, _, _ = _random_operands(0, 3, 3, 2, 16, 4, False)
    t = _port(blocks, idx, mask.astype(np.int32), z)
    rows = torch.full((3,), 16, dtype=torch.int32)
    nbrs = torch.full((3, 2), 16, dtype=torch.int32)
    before = community_spmm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        community_spmm.community_spmm_ell(*t, rows, nbrs)
    assert community_spmm.launches == before


def test_check_indices_reads_live_slots_only():
    """Live slots must index one of the M communities; a masked slot's
    index may hold any value.  The trainer runs this once, on its layout."""
    idx = torch.tensor([[0, 2], [1, 9]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    community_spmm.check_indices(idx, mask, 3)
    for bad in (3, -1):
        idx[0, 1] = bad
        with pytest.raises(IndexError, match="outside z_all"):
            community_spmm.check_indices(idx, mask, 3)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(community_spmm.LIB)


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    path = build.library_path(community_spmm.LIB)
    assert path.parent.parent == build.BUILD_ROOT
    assert path.name == f"lib{community_spmm.LIB}.so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path(community_spmm.LIB) != path
