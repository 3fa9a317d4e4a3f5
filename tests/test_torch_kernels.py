"""Community aggregation of the PyTorch port against the JAX package.

The port's plain versions (``repro_torch.kernels.ref``) of the dense,
strided ELL, packed-plane and fused kernels are held against the
reference's jnp oracles on random operands, and against the Pallas kernel bodies
themselves in interpret mode on layout-valid operands (pad rows zero and
8-aligned plane offsets, as in every real layout: the Pallas kernels guard
rows at tile granularity and steer 8-row slabs where the oracles and the
CUDA kernels guard and address rows exactly).  Tolerances: max |diff| ≤
1e-6 · max |ref| against the oracles (1e-5 for the strided kernel with bf16
blocks: the same upcast values, summed in another order), 1e-5 · max |ref|
for the dense, packed and fused kernels against the interpret-mode bodies
(the Pallas bodies sum in tiles; the fused body sums (A·Z)·W, the plain
version A·(Z·W)).  The dense cases give absent blocks random non-zero
values: the plain version multiplies them by 0, the kernels skip them.

The plain versions of the SSD scan and flash attention are held against
the interpret-mode Pallas kernels and the reference's oracles: f32 inputs
within 1e-5 · max |ref| (the same f32 algorithm, summed in another order),
bf16 inputs within 2^-7 · max |ref|, one bf16 ulp at the largest value
(both upcast the same bf16 values and sum in f32, then round the output to
bf16 once; sums in another order may round to the neighbouring value).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against the plain versions (skipped without a card), and
``chip_smoke.py`` does so at the trainer's and the server's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import messages as jmessages
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.community_spmm import community_spmm as pallas_dense
from repro.kernels.community_spmm import community_spmm_ell as pallas_ell
from repro.kernels.community_spmm import \
    community_spmm_ell_fused as pallas_fused
from repro.kernels.community_spmm import \
    community_spmm_ell_packed as pallas_packed
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.core import messages
from repro_torch.kernels import build, community_spmm, ops, ref
from repro_torch.kernels import fista as fista_launcher
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels import ssd_scan as ssd_launcher


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


def test_every_source_is_a_registered_library():
    """``build.LIBRARIES`` lists every CUDA source, and the launchers load
    only registered libraries."""
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.LIBRARIES) == sources
    assert {community_spmm.LIB, community_spmm.FUSED_LIB, ssd_launcher.LIB,
            ssd_launcher.TC_LIB, flash_launcher.LIB, flash_launcher.TC_LIB,
            fista_launcher.LIB} == set(build.LIBRARIES)
    # the dense launch is an addressing of the ELL kernel, not a library
    assert "community_spmm_dense" not in sources


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    path = build.library_path(community_spmm.LIB)
    assert path.parent.parent == build.BUILD_ROOT
    assert path.name == f"lib{community_spmm.LIB}.so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path(community_spmm.LIB) != path


# ---------------------------------------------------------------------------
# packed-plane and fused kernels
# ---------------------------------------------------------------------------

def _packed_operands(seed, k, max_deg, n_pad, c_in, c_out, layout_valid):
    """Random packed-plane operands: neighbour slots packed back to back
    on one plane, masked slots (mask 0) whose offsets and counts point
    anywhere.  ``layout_valid``: 8-aligned offsets and counts, and blocks
    zero past the row and neighbour counts (the zero-outside-counts
    contract of every real layout); otherwise ragged counts."""
    rng = np.random.default_rng(seed)
    n_slots = k + 2
    if layout_valid:
        counts = 8 * rng.integers(1, n_pad // 8 + 1, size=n_slots)
        rows = 8 * rng.integers(1, n_pad // 8 + 1, size=k)
    else:
        counts = rng.integers(1, n_pad + 1, size=n_slots)
        rows = rng.integers(1, n_pad + 1, size=k)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    plane_rows = int(counts.sum())
    slot = rng.integers(0, n_slots, size=(k, max_deg))
    mask = np.zeros((k, max_deg), np.float32)
    for r in range(k):
        mask[r, : 1 + r % max_deg] = 1.0
    live = mask > 0
    off = np.where(live, starts[slot],
                   rng.integers(0, plane_rows, size=(k, max_deg)))
    nbrs = np.where(live, counts[slot],
                    rng.integers(0, n_pad + 1, size=(k, max_deg)))
    blocks = rng.normal(size=(k, max_deg, n_pad, n_pad)).astype(np.float32)
    if layout_valid:
        lane = np.arange(n_pad)
        blocks *= lane[None, None, :, None] < rows[:, None, None, None]
        blocks *= lane[None, None, None, :] < nbrs[:, :, None, None]
    z = rng.normal(size=(plane_rows, c_in)).astype(np.float32)
    w = rng.normal(size=(c_in, c_out)).astype(np.float32)
    return (blocks, off.astype(np.int32), mask, z, w, rows.astype(np.int32),
            nbrs.astype(np.int32))


PACKED_CASES = [  # k, max_deg, n_pad, c_in, c_out
    (1, 4, 32, 24, 16),
    (3, 3, 40, 16, 8),
    (2, 5, 24, 12, 20),
    (4, 1, 64, 8, 4),
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k,max_deg,n_pad,c_in,c_out", PACKED_CASES)
def test_packed_and_fused_plain_versions_match_reference_oracles(
        k, max_deg, n_pad, c_in, c_out, bf16):
    blocks, off, mask, z, w, rows, nbrs = _packed_operands(
        k, k, max_deg, n_pad, c_in, c_out, layout_valid=False)
    jb = jnp.asarray(blocks, jnp.bfloat16) if bf16 else jnp.asarray(blocks)
    tb = torch.as_tensor(blocks).to(torch.bfloat16 if bf16 else torch.float32)
    want_p = jref.community_spmm_ell_packed_einsum(
        jb, *_jax(off, mask, z, rows, nbrs))
    want_f = jref.community_spmm_ell_fused_einsum(
        jb, *_jax(off, mask, z, w, rows, nbrs))
    got_p = ref.community_spmm_ell_packed_einsum(
        tb, *_port(off, mask, z, rows, nbrs))
    got_f = ref.community_spmm_ell_fused_einsum(
        tb, *_port(off, mask, z, w, rows, nbrs))
    _close(got_p, want_p, 1e-6)
    _close(got_f, want_f, 1e-6)
    # the CPU dispatch runs the plain versions, bit for bit
    np.testing.assert_array_equal(
        ops.community_spmm_ell_packed(tb, *_port(off, mask, z, rows,
                                                 nbrs)).numpy(),
        got_p.numpy())
    np.testing.assert_array_equal(
        ops.community_spmm_ell_fused(tb, *_port(off, mask, z, w, rows,
                                                nbrs)).numpy(),
        got_f.numpy())


@pytest.mark.parametrize("k,max_deg,n_pad,c_in,c_out", PACKED_CASES)
def test_packed_and_fused_plain_versions_match_pallas_interpret(
        k, max_deg, n_pad, c_in, c_out):
    blocks, off, mask, z, w, rows, nbrs = _packed_operands(
        k + 1, k, max_deg, n_pad, c_in, c_out, layout_valid=True)
    want_p = pallas_packed(*_jax(blocks, off, mask, z, rows, nbrs),
                           interpret=True)
    want_f = pallas_fused(*_jax(blocks, off, mask, z, w, rows, nbrs),
                          interpret=True)
    _close(ops.community_spmm_ell_packed(
        *_port(blocks, off, mask, z, rows, nbrs)), want_p, 1e-5)
    _close(ops.community_spmm_ell_fused(
        *_port(blocks, off, mask, z, w, rows, nbrs)), want_f, 1e-5)


def test_packed_bf16_blocks_match_pallas_interpret():
    blocks, off, mask, z, _, rows, nbrs = _packed_operands(
        9, 2, 3, 32, 16, 8, layout_valid=True)
    jb = jnp.asarray(blocks, jnp.bfloat16)
    want = pallas_packed(jb, *_jax(off, mask, z, rows, nbrs), interpret=True)
    got = ops.community_spmm_ell_packed(torch.as_tensor(blocks).bfloat16(),
                                        *_port(off, mask, z, rows, nbrs))
    _close(got, want, 1e-5)


def test_packed_masked_slots_contribute_nothing():
    """A masked slot adds nothing, wherever its offset and count point;
    unmasked, the same slots would."""
    blocks, off, mask, z, w, rows, nbrs = _port(*_packed_operands(
        4, 3, 3, 32, 8, 4, layout_valid=False))
    out = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    dead = mask == 0
    moved_off, moved_n = off.clone(), nbrs.clone()
    moved_off[dead] = (moved_off[dead] * 7 + 3) % z.shape[0]
    moved_n[dead] = 32 - moved_n[dead]
    np.testing.assert_array_equal(
        ops.community_spmm_ell_packed(blocks, moved_off, mask, z, rows,
                                      moved_n).numpy(), out.numpy())
    np.testing.assert_array_equal(
        ops.community_spmm_ell_fused(blocks, moved_off, mask, z, w, rows,
                                     moved_n).numpy(),
        ops.community_spmm_ell_fused(blocks, off, mask, z, w, rows,
                                     nbrs).numpy())
    lane = torch.arange(32)
    for m in range(3):
        assert not out[m, lane >= rows[m]].any()


def _serving_layout():
    g, part = jgraph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    lay = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                        compressed=True, pad_mode="bucketed")
    csr = lay.compress()
    dl = lay.device_layout(1)
    rows, nbrs = csr.ell_row_counts()
    off = jmessages.plane_read_offsets(csr.ell_indices, csr.ell_mask,
                                       dl.local_offsets)
    self_mask = jmessages.self_slot_mask(csr.ell_indices, csr.ell_mask)
    x = np.random.default_rng(2).normal(
        size=(g.num_nodes, 12)).astype(np.float32)
    z = dl.pack_state(lay.pack(x))
    return lay, csr, dl, (csr.ell_blocks, off, csr.ell_mask, self_mask, z,
                          rows, nbrs)


def test_plane_tables_equal_reference():
    _, csr, dl, _ = _serving_layout()
    np.testing.assert_array_equal(
        messages.plane_read_offsets(csr.ell_indices, csr.ell_mask,
                                    dl.local_offsets),
        jmessages.plane_read_offsets(csr.ell_indices, csr.ell_mask,
                                     dl.local_offsets))
    np.testing.assert_array_equal(
        messages.self_slot_mask(csr.ell_indices, csr.ell_mask),
        jmessages.self_slot_mask(csr.ell_indices, csr.ell_mask))


def test_halo_split_reassembles_the_full_aggregate():
    """halo + self block == the packed aggregate over every slot, and the
    halo equals the reference's ``community_halo_spmm``."""
    lay, _, dl, ops_args = _serving_layout()
    blocks, off, mask, self_mask, z, rows, nbrs = ops_args
    halo = ops.community_halo_spmm(*_port(*ops_args))
    _close(halo, jops.community_halo_spmm(*_jax(*ops_args)), 1e-6)
    full = ops.community_spmm_ell_packed(*_port(blocks, off, mask, z, rows,
                                                nbrs))
    split = halo.clone()
    for m in range(lay.num_parts):
        rc, start = int(rows[m]), int(dl.local_offsets[m])
        a_self = torch.as_tensor(lay.a_blocks[m, m, :rc, :rc])
        split[m, :rc] += a_self @ torch.as_tensor(z[start:start + rc])
    _close(split, full, 1e-6)
    assert float((halo - full).abs().max()) > 1e-3   # the self slot counts


def test_check_plane_offsets_reads_live_slots_only():
    """A live slot's rows [off, off + count) must lie in the plane; a
    masked slot's offset and count may hold any value."""
    off = torch.tensor([[0, 99], [8, -5]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    nbrs = torch.tensor([[8, 64], [8, 3]], dtype=torch.int32)
    community_spmm.check_plane_offsets(off, mask, nbrs, 16)
    community_spmm.check_plane_offsets(off.numpy(), mask.numpy(),
                                       nbrs.numpy(), 16)
    for m, d, value in ((1, 0, 9), (1, 0, -1), (0, 0, 16)):
        bad = off.clone()
        bad[m, d] = value
        with pytest.raises(IndexError, match="outside the packed plane"):
            community_spmm.check_plane_offsets(bad, mask, nbrs, 16)


@pytest.mark.parametrize("kernel", ["packed", "fused"])
def test_packed_launchers_refuse_cpu_tensors(kernel):
    blocks, off, mask, z, w, rows, nbrs = _port(*_packed_operands(
        0, 2, 2, 16, 4, 4, layout_valid=True))
    mask = mask.to(torch.int32)
    before = (community_spmm.packed_launches, community_spmm.fused_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kernel == "packed":
            community_spmm.community_spmm_ell_packed(blocks, off, mask, z,
                                                     rows, nbrs)
        else:
            community_spmm.community_spmm_ell_fused(blocks, off, mask, z, w,
                                                    rows, nbrs)
    assert (community_spmm.packed_launches,
            community_spmm.fused_launches) == before


def test_fused_shared_memory_fits_the_serving_widths():
    """One 128-column chunk of the (32, C_in) aggregate per block at the
    serving widths, plus the (32, 36) and (32, 132) f32 staging tiles; the
    widest C_in is 12,288 (12 chunks on each of 8 blocks), past the
    one-block kernel's 3,328."""
    staging = 4 * 32 * (36 + 132)
    assert community_spmm.fused_smem_bytes(1000) == 32 * 128 * 4 + staging
    assert community_spmm.fused_smem_bytes(767) == 32 * 128 * 4 + staging
    assert community_spmm.fused_smem_bytes(3328) == 4 * 32 * 128 * 4 + staging
    assert community_spmm.fused_smem_bytes(12288) <= community_spmm._SMEM_LIMIT
    assert community_spmm.fused_smem_bytes(12289) > community_spmm._SMEM_LIMIT


def test_fused_cluster_layout_across_widths():
    """Every C_in the launcher takes: ceil(C_in / 128) chunks (at least one)
    over a cluster of at most 8 blocks, each block owning ceil(chunks /
    cluster) of them in shared memory within the block's limit; 162 and 216
    blocks at the serving shapes (one lane, n_pad 864)."""
    limit = community_spmm._SMEM_LIMIT
    widths = [c for c in range(1, 12290)
              if community_spmm.fused_smem_bytes(c) <= limit]
    assert widths == list(range(1, 12289))
    for c_in in widths:
        chunks = max(1, -(-c_in // 128))
        cluster, owned = community_spmm.fused_cluster(c_in)
        assert cluster == min(chunks, 8)
        assert owned == -(-chunks // cluster)
        assert (owned - 1) * cluster < chunks <= owned * cluster
        assert community_spmm.fused_smem_bytes(c_in) \
            == owned * 32 * 128 * 4 + 4 * 32 * (36 + 132)
    assert community_spmm.fused_grid(1, 864, 767) == (6, 27, 1)
    assert community_spmm.fused_grid(1, 864, 1000) == (8, 27, 1)
    assert community_spmm.fused_grid(3, 70, 64) == (1, 3, 3)
    for c_in in (767, 1000):
        assert np.prod(community_spmm.fused_grid(1, 864, c_in)) >= 132


@pytest.mark.parametrize("c,grid", [(767, (6, 36, 3)), (1000, (8, 36, 3))])
def test_ell_layout_large_tile_at_the_trainer_shapes(c, grid):
    """k = 3 lanes of n_pad 4584: 128 x 128 tiles, 8 x 8 per thread, three
    stages, 648 / 864 blocks (at least two per SM of 132)."""
    lay = community_spmm.ell_layout(3, 4584, c, 4, 16, 16)
    assert (lay["tile"], lay["bm"], lay["bn"], lay["tm"], lay["tn"],
            lay["stages"]) == ("large", 128, 128, 8, 8, 3)
    assert lay["grid"] == grid and np.prod(grid) >= 2 * 132
    assert lay["smem_bytes"] == 3 * (128 * (32 * 4 + 16) + 32 * 128 * 4)
    # two blocks share an SM: 228 KB of shared memory, 1 KB reserved each
    assert 2 * (lay["smem_bytes"] + 1024) <= 233472
    bf16 = community_spmm.ell_layout(3, 4584, c, 2, 16, 16)
    assert bf16["tile"] == "large"
    assert bf16["smem_bytes"] == 3 * (128 * (32 * 2 + 16) + 32 * 128 * 4)


@pytest.mark.parametrize("c,tile,shape,grid", [
    (767, "half", (64, 32, 4, 4), (24, 14, 1)),
    (1000, "small", (64, 64, 8, 4), (16, 14, 1))])
def test_ell_layout_small_tiles_at_the_halo_shape(c, tile, shape, grid):
    """One lane of n_pad 864 gives only 42 / 56 large tiles.  At C = 1000
    the 64 x 64 tile's 224 blocks put at most 2 on an SM; at C = 767 its
    168 blocks put 2 on 36 SMs and 1 on the rest, so the 64 x 32 tile's
    336 blocks (at most 3 half tiles an SM) finish first."""
    lay = community_spmm.ell_layout(1, 864, c, 4, 16, 16)
    assert (lay["tile"], lay["bm"], lay["bn"], lay["tm"], lay["tn"]) == (
        tile, *shape)
    assert lay["grid"] == grid and lay["stages"] == 4
    assert lay["threads"] == 128
    assert -(-c // 128) * -(-864 // 128) < 2 * 132


def test_ell_layout_balances_the_busiest_sm():
    """Below the large tile's grid, the half tile is taken exactly where 3
    of its slots on the busiest SM weigh less than 5 of the small tile's."""
    seen = set()
    for k in range(1, 40):
        for n_pad, c in ((864, 767), (864, 1000), (131, 67), (200, 130)):
            lay = community_spmm.ell_layout(k, n_pad, c, 4, 16, 16)
            if lay["tile"] == "large":
                continue

            def busiest(bm, bn):
                return -(-(-(-c // bn) * -(-n_pad // bm) * k) // 132)
            half = 3 * busiest(64, 32) < 5 * busiest(64, 64)
            assert lay["tile"] == ("half" if half else "small")
            seen.add(lay["tile"])
    assert seen == {"half", "small"}


@pytest.mark.parametrize("k,n_pad,c", [(3, 4584, 10), (1, 864, 1),
                                       (3, 4584, 32), (200, 4584, 16)])
def test_ell_layout_narrow_tile_up_to_32_columns(k, n_pad, c):
    """C <= 32 takes 64 x 16 tiles with one column per thread, whatever the
    grid: at C = 10, 216 blocks stream the trainer's blocks once."""
    lay = community_spmm.ell_layout(k, n_pad, c, 4, 16, 16)
    assert (lay["tile"], lay["bm"], lay["bn"], lay["tm"], lay["tn"]) == (
        "narrow", 64, 16, 4, 1)
    assert lay["grid"] == (-(-c // 16), -(-n_pad // 64), k)
    assert lay["z_copy"] == 4
    assert community_spmm.ell_layout(k, n_pad, 33, 4, 16, 16)["tile"] != \
        "narrow"


def test_ell_layout_copy_widths():
    """16-byte copies only where pointer and row stride allow them: Z rows
    of 767 f32 (3,068 bytes) and A rows of n_pad 131 take 4-byte copies,
    bf16 rows of odd length 2-byte loads."""
    align = community_spmm.copy_align
    assert align(1 << 20, 4 * 767) == 4 and align(1 << 20, 4000) == 16
    assert align(1 << 20, 4 * 131) == 4 and align(1 << 20, 2 * 131) == 2
    assert align(1 << 20 | 8, 4096) == 8 and align(0, 0) == 16
    trainer = community_spmm.ell_layout(3, 4584, 767, 4,
                                        align(1 << 20, 4 * 767),
                                        align(1 << 20, 4 * 4584))
    assert (trainer["a_copy"], trainer["z_copy"]) == (16, 4)
    for bb, want in ((4, 4), (2, 2)):
        lay = community_spmm.ell_layout(3, 131, 64, bb, 16,
                                        align(1 << 20, bb * 131))
        assert (lay["a_copy"], lay["z_copy"]) == (want, 16)
    # Z rows of the narrow tile always take 4-byte copies
    assert community_spmm.ell_layout(3, 64, 16, 4, 16, 16)["z_copy"] == 4
    lay = community_spmm.ell_layout(3, 130, 64, 2, 16, align(0, 2 * 130))
    assert lay["a_copy"] == 4
    # the operands' own pointers: a view one element in is 4-byte aligned
    blocks = torch.zeros((2, 2, 64, 64))
    plane = torch.zeros((100, 65))
    assert community_spmm.operand_layout(blocks, plane)["z_copy"] == 4
    assert community_spmm.operand_layout(
        blocks, torch.zeros((100, 64)))["z_copy"] == 16


@pytest.mark.parametrize("k,c,tile,grid", [
    (3, 767, "large", (6, 36, 3)), (3, 1000, "large", (8, 36, 3)),
    (3, 10, "narrow", (1, 72, 3)), (1, 1000, "large", (8, 36, 1)),
    (1, 767, "small", (12, 72, 1)), (1, 10, "narrow", (1, 72, 1))])
def test_dense_launch_takes_the_ell_layout(k, c, tile, grid):
    """The dense launch is the ELL kernel's: its tile is
    ``community_spmm_ell_layout``'s for f32 blocks of the (k, M, n, n)
    block row, read off the operands by ``operand_layout``.  At the
    trainer's n_pad 4584, k = 3 lanes take the large tile at C = 767 and
    1000 and the narrow one at C = 10; one lane keeps the large tile at
    C = 1000 (288 blocks) and drops to 64 x 64 at C = 767 (216 large
    tiles are too few)."""
    a_row = torch.empty((k, 3, 4584, 4584), device="meta")
    z = torch.empty((3, 4584, c), device="meta")
    want = community_spmm.ell_layout(k, 4584, c, 4, 4 if c == 767 else 16,
                                     16)
    assert (want["tile"], want["grid"]) == (tile, grid)
    assert community_spmm.operand_layout(a_row, z) == want
    assert want["a_copy"] == 16
    assert want["z_copy"] == (16 if tile != "narrow" and c != 767 else 4)


def test_ell_layout_shared_memory_fits_every_configuration():
    """Every tile, in f32 and bf16, stays within a block's 232,448 bytes,
    and each needs its 48 KB-plus opt-in only as dynamic shared memory."""
    seen = set()
    for k, n_pad, c in ((3, 4584, 1000), (1, 864, 767), (1, 864, 1000),
                        (3, 4584, 10)):
        for bb in (4, 2):
            lay = community_spmm.ell_layout(k, n_pad, c, bb, 16, 16)
            seen.add(lay["tile"])
            bm, bn, _, _, stages = community_spmm.ELL_TILES[lay["tile"]]
            assert lay["smem_bytes"] == stages * (bm * (32 * bb + 16)
                                                  + 32 * bn * 4)
            assert lay["smem_bytes"] <= community_spmm._SMEM_LIMIT
    assert seen == set(community_spmm.ELL_TILES)
    with pytest.raises(ValueError, match="block_bytes"):
        community_spmm.ell_layout(1, 8, 8, 8, 16, 16)


def _fused_cpu_operands():
    blocks, off, mask, z, w, rows, nbrs = _port(*_packed_operands(
        0, 2, 3, 16, 8, 5, layout_valid=True))
    return [blocks, off, mask.to(torch.int32), z, w, rows, nbrs]


FUSED_REFUSALS = {   # operand index -> bad value, error, message
    "blocks not 4-D": (0, lambda t: t[0], ValueError, "expected blocks"),
    "blocks f16": (0, lambda t: t.half(), TypeError, "dtype"),
    "offsets int64": (1, lambda t: t.long(), TypeError, "dtype"),
    "offsets shape": (1, lambda t: t[:, :2].contiguous(), ValueError,
                      "shape"),
    "mask float": (2, lambda t: t.float(), TypeError, "dtype"),
    "plane 3-D": (3, lambda t: t[None], ValueError, "expected z_plane"),
    "plane f64": (3, lambda t: t.double(), TypeError, "dtype"),
    "plane not contiguous": (3, lambda t: t.t().contiguous().t(),
                             ValueError, "contiguous"),
    "w rows": (4, lambda t: t[:-1].contiguous(), ValueError, "shape"),
    "w f64": (4, lambda t: t.double(), TypeError, "dtype"),
    "row_counts shape": (5, lambda t: t[:1].contiguous(), ValueError,
                         "shape"),
    "nbr_counts int64": (6, lambda t: t.long(), TypeError, "dtype"),
}


@pytest.mark.parametrize("case", sorted(FUSED_REFUSALS))
def test_fused_launcher_refuses_bad_operands(case):
    """Every operand check of the fused launcher, run on the CPU through
    ``check_fused_operands`` (the launcher calls it with the CUDA device)."""
    args = _fused_cpu_operands()
    community_spmm.check_fused_operands(torch.device("cpu"), *args)
    i, bad, error, message = FUSED_REFUSALS[case]
    args[i] = bad(args[i])
    with pytest.raises(error, match=message):
        community_spmm.check_fused_operands(torch.device("cpu"), *args)


def test_fused_launcher_refuses_a_width_past_the_limit():
    blocks, off, mask, _, _, rows, nbrs = _fused_cpu_operands()
    for c_in, fits in ((12288, True), (12289, False)):
        z = torch.zeros((blocks.shape[0] * 64, c_in))
        w = torch.zeros((c_in, 1))
        if fits:
            community_spmm.check_fused_operands(
                torch.device("cpu"), blocks, off, mask, z, w, rows, nbrs)
            continue
        with pytest.raises(ValueError, match="shared memory"):
            community_spmm.check_fused_operands(
                torch.device("cpu"), blocks, off, mask, z, w, rows, nbrs)
    other = torch.device("meta")
    with pytest.raises(ValueError, match="is on"):
        community_spmm.check_fused_operands(
            other, blocks, off, mask, z, w, rows, nbrs)


def test_library_path_is_keyed_by_shared_headers(monkeypatch, tmp_path):
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    paths = {name: build.library_path(name) for name in build.LIBRARIES}
    header = tmp_path / "ell_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    for name, path in paths.items():
        assert build.library_path(name) != path


# ---------------------------------------------------------------------------
# dense block-row kernel
# ---------------------------------------------------------------------------

def _dense_operands(seed, k, m, n_pad, c):
    """Random dense block rows whose absent blocks (mask 0) hold random
    non-zero values, per-lane masks with zeros (each lane keeps its own
    block), and a shared row with a zero."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, m, n_pad, n_pad)).astype(np.float32)
    z = rng.normal(size=(m, n_pad, c)).astype(np.float32)
    lanes = (rng.random((k, m)) > 0.4).astype(np.int32)
    lanes[np.arange(k), np.arange(k) % m] = 1
    shared = np.ones(m, np.int32)
    shared[-1] = 0
    return a, z, lanes, shared


DENSE_CASES = [  # k, M, n_pad, C
    (3, 3, 64, 48),
    (4, 4, 40, 10),
    (2, 5, 24, 33),
    (1, 3, 72, 128),
]


@pytest.mark.parametrize("form", ["lanes", "shared", "none", "row"])
@pytest.mark.parametrize("k,m,n_pad,c", DENSE_CASES)
def test_dense_plain_version_matches_reference_oracle(k, m, n_pad, c, form):
    """Every mask form of ``ops.community_spmm`` — per-lane (k, M), shared
    (M,), None, and one 3-D block row — against the reference's dispatch
    (its jnp oracle, vmapped over lanes) and the port's ``ref`` directly."""
    a, z, lanes, shared = _dense_operands(k + m, k, m, n_pad, c)
    if form == "row":
        a, mask = a[0], shared
    else:
        mask = {"lanes": lanes, "shared": shared, "none": None}[form]
    want = jops.community_spmm(*_jax(a, z, mask))
    got = ops.community_spmm(*_port(a, z, mask))
    _close(got, want, 1e-6)
    # the CPU dispatch runs the plain version, bit for bit
    full = np.ones(m, np.int32) if mask is None else mask
    np.testing.assert_array_equal(
        got.numpy(), ref.community_spmm_ref(*_port(a, z, full)).numpy())
    if form == "row":
        _close(got, jref.community_spmm_ref(*_jax(a, z, mask)), 1e-6)


@pytest.mark.parametrize("k,m,n_pad,c", DENSE_CASES)
def test_dense_plain_version_matches_pallas_interpret(k, m, n_pad, c):
    """The interpret-mode Pallas body, lane by lane with each lane's mask
    (the reference's vmap), against the port's CPU dispatch."""
    a, z, lanes, _ = _dense_operands(2 * k + m, k, m, n_pad, c)
    want = np.stack([np.asarray(pallas_dense(*_jax(a[i], z, lanes[i]),
                                             interpret=True))
                     for i in range(k)])
    _close(ops.community_spmm(*_port(a, z, lanes)), want, 1e-5)


def test_dense_masked_block_contributes_nothing():
    """A masked block adds nothing, whatever finite values it holds;
    unmasked, the same block would."""
    a, z, lanes, _ = _port(*_dense_operands(5, 3, 4, 16, 8))
    out = ops.community_spmm(a, z, lanes)
    full = ops.community_spmm(a, z, torch.ones_like(lanes))
    assert float((out - full).abs().max()) > 1e-3
    moved = a.clone()
    moved[lanes == 0] = 7.0 * moved[lanes == 0] + 1.0
    np.testing.assert_array_equal(ops.community_spmm(moved, z, lanes).numpy(),
                                  out.numpy())


def test_dense_launcher_refuses_cpu_tensors():
    a, z, lanes, _ = _port(*_dense_operands(0, 2, 3, 16, 4))
    before = community_spmm.dense_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        community_spmm.community_spmm(a, z, lanes)
    assert community_spmm.dense_launches == before


def test_dense_equals_ell_on_a_layout_with_every_block():
    """On a layout whose ELL slots list every block in ascending community
    order (max_deg = M), the dense form over the block rows and the ELL
    form over the slots are one sum: the plain versions agree to f32
    noise (the CUDA kernels share one FFMA order and agree bitwise; the
    card checks that)."""
    g, part = jgraph.synthetic_powerlaw_communities(
        3, nodes_per_part=24, size_skew=0.5, feat_dim=8, seed=0)
    lay = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                        compressed=True, pad_mode="global")
    csr = lay.compress()
    assert csr.max_deg == lay.num_parts
    np.testing.assert_array_equal(csr.ell_indices,
                                  np.tile(np.arange(3), (3, 1)))
    z = lay.pack(np.random.default_rng(4).normal(
        size=(g.num_nodes, 12)).astype(np.float32))
    dense = ops.community_spmm(*_port(lay.a_blocks, z, lay.neighbor_mask))
    ell = ops.community_spmm_ell(*_port(csr.ell_blocks, csr.ell_indices,
                                        csr.ell_mask, z))
    _close(dense, ell, 1e-6)


def test_ops_route_device_tensors_to_the_launchers(monkeypatch):
    """Tensors off the CPU reach the CUDA launchers with int32 tables,
    contiguous operands and the dense mask expanded to (k, M); the CUDA
    branch runs here on meta tensors (no data) with the launchers
    recorded in place of the kernels."""
    calls = {}

    def record(name):
        def launcher(*args):
            calls[name] = args
            return torch.empty((1, 1, 1), device="meta")
        return launcher

    for name in ("community_spmm", "community_spmm_ell",
                 "community_spmm_ell_packed", "community_spmm_ell_fused"):
        monkeypatch.setattr(community_spmm, name, record(name))

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    k, m, d, n, c = 3, 4, 2, 8, 5
    ops.community_spmm(meta((k, m, n, n)), meta((m, n, c)),
                       meta((m,), torch.bool))
    a, z, mask = calls.pop("community_spmm")
    assert tuple(mask.shape) == (k, m) and mask.dtype == torch.int32
    ops.community_spmm(meta((m, n, n)), meta((m, n, c)))
    a, z, mask = calls.pop("community_spmm")
    assert tuple(a.shape) == (1, m, n, n) and tuple(mask.shape) == (1, m)
    table, fmask = meta((k, d), torch.int64), meta((k, d))
    ops.community_spmm_ell(meta((k, d, n, n)), table, fmask,
                           meta((m, n, c)))
    args = calls.pop("community_spmm_ell")
    assert [t.dtype for t in args[1:3] + args[4:]] == [torch.int32] * 4
    counts = (meta((k,), torch.int32), meta((k, d), torch.int32))
    ops.community_spmm_ell_packed(meta((k, d, n, n)), table, fmask,
                                  meta((20, c)), *counts)
    ops.community_spmm_ell_fused(meta((k, d, n, n)), table, fmask,
                                 meta((20, c)), meta((c, 6)), *counts)
    assert set(calls) == {"community_spmm_ell_packed",
                          "community_spmm_ell_fused"}
    for args in calls.values():
        assert all(t.is_contiguous() for t in args)


# ---------------------------------------------------------------------------
# SSD scan and flash attention
# ---------------------------------------------------------------------------

SSD_CASES = [                 # (b, s, h, p, g, n, chunk)
    (2, 128, 4, 32, 2, 32, 32),   # S a multiple of the chunk, G = 2
    (1, 96, 2, 16, 1, 16, 64),    # ragged: the chunk halves to 32
    (1, 100, 2, 16, 1, 8, 256),   # S < chunk: one chunk of 100
    (2, 64, 8, 16, 4, 16, 16),    # G = 4
]


def _ssd_operands(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (0.5 * np.abs(rng.normal(size=(b, s, h)))).astype(np.float32),
            -np.abs(rng.normal(size=(h,))).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


def _as(x, dtype):
    """numpy → (jnp, torch) pair in ``dtype`` ("f32" or "bf16")."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_plain_version_matches_pallas_interpret(b, s, h, p, g, n, chunk,
                                                    dtype):
    x, dt, a, bm, cm = _ssd_operands(0, b, s, h, p, g, n)
    jx, tx = _as(x, dtype)
    jb, tb = _as(bm, dtype)
    jc, tc = _as(cm, dtype)
    want, _ = pallas_ssd(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc,
                         chunk=chunk, interpret=True)
    got, none = ops.ssd_scan(tx, torch.as_tensor(dt), torch.as_tensor(a), tb,
                             tc, chunk=chunk)
    assert none is None and got.dtype == tx.dtype
    _close(got.float(), np.asarray(want, np.float32),
           1e-5 if dtype == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [c for c in SSD_CASES
                                               if c[1] % c[6] == 0])
def test_ssd_plain_version_matches_reference_oracle(b, s, h, p, g, n, chunk):
    """Where the chunk divides S the reference's oracle runs too."""
    args = _ssd_operands(1, b, s, h, p, g, n)
    want = jref.ssd_scan_ref(*(jnp.asarray(v) for v in args), chunk=chunk)
    got = ref.ssd_scan_ref(*(torch.as_tensor(v) for v in args), chunk=chunk)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s,chunk,want", [(4096, 256, 256), (100, 256, 100),
                                          (1000, 256, 8), (96, 64, 32),
                                          (7, 4, 1)])
def test_ssd_chunk_length_halves_until_it_divides(s, chunk, want):
    assert ref.ssd_chunk_length(s, chunk) == want


FLASH_CASES = [               # (b, s, hq, hkv, hd, causal, window)
    (2, 128, 4, 4, 32, True, None),    # MHA, causal
    (1, 256, 8, 2, 32, True, None),    # GQA
    (2, 128, 4, 1, 64, True, None),    # MQA
    (1, 256, 2, 2, 32, True, 48),      # sliding window
    (2, 128, 2, 1, 32, False, None),   # non-causal
    (1, 128, 4, 2, 16, False, 40),     # window without causal
]


def _flash_operands(seed, b, s, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hq, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", FLASH_CASES)
def test_flash_plain_version_matches_pallas_interpret(b, s, hq, hkv, hd,
                                                      causal, window, dtype):
    pairs = [_as(v, dtype) for v in _flash_operands(0, b, s, hq, hkv, hd)]
    want = pallas_flash(*(j for j, _ in pairs), causal=causal, window=window,
                        block_q=64, block_k=32, interpret=True)
    got = ops.flash_attention(*(t for _, t in pairs), causal=causal,
                              window=window)
    assert got.dtype == pairs[0][1].dtype
    _close(got.float(), np.asarray(want, np.float32),
           1e-5 if dtype == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", FLASH_CASES)
def test_flash_plain_version_matches_reference_oracle(b, s, hq, hkv, hd,
                                                      causal, window):
    args = _flash_operands(1, b, s, hq, hkv, hd)
    want = jref.flash_attention_ref(*(jnp.asarray(v) for v in args),
                                    causal=causal, window=window)
    got = ref.flash_attention_ref(*(torch.as_tensor(v) for v in args),
                                  causal=causal, window=window)
    _close(got, want, 1e-6)


def test_ssd_and_flash_launchers_refuse_cpu_tensors():
    x, dt, a, bm, cm = (torch.as_tensor(v)
                        for v in _ssd_operands(0, 1, 32, 2, 8, 1, 8))
    before = ssd_launcher.ssd_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_launcher.ssd_scan(x, dt, a, bm, cm, 32)
    assert ssd_launcher.ssd_launches == before
    q, k, v = (torch.as_tensor(t) for t in _flash_operands(0, 1, 32, 2, 1, 8))
    before = flash_launcher.flash_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_launcher.flash_attention(q, k, v)
    assert flash_launcher.flash_launches == before


def test_ssd_and_flash_ops_route_device_tensors_to_the_launchers(
        monkeypatch):
    """Tensors off the CPU reach the launchers contiguous, with dt and a in
    f32 and the chunk, masks and query offset passed through (meta
    tensors, launchers recorded in place of the kernels)."""
    calls = {}

    def ssd(*args):
        calls["ssd"] = args
        return torch.empty(args[0].shape, device="meta")

    def flash(*args, **kwargs):
        calls["flash"] = (args, kwargs)
        return torch.empty(args[0].shape, device="meta")

    monkeypatch.setattr(ssd_launcher, "ssd_scan", ssd)
    monkeypatch.setattr(flash_launcher, "flash_attention", flash)

    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    y, none = ops.ssd_scan(meta((2, 4, 16, 8)).transpose(1, 2),
                           meta((2, 16, 4)), meta((4,)), meta((2, 16, 1, 8)),
                           meta((2, 16, 1, 8)), chunk=8)
    assert none is None and tuple(y.shape) == (2, 16, 4, 8)
    args = calls.pop("ssd")
    assert all(t.is_contiguous() for t in args[:5]) and args[5] == 8
    assert [t.dtype for t in args[1:3]] == [torch.float32] * 2
    ops.flash_attention(meta((1, 4, 16, 8)).transpose(1, 2),
                        meta((1, 16, 2, 8)), meta((1, 16, 2, 8)),
                        causal=False, window=5)
    args, kwargs = calls.pop("flash")
    assert all(t.is_contiguous() for t in args)
    assert kwargs == {"causal": False, "window": 5, "q_offset": 0}


def test_flash_tensor_core_tiles_fit_every_head_dim():
    """The tensor-core kernel's tiles for every head_dim 1..256: the head
    padded to the next multiple of 64, two 64-row warpgroups up to hd 192
    with 128-key tiles (64 at hd 192), one warpgroup and 32-key tiles at
    256; q plus two
    stages of k and v, with 1 KB to align the swizzled blocks, fit a
    block's 232,448 bytes of shared memory."""
    for hd in range(1, 257):
        t = flash_launcher.tc_layout(hd)
        assert t["head_pad"] % 64 == 0
        assert hd <= t["head_pad"] < hd + 64
        assert (t["block_q"], t["block_k"], t["threads"]) == {
            256: (64, 32, 128), 192: (128, 64, 256)}.get(t["head_pad"],
                                                         (128, 128, 256))
        assert t["smem_bytes"] == 2 * t["head_pad"] * (
            t["block_q"] + 4 * t["block_k"]) + 1024
        assert t["smem_bytes"] <= 232448
    assert flash_launcher.tc_layout(128)["smem_bytes"] == 164864
    for hd in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            flash_launcher.tc_layout(hd)


def test_flash_ffma_tiles_fit_every_head_dim():
    """The FFMA (f32) kernel's tiles for every head_dim 1..256: the head
    padded to 64, 128 or 256; 128 query rows, 64-key tiles and 8 lanes a
    row at 64, 128 / 128 / 16 at 128, 64 / 64 / 16 at 256; q and k (rows
    padded by 4 floats), v and P for two keys a lane fit a block's 232,448
    bytes of shared memory (two blocks an SM at hd <= 64); the row groups
    of ``lanes_per_row`` lanes cover the block's rows and the lanes of a
    row the tile's keys and the padded head_dim in 4-column groups; and
    the grid's query tiles cover every row of the sequences the kernel is
    run at."""
    for hd in range(1, 257):
        t = flash_launcher.ffma_layout(hd)
        head, lanes = t["head_pad"], t["lanes_per_row"]
        assert head in (64, 128, 256) and hd <= head
        assert head == 64 or hd > head // 2
        assert (t["block_q"], t["block_k"], lanes, t["threads"]) == {
            64: (128, 64, 8, 256), 128: (128, 128, 16, 256),
            256: (64, 64, 16, 256)}[head]
        assert t["smem_bytes"] == 4 * (
            (t["block_q"] + t["block_k"]) * (head + 4)
            + t["block_k"] * head + 2 * lanes * (t["block_q"] + 4))
        assert t["smem_bytes"] <= 232448
        assert t["rows_per_thread"] * t["threads"] // lanes == t["block_q"]
        assert t["keys_per_thread"] * lanes == t["block_k"]
        assert head % (4 * lanes) == 0
        for s in (1, 63, 64, 65, 129, 1000, 2048, 3000, 4097, 32768):
            tiles = -(-s // t["block_q"])
            assert (tiles - 1) * t["block_q"] < s <= tiles * t["block_q"]
    assert flash_launcher.ffma_layout(128)["smem_bytes"] == 217600
    assert 2 * (flash_launcher.ffma_layout(64)["smem_bytes"] + 1024) \
        <= 233472
    for hd in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            flash_launcher.ffma_layout(hd)


def _flash_cpu(b=1, s=8, hq=4, hkv=2, hd=16, dtype=torch.bfloat16):
    return [torch.zeros(shape, dtype=dtype) for shape in
            ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


FLASH_REFUSALS = {   # mutation of (q, k, v, window) -> error, message
    "q 3-D": (lambda a: [a[0][0]] + a[1:], ValueError, "expected q"),
    "q f16": (lambda a: [t.half() for t in a[:3]] + a[3:], TypeError,
              "dtype"),
    "k f32 beside bf16 q": (lambda a: [a[0], a[1].float()] + a[2:],
                            TypeError, "dtype"),
    "k other length": (lambda a: [a[0], a[1][:, :4].contiguous()] + a[2:],
                       ValueError, "shape"),
    "v other heads": (lambda a: [a[0], a[1], a[2][:, :, :1].contiguous(),
                                 a[3]], ValueError, "shape"),
    "q not contiguous": (lambda a: [a[0].transpose(1, 2).contiguous()
                                    .transpose(1, 2)] + a[1:], ValueError,
                         "contiguous"),
    "kv heads do not divide": (lambda a: [a[0]] + _flash_cpu(hkv=3)[1:]
                               + a[3:], ValueError, "kv heads"),
    "head_dim 257": (lambda a: _flash_cpu(hd=257) + a[3:], ValueError,
                     "head_dim"),
    "window 0": (lambda a: a[:3] + [0], ValueError, "window"),
}


@pytest.mark.parametrize("case", sorted(FLASH_REFUSALS))
def test_flash_launcher_refuses_bad_operands_on_the_host(case):
    """Every operand check of the flash launcher, on the CPU through
    ``check_operands`` (the launcher calls it with the CUDA device)."""
    cpu = torch.device("cpu")
    args = _flash_cpu() + [None]
    assert flash_launcher.check_operands(*args, cpu) == (1, 8, 4, 2, 16)
    mutate, error, message = FLASH_REFUSALS[case]
    with pytest.raises(error, match=message):
        flash_launcher.check_operands(*mutate(args), cpu)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_dispatch_is_fixed_by_dtype(monkeypatch, dtype):
    """bf16 reaches the tensor-core library, f32 the FFMA one; every call
    counts in ``flash_launches``, tensor-core calls in ``flash_tc_launches``
    (launch recorded in place of the kernel, the device check bypassed)."""
    calls = []
    monkeypatch.setattr(flash_launcher.build, "cuda_device",
                        lambda kernel, t: t.device)
    monkeypatch.setattr(flash_launcher.build, "launch",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(flash_launcher, "flash_launches", 0)
    monkeypatch.setattr(flash_launcher, "flash_tc_launches", 0)
    q, k, v = _flash_cpu(dtype=dtype)
    out = flash_launcher.flash_attention(q, k, v, causal=False, window=3)
    assert out.dtype == dtype and out.shape == q.shape
    (kernel, lib, symbol, tensors, scalars, _, errors), = calls
    tc = dtype == torch.bfloat16
    assert lib == (flash_launcher.TC_LIB if tc else flash_launcher.LIB)
    assert symbol == ("flash_attention_bf16" if tc else
                      "flash_attention_f32")
    assert errors.startswith(lib)
    assert scalars == [1, 8, 4, 2, 16, 0, 3, 0.25]
    assert (flash_launcher.flash_launches,
            flash_launcher.flash_tc_launches) == (1, int(tc))
