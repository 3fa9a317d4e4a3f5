"""The port's CUDA kernels, trainers and server on the card (skipped
without one).

Imports torch, numpy and the port only, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: the strided and packed kernels within 1e-6 · max |ref| with f32
blocks and 1e-5 with bf16; the fused kernel within 1e-5 · max of the packed
kernel followed by ``torch.matmul``, within 1e-4 · max of its reassociated
plain version, and bitwise equal to the packed kernel with W = I; the
dense kernel within 1e-5 · max of its plain version (cuBLAS sums the
plain einsum in another order), with absent blocks holding random values
or NaN (never read), and bitwise equal to the ELL kernel where the ELL
slots list every block in order (the dense launch is the ELL kernel's
dense addressing).  The trainer's
kernel path is held against its plain path at one shared state, in ELL and
dense mode; the server's cached path against its cold path (bitwise) and
against the same server on the CPU; the serial and baseline trainers run.

The SSD scan and flash attention kernels are held against their plain
versions: f32 flash (the FFMA kernel) within 1e-5 · max |ref|; f32 SSD
within 1e-4 · max (the chunk's cumsum is summed in another order, and the
decay exp(cum_t − cum_u) turns its absolute error |cum| · 2^-24 into a
relative one); bf16 within 2^-7 · max, one bf16 ulp at the largest value
(both sum in f32 and round the output once; the tensor-core flash kernel
also rounds P to bf16 before P·V, and normalises by the sum of the rounded
P; the tensor-core SSD kernel rounds B·w, the carried state and the
decayed scores to bf16 before its products).  The reduced Mamba-2
forward through the SSD kernel matches the plain path in f32 within
1e-4 · max on the logits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import gcn, graph
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.serial import BaselineTrainer, SerialADMMTrainer
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.configs import get_config
from repro_torch.kernels import build, community_spmm, ops, ref
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels import ssd_scan as ssd_launcher
from repro_torch.models.build import make_model
from repro_torch.serve import CommunityServer, ServeConfig

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


@pytest.mark.parametrize("mode", ["packed", "dense", "packed-bf16"])
def test_trainer_kernel_path_matches_plain_path(cuda_device, mode):
    g, _ = graph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    config = {"packed": TrainerConfig.packed(use_kernel=True),
              "dense": TrainerConfig.dense(use_kernel=True),
              "packed-bf16": TrainerConfig.packed(use_kernel=True,
                                                  adjacency_bf16=True)}[mode]
    tr = ParallelADMMTrainer(gcn.GCNConfig((16, 32, g.num_classes)),
                             ADMMConfig(nu=1e-3, rho=1e-3), g, 8, seed=0,
                             config=config)
    assert tr.device.type == "cuda"
    for _ in range(5):
        tr.step()
    community_spmm.launches = community_spmm.dense_launches = 0
    tr.step()
    count = community_spmm.dense_launches if mode == "dense" \
        else community_spmm.launches
    assert count == tr.cfg.num_layers + 1
    got, want = tr.objectives(use_kernel=True), tr.objectives(use_kernel=False)
    for (va, ga), (vb, gb) in zip(got["w"] + got["z"],
                                  want["w"] + want["z"]):
        assert float((va - vb).abs().max()) <= 1e-5 * float(vb.abs().max())
        assert float((ga - gb).abs().max()) <= 1e-5 * float(gb.abs().max())
    log = tr.train(2)
    assert all(np.isfinite(log.lagrangian)) and all(np.isfinite(log.residual))


@pytest.mark.parametrize("fused", [False, True], ids=["packed", "fused"])
def test_multishard_trainer_kernel_path_matches_plain_path(cuda_device,
                                                           fused):
    """Four loopback shards on the packed wire: each aggregation is one
    launch of the packed kernel over every shard's lanes (the fused kernel
    at the four Z-update sites with ``fused``), and the kernel path's
    objectives match the plain path's at one shared state."""
    g, _ = graph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    tr = ParallelADMMTrainer(gcn.GCNConfig((16, 32, g.num_classes)),
                             ADMMConfig(nu=1e-3, rho=1e-3), g, 8, seed=0,
                             config=TrainerConfig.packed(use_kernel=True,
                                                         fused=fused),
                             n_shards=4)
    for _ in range(5):
        tr.step()
    community_spmm.packed_launches = community_spmm.fused_launches = 0
    tr.step()
    # two W-update aggregates; unfused also the dual refresh, fused the
    # target, relay, FISTA and dual sites
    assert community_spmm.packed_launches == (2 if fused else 3)
    assert community_spmm.fused_launches == (4 if fused else 0)
    got, want = tr.objectives(use_kernel=True), tr.objectives(use_kernel=False)
    tol = 1e-4 if fused else 1e-5
    for (va, ga), (vb, gb) in zip(got["w"] + got["z"],
                                  want["w"] + want["z"]):
        assert float((va - vb).abs().max()) <= tol * float(vb.abs().max())
        assert float((ga - gb).abs().max()) <= tol * float(gb.abs().max())
    log = tr.train(2)
    assert all(np.isfinite(log.lagrangian)) and all(np.isfinite(log.residual))


def _stacked_trainer_operands(c_in, c_out, device, shards=3, n_pad=4584):
    """The 3-shard trainer's stacked packed-wire operands at full width:
    one lane per shard, three slots each reading one of the three buckets
    of its shard's receive plane; the planes laid end to end and the
    offsets shifted by s · recv_plane_rows."""
    gen = torch.Generator(device=device).manual_seed(c_in)
    d = 3
    rpr = d * n_pad
    blocks = torch.randn((shards, d, n_pad, n_pad), generator=gen,
                         device=device)
    local = (torch.arange(d, device=device) * n_pad).repeat(shards, 1)
    shift = (torch.arange(shards, device=device) * rpr)[:, None]
    off = (local + shift).to(torch.int32).contiguous()
    mask = torch.ones((shards, d), dtype=torch.int32, device=device)
    planes = torch.randn((shards * rpr, c_in), generator=gen, device=device)
    w = torch.randn((c_in, c_out), generator=gen, device=device) / 30.0
    rows = torch.full((shards,), n_pad, dtype=torch.int32, device=device)
    nbrs = torch.full((shards, d), n_pad, dtype=torch.int32, device=device)
    return blocks, off, local.to(torch.int32), mask, planes, w, rows, nbrs, rpr


@pytest.mark.parametrize("c_in,c_out", [(767, 1000), (1000, 10)])
def test_stacked_launches_at_the_trainer_shapes(cuda_device, c_in, c_out):
    """The packed and fused launches over the three shards' stacked lanes:
    against their plain versions, and bitwise equal to one launch per
    shard on its own receive plane with unshifted offsets."""
    blocks, off, local, mask, planes, w, rows, nbrs, rpr = \
        _stacked_trainer_operands(c_in, c_out, cuda_device)
    packed = community_spmm.community_spmm_ell_packed(blocks, off, mask,
                                                      planes, rows, nbrs)
    fused = community_spmm.community_spmm_ell_fused(blocks, off, mask,
                                                    planes, w, rows, nbrs)
    want = ref.community_spmm_ell_packed_einsum(blocks, off, mask, planes,
                                                rows, nbrs)
    assert float((packed - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    plain = ref.community_spmm_ell_fused_einsum(blocks, off, mask, planes,
                                                w, rows, nbrs)
    assert float((fused - plain).abs().max()) <= \
        1e-4 * float(plain.abs().max())
    two_step = packed @ w
    assert float((fused - two_step).abs().max()) <= \
        1e-5 * float(two_step.abs().max())
    per_p, per_f = [], []
    for s in range(blocks.shape[0]):
        lane = slice(s, s + 1)
        plane = planes[s * rpr:(s + 1) * rpr]
        args = (blocks[lane], local[lane].contiguous(), mask[lane])
        per_p.append(community_spmm.community_spmm_ell_packed(
            *args, plane, rows[lane], nbrs[lane]))
        per_f.append(community_spmm.community_spmm_ell_fused(
            *args, plane, w, rows[lane], nbrs[lane]))
    assert torch.equal(packed, torch.cat(per_p))
    assert torch.equal(fused, torch.cat(per_f))


def _packed_operands(seed, k, max_deg, n_pad, c_in, c_out, device):
    """Random packed-plane operands with ragged counts; masked slots point
    anywhere in the plane."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, n_pad + 1, size=k + 2)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    plane_rows = int(counts.sum())
    slot = rng.integers(0, k + 2, size=(k, max_deg))
    mask = np.zeros((k, max_deg), np.float32)
    for r in range(k):
        mask[r, : 1 + r % max_deg] = 1.0
    off = np.where(mask > 0, starts[slot],
                   rng.integers(0, plane_rows, size=(k, max_deg)))
    out = [rng.normal(size=(k, max_deg, n_pad, n_pad)).astype(np.float32),
           off.astype(np.int32), mask,
           rng.normal(size=(plane_rows, c_in)).astype(np.float32),
           rng.normal(size=(c_in, c_out)).astype(np.float32),
           rng.integers(1, n_pad + 1, size=k).astype(np.int32),
           (counts[slot] * (mask > 0)).astype(np.int32)]
    return [torch.as_tensor(x, device=device) for x in out]


PACKED = [  # k, max_deg, n_pad, c_in, c_out
    (1, 16, 96, 200, 130),
    (3, 3, 64, 48, 10),
    (2, 5, 131, 67, 256),
    (4, 1, 40, 1000, 3),
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k,max_deg,n_pad,c_in,c_out", PACKED)
def test_packed_kernel_matches_plain_version(cuda_device, k, max_deg, n_pad,
                                             c_in, c_out, bf16):
    blocks, off, mask, z, _, rows, nbrs = _packed_operands(
        0, k, max_deg, n_pad, c_in, c_out, cuda_device)
    if bf16:
        blocks = blocks.to(torch.bfloat16)
    before = community_spmm.packed_launches
    got = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    torch.cuda.synchronize()
    assert community_spmm.packed_launches == before + 1
    want = ref.community_spmm_ell_packed_einsum(blocks, off, mask, z, rows,
                                                nbrs)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= (1e-5 if bf16 else 1e-6) * scale


@pytest.mark.parametrize("k,max_deg,n_pad,c_in,c_out", PACKED)
def test_fused_kernel_matches_plain_versions(cuda_device, k, max_deg, n_pad,
                                             c_in, c_out):
    blocks, off, mask, z, w, rows, nbrs = _packed_operands(
        1, k, max_deg, n_pad, c_in, c_out, cuda_device)
    before = community_spmm.fused_launches
    got = ops.community_spmm_ell_fused(blocks, off, mask, z, w, rows, nbrs)
    torch.cuda.synchronize()
    assert community_spmm.fused_launches == before + 1
    agg = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    two_step = agg @ w
    assert float((got - two_step).abs().max()) \
        <= 1e-5 * float(two_step.abs().max())
    plain = ref.community_spmm_ell_fused_einsum(blocks, off, mask, z, w, rows,
                                                nbrs)
    assert float((got - plain).abs().max()) <= 1e-4 * float(plain.abs().max())
    # with W = I the fused output is the packed aggregate, bit for bit
    eye = torch.eye(c_in, device=cuda_device)
    assert torch.equal(
        ops.community_spmm_ell_fused(blocks, off, mask, z, eye, rows, nbrs),
        agg)


def test_halo_kernel_matches_plain_version(cuda_device):
    blocks, off, mask, z, _, rows, nbrs = _packed_operands(
        2, 3, 4, 64, 32, 8, cuda_device)
    self_mask = torch.zeros_like(mask)
    self_mask[:, 0] = mask[:, 0]
    got = ops.community_halo_spmm(blocks, off, mask, self_mask, z, rows, nbrs)
    cross = mask * (1.0 - self_mask)
    want = ref.community_spmm_ell_packed_einsum(
        blocks, off, cross, z, rows, (nbrs * (cross > 0)).to(torch.int32))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("c_out", [1, 10, 1000])
@pytest.mark.parametrize("c_in", [64, 127, 129, 767, 1000, 1025])
def test_fused_cluster_kernel_at_the_chunk_edges(cuda_device, c_in, c_out):
    """Widths on both sides of a 128-column chunk and of the 8-block
    cluster (1025 columns: nine chunks, two on block 0), three lanes."""
    blocks, off, mask, z, w, rows, nbrs = _packed_operands(
        4, 3, 4, 70, c_in, c_out, cuda_device)
    got = ops.community_spmm_ell_fused(blocks, off, mask, z, w, rows, nbrs)
    agg = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    two_step = agg @ w
    assert float((got - two_step).abs().max()) \
        <= 1e-5 * float(two_step.abs().max())
    plain = ref.community_spmm_ell_fused_einsum(blocks, off, mask, z, w, rows,
                                                nbrs)
    assert float((got - plain).abs().max()) <= 1e-4 * float(plain.abs().max())
    eye = torch.eye(c_in, device=cuda_device)
    assert torch.equal(
        ops.community_spmm_ell_fused(blocks, off, mask, z, eye, rows, nbrs),
        agg)


def test_fused_layout_matches_the_launcher(cuda_device):
    """The kernel's own cluster size and shared-memory bytes equal the
    launcher's ``fused_cluster`` / ``fused_smem_bytes`` at every width."""
    import ctypes
    lib = build.load(community_spmm.FUSED_LIB)
    query = lib.community_spmm_ell_fused_layout
    query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    for c_in in range(1, 12290):
        query(c_in, out)
        assert (out[0], out[1], out[2]) == (
            community_spmm.fused_cluster(c_in)[0], 32,
            community_spmm.fused_smem_bytes(c_in))


def test_fused_kernel_refuses_too_wide_c_in(cuda_device):
    blocks, off, mask, z, w, rows, nbrs = _packed_operands(
        3, 1, 1, 16, 12289, 4, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        community_spmm.community_spmm_ell_fused(
            blocks, off, mask.to(torch.int32), z, w, rows, nbrs)


def test_server_on_the_card_matches_the_cpu(cuda_device):
    g, part = graph.synthetic_powerlaw_communities(
        8, nodes_per_part=12, attach=1, feat_dim=8, size_skew=0.8, seed=0)
    cfg = gcn.GCNConfig((8, 16, g.num_classes))
    layout = graph.build_community_layout(g.num_nodes, g.edges, part,
                                          compressed=True,
                                          pad_mode="bucketed", num_parts=8)
    ws = gcn.init_weights(cfg, torch.Generator().manual_seed(0))
    ids = np.arange(g.num_nodes)
    cpu = CommunityServer(cfg, layout, ws, g.features, device="cpu")
    want = cpu.serve(ids)
    community_spmm.packed_launches = community_spmm.fused_launches = 0
    cached = CommunityServer(cfg, layout, ws, g.features)
    assert cached.device.type == "cuda"
    got = cached.serve(ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cold = CommunityServer(cfg, layout, ws, g.features,
                           ServeConfig(cache_enabled=False))
    np.testing.assert_array_equal(cold.serve(ids), got)
    assert community_spmm.packed_launches > 0
    fused = CommunityServer(cfg, layout, ws, g.features,
                            ServeConfig(fused=True, cache_enabled=False))
    np.testing.assert_allclose(fused.serve(ids), got, rtol=1e-4, atol=1e-5)
    assert community_spmm.fused_launches > 0
    assert cached.stats() == cpu.stats()


# the dense kernel against the plain einsum: f32 sums of up to M · n_pad
# products in two orders
DENSE_TOL = 1e-5


def _dense_operands(seed, k, m, n_pad, c, device):
    """Random dense block rows, per-lane masks with zeros (absent blocks
    hold random values), lane i keeping block i % M."""
    rng = np.random.default_rng(seed)
    lanes = (rng.random((k, m)) > 0.4).astype(np.int32)
    lanes[np.arange(k), np.arange(k) % m] = 1
    out = [rng.normal(size=(k, m, n_pad, n_pad)).astype(np.float32),
           rng.normal(size=(m, n_pad, c)).astype(np.float32), lanes]
    return [torch.as_tensor(x, device=device) for x in out]


@pytest.mark.parametrize("k,m,n_pad,c", [
    (3, 3, 64, 48), (4, 4, 131, 67), (2, 5, 40, 10), (1, 3, 200, 1000),
    (3, 3, 96, 767)])
def test_dense_kernel_matches_plain_version(cuda_device, k, m, n_pad, c):
    a, z, lanes = _dense_operands(k, k, m, n_pad, c, cuda_device)
    before = community_spmm.dense_launches
    got = ops.community_spmm(a, z, lanes)
    torch.cuda.synchronize()
    assert community_spmm.dense_launches == before + 1
    want = ref.community_spmm_ref(a, z, lanes)
    assert float((got - want).abs().max()) \
        <= DENSE_TOL * float(want.abs().max())
    # the shared-row and mask=None forms, and one 3-D block row
    shared = lanes[0]
    for args in ((a, z, shared), (a, z, None), (a[0], z, shared)):
        got = ops.community_spmm(*args)
        mask = torch.ones(m, dtype=torch.int32, device=cuda_device) \
            if args[2] is None else args[2]
        want = ref.community_spmm_ref(args[0], z, mask)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) \
            <= DENSE_TOL * float(want.abs().max())


def test_dense_kernel_never_reads_an_absent_block(cuda_device):
    """NaN in every absent block: the kernel's output stays finite and
    equals the plain version on zeroed blocks; the plain version itself
    gives NaN (0 · NaN)."""
    a, z, lanes = _dense_operands(9, 3, 4, 72, 20, cuda_device)
    clean = a * lanes[:, :, None, None]
    a[lanes == 0] = float("nan")
    got = ops.community_spmm(a, z, lanes)
    want = ref.community_spmm_ref(clean, z, lanes)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) \
        <= DENSE_TOL * float(want.abs().max())
    assert not bool(torch.isfinite(ref.community_spmm_ref(a, z, lanes)).all())


def test_dense_kernel_is_bitwise_the_ell_kernel_with_every_block(
        cuda_device):
    """ELL slots listing every block in ascending order: the two kernels run
    one FFMA chain per output in the same order."""
    g, part = graph.synthetic_powerlaw_communities(
        3, nodes_per_part=40, size_skew=0.5, feat_dim=8, seed=0)
    lay = graph.build_community_layout(g.num_nodes, g.edges, part,
                                       compressed=True, pad_mode="global")
    csr = lay.compress()
    assert csr.max_deg == lay.num_parts
    z = torch.randn((lay.num_parts, lay.n_pad, 70), device=cuda_device)

    def dev(x):
        return torch.as_tensor(x, device=cuda_device)
    dense = ops.community_spmm(dev(lay.a_blocks), z, dev(lay.neighbor_mask))
    ell = ops.community_spmm_ell(dev(csr.ell_blocks), dev(csr.ell_indices),
                                 dev(csr.ell_mask), z)
    assert torch.equal(dense, ell)


@pytest.mark.parametrize("tile,n_pad,c", [("large", 1500, 1000),
                                          ("small", 400, 300),
                                          ("half", 200, 130),
                                          ("narrow", 1500, 10)])
def test_dense_kernel_is_bitwise_the_ell_kernel_at_each_tile(
        cuda_device, tile, n_pad, c):
    """k = M = 3, every block live and listed in order by the ELL slots:
    the dense launch and the strided ELL launch take the same tile
    configuration (the ELL kernel, dense addressing) and sum one FFMA chain
    per output in the same order."""
    gen = torch.Generator(device=cuda_device).manual_seed(n_pad + c)
    a = torch.randn((3, 3, n_pad, n_pad), generator=gen, device=cuda_device)
    z = torch.randn((3, n_pad, c), generator=gen, device=cuda_device)
    assert community_spmm.operand_layout(a, z)["tile"] == tile
    i32 = dict(dtype=torch.int32, device=cuda_device)
    ones = torch.ones((3, 3), **i32)
    dense = ops.community_spmm(a, z, ones)
    ell = ops.community_spmm_ell(a, torch.arange(3, **i32).repeat(3, 1),
                                 ones, z)
    assert torch.equal(dense, ell)


@pytest.mark.parametrize("tile,k,d,n_pad,c", [
    ("half", 1, 16, 864, 767), ("small", 1, 16, 864, 1000),
    ("large", 3, 3, 1536, 1024), ("narrow", 1, 16, 864, 10)])
def test_fused_identity_is_bitwise_the_packed_kernel_at_each_tile(
        cuda_device, tile, k, d, n_pad, c):
    """The fused kernel with W = I against the packed kernel in each of its
    tile configurations, the halo shape (one lane, 16 slots of 864 rows)
    among them: the same FFMA chain per output, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    blocks = torch.randn((k, d, n_pad, n_pad), generator=gen,
                         device=cuda_device)
    plane = torch.randn((d * n_pad, c), generator=gen, device=cuda_device)
    assert community_spmm.operand_layout(blocks, plane)["tile"] == tile
    i32 = dict(dtype=torch.int32, device=cuda_device)
    off = (torch.arange(d, **i32) * n_pad).repeat(k, 1)
    mask = torch.ones((k, d), **i32)
    rows = torch.full((k,), n_pad - 5, **i32)
    nbrs = torch.full((k, d), n_pad, **i32)
    nbrs[:, 1] = 33
    packed = ops.community_spmm_ell_packed(blocks, off, mask, plane, rows,
                                           nbrs)
    eye = torch.eye(c, device=cuda_device)
    fused = ops.community_spmm_ell_fused(blocks, off, mask, plane, eye, rows,
                                         nbrs)
    assert torch.equal(fused, packed)


def test_ell_layout_matches_the_launcher(cuda_device):
    """The kernel's own tile configuration, grid, stage ring and copy widths
    equal ``ell_layout`` over a sweep of lanes, rows, columns, block types
    and operand alignments."""
    import ctypes
    lib = build.load(community_spmm.LIB)
    query = lib.community_spmm_ell_layout
    query.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 11)()
    for k in (1, 2, 3, 16, 132):
        for n_pad in (1, 8, 63, 64, 65, 127, 128, 129, 131, 864, 4584):
            for c in (1, 10, 16, 17, 32, 33, 64, 67, 128, 129, 767, 1000):
                for bb in (4, 2):
                    for z_align, a_align in ((16, 16), (4, 4), (4, 2),
                                             (8, 16), (16, 1)):
                        assert query(k, n_pad, c, bb, z_align, a_align,
                                     out) == 0
                        t = community_spmm.ell_layout(k, n_pad, c, bb,
                                                      z_align, a_align)
                        assert list(out) == [
                            t["bm"], t["bn"], t["tm"], t["tn"], t["stages"],
                            *t["grid"], t["smem_bytes"], t["a_copy"],
                            t["z_copy"]]
    assert query(1, 8, 8, 8, 16, 16, out) == 1


@pytest.mark.parametrize("bb", [4, 2])
@pytest.mark.parametrize("z_align,a_align", [(16, 16), (4, 4), (4, 2),
                                             (8, 16)])
def test_launch_specs_match_the_layout_queries(cuda_device, bb, z_align,
                                               a_align):
    """Every launch spec (strided, packed, dense, fused) answers what its
    library's layout query answers: tile, threads per tile, stages, grid,
    shared memory and copy widths; the fused spec its cluster and shared
    memory."""
    for k in (1, 3, 16, 132):
        for n_pad in (8, 65, 129, 864, 4584):
            for c in (1, 10, 33, 64, 767, 1000):
                specs = [community_spmm.ell_spec(
                             k, 3, n_pad, c, k, block_bytes=bb,
                             z_align=z_align, a_align=a_align),
                         community_spmm.ell_packed_spec(
                             k, 3, n_pad, c, k * n_pad, block_bytes=bb,
                             z_align=z_align, a_align=a_align),
                         community_spmm.ell_fused_spec(
                             k, 3, n_pad, c, 7, k * n_pad, block_bytes=bb)]
                if bb == 4:
                    specs.append(community_spmm.spmm_spec(
                        k, 3, n_pad, c, z_align=z_align, a_align=a_align))
                for spec in specs:
                    assert community_spmm.query_layout(spec) == \
                        spec.layout_words(), (spec.name, spec.query)


def test_analysis_on_the_card(cuda_device):
    """The linter's configs on the card: every kernel event on the CUDA
    route, zero error findings, each spec within the card's shared memory
    and equal to its layout query."""
    from repro_torch import analysis
    from repro_torch.analysis.registry import AnalysisContext
    from repro_torch.analysis.rules.kernel import kernel_entries, smem_limit
    from repro_torch.launch import analyze

    for spec in analyze.FULL_CONFIGS:
        tape, exp = analysis.record_step(
            analyze.build_trainer(spec, cuda_device))
        ctx = AnalysisContext(trace=tape, expectations=exp)
        rep = analysis.run_rules(ctx, waivers=analyze.waivers())
        assert not rep.errors(), rep.summary()
        kernels = tape.of_kind("kernel")
        assert kernels and {e.info["route"] for e in kernels} == {"cuda"}
        for s, _ in kernel_entries(ctx):
            assert s.smem_bytes <= smem_limit()
            assert community_spmm.query_layout(s) == s.layout_words()


# the ELL / packed kernel at its tile edges: n_pad and C on both sides of 64
# and 128, C from 1 to 767, in each tile configuration (the fewest lanes
# that select it)
EDGE_N = (63, 64, 65, 127, 128, 129, 131)
EDGE_C = {"narrow": (1, 10, 32),
          "half": (33, 63, 64, 65, 67, 129, 767),
          "small": (63, 64, 65, 67, 127, 128, 129, 767),
          "large": (64, 65, 67, 128, 129, 767)}
EDGE_CASES = [(tile, n, c) for tile, cs in EDGE_C.items() for n in EDGE_N
              for c in cs]


def _edge_operands(seed, tile, n_pad, c, packed, device):
    """ELL (or packed-plane) operands that select ``tile``: ragged row
    counts, neighbour counts that include 0 and values off the 32-row
    stage, masked slots whose table entry and count hold values far out of
    range (the kernel must not read them).  Returns the kernel's operands
    and the plain version's (masked entries zeroed)."""
    rng = np.random.default_rng(seed)
    d = 3 if tile == "large" else 4
    k = next(k for k in range(1, 600) if community_spmm.ell_layout(
        k, n_pad, c, 4, 16, 16)["tile"] == tile)
    mask = (rng.random((k, d)) < 0.7).astype(np.int32)
    mask[np.arange(k), rng.integers(0, d, size=k)] = 1
    nbrs = rng.integers(0, n_pad + 1, size=(k, d))
    live = np.flatnonzero(mask)
    special = np.array([0, 1, 31, 33, n_pad - 1, n_pad])[: live.size]
    nbrs.flat[live[: special.size]] = special
    rows = rng.integers(1, n_pad + 1, size=k)
    rows[0] = n_pad
    if packed:
        z_rows = 3 * n_pad + 5
        table = rng.integers(0, z_rows - n_pad + 1, size=(k, d))
    else:
        z_rows = 5
        table = rng.integers(0, z_rows, size=(k, d))
    dead = mask == 0
    i32 = dict(dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = torch.randn((k, d, n_pad, n_pad), generator=gen, device=device)
    z = torch.randn((z_rows, c) if packed else (z_rows, n_pad, c),
                    generator=gen, device=device)
    kernel_ops = [torch.as_tensor(np.where(dead, 1 << 30, table), **i32),
                  torch.as_tensor(mask, **i32), torch.as_tensor(rows, **i32),
                  torch.as_tensor(np.where(dead, -7, nbrs), **i32)]
    plain_ops = [torch.as_tensor(np.where(dead, 0, table), **i32),
                 kernel_ops[1], kernel_ops[2],
                 torch.as_tensor(np.where(dead, 0, nbrs), **i32)]
    return blocks, z, kernel_ops, plain_ops


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tile,n_pad,c", EDGE_CASES)
def test_ell_kernel_at_the_tile_edges(cuda_device, tile, n_pad, c, packed,
                                      bf16):
    blocks, z, (table, mask, rows, nbrs), (ptable, _, _, pnbrs) = \
        _edge_operands(n_pad * 1000 + c, tile, n_pad, c, packed,
                       cuda_device)
    if bf16:
        blocks = blocks.to(torch.bfloat16)
    lay = community_spmm.operand_layout(blocks, z)
    assert lay["tile"] == tile
    if packed:
        got = community_spmm.community_spmm_ell_packed(blocks, table, mask,
                                                       z, rows, nbrs)
        want = ref.community_spmm_ell_packed_einsum(blocks, ptable, mask, z,
                                                    rows, pnbrs)
    else:
        got = community_spmm.community_spmm_ell(blocks, table, mask, z, rows,
                                                nbrs)
        want = ref.community_spmm_ell_einsum(blocks, ptable, mask, z, rows,
                                             pnbrs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= (1e-5 if bf16 else 1e-6) * scale


def test_dense_launcher_refuses_bad_operands(cuda_device):
    a, z, lanes = _dense_operands(2, 2, 3, 16, 4, cuda_device)
    with pytest.raises(ValueError, match="shape"):
        community_spmm.community_spmm(a, z, lanes[:, :2].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        community_spmm.community_spmm(a.double(), z, lanes)


def test_serial_and_baseline_trainers_run_on_the_card(cuda_device):
    g, _ = graph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    cfg = gcn.GCNConfig((16, 32, g.num_classes))
    serial = SerialADMMTrainer(cfg, ADMMConfig(nu=1e-3, rho=1e-3), g)
    assert serial.device.type == "cuda"
    log = serial.train(3)
    assert all(np.isfinite(log.lagrangian)) and all(np.isfinite(log.residual))
    cpu = SerialADMMTrainer(cfg, ADMMConfig(nu=1e-3, rho=1e-3), g,
                            device="cpu")
    cpu.state = serial.state.__class__(
        *[tuple(t.cpu() for t in leaf) if isinstance(leaf, tuple)
          else leaf.cpu() for leaf in serial.state])
    assert abs(float(cpu._lagrangian(cpu.state))
               - float(serial._lagrangian(serial.state))) \
        <= 1e-5 * abs(float(cpu._lagrangian(cpu.state)))
    base = BaselineTrainer(cfg, g, "adam", 1e-2)
    log = base.train(3)
    assert log.lagrangian[-1] < log.lagrangian[0]


# ---------------------------------------------------------------------------
# SSD scan and flash attention
# ---------------------------------------------------------------------------

BF16_TOL = 2.0 ** -7


def _within(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


def _ssd_operands(seed, b, s, h, p, g, n, dtype, device):
    rng = np.random.default_rng(seed)
    x, bm, cm = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                 device=device).to(dtype)
                 for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    dt = torch.as_tensor((0.5 * np.abs(rng.normal(size=(b, s, h))))
                         .astype(np.float32), device=device)
    a = -torch.as_tensor(np.abs(rng.normal(size=(h,))).astype(np.float32),
                         device=device)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 512, 4, 64, 1, 128, 256),   # the model's head_dim and d_state
    (1, 1000, 4, 32, 2, 64, 256),   # ragged: the chunk halves to 8
    (2, 100, 8, 16, 4, 16, 256),    # S < chunk: one chunk of 100
    (1, 192, 2, 64, 2, 128, 64),    # one 64-row tile per chunk, G = 2
])
def test_ssd_kernel_matches_plain_version(cuda_device, b, s, h, p, g, n,
                                          chunk, dtype):
    args = _ssd_operands(0, b, s, h, p, g, n, dtype, cuda_device)
    before = ssd_launcher.ssd_launches
    got, none = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert none is None and ssd_launcher.ssd_launches == before + 1
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    _within(got, want, 1e-4 if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("p", [16, 32, 64])
@pytest.mark.parametrize("chunk", [8, 64, 100, 192, 256])
def test_ssd_tensor_core_kernel_at_the_edges(cuda_device, chunk, p, n, g):
    """The bf16 (wgmma) kernel, batch 2, 4 heads, three chunks: chunks of
    one partial 64-row tile (8), one whole tile (64), a ragged second tile
    (100), three tiles (192) and four (256); head_dim and d_state below
    the 64- and 128-wide tiles; 1, 2 and 4 groups."""
    args = _ssd_operands(chunk + p + n + g, 2, 3 * chunk, 4, p, g, n,
                         torch.bfloat16, cuda_device)
    before = ssd_launcher.ssd_tc_launches
    got, _ = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_launcher.ssd_tc_launches == before + 1
    _within(got, ref.ssd_scan_ref(*args, chunk=chunk), BF16_TOL)


@pytest.mark.parametrize("s,chunk", [(200, 100), (64, 8)])
def test_ssd_tensor_core_kernel_on_unaligned_rows(cuda_device, s, chunk):
    """head_dim 20 and d_state 24 (rows not on 16 bytes): element loads
    in place of 16-byte copies, and the same result."""
    args = _ssd_operands(s, 2, s, 4, 20, 2, 24, torch.bfloat16, cuda_device)
    got, _ = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    _within(got, ref.ssd_scan_ref(*args, chunk=chunk), BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_route_counts(cuda_device, dtype):
    """A bf16 call counts one tensor-core launch, an f32 call one FFMA
    launch; both count in ``ssd_launches``."""
    args = _ssd_operands(5, 1, 128, 2, 16, 1, 16, dtype, cuda_device)
    before = (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches)
    ops.ssd_scan(*args, chunk=64)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches) == (
        before[0] + 1, before[1] + tc)


def test_ssd_tc_layout_matches_the_launcher(cuda_device):
    """The tensor-core kernel's own grids and shared memory equal
    ``tc_layout`` over a sweep of shapes and chunks."""
    import ctypes
    lib = build.load(ssd_launcher.TC_LIB)
    query = lib.ssd_scan_wgmma_layout
    query.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 11)()
    for b, s, h, p, n, chunk in ((4, 4096, 64, 64, 128, 256),
                                 (1, 32768, 64, 64, 128, 256),
                                 (2, 300, 4, 20, 24, 100),
                                 (1, 1000, 4, 32, 64, 8)):
        assert query(b, s, h, p, n, chunk, out) == 0
        t = ssd_launcher.tc_layout(b, s, h, p, n, chunk)
        assert list(out) == [*t["pass1_grid"], t["pass1_smem_bytes"],
                             *t["pass2_grid"], *t["pass3_grid"],
                             t["pass3_threads"], t["pass3_smem_bytes"]]
    assert query(1, 512, 4, 64, 128, 512, out) != 0


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 24, 4, 64, 1, 128, 8),       # chunk 8: one partial 64-row tile
    (2, 192, 4, 64, 2, 128, 64),     # chunk 64: one whole tile, G = 2
    (1, 1024, 4, 64, 1, 128, 256),   # chunk 256: four tiles, the model's
    (2, 100, 4, 64, 1, 128, 256),    # S = 100 < chunk: one chunk of 100
    (1, 1000, 4, 64, 2, 128, 256),   # S = 1000: the chunk halves to 8
    (2, 512, 4, 32, 2, 64, 256),     # P < 64, N < 128, G = 2
    (2, 300, 4, 18, 2, 22, 100),     # rows off 16 bytes: 4-byte copies
])
def test_ssd_ffma_kernel_at_the_edges(cuda_device, b, s, h, p, g, n, chunk):
    """The f32 (FFMA) three-pass kernels against the plain scan and against
    the plain three-pass form in f32 (``ref.ssd_scan_three_pass``), each
    within the f32 limit of 1e-4 · max; one launch, none on the tensor
    cores."""
    args = _ssd_operands(s + p + n, b, s, h, p, g, n, torch.float32,
                         cuda_device)
    before = (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches)
    got, _ = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches) == (
        before[0] + 1, before[1])
    _within(got, ref.ssd_scan_ref(*args, chunk=chunk), 1e-4)
    _within(got, ref.ssd_scan_three_pass(*args, chunk=chunk), 1e-4)


def test_ssd_ffma_layout_matches_the_launcher(cuda_device):
    """The FFMA route's own grids and shared memory equal ``ffma_layout``
    over a sweep of shapes and chunks."""
    import ctypes
    lib = build.load(ssd_launcher.LIB)
    query = lib.ssd_scan_f32_layout
    query.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 12)()
    for b, s, h, p, n, chunk in ((4, 4096, 64, 64, 128, 256),
                                 (1, 32768, 64, 64, 128, 256),
                                 (2, 300, 4, 18, 22, 100),
                                 (1, 1000, 4, 32, 64, 8)):
        assert query(b, s, h, p, n, chunk, out) == 0
        t = ssd_launcher.ffma_layout(b, s, h, p, n, chunk)
        assert list(out) == [*t["pass1_grid"], t["pass1_threads"],
                             t["pass1_smem_bytes"], *t["pass2_grid"],
                             *t["pass3_grid"], t["pass3_threads"],
                             t["pass3_smem_bytes"]]
    assert query(1, 512, 4, 64, 128, 512, out) != 0


def test_ssd_launcher_refuses_bad_operands(cuda_device):
    x, dt, a, bm, cm = _ssd_operands(1, 1, 64, 4, 16, 2, 16, torch.float32,
                                     cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        ssd_launcher.ssd_scan(x, dt, a, bm.bfloat16(), cm, 64)
    with pytest.raises(ValueError, match="chunk <= 256"):
        ssd_launcher.ssd_scan(x.repeat(1, 8, 1, 1), dt.repeat(1, 8, 1), a,
                              bm.repeat(1, 8, 1, 1), cm.repeat(1, 8, 1, 1),
                              512)
    with pytest.raises(ValueError, match="groups"):
        ssd_launcher.ssd_scan(x[:, :, :3].contiguous(),
                              dt[:, :, :3].contiguous(), a[:3].contiguous(),
                              bm, cm, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (1, 512, 4, 1, 128, True, None),     # MQA, causal
    (2, 300, 8, 2, 64, True, None),      # GQA, a ragged last tile
    (1, 384, 2, 1, 256, True, 100),      # head_dim 256, sliding window
    (1, 256, 4, 4, 32, False, None),     # non-causal
    (1, 256, 2, 2, 48, False, 70),       # window without causal
])
def test_flash_kernel_matches_plain_version(cuda_device, b, s, hq, hkv, hd,
                                            causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                        (b, s, hkv, hd)))
    before = flash_launcher.flash_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_launcher.flash_launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _within(got, want, 1e-5 if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("causal,window", [
    (True, "1"), (True, "127"), (True, ">= S"), (False, "1"),
    (False, "127")])
@pytest.mark.parametrize("hd", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 65, 129, 4097])
def test_flash_tensor_core_kernel_at_the_tile_edges(cuda_device, s, hd,
                                                    causal, window, hq, hkv):
    """The bf16 (wgmma) kernel, batch 2: sequences on both sides of the
    64-row and 64-key tiles, head dims that are not multiples of 64,
    windows of one key, 127 keys and the whole sequence, GQA and MQA;
    causal, and non-causal with a window (one-sided: q − k < window, so
    every later key stays visible)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * 1000 + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16) for shape in ((2, s, hq, hd),
                                                 (2, s, hkv, hd),
                                                 (2, s, hkv, hd)))
    w = s + 1 if window == ">= S" else int(window)
    before = flash_launcher.flash_tc_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize()
    assert flash_launcher.flash_tc_launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=w)
    _within(got, want, BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,nm,hq,hkv,hd,causal,window", [
    (512, 2, 4, 1, 128, True, None),      # gemma's single KV head
    (4096, 4, 4, 2, 128, True, None),     # qwen2-7b's heads, 1 x 4
    (300, 3, 2, 1, 64, True, 70),         # ragged slices, a window
    (384, 2, 2, 1, 256, True, 100),       # head_dim 256
    (256, 4, 4, 4, 80, False, 33),        # window without causal
])
def test_flash_kernel_at_a_query_offset(cuda_device, s, nm, hq, hkv, hd,
                                        causal, window, dtype):
    """Each context-parallel rank's query rows [m·S/nm, …) at query offset
    m·S/nm against every key: the kernel against its plain version at the
    same offset (f32 within 1e-5 · max, bf16 within one bf16 ulp), each
    call counted in ``flash_offset_launches`` from rank 1 on; offset 0
    over the whole sequence is the launch without an offset, bit for
    bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + nm)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((2, s, hq, hd), (2, s, hkv, hd),
                                        (2, s, hkv, hd)))
    whole = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(whole, ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=0))
    bounds = [s * m // nm for m in range(nm + 1)]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = q[:, lo:hi].contiguous()
        before = flash_launcher.flash_offset_launches
        got = ops.flash_attention(rows, k, v, causal=causal, window=window,
                                  q_offset=lo)
        torch.cuda.synchronize()
        assert flash_launcher.flash_offset_launches == before + int(lo > 0)
        want = ref.flash_attention_ref(rows, k, v, causal=causal,
                                       window=window, q_offset=lo)
        _within(got, want, 1e-5 if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route_counts(cuda_device, dtype):
    """A bf16 call counts one tensor-core launch, an f32 call one FFMA
    launch; both count in ``flash_launches``."""
    q = torch.randn((1, 96, 2, 64), device=cuda_device).to(dtype)
    before = (flash_launcher.flash_launches,
              flash_launcher.flash_tc_launches)
    ops.flash_attention(q, q[:, :, :1].contiguous(),
                        q[:, :, :1].contiguous())
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (flash_launcher.flash_launches,
            flash_launcher.flash_tc_launches) == (before[0] + 1,
                                                  before[1] + tc)


def test_flash_layout_matches_the_launcher(cuda_device):
    """The tensor-core kernel's own tiles equal ``tc_layout`` for every
    head_dim."""
    import ctypes
    lib = build.load(flash_launcher.TC_LIB)
    query = lib.flash_attention_bf16_layout
    query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    for hd in range(1, 257):
        assert query(hd, out) == 0
        t = flash_launcher.tc_layout(hd)
        assert list(out) == [t["head_pad"], t["block_q"], t["block_k"],
                             t["threads"], t["smem_bytes"]]


@pytest.mark.parametrize("s,hq,hkv,hd,causal,window,v_hd", [
    (1, 4, 1, 64, True, None, None),        # one row
    (100, 7, 1, 80, True, None, None),      # S below a tile, GQA 7:1, hd 80
    (3000, 28, 4, 128, True, None, None),   # ragged S, qwen2-7b's heads
    (513, 14, 2, 192, True, None, 128),     # qk 192, v 128 zero-padded
    (700, 8, 1, 256, True, 100, None),      # hd 256, a window
    (640, 7, 1, 64, False, None, None),     # non-causal, GQA 7:1
    (640, 4, 2, 128, False, 33, None),      # a window without causal
    (130, 4, 4, 128, True, 1, None),        # a window of one key
    (130, 2, 1, 30, True, None, None),      # hd 30: 4-byte copies
])
def test_flash_ffma_kernel_at_the_edges(cuda_device, s, hq, hkv, hd, causal,
                                        window, v_hd):
    """The f32 (FFMA) kernel, batch 2: head dims 64, 80, 128, 192 (v
    zero-padded from 128, as MLA's attend calls it) and 256, sequences
    below and off the 128-row / 64-key tiles, windows, non-causal, GQA 7:1;
    within 1e-5 · max of the plain version, one launch, none on the tensor
    cores."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * 1000 + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((2, s, hq, hd), (2, s, hkv, hd),
                             (2, s, hkv, v_hd or hd)))
    v = torch.nn.functional.pad(v, (0, hd - v.shape[-1]))
    before = (flash_launcher.flash_launches,
              flash_launcher.flash_tc_launches)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_launcher.flash_launches,
            flash_launcher.flash_tc_launches) == (before[0] + 1, before[1])
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _within(got, want, 1e-5)
    if v_hd:
        assert not bool(got[..., v_hd:].any())


@pytest.mark.parametrize("s,nm,hq,hkv,hd,causal,window", [
    (2048, 4, 28, 4, 128, True, None),      # qwen2-7b's context ranks
    (1000, 3, 7, 1, 256, True, 300),        # ragged slices, hd 256, window
    (300, 2, 7, 1, 80, False, None),        # non-causal, hd 80
])
def test_flash_ffma_kernel_at_a_query_offset(cuda_device, s, nm, hq, hkv, hd,
                                             causal, window):
    """Each context rank's query rows at its offset against every key, f32,
    within 1e-5 · max of the plain version at the same offset."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((1, s, hq, hd), (1, s, hkv, hd),
                             (1, s, hkv, hd)))
    bounds = [s * m // nm for m in range(nm + 1)]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = q[:, lo:hi].contiguous()
        got = ops.flash_attention(rows, k, v, causal=causal, window=window,
                                  q_offset=lo)
        torch.cuda.synchronize()
        _within(got, ref.flash_attention_ref(rows, k, v, causal=causal,
                                             window=window, q_offset=lo),
                1e-5)


def test_flash_ffma_layout_matches_the_launcher(cuda_device):
    """The FFMA kernel's own tiles equal ``ffma_layout`` for every
    head_dim."""
    import ctypes
    lib = build.load(flash_launcher.LIB)
    query = lib.flash_attention_f32_layout
    query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 8)()
    for hd in range(1, 257):
        assert query(hd, out) == 0
        t = flash_launcher.ffma_layout(hd)
        assert list(out) == [t["head_pad"], t["block_q"], t["block_k"],
                             t["threads"], t["smem_bytes"],
                             t["rows_per_thread"], t["keys_per_thread"],
                             t["lanes_per_row"]]
    assert query(0, out) != 0 and query(257, out) != 0


def test_flash_launcher_refuses_bad_operands(cuda_device):
    q = torch.zeros((1, 16, 4, 32), device=cuda_device)
    k = torch.zeros((1, 16, 3, 32), device=cuda_device)
    with pytest.raises(ValueError, match="kv heads"):
        flash_launcher.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="dtype"):
        flash_launcher.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="window"):
        flash_launcher.flash_attention(q, q, q, window=0)
    wide = torch.zeros((1, 16, 1, 512), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_launcher.flash_attention(wide, wide, wide)


def test_mamba2_kernel_forward_matches_plain_forward(cuda_device):
    """The reduced Mamba-2 (f32) on the card: 2 SSD launches per forward,
    logits within 1e-4 · max of the plain path."""
    model = make_model(get_config("mamba2-1.3b", reduced=True))
    params = model.init(seed=0, device=cuda_device)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 96),
                           device=cuda_device)
    with torch.no_grad():
        want, _, _ = model.forward(params, {"tokens": tokens})
        before = ssd_launcher.ssd_launches
        got, _, _ = model.forward(params, {"tokens": tokens},
                                  use_kernel=True)
    assert ssd_launcher.ssd_launches == before + model.cfg.num_layers
    _within(got, want, 1e-4)


# flash launches per forward of each family's reduced configuration: one
# per full-sequence self-attention (the hybrid's one local attention per
# period; the encoder-decoder's encoder and decoder layers)
FAMILY_LAUNCHES = {"qwen2-7b": 2, "gemma-2b": 2, "nemotron-4-15b": 2,
                   "deepseek-v3-671b": 2, "deepseek-moe-16b": 2,
                   "moonshot-v1-16b-a3b": 2, "recurrentgemma-9b": 1,
                   "internvl2-2b": 2, "seamless-m4t-medium": 4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_family_kernel_forward_matches_plain_forward(cuda_device, arch,
                                                     dtype):
    """Each attention family at its reduced configuration on the card,
    2 x 4096 positions (above the attention chunk, so the plain route runs
    its chunk loop and recurrentgemma's window of 64 bites): the kernel
    forward launches the flash kernel once per full-sequence
    self-attention (bf16 all on the tensor cores), and its logits are
    within 1e-4 · max (f32) or 5e-2 · max (bf16, the rounding of P and of
    each layer's output at other places) of the plain route's.  The MoE
    families in bf16 are held to finite logits only: top-k routing is
    discontinuous, and a one-ulp bf16 difference at a router input moves
    that token to another expert (in f32 they are held to 1e-4)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    model = make_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, s = 2, 4096
    dt = getattr(torch, dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=cuda_device)}
    if cfg.arch_type == "vlm":
        npfx = cfg.frontend.num_embeddings
        batch["tokens"] = batch["tokens"][:, npfx:]
        batch["vision_embeds"] = torch.randn(
            (b, npfx, cfg.d_model), generator=gen, device=cuda_device).to(dt)
    if cfg.is_encoder_decoder:
        batch["tokens"] = batch["tokens"][:, :s // 2]
        batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=cuda_device).to(dt)
    with torch.no_grad():
        want, _, _ = model.forward(params, batch)
        before = (flash_launcher.flash_launches,
                  flash_launcher.flash_tc_launches)
        got, _, _ = model.forward(params, batch, use_kernel=True)
    n = FAMILY_LAUNCHES[arch]
    assert flash_launcher.flash_launches == before[0] + n
    assert flash_launcher.flash_tc_launches == before[1] + (
        n if dtype == "bfloat16" else 0)
    if dtype == "bfloat16" and cfg.moe is not None:
        assert bool(torch.isfinite(got).all())
    else:
        _within(got, want, 1e-4 if dtype == "float32" else 5e-2)


# ---------------------------------------------------------------------------
# language-model training on the card against the CPU (reduced, f32)
# ---------------------------------------------------------------------------

def _reduced_train_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One train_step (SGD at lr 1, so the delta is −g; grad_accum 2) from
    the same weights: each leaf's delta within 1e-5 · max |delta| beside
    one f32 spacing of the new value (each side rounds p − g), the loss
    within 1e-5 relative; no kernel launched."""
    import dataclasses
    from repro_torch.util import tree
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              optimizer="sgd", learning_rate=1.0,
                              grad_accum=2)
    model = make_model(cfg)
    batch = _reduced_train_batch(cfg)
    p_cpu = model.init(seed=0, device="cpu")
    p_card = tree.tree_map(lambda t: t.to(cuda_device), p_cpu)
    launches = (flash_launcher.flash_launches, ssd_launcher.ssd_launches)
    new_cpu, _, m_cpu = model.train_step(p_cpu, (), batch)
    new_card, _, m_card = model.train_step(p_card, (), batch)
    assert launches == (flash_launcher.flash_launches,
                        ssd_launcher.ssd_launches)
    for p0, a, b in zip(tree.leaves(p_cpu), tree.leaves(new_card),
                        tree.leaves(new_cpu)):
        p0, a, b = (t.double().cpu().numpy() for t in (p0, a, b))
        slack = np.spacing(np.abs(b).astype(np.float32))
        assert float((np.abs(a - b) - slack).max()) <= \
            1e-5 * float(np.abs(b - p0).max())
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= \
        1e-5 * abs(float(m_cpu["loss"]))


@pytest.mark.parametrize("arch,n_before", [("gemma-2b", 2),
                                           ("deepseek-moe-16b", 4)])
def test_layerwise_iteration_on_card_matches_cpu(cuda_device, arch,
                                                 n_before):
    """One layerwise ADMM iteration on the card and on the CPU from the
    CPU's state after ``n_before`` (a depth at which no line search sits
    on a tie: tests/test_torch_layerwise.py): τ, θ and τ_R equal, every
    tensor within 1e-4 · max."""
    from repro_torch.core.layerwise import LayerwiseADMMTrainer
    from repro_torch.util import tree
    tr = LayerwiseADMMTrainer(get_config(arch, reduced=True),
                              ADMMConfig(nu=1e-2, rho=1e-2))
    batch = _reduced_train_batch(tr.cfg)
    st, z0 = tr.init(0, batch, "cpu")
    for _ in range(n_before):
        st = tr.iteration(st, z0, batch["targets"])
    want = tr.iteration(st, z0, batch["targets"])
    got = tr.iteration(tree.tree_map(lambda t: t.to(cuda_device), st),
                       z0.to(cuda_device), batch["targets"])
    for f in ("taus", "thetas", "tau_r"):
        for a, b in zip(tree.leaves(getattr(got, f)),
                        tree.leaves(getattr(want, f))):
            assert torch.equal(a.cpu(), b), f
    for f in ("stack", "readout", "zs", "u"):
        for a, b in zip(tree.leaves(getattr(got, f)),
                        tree.leaves(getattr(want, f))):
            _within(a.cpu(), b, 1e-4)


def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    """Card tensors (bf16, f32, int32) saved and restored onto the card,
    bit for bit."""
    from repro_torch import checkpoint
    from repro_torch.util import tree
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = {"params": {"w": torch.randn((64, 32), generator=gen,
                                         device=cuda_device).bfloat16(),
                        "b": torch.randn((32,), generator=gen,
                                         device=cuda_device)},
             "opt": {"t": torch.tensor(3, dtype=torch.int32,
                                       device=cuda_device)}}
    checkpoint.save(tmp_path, state, step=4)
    back = checkpoint.restore(tmp_path, tree.tree_map(torch.zeros_like,
                                                      state))
    for a, b in zip(tree.leaves(back), tree.leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the process transport on the card: 2 gloo ranks sharing it
# ---------------------------------------------------------------------------

PROC_PARTS, PROC_SHARDS = 4, 2


def _proc_trainer(mesh=None, device=None, **kw):
    g, _ = graph.synthetic_powerlaw_communities(
        PROC_PARTS, nodes_per_part=24, size_skew=1.0, feat_dim=16, seed=0)
    return ParallelADMMTrainer(
        gcn.GCNConfig((16, 32, g.num_classes)), ADMMConfig(nu=1e-3, rho=1e-3),
        g, PROC_PARTS, seed=0, device=device, n_shards=PROC_SHARDS,
        mesh=mesh, config=TrainerConfig.packed(use_kernel=True, **kw))


def _proc_rank(rank, store, out_dir):
    import json
    import pathlib

    from repro_torch.analysis import registry
    from repro_torch.analysis import trainer as atrainer
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.init_process_mesh(rank, PROC_SHARDS, "gloo", store,
                                      timeout=60)
    try:
        rec = {}
        for name, kw in (("packed", {}), ("fused-overlap",
                                          {"fused": True, "overlap": True})):
            tt = _proc_trainer(mesh, **kw)
            before = community_spmm.packed_launches, \
                community_spmm.fused_launches
            tt.step()
            after = community_spmm.packed_launches, \
                community_spmm.fused_launches
            st = tt.state
            np.savez(pathlib.Path(out_dir) / f"{name}-{rank}.npz",
                     *[t.cpu().numpy() for t in st.weights + st.zs
                       + (st.u,) + st.taus + st.thetas])
            del st      # the recorded step must free the state it replaces
            tape, exp = atrainer.record_step(tt)
            report = registry.run_rules(registry.AnalysisContext(
                trace=tape, expectations=exp))
            rec[name] = {
                "launches": [a - b for a, b in zip(after, before)],
                "sent": tt.comm_stats["sent_bytes"],
                "wire": tt.comm_stats["wire_bytes"],
                "errors": [f.rule for f in report.errors()],
                "cuda_kernels": sorted({e.info["route"] for e in
                                        tape.of_kind("kernel")})}
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        mesh_lib.destroy(mesh)


def test_two_gloo_ranks_on_the_card_match_the_loopback(cuda_device,
                                                       tmp_path):
    """Two rank processes share the card (gloo, rows staged through pinned
    host buffers): one step from the seed equals the loopback trainer's
    (τ/θ equal, every tensor within 1e-5 · max), each rank launches the
    packed kernel 3 times a step (fused + overlap: its arrival groups'
    packed and fused calls), sends the plan's wire bytes, and its recorded
    step has no error finding with every launch on the CUDA route."""
    import json

    from repro_torch.launch import mesh as mesh_lib
    build.load_all(["community_spmm_ell", "community_spmm_ell_fused"])
    mesh_lib.run_ranks(_proc_rank, PROC_SHARDS, (str(tmp_path),),
                       timeout=300)
    for name, kw in (("packed", {}), ("fused-overlap",
                                      {"fused": True, "overlap": True})):
        lt = _proc_trainer(device="cuda", **kw)
        before = community_spmm.packed_launches, community_spmm.fused_launches
        lt.step()
        loop = [community_spmm.packed_launches - before[0],
                community_spmm.fused_launches - before[1]]
        st = lt.state
        want = [t.cpu().numpy() for t in st.weights + st.zs + (st.u,)
                + st.taus + st.thetas]
        parts = []
        for r in range(PROC_SHARDS):
            with np.load(tmp_path / f"{name}-{r}.npz") as data:
                parts.append([data[f"arr_{i}"] for i in range(len(want))])
            rec = json.loads((tmp_path / f"rank{r}.json").read_text())[name]
            # the loopback launches once over both shards' lanes where
            # each rank launches once over its own
            assert rec["launches"] == loop, (name, rec, loop)
            assert rec["sent"] == rec["wire"] > 0
            assert rec["errors"] == [], rec
            assert rec["cuda_kernels"] == ["cuda"]
        n = 2
        for i, w in enumerate(want):
            shared = i < n or 2 * n + 1 <= i < 3 * n + 1
            got = parts[0][i] if shared else \
                np.concatenate([p[i] for p in parts])
            if shared:
                assert all(np.array_equal(p[i], got) for p in parts)
            if i >= 2 * n + 1:
                np.testing.assert_array_equal(got, w)
            else:
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(got - w).max()) <= 1e-5 * scale, \
                    (name, i)


# ---------------------------------------------------------------------------
# the language models over a data × model mesh of gloo ranks on the card
# ---------------------------------------------------------------------------

def _lm_cfg(arch, **kw):
    import dataclasses
    return dataclasses.replace(get_config(arch, reduced=True), **kw)


def _lm_rank(rank, store, spec):
    import hashlib
    import pathlib

    from repro_torch.core import layerwise
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.util import tree
    base = mesh_lib.init_process_mesh(rank, spec["world"], "gloo", store,
                                      timeout=60)
    try:
        mesh = mesh_lib.make_rank_mesh(base, spec["model_axis"])
        dev = mesh.device
        with np.load(spec["inputs"]) as data:
            arrays = [torch.from_numpy(data[f"arr_{i}"]).to(dev)
                      for i in range(len(data.files))]
        out = pathlib.Path(spec["out"])
        if spec["kind"] == "deferred":
            cfg = _lm_cfg("gemma-2b", optimizer="sgd", learning_rate=1.0,
                          grad_accum=2)
            model = make_model(cfg)
            params = tree.unflatten(model.init(0, "cpu"), arrays)
            batch = _reduced_train_batch(cfg)
            rows = mesh_lib.batch_rows(mesh, len(batch["tokens"]))
            new, _, met = model.train_step_deferred(
                mesh, params, (), {k: v[rows] for k, v in batch.items()})
            leaves = [t.cpu().numpy() for t in tree.leaves(new)]
            h = hashlib.sha256(b"".join(a.tobytes() for a in leaves))
            np.savez(out / f"rank{rank}.npz", *leaves,
                     loss=float(met["loss"]), hash=h.hexdigest())
        else:
            tr = layerwise.LayerwiseADMMTrainer(
                get_config("gemma-2b", reduced=True),
                ADMMConfig(nu=1e-2, rho=1e-2), mesh=mesh)
            batch = _reduced_train_batch(tr.cfg)
            one = layerwise.LayerwiseADMMTrainer(
                get_config("gemma-2b", reduced=True), ADMMConfig())
            like, _ = one.init(0, batch, "cpu")
            st = tree.unflatten(like, arrays[:-1])
            local, z0 = tr.shard_state(st, arrays[-1])
            nxt = tr.iteration(local, z0, batch["targets"])
            seg, lo, hi, _ = tr.local[0]
            parts = {"w": [t.cpu().numpy() for t in
                           tree.leaves(nxt.stack[seg.kind])],
                     "z": nxt.zs[seg.kind].cpu().numpy()}
            np.savez(out / f"rank{rank}.npz", *parts["w"], z=parts["z"],
                     taus=nxt.taus[seg.kind].cpu().numpy(),
                     thetas=nxt.thetas[seg.kind].cpu().numpy(),
                     lo=lo, hi=hi, rows=[tr._rows.start, tr._rows.stop])
    finally:
        mesh_lib.destroy(base)


def test_two_gloo_ranks_run_the_deferred_step_on_the_card(cuda_device,
                                                          tmp_path):
    """Reduced f32 gemma-2b (SGD at lr 1, grad_accum 2), 2 data ranks
    sharing the card against one process's train_step_deferred on the
    whole batch: each leaf within 1e-5 · max |delta| beside one f32
    spacing, the loss within 1e-5, the same bits on both ranks."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.util import tree
    cfg = _lm_cfg("gemma-2b", optimizer="sgd", learning_rate=1.0,
                  grad_accum=2)
    model = make_model(cfg)
    p = model.init(0, cuda_device)
    np.savez(tmp_path / "inputs.npz",
             *[t.cpu().numpy() for t in tree.leaves(p)])
    want, _, met = model.train_step_deferred(None, p, (),
                                             _reduced_train_batch(cfg))
    mesh_lib.run_ranks(_lm_rank, 2, ({
        "world": 2, "model_axis": 1, "kind": "deferred",
        "inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path)},),
        timeout=300)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert str(ranks[0]["hash"]) == str(ranks[1]["hash"])
    for i, (p0, w) in enumerate(zip(tree.leaves(p), tree.leaves(want))):
        p0, w = p0.double().cpu().numpy(), w.double().cpu().numpy()
        g = ranks[0][f"arr_{i}"].astype(np.float64)
        slack = np.spacing(np.abs(w).astype(np.float32))
        assert float((np.abs(g - w) - slack).max()) <= \
            1e-5 * float(np.abs(w - p0).max())
    assert abs(float(ranks[0]["loss"]) - float(met["loss"])) <= \
        1e-5 * abs(float(met["loss"]))


def test_two_by_two_gloo_ranks_run_a_layerwise_iteration_on_the_card(
        cuda_device, tmp_path):
    """Reduced f32 gemma-2b on a 2 × 2 mesh of gloo ranks sharing the card
    (blocks over model, rows over data), one iteration from the one-process
    state after 2 against one process on the card: τ/θ equal, W and Z
    within 1e-4 · max, W the same bits on both data ranks of a block."""
    from repro_torch.core import layerwise
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.util import tree
    tr = layerwise.LayerwiseADMMTrainer(get_config("gemma-2b", reduced=True),
                                        ADMMConfig(nu=1e-2, rho=1e-2))
    batch = _reduced_train_batch(tr.cfg)
    st, z0 = tr.init(0, batch, cuda_device)
    for _ in range(2):
        st = tr.iteration(st, z0, batch["targets"])
    np.savez(tmp_path / "inputs.npz",
             *[t.cpu().numpy() for t in tree.leaves(st) + [z0]])
    want = tr.iteration(st, z0, batch["targets"])
    mesh_lib.run_ranks(_lm_rank, 4, ({
        "world": 4, "model_axis": 2, "kind": "layerwise",
        "inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path)},),
        timeout=300)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    w_want = [t.cpu().numpy() for t in tree.leaves(want.stack["attn_mlp"])]
    z_want = want.zs["attn_mlp"].cpu().numpy()
    for r in ranks:
        lo, hi = int(r["lo"]), int(r["hi"])
        r0, r1 = (int(v) for v in r["rows"])
        np.testing.assert_array_equal(
            r["taus"], want.taus["attn_mlp"][lo:hi].cpu().numpy())
        np.testing.assert_array_equal(
            r["thetas"], want.thetas["attn_mlp"][lo:hi].cpu().numpy())
        for i, w in enumerate(w_want):
            _within(torch.from_numpy(r[f"arr_{i}"]),
                    torch.from_numpy(w[lo:hi]), 1e-4)
        _within(torch.from_numpy(r["z"]),
                torch.from_numpy(z_want[lo:hi, r0:r1]), 1e-4)
    for a, b in ((0, 2), (1, 3)):       # the data ranks of each model rank
        for i in range(len(w_want)):
            assert np.array_equal(ranks[a][f"arr_{i}"], ranks[b][f"arr_{i}"])
