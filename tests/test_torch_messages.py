"""The port's exchange plan, its pricing and its loopback transport.

Host side: every table of ``NeighborExchange`` (rounds included), every
restricted plan, ``arrival_rounds``, ``exchange_bytes``,
``overlap_stats`` (at one set of model constants),
``verify_transport_bytes``, ``ring_round_coloring`` and
``CommunityBatchSampler`` must equal ``repro``'s exactly.  The loopback
transports run the plan for every shard at once; they are held, bit for
bit, against a numpy simulation of the reference's per-shard program (one
``ppermute`` per round: each pair's source rows land in the destination's
buffer, pad positions dropped, bf16 rounding on the wired rows only).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import messages as jmessages
from repro.sharding import partition as jpartition
from repro_torch.core import graph, messages
from repro_torch.sharding import partition

CASES = [(4, 2), (4, 4), (8, 4), (6, 3)]      # (M, n_shards)
PLAN_KINDS = ["whole-block", "row-exact", "packed"]


def _layout(m: int, seed: int = 0):
    g, part = graph.synthetic_powerlaw_communities(
        m, nodes_per_part=12, attach=1, size_skew=0.8, feat_dim=4,
        seed=seed)
    return graph.build_community_layout(g.num_nodes, g.edges, part,
                                        compressed=True, pad_mode="bucketed")


def _plans(m, n_shards, kind):
    lay = _layout(m)
    kw = {}
    if kind != "whole-block":
        kw["sizes"] = lay.sizes
    if kind == "packed":
        kw["row_counts"] = lay.eff_row_counts()
    args = (lay.neighbor_mask, n_shards, lay.n_pad)
    return (lay, jmessages.build_neighbor_exchange(*args, **kw),
            messages.build_neighbor_exchange(*args, **kw))


def _assert_equal(want, got, where=""):
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            _assert_equal(getattr(want, f.name), getattr(got, f.name),
                          f"{where}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), (where, want, got)


@pytest.mark.parametrize("kind", PLAN_KINDS)
@pytest.mark.parametrize("m,n_shards", CASES)
def test_plan_tables_equal_the_reference(m, n_shards, kind):
    lay, want, got = _plans(m, n_shards, kind)
    _assert_equal(want, got, "plan")
    csr = lay.compress()
    np.testing.assert_array_equal(
        got.localize_indices(csr.ell_indices, csr.ell_mask),
        want.localize_indices(csr.ell_indices, csr.ell_mask))
    if kind == "packed":
        np.testing.assert_array_equal(
            got.localized_offsets(csr.ell_indices, csr.ell_mask),
            want.localized_offsets(csr.ell_indices, csr.ell_mask))
    np.testing.assert_array_equal(messages.arrival_rounds(got),
                                  jmessages.arrival_rounds(want))


@pytest.mark.parametrize("kind", PLAN_KINDS)
@pytest.mark.parametrize("m,n_shards", CASES)
def test_restricted_plans_equal_the_reference(m, n_shards, kind):
    _, want, got = _plans(m, n_shards, kind)
    subsets = [c for r in range(1, n_shards + 1)
               for c in itertools.combinations(range(n_shards), r)]
    for sub in subsets:
        w = jmessages.restrict_exchange(want, sub)
        g = messages.restrict_exchange(got, sub)
        _assert_equal(w, g, f"restrict{sub}")
        np.testing.assert_array_equal(messages.arrival_rounds(g),
                                      jmessages.arrival_rounds(w))
    assert messages.restrict_exchange(got, range(n_shards)) is got
    with pytest.raises(ValueError, match="non-empty"):
        messages.restrict_exchange(got, [])


@pytest.mark.parametrize("kind", PLAN_KINDS)
@pytest.mark.parametrize("m,n_shards", CASES)
def test_plan_pricing_equals_the_reference(m, n_shards, kind):
    lay, want, got = _plans(m, n_shards, kind)
    dims = [4, 32, 4, 4, 32]
    for item in (4, 2):
        eb_w = jmessages.exchange_bytes(want, dims, itemsize=item)
        eb_g = messages.exchange_bytes(got, dims, itemsize=item)
        assert eb_g == eb_w
        cs_w = jmessages.gather_bytes(lay.neighbor_mask, lay.n_pad, dims,
                                      itemsize=item)
        cs_w.update(eb_w)
        cs_g = dict(cs_w)
        assert messages.verify_transport_bytes(cs_g) == \
            jmessages.verify_transport_bytes(cs_w)
        for enabled in (False, True):
            kw = dict(itemsize=item, enabled=enabled,
                      peak_flops=messages.PEAK_FLOPS,
                      ici_bw=messages.LINK_BW)
            assert messages.overlap_stats(got, lay.neighbor_mask, dims,
                                          **kw) == \
                jmessages.overlap_stats(want, lay.neighbor_mask, dims, **kw)
    # the port's default model is the H100's
    ov = messages.overlap_stats(got, lay.neighbor_mask, dims)
    assert ov["model"] == {"peak_flops": 67e12, "ici_bw": 450e9,
                           "itemsize": 4}


def test_verify_transport_bytes_raises_as_the_reference():
    base = {"full_bytes": 100, "needed_bytes": 60, "wire_bytes": 50,
            "p2p_needed_bytes": 40, "padding_bytes": 10,
            "lanes_per_shard": 2, "row_exact": True}
    for bad in ({"wire_bytes": 150}, {"padding_bytes": 11},
                {"p2p_needed_bytes": 70, "padding_bytes": -20},
                {"lanes_per_shard": 1, "row_exact": False, "wire_bytes": 70,
                 "padding_bytes": 30}):
        with pytest.raises(ValueError) as want:
            jmessages.verify_transport_bytes(dict(base, **bad))
        with pytest.raises(ValueError) as got:
            messages.verify_transport_bytes(dict(base, **bad))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(6))
def test_ring_round_coloring_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(3 * n, 2))
             if a != b]
    assert partition.ring_round_coloring(pairs, n) == \
        jpartition.ring_round_coloring(pairs, n)
    for bad in ([(0, 0)], [(0, n)]):
        with pytest.raises(ValueError) as want:
            jpartition.ring_round_coloring(bad, n)
        with pytest.raises(ValueError) as got:
            partition.ring_round_coloring(bad, n)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,f,seed,weighted", [
    (4, 0.5, 0, False), (4, 0.5, 3, True), (8, 0.25, 1, True),
    (3, 1 / 3, 0, True), (6, 0.4, 2, False), (2, 1.0, 0, True)])
def test_batch_sampler_draws_the_reference_batches(n, f, seed, weighted):
    w = np.random.default_rng(seed).integers(1, 50, size=n) \
        if weighted else None
    want = jpartition.CommunityBatchSampler(n, f, seed=seed, weights=w)
    got = partition.CommunityBatchSampler(n, f, seed=seed, weights=w)
    assert got.num_batches == want.num_batches
    for c in range(3):
        assert got.cycle(c) == want.cycle(c)
    assert [got.batch(t) for t in range(12)] == \
        [want.batch(t) for t in range(12)]


# ---------------------------------------------------------------------------
# the loopback transport against a numpy simulation of the ppermute rounds
# ---------------------------------------------------------------------------

def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (to nearest even) and back, on the bits."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + (((b >> 16) & 1) + 0x7FFF)) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _simulate_strided(plan, x_loc, comm_bf16):
    """The reference's ``exchange_neighbors`` shard by shard: own lanes at
    their slots, then per round every pair's send rows into the
    destination's receive slots, positions past the buffer dropped."""
    s_n, n, c = plan.n_shards, plan.n_pad, x_loc.shape[-1]
    flat = x_loc.reshape(s_n, -1, c)
    limit = plan.r_pad * n
    bufs = np.zeros((s_n, limit, c), np.float32)
    for s in range(s_n):
        for i, slot in enumerate(plan.own_slots[s]):
            bufs[s, slot * n:(slot + 1) * n] = flat[s, i * n:(i + 1) * n]
    for rnd in plan.rounds:
        for src, dst in rnd.pairs:
            payload = flat[src][rnd.send_idx[src]]
            if comm_bf16:
                payload = _bf16(payload)
            for t, row in enumerate(rnd.recv_slot[dst]):
                if row < limit:
                    bufs[dst, row] = payload[t]
    return bufs.reshape(s_n, plan.r_pad, n, c)


def _simulate_packed(plan, planes, comm_bf16):
    """The reference's ``exchange_neighbors_packed`` shard by shard, with
    every stage: the own copy (rows past the plane filled with 0), then one
    buffer per round."""
    s_n, rpr, c = plan.n_shards, plan.recv_plane_rows, planes.shape[-1]
    bufs = np.zeros((s_n, rpr, c), np.float32)
    for s in range(s_n):
        for r, src_row in enumerate(plan.own_copy_rows[s]):
            if src_row < plan.plane_rows:
                bufs[s, r] = planes[s, src_row]
    stages = [bufs.copy()]
    for rnd in plan.rounds:
        for src, dst in rnd.pairs:
            payload = planes[src][rnd.send_rows_packed[src]]
            if comm_bf16:
                payload = _bf16(payload)
            for t, row in enumerate(rnd.recv_rows_packed[dst]):
                if row < rpr:
                    bufs[dst, row] = payload[t]
        stages.append(bufs.copy())
    return [st.reshape(s_n * rpr, c) for st in stages]


def _payload(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("comm_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["whole-block", "row-exact"])
@pytest.mark.parametrize("m,n_shards", CASES)
def test_strided_loopback_equals_the_simulated_rounds(m, n_shards, kind,
                                                      comm_bf16):
    lay, _, plan = _plans(m, n_shards, kind)
    x = _payload((m, lay.n_pad, 5), m + n_shards)
    got = messages.exchange_neighbors(plan, torch.as_tensor(x), comm_bf16)
    want = _simulate_strided(plan, x, comm_bf16)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if comm_bf16:
        # own rows stay f32: the same exchange in f32 agrees on them
        f32 = messages.exchange_neighbors(plan, torch.as_tensor(x))
        own = plan.own_slots
        for s in range(n_shards):
            np.testing.assert_array_equal(got[s, own[s]].numpy(),
                                          f32[s, own[s]].numpy())


@pytest.mark.parametrize("comm_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n_shards", CASES)
def test_packed_loopback_equals_the_simulated_rounds(m, n_shards, comm_bf16):
    lay, _, plan = _plans(m, n_shards, "packed")
    dl = lay.device_layout(n_shards)
    # the packed state of a blocked payload that is zero past the counts
    blk = _payload((m, lay.n_pad, 5), 7 * m + n_shards)
    rc = lay.eff_row_counts()
    blk[np.arange(lay.n_pad)[None, :] >= rc[:, None]] = 0.0
    planes = dl.pack_state(blk)
    x = torch.as_tensor(planes)
    want = _simulate_packed(plan, planes.reshape(n_shards, -1, 5), comm_bf16)
    final = messages.exchange_neighbors_packed(plan, x, comm_bf16)
    np.testing.assert_array_equal(final.numpy(), want[-1])
    staged = messages.exchange_neighbors_packed(plan, x, comm_bf16,
                                                staged=True)
    assert len(staged) == plan.num_rounds + 1
    for a, b in zip(staged, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert len({t.data_ptr() for t in staged}) == len(staged)
    # the packed receive planes unpack to the strided receive buffers
    strided = messages.exchange_neighbors(plan, torch.as_tensor(blk),
                                          comm_bf16)
    rpr = plan.recv_plane_rows
    for s in range(n_shards):
        ru = plan.recv_unpack_rows[s]
        plane = final[s * rpr:(s + 1) * rpr].numpy()
        rows = np.where((ru < rpr)[:, None], plane[np.minimum(ru, rpr - 1)],
                        0.0)
        np.testing.assert_array_equal(
            rows.reshape(plan.r_pad, lay.n_pad, 5), strided[s].numpy())


@pytest.mark.parametrize("comm_bf16", [False, True], ids=["f32", "bf16"])
def test_allgather_loopback_keeps_every_row_each_lane_reads(comm_bf16):
    """The one all-gathered copy holds, for every lane of every shard, the
    rows the reference's per-shard masked copy gives at its neighbours,
    and rounds every row to bf16 on the bf16 wire."""
    lay = _layout(8)
    s_n, m = 4, 8
    x = _payload((m, lay.n_pad, 3), 11)
    nbr = np.asarray(lay.neighbor_mask, np.float32)
    shard_nbr = nbr.reshape(s_n, m // s_n, m).max(axis=1)
    got = messages.allgather(torch.as_tensor(x), comm_bf16).numpy()
    wire = _bf16(x) if comm_bf16 else x
    np.testing.assert_array_equal(got, wire)
    masked = wire[None] * shard_nbr[:, :, None, None]
    for lane in range(m):
        reads = np.nonzero(nbr[lane])[0]
        np.testing.assert_array_equal(got[reads],
                                      masked[lane // (m // s_n), reads])


def test_one_shard_exchanges_are_the_local_payload():
    lay, _, plan = _plans(4, 1, "packed")
    x = torch.as_tensor(_payload((4, lay.n_pad, 3), 0))
    assert torch.equal(messages.exchange_neighbors(plan, x)[0], x)
    plane = torch.as_tensor(_payload((plan.plane_rows, 3), 1))
    assert messages.exchange_neighbors_packed(plan, plane) is plane
    assert messages.exchange_neighbors_packed(plan, plane,
                                              staged=True)[0] is plane


def test_module_tables_equal_the_reference():
    """The byte accounting the trainer prices with, on the same layout."""
    lay = _layout(8)
    dims = [4, 32, 4]
    assert messages.gather_bytes(lay.neighbor_mask, lay.n_pad, dims) == \
        jmessages.gather_bytes(lay.neighbor_mask, lay.n_pad, dims)
    assert messages.pad_stats(lay.neighbor_mask, lay.sizes, lay.row_counts,
                              lay.n_pad, dims, itemsize=2) == \
        jmessages.pad_stats(lay.neighbor_mask, lay.sizes, lay.row_counts,
                            lay.n_pad, dims, itemsize=2)
