"""Host layer of the PyTorch port against the JAX package: exact equality.

``repro_torch.core.graph``, ``repro_torch.sharding.multilevel`` and the
accounting functions of ``repro_torch.core.messages`` are numpy copies of
the reference; every array and number they produce must equal the
reference's bit for bit on the same inputs.
"""
import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import messages as jmessages
from repro_torch.core import graph, messages


def _assert_same(a, b):
    """Equal values, dtypes and shapes (None stays None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _graph(name):
    if name == "powerlaw32":
        return jgraph.synthetic_powerlaw_communities(
            32, nodes_per_part=32, attach=2, seed=0, feat_dim=8)[0]
    if name == "powerlaw8":
        return jgraph.synthetic_powerlaw_communities(
            8, nodes_per_part=16, attach=1, seed=0, feat_dim=8)[0]
    if name == "skewed8":
        return jgraph.synthetic_powerlaw_communities(
            8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)[0]
    return jgraph.synthetic_sbm("amazon_photo_mini", seed=1)


# (graph, M): {method: (edge_cut, max_deg)} — the golden pins of
# tests/test_partition.py, which the port must reproduce as well
GOLDEN_QUALITY = {
    ("powerlaw32", 32): {"bfs_kl": (1224, 24), "multilevel": (244, 13)},
    ("powerlaw8", 8): {"bfs_kl": (179, 6), "multilevel": (96, 5)},
    ("sbm_photo_mini", 3): {"bfs_kl": (6968, 3), "multilevel": (3836, 3)},
    ("sbm_photo_mini", 4): {"bfs_kl": (6035, 4), "multilevel": (3878, 4)},
}


@pytest.mark.parametrize("name,m,method", [
    (name, m, method) for name, m in sorted(GOLDEN_QUALITY)
    for method in ("bfs_kl", "multilevel")
    # the multilevel run on the 1,530-node graph takes seconds per package:
    # one part count of it is enough
    if (name, m, method) != ("sbm_photo_mini", 4, "multilevel")])
def test_partitioners_equal_reference_and_golden_pins(name, m, method):
    g = _graph(name)
    want = jgraph.partition_graph(g.num_nodes, g.edges, m, seed=0,
                                  method=method)
    got = graph.partition_graph(g.num_nodes, g.edges, m, seed=0,
                                method=method)
    _assert_same(want, got)
    q = graph.partition_quality(g.num_nodes, g.edges, got, m)
    assert q == jgraph.partition_quality(g.num_nodes, g.edges, want, m)
    assert (q["edge_cut"], q["max_deg"]) == GOLDEN_QUALITY[(name, m)][method]


@pytest.mark.parametrize("m,seed,golden", [
    (3, 0, (1530, 165707, 6968)), (4, 0, (2296, 796806, 6035)),
    (3, 1, (1530, 185447, 6893)), (6, 2, (3825, 890231, 8711))])
def test_bfs_kl_checksum_golden(m, seed, golden):
    """The checksums tests/test_partition.py pins for the reference."""
    g = _graph("sbm_photo_mini")
    part = graph.partition_graph(g.num_nodes, g.edges, m, seed=seed)
    got = (int(part.sum()),
           int((part * np.arange(len(part))).sum() % 1000003),
           graph.edge_cut(g.edges, part))
    assert got == golden


def test_partition_rejects_unknown_method():
    g = _graph("powerlaw8")
    with pytest.raises(ValueError, match="unknown partition method"):
        graph.partition_graph(g.num_nodes, g.edges, 3, method="metis5")


@pytest.mark.parametrize("limit", [1, 7, 8, 9, 100, 4584, 5000])
def test_pad_ladder_and_buckets(limit):
    assert graph.pad_ladder(limit) == jgraph.pad_ladder(limit)
    sizes = np.array([0, 1, 7, 8, 9, 17, 33, limit, max(limit - 3, 0)])
    n_pad = -(-max(limit, 8) // 8) * 8
    _assert_same(jgraph.bucket_pad_sizes(sizes, n_pad),
                 graph.bucket_pad_sizes(sizes, n_pad))


LAYOUTS = [("skewed8", 8, "bucketed"), ("skewed8", 8, "global"),
           ("powerlaw32", 32, "bucketed"), ("sbm_photo_mini", 3, "bucketed")]


def _layouts(name, m, pad_mode):
    g = _graph(name)
    part = jgraph.partition_graph(g.num_nodes, g.edges, m, seed=0)
    want = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                         compressed=True, pad_mode=pad_mode)
    got = graph.build_community_layout(g.num_nodes, g.edges, part,
                                       compressed=True, pad_mode=pad_mode)
    return g, want, got


@pytest.mark.parametrize("name,m,pad_mode", LAYOUTS)
def test_community_layout_and_block_csr_equal(name, m, pad_mode):
    g, want, got = _layouts(name, m, pad_mode)
    for f in ("num_parts", "n_pad", "pad_mode"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("perm", "a_blocks", "node_mask", "neighbor_mask", "sizes",
              "row_counts"):
        _assert_same(getattr(want, f), getattr(got, f))
    _assert_same(want.eff_row_counts(), got.eff_row_counts())
    _assert_same(want.row_offsets(), got.row_offsets())
    cw, cg = want.compress(), got.compress()
    for f in ("indptr", "indices", "blocks", "ell_indices", "ell_mask",
              "ell_blocks", "sizes", "row_counts"):
        _assert_same(getattr(cw, f), getattr(cg, f))
    for a, b in zip(cw.ell_row_counts(), cg.ell_row_counts()):
        _assert_same(a, b)
    assert (cg.nnz, cg.max_deg, cg.ell_nbytes) == \
        (cw.nnz, cw.max_deg, cw.ell_nbytes)
    x = np.random.default_rng(0).normal(
        size=(g.num_nodes, 5)).astype(np.float32)
    _assert_same(want.pack(x), got.pack(x))
    _assert_same(want.blockify(x), got.blockify(x))
    _assert_same(want.unblockify(want.blockify(x)),
                 got.unblockify(got.blockify(x)))
    _assert_same(cw.spmm(want.pack(x)), cg.spmm(got.pack(x)))


@pytest.mark.parametrize("name,m,pad_mode", LAYOUTS)
def test_packed_device_layout_equal(name, m, pad_mode):
    g, want, got = _layouts(name, m, pad_mode)
    shard_counts = [s for s in (1, 2, 4) if m % s == 0]
    rng = np.random.default_rng(1)
    for n_shards in shard_counts:
        dw, dg = want.device_layout(n_shards), got.device_layout(n_shards)
        for f in ("n_shards", "lanes_per_shard", "n_pad", "plane_rows",
                  "total_rows", "true_rows"):
            assert getattr(dg, f) == getattr(dw, f)
        for f in ("row_counts", "local_offsets", "shard_rows", "unpack_rows",
                  "pack_rows"):
            _assert_same(getattr(dw, f), getattr(dg, f))
        _assert_same(dw.global_unpack_rows(), dg.global_unpack_rows())
        _assert_same(dw.global_pack_rows(), dg.global_pack_rows())
        blk = got.pack(rng.normal(size=(g.num_nodes, 3)).astype(np.float32))
        _assert_same(dw.pack_state(blk), dg.pack_state(blk))
        _assert_same(dw.unpack_state(dw.pack_state(blk)),
                     dg.unpack_state(dg.pack_state(blk)))


@pytest.mark.parametrize("name,m,pad_mode", LAYOUTS[:3])
def test_topology_helpers_equal(name, m, pad_mode):
    _, want, got = _layouts(name, m, pad_mode)
    nbr = want.neighbor_mask
    for a, b in zip(jgraph.halo_readers(nbr), graph.halo_readers(nbr)):
        _assert_same(a, b)
    for hops in (0, 1, 2):
        for a, b in zip(jgraph.read_closure(nbr, [0, m - 1], hops),
                        graph.read_closure(nbr, [0, m - 1], hops)):
            _assert_same(a, b)
    for n_shards in (1, 2):
        nw, aw = jgraph.shard_neighbor_graph(nbr, n_shards)
        ng, ag = graph.shard_neighbor_graph(nbr, n_shards)
        _assert_same(aw, ag)
        for a, b in zip(nw, ng):
            _assert_same(a, b)


@pytest.mark.parametrize("kw", [
    dict(num_parts=8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0),
    dict(num_parts=32, nodes_per_part=32, size_skew=1.0, seed=0),
    dict(num_parts=6, nodes_per_part=16, attach=1, seed=3, feat_dim=4),
    dict(num_parts=8, nodes_per_part=12, attach=1, seed=0, feat_dim=8,
         size_skew=0.8),
])
def test_synthetic_powerlaw_communities_equal(kw):
    gw, pw = jgraph.synthetic_powerlaw_communities(**kw)
    gg, pg = graph.synthetic_powerlaw_communities(**kw)
    _assert_same(pw, pg)
    for f in ("edges", "features", "labels", "train_mask", "test_mask"):
        _assert_same(getattr(gw, f), getattr(gg, f))
    assert gg.num_classes == gw.num_classes


@pytest.mark.parametrize("name,seed", [("amazon_photo_mini", 0),
                                       ("amazon_computers_mini", 1)])
def test_synthetic_sbm_equal(name, seed):
    assert graph.DATASET_STATS == jgraph.DATASET_STATS
    gw, gg = jgraph.synthetic_sbm(name, seed=seed), \
        graph.synthetic_sbm(name, seed=seed)
    for f in ("edges", "features", "labels", "train_mask", "test_mask"):
        _assert_same(getattr(gw, f), getattr(gg, f))
    assert (gg.num_nodes, gg.num_edges, gg.num_classes) == \
        (gw.num_nodes, gw.num_edges, gw.num_classes)
    _assert_same(jgraph.normalized_adjacency(gw.num_nodes, gw.edges),
                 graph.normalized_adjacency(gg.num_nodes, gg.edges))


@pytest.mark.parametrize("name,m,pad_mode", LAYOUTS)
def test_accounting_equal(name, m, pad_mode):
    _, lay, _ = _layouts(name, m, pad_mode)
    dims = [16, 32, 4, 4, 32]
    for itemsize in (2, 4):
        assert messages.gather_bytes(lay.neighbor_mask, lay.n_pad, dims,
                                     itemsize=itemsize) == \
            jmessages.gather_bytes(lay.neighbor_mask, lay.n_pad, dims,
                                   itemsize=itemsize)
        assert messages.adjacency_bytes(lay.neighbor_mask, lay.n_pad,
                                        itemsize=itemsize) == \
            jmessages.adjacency_bytes(lay.neighbor_mask, lay.n_pad,
                                      itemsize=itemsize)
        for rc in (None, lay.row_counts):
            assert messages.pad_stats(lay.neighbor_mask, lay.sizes, rc,
                                      lay.n_pad, dims, itemsize=itemsize) \
                == jmessages.pad_stats(lay.neighbor_mask, lay.sizes, rc,
                                       lay.n_pad, dims, itemsize=itemsize)
    with pytest.raises(ValueError, match="below true community sizes"):
        messages.pad_stats(lay.neighbor_mask, lay.sizes,
                           np.zeros_like(lay.sizes), lay.n_pad, dims)
