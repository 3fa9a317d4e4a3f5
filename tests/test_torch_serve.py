"""The port's serving engine against the JAX package's, and on its own.

Parity: the same graph, layout and (JAX-drawn) weights go through
``repro.serve.CommunityServer`` and ``repro_torch.serve.CommunityServer``
(``device="cpu"``) on the same request stream.  Embeddings agree within
``rtol=1e-5, atol=1e-6`` (the self + halo split and the layer GEMM summed by
two libraries); ``stats()`` and the ``update_features`` reports are exactly
equal, because the cache decisions are deterministic host logic.

Port-internal: the counterparts of tests/test_serve_engine.py and
tests/test_serve_cache.py — bitwise hit-after-miss, cache on/off and
post-update parity, request order, invalidation against the dependency
tables, the batcher's ladder, and every cache behaviour.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core import graph as jgraph
from repro.serve import CommunityServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import zipf_node_stream as jax_zipf_node_stream
from repro_torch import convert
from repro_torch.core import gcn, graph
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (CacheStats, CommunityServer, FrequencySketch,
                               LRUCache, ServeConfig, zipf_node_stream)

M = 8


def _graph(seed: int = 0):
    return graph.synthetic_powerlaw_communities(
        num_parts=M, nodes_per_part=12, attach=1, seed=seed, feat_dim=8,
        size_skew=0.8)


def _build(config: "ServeConfig | None" = None, seed: int = 0):
    """The port's engine over the JAX package's initial weights."""
    g, part = _graph(seed)
    cfg = gcn.GCNConfig(layer_dims=(8, 8, g.num_classes))
    layout = graph.build_community_layout(g.num_nodes, g.edges, part,
                                          compressed=True,
                                          pad_mode="bucketed", num_parts=M)
    ws = [np.asarray(w) for w in jgcn.init_weights(
        jgcn.GCNConfig(layer_dims=cfg.layer_dims), jax.random.key(seed))]
    srv = CommunityServer(cfg, layout, convert.weights_from_numpy(ws, "cpu"),
                          g.features, config, device="cpu")
    return g, cfg, ws, srv


def _build_jax(config: "JaxServeConfig | None" = None, seed: int = 0):
    g, part = jgraph.synthetic_powerlaw_communities(
        num_parts=M, nodes_per_part=12, attach=1, seed=seed, feat_dim=8,
        size_skew=0.8)
    cfg = jgcn.GCNConfig(layer_dims=(8, 8, g.num_classes))
    layout = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                           compressed=True,
                                           pad_mode="bucketed", num_parts=M)
    ws = jgcn.init_weights(cfg, jax.random.key(seed))
    return JaxServer(cfg, layout, ws, g.features, config)


@pytest.fixture(scope="module")
def served():
    return _build()


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

CONFIGS = {
    "cached": {},
    "cold": {"cache_enabled": False},
    "fused-cold": {"fused": True, "cache_enabled": False},
    "small-lru": {"embed_capacity": 5, "halo_capacity": 6,
                  "admission": "lru", "max_batch": 32},
    "small-zipf-fused": {"embed_capacity": 6, "halo_capacity": 4,
                         "fused": True, "sketch_sample": 16,
                         "max_batch": 32},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax_engine(name):
    kw = CONFIGS[name]
    g, cfg, _, srv = _build(ServeConfig(**kw))
    jsrv = _build_jax(JaxServeConfig(**kw))
    stream = zipf_node_stream(g.num_nodes, 320, s=1.1, seed=1)
    rng = np.random.default_rng(3)
    touched = rng.choice(g.num_nodes, size=2, replace=False)
    feats = rng.normal(size=(2, cfg.layer_dims[0])).astype(np.float32)
    for i in range(0, len(stream), 32):
        if i == 160:
            assert srv.update_features(touched, feats) == \
                jsrv.update_features(touched, feats)
        batch = stream[i:i + 32]
        np.testing.assert_allclose(srv.serve(batch), jsrv.serve(batch),
                                   rtol=1e-5, atol=1e-6)
    assert srv.stats() == jsrv.stats()
    srv.reset_stats()
    jsrv.reset_stats()
    assert srv.stats() == jsrv.stats()


def test_every_node_matches_jax_engine(served):
    g, _, _, srv = served
    ids = np.arange(g.num_nodes)
    np.testing.assert_allclose(srv.serve(ids), _build_jax().serve(ids),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,seed", [(1.1, 1), (0.8, 0), (1.5, 7)])
def test_zipf_stream_equals_reference(s, seed):
    np.testing.assert_array_equal(
        zipf_node_stream(500, 1000, s=s, seed=seed),
        jax_zipf_node_stream(500, 1000, s=s, seed=seed))


def test_zipf_stream_rejects_empty_graph():
    with pytest.raises(ValueError, match="num_nodes"):
        zipf_node_stream(0, 4)


# ---------------------------------------------------------------------------
# the engine on its own
# ---------------------------------------------------------------------------

def test_serve_matches_dense_forward(served):
    g, cfg, ws, srv = served
    a = torch.as_tensor(graph.normalized_adjacency(g.num_nodes, g.edges))
    want = gcn.forward(cfg, a, torch.as_tensor(g.features),
                       convert.weights_from_numpy(ws, "cpu"))[-1]
    got = srv.serve(np.arange(g.num_nodes))
    # the per-community self + halo split reassociates the dense product
    np.testing.assert_allclose(got, want.numpy(), atol=5e-5, rtol=1e-4)


def test_hit_after_miss_is_bitwise(served):
    g, _, _, srv = served
    ids = np.random.default_rng(0).integers(0, g.num_nodes, size=48)
    first = srv.serve(ids)          # fills the cache for these communities
    h0 = srv.request_hits
    second = srv.serve(ids)         # pure hit path
    assert srv.request_hits - h0 == len(ids)
    np.testing.assert_array_equal(first, second)


def test_request_order_preserved(served):
    g, _, _, srv = served
    ids = np.array([g.num_nodes - 1, 0, 5, 0, 17, 3])
    out = srv.serve(ids)
    singles = np.concatenate([srv.serve(np.array([i])) for i in ids])
    np.testing.assert_array_equal(out, singles)


def test_cache_disabled_is_bitwise_parity():
    g, _, _, on = _build(ServeConfig(cache_enabled=True))
    _, _, _, off = _build(ServeConfig(cache_enabled=False))
    ids = np.arange(g.num_nodes)
    np.testing.assert_array_equal(on.serve(ids), off.serve(ids))
    # disabled really caches nothing and recomputes every batch
    assert len(off.embed_cache) == 0 and off.request_hits == 0
    assert off.block_computes > on.block_computes


def test_fused_cold_path_matches(served):
    g, _, _, srv = served
    _, _, _, fused = _build(ServeConfig(fused=True, cache_enabled=False))
    ids = np.arange(g.num_nodes)
    np.testing.assert_allclose(fused.serve(ids), srv.serve(ids),
                               atol=5e-5, rtol=1e-4)


def test_invalidation_matches_dependency_tables():
    g, cfg, _, srv = _build()
    srv.serve(np.arange(g.num_nodes))       # warm every cache line
    n_l = cfg.num_layers
    assert len(srv.embed_cache) > 0

    node = 0
    feats = np.asarray(g.features)[[node]] + 1.0
    rep = srv.update_features([node], feats)

    seeds = np.array([srv.node_comm[node]])
    closure = graph.read_closure(srv.neighbor_mask, seeds, hops=n_l)
    for hop, want in enumerate(closure):
        np.testing.assert_array_equal(rep["dirty"][hop], want)

    nbr_cross = srv.neighbor_mask & ~np.eye(M, dtype=bool)
    for layer in range(1, n_l + 1):
        want_embed = {(int(m), layer) for m in closure[layer]}
        assert {k for k in rep["embed"] if k[1] == layer} == want_embed
        want_halo = {(int(m), layer) for m in np.flatnonzero(
            nbr_cross[:, closure[layer - 1]].any(axis=1))}
        assert {k for k in rep["halo"] if k[1] == layer} == want_halo
    # the halo readers of the seed community are its hop-1 closure
    assert set(srv.readers[int(seeds[0])]) == set(closure[1].tolist())

    clean = set(range(M)) - {int(m) for m in closure[1]}
    assert clean, "test graph too dense to observe surviving cache lines"
    for m in clean:
        assert (m, 1) in srv.embed_cache


@pytest.mark.parametrize("fused", [False, True])
def test_post_update_serving_matches_fresh_engine(fused):
    config = ServeConfig(fused=fused)
    g, cfg, ws, srv = _build(config)
    ids = np.arange(g.num_nodes)
    srv.serve(ids)
    rng = np.random.default_rng(1)
    touched = np.array([2, 40, 41])
    feats = rng.normal(size=(3, cfg.layer_dims[0])).astype(np.float32)
    plane_before = srv.z0_plane
    srv.update_features(touched, feats)
    assert srv.z0_plane is not plane_before     # replaced, never written

    new_features = np.asarray(g.features).copy()
    new_features[touched] = feats
    fresh = CommunityServer(cfg, srv.layout,
                            convert.weights_from_numpy(ws, "cpu"),
                            new_features, config, device="cpu")
    np.testing.assert_array_equal(srv.serve(ids), fresh.serve(ids))


def test_update_features_validates_shape(served):
    _, cfg, _, srv = served
    with pytest.raises(ValueError, match="feats shape"):
        srv.update_features([0], np.zeros((2, cfg.layer_dims[0]),
                                          np.float32))


def test_weight_count_is_checked():
    g, cfg, ws, srv = _build()
    with pytest.raises(ValueError, match="weight matrices"):
        CommunityServer(cfg, srv.layout, ws[:1], g.features, device="cpu")


def test_batcher_buckets_on_pad_ladder(served):
    g, _, _, srv = served
    ids = np.random.default_rng(2).integers(0, g.num_nodes, size=100)
    batches = srv.batcher.coalesce(ids)
    ladder = set(srv.batcher.ladder)
    seen = np.concatenate([b.positions for b in batches])
    assert sorted(seen) == list(range(len(ids)))
    for b in batches:
        assert b.bucket in ladder and b.bucket >= b.count
        np.testing.assert_array_equal(srv.node_comm[ids[b.positions]],
                                      b.comm)
        np.testing.assert_array_equal(b.rows[:b.count],
                                      srv.node_row[ids[b.positions]])
        np.testing.assert_array_equal(b.rows[b.count:], 0)


def test_batcher_refuses_oversized_batch_and_2d_ids(served):
    _, _, _, srv = served
    with pytest.raises(ValueError, match="ladder cap"):
        srv.batcher.bucket(srv.batcher.ladder[-1] + 1)
    with pytest.raises(ValueError, match="1-D"):
        srv.batcher.coalesce(np.zeros((2, 2), np.int64))


def test_stats_shape(served):
    _, _, _, srv = served
    srv.serve(np.array([0, 1, 2]))
    s = srv.stats()
    assert {"requests", "block_computes", "halo_computes", "embed_cache",
            "halo_cache"} <= set(s)
    assert s["requests"]["total"] >= 3


def test_serve_config_rejects_unknown_admission():
    with pytest.raises(ValueError, match="unknown admission"):
        ServeConfig(admission="fifo")


def test_launcher_runs_on_cpu(capsys):
    assert serve_cli.main(["--parts", "4", "--nodes-per-part", "12",
                           "--epochs", "1", "--requests", "256", "--batch",
                           "32", "--update", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "qps" in out and "hit rate" in out
    assert "dirty communities per hop" in out and "post-update p50" in out


# ---------------------------------------------------------------------------
# the caches
# ---------------------------------------------------------------------------

def test_capacity_bound_and_lru_eviction_order():
    c = LRUCache(3)
    for k in "abcd":
        assert c.put(k, k.upper())
    assert len(c) == 3
    assert "a" not in c and c.keys() == ["b", "c", "d"]
    assert c.stats.evictions == 1


def test_get_refreshes_recency():
    c = LRUCache(3)
    for k in "abc":
        c.put(k, 0)
    assert c.get("a") == 0          # 'a' now most recent
    c.put("d", 0)                   # evicts 'b', not 'a'
    assert "a" in c and "b" not in c
    assert c.keys() == ["c", "a", "d"]


def test_put_overwrite_refreshes_without_eviction():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.put("a", 3)            # overwrite, no eviction
    assert len(c) == 2 and c.get("a") == 3
    assert c.stats.evictions == 0
    assert c.keys() == ["b", "a"]


@pytest.mark.parametrize("admission", ["lru", "zipf"])
def test_capacity_zero_disables(admission):
    c = LRUCache(0, admission=admission)
    assert not c.put("a", 1)
    assert c.get("a") is None
    assert len(c) == 0
    assert c.stats.rejections == 1 and c.stats.misses == 1


@pytest.mark.parametrize("hot_touches,cold_touches,admitted", [
    (5, 1, False),     # a single-touch candidate must not evict a hot key
    (1, 3, True),      # a hotter candidate replaces the resident
    (2, 2, True),      # ties admit (estimate not strictly colder)
])
def test_zipf_admission(hot_touches, cold_touches, admitted):
    c = LRUCache(1, admission="zipf")
    for _ in range(hot_touches):
        c.get("old")
    c.put("old", 1)
    for _ in range(cold_touches):
        c.get("new")
    assert c.put("new", 2) is admitted
    assert ("new" in c) is admitted and ("old" in c) is not admitted
    assert c.stats.rejections == (0 if admitted else 1)
    assert c.stats.evictions == (1 if admitted else 0)


def test_lru_admission_always_evicts():
    c = LRUCache(1, admission="lru")
    for _ in range(5):
        c.get("hot")
    c.put("hot", 1)
    assert c.put("cold", 2)
    assert "cold" in c and "hot" not in c


def test_contains_is_side_effect_free():
    c = LRUCache(2, admission="zipf")
    c.put("a", 1)
    c.put("b", 2)
    before = (c.stats.hits, c.stats.misses, c.keys())
    assert "a" in c and "z" not in c
    assert (c.stats.hits, c.stats.misses, c.keys()) == before


def test_invalidate_and_invalidate_where():
    c = LRUCache(8)
    for m in range(4):
        c.put((m, 1), m)
        c.put((m, 2), m)
    assert c.invalidate((0, 1))
    assert not c.invalidate((0, 1))     # already gone
    doomed = c.invalidate_where(lambda k: k[1] == 2)
    assert sorted(doomed) == [(m, 2) for m in range(4)]
    assert len(c) == 3
    assert c.stats.invalidations == 5


def test_clear_counts_invalidations():
    c = LRUCache(4)
    for k in "abc":
        c.put(k, 0)
    c.clear()
    assert len(c) == 0 and c.stats.invalidations == 3


def test_frequency_sketch_ages():
    s = FrequencySketch(sample=8)
    for _ in range(7):
        s.touch("a")
    assert s.estimate("a") == 7
    s.touch("b")                    # 8th touch triggers halving
    assert s.estimate("a") == 3     # 7 // 2
    assert s.estimate("b") == 0     # 1 // 2 -> dropped


def test_stats_hit_rate():
    st = CacheStats(hits=3, misses=1)
    assert st.lookups == 4 and st.hit_rate == 0.75
    assert st.as_dict()["hit_rate"] == 0.75
    st.reset()
    assert st.lookups == 0 and st.hit_rate == 0.0


@pytest.mark.parametrize("make,match", [
    (lambda: LRUCache(-1), "capacity"),
    (lambda: LRUCache(2, admission="fifo"), "admission"),
    (lambda: FrequencySketch(sample=0), "sample"),
])
def test_constructor_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()
