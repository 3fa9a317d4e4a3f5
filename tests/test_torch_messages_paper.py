"""The paper's Appendix A messages (eq. 4) in the port, against the JAX
package, and the trainer's inline relay aggregate against them.

``row_aggregate``, ``first_order_messages`` (p), ``relay_aggregate`` (q),
``second_order_from_relay`` (s²) and ``neighbor_preactivations`` take the
same seeded numpy operands in both packages and agree within 1e-6 · max
|ref| in f32 (a sum of M · n_pad products, summed in another order).  The
port's trainer computes q inline, per lane (``_Body.agg_mm`` at the Z
update's relay site); it equals the literal Σ_r p_{r→m} of the dense
blocks within 1e-5 · max, on the dense and ELL adjacency and over four
loopback shards, where each lane reads its neighbours through the
exchange's receive buffers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import messages as jmsg
from repro_torch.core import gcn, graph, messages
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig

M, N, C, C_NEXT = 4, 16, 8, 6


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"a_row": rng.normal(size=(M, N, N)).astype(f32),
            "z_all": rng.normal(size=(M, N, C)).astype(f32),
            "w": rng.normal(size=(C, C_NEXT)).astype(f32),
            "mask": np.array([1, 0, 1, 1], f32),
            "q_all": rng.normal(size=(M, N, C_NEXT)).astype(f32),
            "z_var": rng.normal(size=(N, C)).astype(f32),
            "z_ref": rng.normal(size=(N, C)).astype(f32)}


CALLS = {
    "row_aggregate": lambda mod, o: mod.row_aggregate(
        o["a_row"], o["z_all"], o["mask"]),
    "row_aggregate_unmasked": lambda mod, o: mod.row_aggregate(
        o["a_row"], o["z_all"]),
    "first_order_messages": lambda mod, o: mod.first_order_messages(
        o["a_row"], o["z_all"], o["w"], o["mask"]),
    "relay_aggregate": lambda mod, o: mod.relay_aggregate(
        o["a_row"], o["z_all"], o["w"], o["mask"]),
    "second_order_from_relay": lambda mod, o: mod.second_order_from_relay(
        o["q_all"], o["a_row"], o["z_var"], o["w"]),
    "neighbor_preactivations": lambda mod, o: mod.neighbor_preactivations(
        o["q_all"], o["a_row"], o["z_var"], o["z_ref"], o["w"]),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_helper_matches_the_reference(name):
    ops = _operands()
    want = np.asarray(CALLS[name](jmsg, {k: jnp.asarray(v)
                                         for k, v in ops.items()}))
    got = CALLS[name](messages, {k: torch.as_tensor(v)
                                 for k, v in ops.items()}).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_relay_identity_eq4():
    """s² = q_r − Ã_{r,m} Z_m W = Σ_{r'≠m} Ã_{r,r'} Z_{r'} W on a symmetric
    block matrix, and the pre-activations at z_var = z_ref reduce to q."""
    rng = np.random.default_rng(1)
    blocks = rng.normal(size=(M, M, N, N)).astype(np.float32)
    blocks = (blocks + blocks.transpose(1, 0, 3, 2)) / 2
    z = rng.normal(size=(M, N, C)).astype(np.float32)
    w = rng.normal(size=(C, C_NEXT)).astype(np.float32)
    a, zt, wt = (torch.as_tensor(x) for x in (blocks, z, w))
    q_all = torch.stack([messages.relay_aggregate(a[r], zt, wt)
                         for r in range(M)])
    me = 0
    s2 = messages.second_order_from_relay(q_all, a[me], zt[me], wt).numpy()
    for r in range(M):
        want = sum(blocks[r, rp] @ z[rp] for rp in range(M) if rp != me) @ w
        assert np.abs(s2[r] - want).max() <= 1e-5 * np.abs(want).max()
    pre = messages.neighbor_preactivations(q_all, a[me], zt[me], zt[me], wt)
    assert torch.allclose(pre, q_all, rtol=0, atol=1e-6 * float(
        q_all.abs().max()))


@pytest.mark.parametrize("mode,n_shards", [("dense", 1), ("ell", 1),
                                           ("p2p", 4)])
def test_trainer_inline_relay_equals_the_literal_sum_of_p(mode, n_shards):
    g, part = graph.synthetic_powerlaw_communities(
        num_parts=8, nodes_per_part=12, attach=1, seed=0, feat_dim=8,
        size_skew=0.8)
    cfg = gcn.GCNConfig(layer_dims=(8, 8, g.num_classes))
    config = TrainerConfig.dense() if mode == "dense" else TrainerConfig.p2p()
    tr = ParallelADMMTrainer(cfg, ADMMConfig(), g, num_parts=8, seed=0,
                             part=part, device="cpu", n_shards=n_shards,
                             config=config)
    body, batch = tr._body, tr._full
    z1 = body.from_plane(tr.state.zs[0])                     # (M, n, C_1)
    w = tr.state.weights[1]
    # the Z update's relay site: q_loc = agg_mm(zh[l - 1], ...) @ W_{l+1}
    q = body.agg_mm(body.gather(z1, batch), None, w, batch,
                    use_kernel=False).numpy()
    a_blocks = tr.layout.a_blocks
    nbr = np.asarray(tr.layout.neighbor_mask, np.float32)
    zt, wt = z1, w
    for m in range(a_blocks.shape[0]):
        p = messages.first_order_messages(torch.as_tensor(a_blocks[m]), zt,
                                          wt, torch.as_tensor(nbr[m]))
        want = p.sum(0).numpy()
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(q[m] - want).max() <= 1e-5 * scale, m
