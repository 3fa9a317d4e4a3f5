"""The expert-parallel all-to-all MoE dispatch (``moe.apply_moe_a2a``)
over four gloo ranks on a 2 × 2 mesh: the port of tests/test_moe_a2a.py,
against the JAX package's on four forced host devices.

One JAX subprocess runs, on the reduced deepseek-moe-16b MoE layer (f32):
the portable path and, under ``sharding_hints(mesh, moe_a2a=True)``, the
all-to-all path on x (2, 32, D); the same layer at ``capacity_factor``
0.5 on x (2, 128, D), where each group of 64 tokens has 32 slots an
expert and tokens are dropped, with each group's keep mask from the
reference's own routing steps (moe.py:196-218); the portable path under
the hints without ``moe_a2a`` on x (2, 32) and (1, 32), on x2 at
capacity factor 0.5, and with 3 experts; the portable path inside a
``shard_map`` manual over ``data``; and the deferred train step under the
hints (SGD, learning rate 1).  It writes the parameters, inputs and
outputs to an .npz.

One spawn of four gloo ranks (no JAX in them) places the layer by
``param_specs``, hands each rank its piece of x (``hints.rank_layout``:
rows over ``data``, positions over ``model``) and all-gathers the pieces
of the output.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.build import make_model
from repro_torch.sharding import hints, partition
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SHAPE = (2, 32)            # the reference test's x
DROP_SHAPE = (2, 128)      # groups of 64 tokens at capacity factor 0.5
STEP_BATCH = (4, 16)
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0

_WORKER = r"""
import dataclasses, json, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.models import moe as moe_lib
from repro.models.build import make_model
from repro.sharding.hints import sharding_hints
from repro.util import shard_map
from repro.util.compat import make_mesh

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()
cfg = get_config("deepseek-moe-16b", reduced=True)
mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
p = moe_lib.init_moe(cfg, jax.random.key(0))
arrays = {f"p/{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(p))}
rng = np.random.default_rng(0)
x = (rng.normal(size=tuple(spec["shape"]) + (cfg.d_model,))
     .astype(np.float32) * 0.5)
arrays["x"] = x
fn = jax.jit(lambda p, x, cfg=cfg: moe_lib.apply_moe(cfg, p, x))
out, aux = fn(p, x)
arrays["base/out"], arrays["base/aux"] = np.asarray(out), np.asarray(aux)
with mesh, sharding_hints(mesh, moe_a2a=True):
    out, aux = jax.jit(lambda p, x: moe_lib.apply_moe(cfg, p, x))(p, x)
arrays["a2a/out"], arrays["a2a/aux"] = np.asarray(out), np.asarray(aux)

# capacity factor 0.5: tokens dropped; each group's keep mask from the
# reference body's routing steps on its tokens
drop = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=0.5))
x2 = (rng.normal(size=tuple(spec["drop_shape"]) + (cfg.d_model,))
      .astype(np.float32) * 0.5)
arrays["x2"] = x2
with mesh, sharding_hints(mesh, moe_a2a=True):
    out, aux = jax.jit(lambda p, x: moe_lib.apply_moe(drop, p, x))(p, x2)
arrays["drop/out"], arrays["drop/aux"] = np.asarray(out), np.asarray(aux)
e, k = cfg.moe.num_experts, cfg.moe.top_k
flat = jnp.asarray(x2.reshape(-1, cfg.d_model))
t = flat.shape[0] // 4
for g in range(4):
    xf = flat[g * t:(g + 1) * t]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    fe = ids.reshape(t * k)
    cap = max(int(t * k / e * drop.moe.capacity_factor), min(t * k, 32))
    si = jnp.argsort(fe, stable=True)
    se = fe[si]
    idx = jnp.arange(t * k, dtype=jnp.int32)
    start = jnp.concatenate([jnp.ones((1,), bool), se[1:] != se[:-1]])
    gs = jax.lax.cummax(jnp.where(start, idx, 0))
    rank = jnp.zeros((t * k,), jnp.int32).at[si].set(idx - gs)
    arrays[f"drop/keep/{g}"] = np.asarray(rank < cap)

# the portable path under the hints (no moe_a2a): x (2, 32) and (1, 32),
# at capacity factor 0.5 on x2, and with 3 experts (3 · C rows: split over
# model at (1, 32), where they cut through an expert, whole at (2, 32))
cfg3 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                        num_experts=3))
p3 = moe_lib.init_moe(cfg3, jax.random.key(1))
arrays.update({f"p3/{i}": np.asarray(l)
               for i, l in enumerate(jax.tree.leaves(p3))})
for name, c, pp, xs in (("e4", cfg, p, x), ("e4_one", cfg, p, x[:1]),
                        ("drop", drop, p, x2), ("e3_one", cfg3, p3, x[:1]),
                        ("e3", cfg3, p3, x)):
    with mesh, sharding_hints(mesh):
        out, aux = jax.jit(lambda q, y, c=c: moe_lib.apply_moe(c, q, y))(
            pp, xs)
    arrays[f"scatter/{name}/out"] = np.asarray(out)
    arrays[f"scatter/{name}/aux"] = np.asarray(aux)

# inside a manual region: the portable path on each data shard
def body(xs):
    out, _ = moe_lib.apply_moe(cfg, p, xs)
    return out
with mesh, sharding_hints(mesh, moe_a2a=True):
    fn = shard_map(body, mesh=mesh, in_specs=P("data", None, None),
                   out_specs=P("data", None, None), check_rep=False,
                   axis_names=("data",))
    arrays["manual/out"] = np.asarray(jax.jit(fn)(x))

# the deferred train step under the hints
scfg = dataclasses.replace(cfg, optimizer="sgd", learning_rate=1.0)
model = make_model(scfg)
params = model.init(jax.random.key(0))
for i, l in enumerate(jax.tree.leaves(params)):
    arrays[f"step/init/{i}"] = np.asarray(l)
batch = {k2: rng.integers(0, cfg.vocab_size, tuple(spec["step_batch"]))
         .astype(np.int32) for k2 in ("tokens", "targets")}
arrays.update({f"step/batch/{k2}": v for k2, v in batch.items()})
with mesh, sharding_hints(mesh, moe_a2a=True):
    step = jax.jit(lambda p_, o, b: model.train_step_deferred(mesh, p_, o, b))
    _, _, mets = step(params, (), batch)
arrays["step/loss"] = np.asarray(mets["loss"])
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


SCATTER = ("e4", "e4_one", "drop", "e3_one", "e3")


def _cfg(capacity_factor=None, experts=None):
    cfg = configs.get_config("deepseek-moe-16b", reduced=True)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def _moe_params(cfg, arrays, prefix="p"):
    like = moe_lib.init_moe(cfg, torch.Generator().manual_seed(0))
    n = len(tree.leaves(like))
    return model_params_from_numpy(
        tree.unflatten(like, [arrays[f"{prefix}/{i}"] for i in range(n)]),
        "cpu")


def _run_layer(cfg, mesh, p_full, x, comm):
    """Each rank's piece of x through ``apply_moe`` under the active hints
    (its slices of the layer); the pieces of the output all-gathered."""
    specs = partition.param_specs(cfg, mesh, {"moe": p_full})["moe"]
    p = partition.place(p_full, specs, mesh)
    lay = hints.rank_layout(x.shape[0], x.shape[1])
    piece = lay.piece(x[lay.rows])
    out, aux = moe_lib.apply_moe(cfg, p, piece, lay)
    spec = ("data" if lay.rows != slice(0, lay.batch) else None,
            "model" if lay.seq_split else None, None)
    return partition.gather_leaf(out, spec, mesh, comm), aux, lay


def _group_keep(cfg, p, x, lay):
    """This rank's group of the flat tokens (the reference's) and its keep
    mask by the port's routing steps."""
    total = lay.batch * lay.seq
    t = total // 4
    g = lay.comm.data.rank * lay.nm + lay.m
    xg = x.reshape(total, -1)[g * t:(g + 1) * t]
    _, ids, _, _ = moe_lib.route(cfg, p, xg)
    flat = ids.reshape(-1)
    return (moe_lib.ranks(flat) < moe_lib.capacity(cfg, t)).numpy(), g


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    base = mesh_lib.init_process_mesh(rank, WORLD, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_rank_mesh(base, 2)
        with np.load(spec["reference"]) as data:
            arrays = {k: data[k] for k in data.files}
        out, rec = {}, {}
        cfg = _cfg()
        p = _moe_params(cfg, arrays)
        x = torch.from_numpy(arrays["x"])
        calls = moe_lib.a2a_calls
        with hints.sharding_hints(mesh, moe_a2a=True) as comm:
            got, aux, lay = _run_layer(cfg, mesh, p, x, comm)
            out["a2a/out"], rec["a2a/aux"] = got.numpy(), float(aux)
            rec["a2a_calls"] = moe_lib.a2a_calls - calls
            rec["a2a_bytes"] = comm.a2a_bytes
            rec["seq_split"] = lay.seq_split
            drop = _cfg(0.5)
            x2 = torch.from_numpy(arrays["x2"])
            got, aux, lay = _run_layer(drop, mesh, p, x2, comm)
            out["drop/out"], rec["drop/aux"] = got.numpy(), float(aux)
            keep, g = _group_keep(drop, p, x2, lay)
            rec["drop/keep"] = [g, keep.tolist()]
            # inside a manual region over data: the portable path on
            # this rank's rows (all of them local, positions still split
            # over model), no all-to-all
            calls = moe_lib.a2a_calls
            with hints.manual_region(("data",)):
                rows = mesh_lib.batch_rows(mesh, SHAPE[0])
                n = rows.stop - rows.start
                part, _, lay = _run_layer(cfg, mesh, p, x[rows], comm)
                assert lay.rows == slice(0, n) and lay.batch == n
            rec["manual"] = [rows.start, part.tolist()]
            rec["manual_calls"] = moe_lib.a2a_calls - calls
        # the hints without moe_a2a: the scatter path over the ranks
        cfg3 = _cfg(experts=3)
        p3 = _moe_params(cfg3, arrays, "p3")
        calls = moe_lib.a2a_calls
        with hints.sharding_hints(mesh) as comm:
            for name, c, pp, xs in (("e4", cfg, p, x), ("e4_one", cfg, p,
                                                         x[:1]),
                                    ("drop", drop, p, x2),
                                    ("e3_one", cfg3, p3, x[:1]),
                                    ("e3", cfg3, p3, x)):
                got, aux, _ = _run_layer(c, mesh, pp, xs, comm)
                out[f"scatter/{name}/out"] = got.numpy()
                rec[f"scatter/{name}/aux"] = float(aux)
            rec["scatter_calls"] = moe_lib.a2a_calls - calls
        # no hints: the portable path
        calls = moe_lib.a2a_calls
        assert hints.rank_layout(*SHAPE) is None
        base_out, base_aux = moe_lib.apply_moe(cfg, p, x)
        out["base/out"], rec["base/aux"] = base_out.numpy(), float(base_aux)
        rec["plain_calls"] = moe_lib.a2a_calls - calls
        # the deferred train step: the same bits with the hints as without
        scfg = dataclasses.replace(cfg, optimizer="sgd", learning_rate=1.0)
        model = make_model(scfg)
        like = model.init(0, "cpu")
        n = len(tree.leaves(like))
        params = model_params_from_numpy(tree.unflatten(
            like, [arrays[f"step/init/{i}"] for i in range(n)]), "cpu")
        rows = mesh_lib.batch_rows(mesh, STEP_BATCH[0])
        batch = {k: arrays[f"step/batch/{k}"][rows]
                 for k in ("tokens", "targets")}
        plain, _, mets = model.train_step_deferred(mesh, params, (), batch)
        with hints.sharding_hints(mesh, moe_a2a=True):
            hinted, _, mets_h = model.train_step_deferred(mesh, params, (),
                                                          batch)
        rec["step_equal"] = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(plain), tree.leaves(hinted)))
        rec["step_loss"] = [float(mets["loss"]), float(mets_h["loss"])]
        if rank == 0:
            np.savez(os.path.join(spec["out"], "ranks.npz"), **out)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        mesh_lib.destroy(base)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_a2a") / "reference.npz"
    spec = {"shape": SHAPE, "drop_shape": DROP_SHAPE,
            "step_batch": STEP_BATCH}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(path),
                           json.dumps(spec)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0 and "WORKER_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return path, arrays


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    path, _ = reference
    out = tmp_path_factory.mktemp("moe_a2a_ranks")
    mesh_lib.run_ranks(_rank_main, WORLD,
                       ({"reference": str(path), "out": str(out)},),
                       timeout=JOIN_TIMEOUT_S)
    with np.load(out / "ranks.npz") as data:
        got = {k: data[k] for k in data.files}
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return got, records


def _close(got, want, tol=1e-5):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def test_a2a_matches_portable(reference, ranks):
    """The all-to-all path over the ranks equals the reference's under the
    same hints and its portable path (no token dropped at x (2, 32, D)),
    within 1e-5 · max; aux differs from the portable one only through the
    per-group statistics (< 1e-4), and equals the reference's a2a aux."""
    _, want = reference
    got, recs = ranks
    _close(got["a2a/out"], want["a2a/out"])
    _close(got["a2a/out"], want["base/out"])
    for rec in recs:
        assert rec["a2a_calls"] == 1 and rec["a2a_bytes"] > 0
        assert rec["seq_split"]
        assert abs(rec["a2a/aux"] - float(want["a2a/aux"])) <= 1e-6
        assert abs(rec["a2a/aux"] - float(want["base/aux"])) < 1e-4
    assert len({rec["a2a/aux"] for rec in recs}) == 1


def test_a2a_drops_the_reference_tokens(reference, ranks):
    """At capacity factor 0.5 each group of 64 tokens drops tokens; every
    rank's group keeps exactly the reference's (token, slot)s, the output
    is within 1e-5 · max and aux within 1e-6."""
    _, want = reference
    got, recs = ranks
    dropped = 0
    for rec in recs:
        g, keep = rec["drop/keep"]
        ref_keep = want[f"drop/keep/{g}"]
        assert np.array_equal(np.asarray(keep), ref_keep), g
        dropped += int((~ref_keep).sum())
        assert abs(rec["drop/aux"] - float(want["drop/aux"])) <= 1e-6
    assert dropped > 0
    assert sorted(rec["drop/keep"][0] for rec in recs) == [0, 1, 2, 3]
    _close(got["drop/out"], want["drop/out"])


@pytest.mark.parametrize("case", SCATTER)
def test_scatter_path_over_ranks_matches_reference(reference, ranks, case):
    """``sharding_hints(mesh)`` without ``moe_a2a``: the scatter path laid
    out as ``hint_tokens`` / ``hint_moe_buffers`` place it (each data rank
    routes its share of the tokens, each model rank runs its rows of the
    buffer) equals the reference's under the same hints within 1e-5 · max,
    aux within 1e-6, with no all-to-all: rows over data or whole (x
    (1, 32)), tokens dropped (capacity factor 0.5), and 3 experts, whose
    buffer rows split over model cut through an expert at (1, 32)."""
    _, want = reference
    got, recs = ranks
    _close(got[f"scatter/{case}/out"], want[f"scatter/{case}/out"])
    for rec in recs:
        assert rec["scatter_calls"] == 0
        assert abs(rec[f"scatter/{case}/aux"]
                   - float(want[f"scatter/{case}/aux"])) <= 1e-6


def test_a2a_gated_off_without_hints(reference, ranks):
    """No hints: the portable scatter path, no all-to-all."""
    _, want = reference
    got, recs = ranks
    assert all(rec["plain_calls"] == 0 for rec in recs)
    _close(got["base/out"], want["base/out"])


def test_a2a_gated_off_inside_manual_region(reference, ranks):
    """Inside a manual region over ``data`` (the deferred train step) the
    dispatch defers to the portable path on the rank's rows — its local
    batch, its positions over ``model`` — : the reference's ``shard_map``
    output, with no all-to-all."""
    _, want = reference
    got, recs = ranks
    rows = SHAPE[0] // 2
    assert sorted({rec["manual"][0] for rec in recs}) == [0, rows]
    for rec in recs:
        assert rec["manual_calls"] == 0
        start, part = rec["manual"]
        _close(np.asarray(part, np.float32),
               want["manual/out"][start:start + rows])


def test_a2a_train_step_deferred_composes(reference, ranks):
    """The deferred train step under ``sharding_hints(mesh, moe_a2a=True)``
    runs the all-to-all gated off: the same parameter bits as without the
    hints, and the reference's loss under the hints within 1e-5."""
    _, want = reference
    _, recs = ranks
    ref = float(want["step/loss"])
    for rec in recs:
        assert rec["step_equal"]
        plain, hinted = rec["step_loss"]
        assert plain == hinted and np.isfinite(plain)
        assert abs(hinted - ref) <= 1e-5 * abs(ref)
