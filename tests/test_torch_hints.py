"""The activation-sharding hints as layout decisions, and the placement
they rest on (``sharding.hints``, ``sharding.partition``).

One JAX subprocess on four forced host devices (2 × 2, 1 × 4 and
``pod`` × ``data`` × ``model`` 2 × 1 × 2 meshes) records:

  * the sharding each reference hint gives an activation, over a grid of
    shapes: ``hint_residual`` (B, S, D), ``hint_qkv`` (q, k, v),
    ``hint_tokens`` (T, D) and ``hint_moe_buffers`` (E·C, D) — each hint
    applied inside ``jax.jit`` and the output's ``NamedSharding`` read;
  * ``NamedSharding(mesh, spec).shard_shape`` of every parameter leaf of
    every architecture (reduced) by the reference's ``param_specs``, and
    of every decode-cache leaf by its ``cache_specs``.

The port's decisions (``residual_layout``, ``qkv_layout``,
``tokens_layout``, ``moe_buffers_layout``; pure functions of shapes and
the mesh, no ranks) must give the same shardings, and its
``partition.local_shape`` the same shard shapes.  Production meshes
(16 × 16, 2 × 16 × 16) at full size are checked by shape arithmetic, and
``place`` then the reassembly of every rank's slice is the tensor bit for
bit (virtual ranks: no group).  The cache specs a decode step over ranks
derives from its slices are those of the global caches.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models.build import make_model
from repro_torch.sharding import hints, partition
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4)),
          "pod2x1x2": (("pod", "data", "model"), (2, 1, 2))}
RESIDUAL = [(b, s) for b in (1, 2, 3, 4) for s in (1, 2, 6, 16)]
QKV = [(b, s, hq, hkv) for b in (1, 2) for s in (1, 4, 6)
       for hq, hkv in ((4, 4), (4, 2), (4, 1), (2, 2), (6, 3))]
TOKENS = [1, 2, 3, 4, 8, 12]
BUFFERS = [(2, 2), (4, 4), (6, 6), (3, 3)]
ARCHS = sorted(configs.list_archs())
CACHE = (2, 16)          # decode cache batch, length
# local (one data rank's) shapes inside the 2 × 2 mesh's data-manual region
MANUAL_RESIDUAL = [(1, 4), (1, 1), (2, 6), (1, 3)]
MANUAL_QKV = [(1, 4, 4, 4), (1, 4, 4, 1), (1, 4, 4, 2), (1, 3, 3, 3),
              (1, 1, 4, 1)]
MANUAL_TOKENS = [2, 4]
MANUAL_BUFFERS = [4, 3]

_WORKER = r"""
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import configs
from repro.models.build import make_model
from repro.sharding import hints, partition
from repro.util.compat import make_mesh

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()


def entries(sharding, ndim):
    if not isinstance(sharding, NamedSharding):
        return None
    out = []
    for e in tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec)):
        out.append([] if e is None else
                   list(e) if isinstance(e, tuple) else [e])
    return out


def hinted(mesh, fn, *shapes):
    xs = [jnp.zeros(s, jnp.float32) for s in shapes]
    with mesh, hints.sharding_hints(mesh):
        outs = jax.jit(fn)(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [entries(o.sharding, o.ndim) for o in outs]


# the specs a hint pins inside a shard_map manual over data on arrays of
# the local shapes (each data rank's), read from its
# with_sharding_constraint calls at trace time; with the manual axes and
# the MoE gate's manual test seen there
def manual_data(mesh, fn, *local):
    from jax.sharding import PartitionSpec as P
    from repro.models import moe as jmoe
    from repro.util.compat import shard_map
    seen, out = [], {}
    wsc = jax.lax.with_sharding_constraint

    def record(x, sharding):
        seen.append(entries(sharding, x.ndim))
        return x

    def body(*a):
        fn(*a)
        out["manual"] = sorted(hints._manual_axes())
        out["moe_manual"] = bool(jmoe._inside_manual_region())
        return a
    xs = [jnp.zeros((mesh.shape["data"] * s[0],) + tuple(s[1:]),
                    jnp.float32) for s in local]
    sm = shard_map(body, mesh=mesh, in_specs=tuple(P("data") for _ in xs),
                   out_specs=tuple(P("data") for _ in xs), check_rep=False,
                   axis_names={"data"})
    jax.lax.with_sharding_constraint = record
    try:
        with mesh, hints.sharding_hints(mesh, moe_a2a=True):
            jax.jit(sm).lower(*xs)
    finally:
        jax.lax.with_sharding_constraint = wsc
    return dict(out, specs=seen)


rec = {}
for name, (names, dims) in spec["meshes"].items():
    mesh = make_mesh(tuple(dims), tuple(names), devices=jax.devices()[:4])
    r = rec[name] = {}
    r["residual"] = [hinted(mesh, hints.hint_residual, (b, s, 8))
                     for b, s in spec["residual"]]
    r["qkv"] = [hinted(mesh, hints.hint_qkv, (b, s, hq, 8), (b, s, hkv, 8),
                       (b, s, hkv, 8))
                for b, s, hq, hkv in spec["qkv"]]
    r["tokens"] = [hinted(mesh, hints.hint_tokens, (t, 8))
                   for t in spec["tokens"]]
    r["buffers"] = [hinted(mesh, hints.hint_moe_buffers, (a, 8), (c, 8))
                    for a, c in spec["buffers"]]
    if name == "2x2":
        r["manual"] = {
            "residual": [manual_data(mesh, hints.hint_residual, (b, s, 8))
                         for b, s in spec["manual_residual"]],
            "qkv": [manual_data(mesh, hints.hint_qkv, (b, s, hq, 8),
                                (b, s, hkv, 8), (b, s, hkv, 8))
                    for b, s, hq, hkv in spec["manual_qkv"]],
            "tokens": [manual_data(mesh, hints.hint_tokens, (t, 8))
                       for t in spec["manual_tokens"]],
            "buffers": [manual_data(mesh, hints.hint_moe_buffers, (a, 8),
                                    (a, 8)) for a in spec["manual_buffers"]]}
    shards = r["shards"] = {}
    for arch in spec["archs"]:
        cfg = configs.get_config(arch, reduced=True)
        model = make_model(cfg)
        params = jax.eval_shape(model.init, jax.random.key(0))
        pspecs = partition.param_specs(cfg, mesh, params)
        caches = model.init_cache(*spec["cache"])
        cspecs = partition.cache_specs(cfg, mesh, caches)
        for kind, shapes, specs in (("params", params, pspecs),
                                    ("caches", caches, cspecs)):
            leaves = jax.tree.leaves(shapes)
            sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            shards[f"{arch}/{kind}"] = [
                list(NamedSharding(mesh, s).shard_shape(tuple(l.shape)))
                for l, s in zip(leaves, sp)]
with open(out_path, "w") as f:
    json.dump(rec, f)
print("WORKER_OK")
"""


@dataclasses.dataclass(frozen=True)
class PlainMesh:
    names: tuple
    dims: tuple

    @property
    def axis_names(self):
        return self.names

    @property
    def shape(self):
        return dict(zip(self.names, self.dims))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("hints") / "reference.json"
    spec = {"meshes": MESHES, "residual": RESIDUAL, "qkv": QKV,
            "tokens": TOKENS, "buffers": BUFFERS, "archs": ARCHS,
            "cache": CACHE, "manual_residual": MANUAL_RESIDUAL,
            "manual_qkv": MANUAL_QKV, "manual_tokens": MANUAL_TOKENS,
            "manual_buffers": MANUAL_BUFFERS}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(path),
                           json.dumps(spec)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0 and "WORKER_OK" in proc.stdout, \
        proc.stderr[-3000:]
    return json.loads(path.read_text())


def _entries(spec, ndim):
    """A port decision's spec as the worker writes a sharding: a list of
    axis lists; None (no constraint) stays None."""
    if spec is None:
        return None
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [list(partition.entry_axes(e)) for e in spec]


def _unconstrained(got):
    """The reference leaves the activation alone: no named sharding, or
    one with no axis on any dim."""
    return got is None or all(not e for e in got)


def _same(port, ref, mesh):
    """One sharding, axes of size 1 (which split nothing, and which JAX
    may leave out of an output's spec) aside."""
    def drop(entries):
        return None if entries is None else [
            [a for a in e if mesh.shape[a] > 1] for e in entries]
    port, ref = drop(port), drop(ref)
    if port is None or _unconstrained(port):
        return _unconstrained(ref)
    return port == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_residual_layout_is_hint_residual(reference, mesh):
    m = PlainMesh(*MESHES[mesh])
    for (b, s), (ref,) in zip(RESIDUAL, reference[mesh]["residual"]):
        lay = hints.residual_layout((b, s, 8), m)
        port = None if lay is None else _entries((lay[0], lay[1], None), 3)
        assert _same(port, ref, m), (mesh, b, s, port, ref)


@pytest.mark.parametrize("mesh", MESHES)
def test_qkv_layout_is_hint_qkv(reference, mesh):
    """``heads`` pins q, k and v's heads over ``model``; ``context`` q's
    rows, k and v whole along ``model``; none leaves them alone."""
    m = PlainMesh(*MESHES[mesh])
    for (b, s, hq, hkv), refs in zip(QKV, reference[mesh]["qkv"]):
        branch, bq = hints.qkv_layout((b, s, hq, 8), (b, s, hkv, 8), m)
        if branch == "heads":
            want = [_entries((bq, None, "model", None), 4)] * 3
        elif branch == "context":
            want = [_entries((bq, "model", None, None), 4)] + \
                [_entries((bq, None, None, None), 4)] * 2
        else:
            want = [None] * 3
        for port, ref in zip(want, refs):
            assert _same(port, ref, m), (mesh, b, s, hq, hkv, branch,
                                         port, ref)


@pytest.mark.parametrize("mesh", MESHES)
def test_token_and_buffer_layouts_are_the_hints(reference, mesh):
    m = PlainMesh(*MESHES[mesh])
    for t, (ref,) in zip(TOKENS, reference[mesh]["tokens"]):
        dp = hints.tokens_layout((t, 8), m)
        assert _same(None if dp is None else _entries((dp, None), 2), ref,
                     m), (mesh, t, dp, ref)
    for (a, c), refs in zip(BUFFERS, reference[mesh]["buffers"]):
        assert a == c                   # the port's two buffers: one shape
        pinned = hints.moe_buffers_layout(a, m)
        for ref in refs:
            assert _same(_entries(("model", None), 2) if pinned else None,
                         ref, m), (mesh, a, c, ref)


def test_layout_decisions_in_a_manual_region_and_the_gate(reference,
                                                          tmp_path):
    """Inside the region manual over the data axes (the deferred train
    step's ``shard_map``) each decision is the reference's there, read
    from its hints inside a ``shard_map`` manual over ``data`` on the 2 × 2
    mesh: the data axes leave every decision (``hint_tokens`` pins
    nothing), ``model`` still splits the residual's sequence, q/k/v and
    the MoE buffers, and the reference's manual axes and the MoE gate's
    test see the region.  A manual ``model`` turns every ``model``
    decision off; the all-to-all gate is off in any manual region
    (moe.py:71-77) and needs E % nm == 0; the token groups follow
    moe.py:262-265.  Over ranks the region keeps ``model`` split
    (``ranks_active``) with every local row, and a manual ``model`` leaves
    nothing split."""
    m = PlainMesh(("data", "model"), (2, 2))
    ref = reference["2x2"]["manual"]
    assert hints.residual_layout((2, 4, 8), m) == (("data",), "model")
    with hints.manual_region(("data",)):
        for (b, s), got in zip(MANUAL_RESIDUAL, ref["residual"]):
            assert got["manual"] == ["data"] and got["moe_manual"]
            lay = hints.residual_layout((b, s, 8), m)
            port = None if lay is None else \
                _entries((lay[0], lay[1], None), 3)
            assert _same(port, got["specs"][0] if got["specs"] else None,
                         m), (b, s, port, got)
        for (b, s, hq, hkv), got in zip(MANUAL_QKV, ref["qkv"]):
            branch, bq = hints.qkv_layout((b, s, hq, 8), (b, s, hkv, 8), m)
            assert bq is None
            if branch == "heads":
                want = [_entries((None, None, "model", None), 4)] * 3
            elif branch == "context":
                want = [_entries((None, "model", None, None), 4)] + \
                    [_entries((None, None, None, None), 4)] * 2
            else:
                want = []
            assert len(got["specs"]) == len(want), (b, s, hq, hkv, got)
            for port, r in zip(want, got["specs"]):
                assert _same(port, r, m), (b, s, hq, hkv, branch, r)
        for t, got in zip(MANUAL_TOKENS, ref["tokens"]):
            assert hints.tokens_layout((t, 8), m) is None
            assert got["specs"] == [], got
        for a, got in zip(MANUAL_BUFFERS, ref["buffers"]):
            pinned = hints.moe_buffers_layout(a, m)
            assert pinned == bool(got["specs"]), (a, got)
            for r in got["specs"]:
                assert _same(_entries(("model", None), 2), r, m)
        assert hints.data_ranks(m) == 1
    with hints.manual_region(("model",)):
        assert hints.qkv_layout((2, 4, 4, 8), (2, 4, 4, 8), m) == \
            (None, None)
        assert not hints.moe_buffers_layout(8, m)
    moe = configs.get_config("deepseek-moe-16b", reduced=True)     # E = 4
    assert hints.a2a_gate(moe, m)
    with hints.manual_region(("data",)):
        assert not hints.a2a_gate(moe, m)
    assert not hints.a2a_gate(moe, PlainMesh(("data", "model"), (1, 3)))
    assert hints.moe_token_axes(8, m) == ("data", "model")
    assert hints.moe_token_axes(2, m) == ("data",)
    assert hints.moe_token_axes(3, m) == ()
    with hints.manual_region(("data",)):
        assert hints.manual_axes() == frozenset({"data"})
        assert hints.inside_manual_region()
    assert not hints.inside_manual_region()
    with hints.sharding_hints(m, moe_a2a=True) as comm:
        assert hints.active_mesh() is m and hints.moe_a2a_enabled()
        assert comm is None and not hints.ranks_active()
        assert hints.rank_layout(2, 4) is None
    assert hints.active_mesh() is None and not hints.moe_a2a_enabled()
    from repro_torch.launch import mesh as mesh_lib
    base = mesh_lib.init_process_mesh(0, 1, "gloo", str(tmp_path / "store"),
                                      device="cpu")
    try:
        mesh = mesh_lib.make_rank_mesh(base, 1)
        with hints.sharding_hints(mesh):
            with hints.manual_region(hints.DATA_AXES):
                assert hints.ranks_active()
                lay = hints.rank_layout(3, 4)
                assert lay.rows == slice(0, 3) and not lay.seq_split
            with hints.manual_region(hints.DATA_AXES + ("model",)):
                assert not hints.ranks_active()
                assert hints.rank_layout(3, 4) is None
    finally:
        mesh_lib.destroy(base)


def _port_shapes(arch, mesh):
    cfg = configs.get_config(arch, reduced=True)
    model = make_model(cfg)
    with FakeTensorMode():
        params = model.init(0, "cpu")
    caches = model.init_cache(*CACHE, device="meta")
    out = {}
    for kind, shapes, specs in (
            ("params", params, partition.param_specs(cfg, mesh, params)),
            ("caches", caches, partition.cache_specs(cfg, mesh, caches))):
        got = []
        for path, leaf in tree.leaves_with_paths(shapes):
            spec = specs
            for k in path:
                spec = spec[k]
            got.append(list(partition.local_shape(leaf.shape, spec, mesh)))
        out[kind] = got
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_local_shapes_are_the_reference_shard_shapes(reference, arch, mesh):
    """Every parameter and decode-cache leaf of the reduced architecture:
    the port's ``local_shape`` by its own specs equals JAX's
    ``NamedSharding(mesh, spec).shard_shape`` by the reference's."""
    got = _port_shapes(arch, PlainMesh(*MESHES[mesh]))
    for kind in ("params", "caches"):
        assert got[kind] == reference[mesh]["shards"][f"{arch}/{kind}"], \
            (arch, mesh, kind)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_local_shapes_divide(multi_pod):
    """On 16 × 16 and 2 × 16 × 16 at the published sizes, every
    parameter's local shape times its axes' sizes is its shape: each axis
    a spec assigns divides its dim."""
    mesh = PlainMesh(("pod", "data", "model") if multi_pod else
                     ("data", "model"), (2, 16, 16) if multi_pod else (16, 16))
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        with FakeTensorMode():
            params = make_model(cfg).init(0, "cpu")
        specs = partition.param_specs(cfg, mesh, params)
        for path, leaf in tree.leaves_with_paths(params):
            spec = specs
            for k in path:
                spec = spec[k]
            local = partition.local_shape(leaf.shape, spec, mesh)
            for dim, (n, full, e) in enumerate(zip(local, leaf.shape,
                                                   spec)):
                size = 1
                for a in partition.entry_axes(e):
                    size *= mesh.shape[a]
                assert n * size == full, (arch, path, dim)


def _virtual(names, dims):
    world = math.prod(dims)
    return [ProcessMesh(r, world, "gloo", torch.device("cpu"), None, names,
                        dims) for r in range(world)]


@pytest.mark.parametrize("mesh", MESHES)
def test_place_then_reassemble_is_the_tensor(mesh):
    """``place`` on every rank of the mesh, each slice written back at its
    chunk: the parameters bit for bit (every leaf's slices are contiguous
    copies of the right size)."""
    names, dims = MESHES[mesh]
    cfg = configs.get_config("deepseek-moe-16b", reduced=True)
    model = make_model(cfg)
    full = model.init(5, "cpu")
    specs = partition.param_specs(cfg, PlainMesh(names, dims), full)
    rebuilt = tree.tree_map(torch.zeros_like, full)
    hits = tree.tree_map(lambda t: torch.zeros_like(t, dtype=torch.int32),
                         full)
    for rank in _virtual(names, dims):
        local = partition.place(full, specs, rank)
        for (path, part), (_, dst), (_, hit) in zip(
                tree.leaves_with_paths(local),
                tree.leaves_with_paths(rebuilt),
                tree.leaves_with_paths(hits)):
            spec = specs
            for k in path:
                spec = spec[k]
            assert part.is_contiguous()
            view = partition.local_slice(dst, spec, rank)
            assert view.shape == part.shape
            view.copy_(part)
            partition.local_slice(hit, spec, rank).add_(1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(rebuilt),
                                                 tree.leaves(full)))
    # every element came from as many ranks as hold a copy of it
    for (path, hit), (_, leaf) in zip(tree.leaves_with_paths(hits),
                                      tree.leaves_with_paths(full)):
        spec = specs
        for k in path:
            spec = spec[k]
        copies = math.prod(dims)
        for e in spec:
            for a in partition.entry_axes(e):
                copies //= dict(zip(names, dims))[a]
        assert bool((hit == copies).all()), path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_cache_specs_from_the_slices(arch, mesh):
    """``decode_step`` over ranks derives the caches' specs from this
    rank's slices (``Model._rank_cache_specs``): they are those of the
    global caches of ``init_cache(batch, max_len, mesh=...)`` — batches
    over the data axes or not, a cache length the data axis splits (a
    batch of 1), rolling — and a batch of 1 whose odd local length could
    be a whole or a data-split cache is refused."""
    m = PlainMesh(*MESHES[mesh])
    model = make_model(configs.get_config(arch, reduced=True))
    for batch, max_len, rolling in ((2, 16, False), (1, 16, False),
                                    (3, 9, False), (2, 16, True)):
        full = model.init_cache(batch, max_len, rolling=rolling,
                                device="meta")
        want = partition.cache_specs(model.cfg, m, full)
        local = model.init_cache(batch, max_len, rolling=rolling,
                                 device="meta", mesh=m)
        assert model._rank_cache_specs(local, batch, rolling, m) == want, \
            (batch, max_len, rolling)
    if m.shape["data"] > 1 and arch != "mamba2-1.3b":   # no k/v caches
        local = model.init_cache(1, 7, device="meta", mesh=m)
        with pytest.raises(ValueError, match="global cache lengths"):
            model._rank_cache_specs(local, 1, False, m)
