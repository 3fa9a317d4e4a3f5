"""The tensor-parallel ``Model.train_step_deferred``: split over ``model``
on a ``data`` × ``model`` mesh of processes, against the JAX package's
placed step on the same mesh shape.

Two JAX subprocesses (about half the architectures each, four forced host
devices apiece) draw gemma-2b, qwen2-7b, deepseek-moe-16b, mamba2-1.3b and
deepseek-v3-671b (MLA, MoE and the multi-token-prediction loss over the
split residual) at their reduced configurations (f32) and a global batch
(B = 8, S = 16), and step under SGD at learning rate 1 (the new parameters
carry the gradient), ``grad_accum`` 1 and 2:

  * 2 × 2: ``jit(train_step_deferred)`` with the parameters and the batch
    placed (``in_shardings`` from ``param_specs`` / ``batch_specs``) under
    ``sharding_hints(mesh, moe_a2a=True)``;
  * 1 × 4: ``jit(train_step)`` placed under ``sharding_hints(mesh)``: the
    reference's deferred step fails inside XLA there ("Cross-partition
    allreduce must be in (partial) manual partitioning mode"), and with one
    data rank both steps compute the same update;
  * the FSDP leg (``FSDP_THRESHOLD = 0``) for gemma-2b and deepseek-moe-16b
    at 2 × 2, grad_accum 2, and qwen2-7b at 2 × 2 with its config's Adam
    (the Adam state placed by ``opt_state_specs`` and compared);
  * deepseek-v3-671b with 6 heads and mamba2-1.3b with 10 SSD heads at
    2 × 2 (split, an odd count of heads a rank) and at 1 × 4 (the layers
    gathered whole: ``transformer.split_arch``);
  * recurrentgemma-9b (the RG-LRU on the rank's channels), internvl2-2b
    (its 16-position vision prefix before the 16 tokens) and
    seamless-m4t-medium (32 frames, 4 decoder tokens: the decoder's
    residual whole at 1 × 4, split at 2 × 2, its encoder split on both)
    at grad_accum 1 on both meshes;
  * the one-device ``train_step`` at grad_accum 1: the reference's own gap
    between its placed step and one device, reported beside the port's.

One spawn of four gloo ranks (no JAX in the ranks: they import this module,
which imports none) places the reference's parameters by ``param_specs``
(``convert.model_params_to_rank``), steps each case tensor-parallel, and
gathers the new parameters whole.  Held:

  * per leaf, within 1e-4 · max |delta| of the reference's, beside one f32
    spacing of the new value; loss and metrics within 1e-5 relative;
  * within the same bound of the port's replicated step (params whole on
    every rank) on the same mesh;
  * the leaves the same on every rank of a model line (norms, biases,
    routers) bit for bit equal on every rank;
  * the bytes sent along ``model`` a step equal to the arithmetic from the
    shapes (forward, remat recompute, backward), and ``sum_data`` called
    once a step whatever ``grad_accum`` is;
  * the bytes each rank counted along ``model``, along the other lines and
    summed over ``data`` equal to what the meta-device dry run of the same
    step counts for that rank (``launch.dryrun``, in this process).

The same spawn holds each differentiable collective against autograd of the
same function written whole in one process (on the 2 × 2 mesh's model
lines of 2 and on the 1 × 4 mesh's line of 4).
"""
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import InputShape
from repro_torch.convert import model_params_to_rank
from repro_torch.core.messages import MeshCollectives
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.build import make_model
from repro_torch.sharding import partition
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"2x2": 2, "1x4": 4}          # name -> model axis
ARCHS = ("gemma-2b", "qwen2-7b", "deepseek-moe-16b", "mamba2-1.3b",
         "deepseek-v3-671b")
# the RG-LRU hybrid, the vision prefix and the encoder-decoder, grad_accum 1
FAMILIES = ("recurrentgemma-9b", "internvl2-2b", "seamless-m4t-medium")
HALVES = (ARCHS[:2] + ARCHS[3:4] + FAMILIES[:2],
          ARCHS[2:3] + ARCHS[4:] + FAMILIES[2:])  # a JAX process each
ACCUMS = (1, 2)
B, S = 8, 16
S_FRAMES = 32                          # seamless: 32 frames, 4 tokens
TOL = 1e-4
LOSS_TOL = 1e-5
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 150.0
ODD_ARCHS = ("gemma-2b", "qwen2-7b", "deepseek-moe-16b")
ODD_S = 9                              # no model axis divides it
# (arch, accum, mesh, variant): "" SGD; "fsdp" SGD with input dims over
# data; "adam" the config's optimizer; "h6" (MLA) and "h10" (d_model 160:
# the SSD mixer's 10 heads) SGD with heads that 2 model ranks divide and 4
# do not (1 x 4 gathers those layers whole)
VARIANT_CFG = {"h6": {"num_heads": 6, "num_kv_heads": 6},
               "h10": {"d_model": 160}}
CASES = ([(arch, accum, mesh, "") for arch in ARCHS for accum in ACCUMS
          for mesh in MESHES]
         + [(arch, 2, "2x2", "fsdp") for arch in ("gemma-2b",
                                                   "deepseek-moe-16b")]
         + [("qwen2-7b", 1, "2x2", "adam")]
         + [(arch, 1, mesh, variant) for arch, variant in
            (("deepseek-v3-671b", "h6"), ("mamba2-1.3b", "h10"))
            for mesh in MESHES]
         + [(arch, 1, mesh, "") for arch in FAMILIES for mesh in MESHES])

_WORKER = r"""
import dataclasses, functools, json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch.mesh import make_host_mesh
from repro.models.build import make_model
from repro.sharding import partition
from repro.sharding.hints import sharding_hints

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()
default = partition.FSDP_THRESHOLD


def placed(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


arrays = {}
for arch in spec["archs"]:
    base = configs.get_config(arch, reduced=True)
    rng = np.random.default_rng(0)
    batch = {k: (rng.integers(0, base.vocab_size, shape).astype(np.int32)
                 if k in ("tokens", "targets") else
                 rng.normal(size=shape).astype(np.float32))
             for k, shape in spec["batches"][arch].items()}
    arrays.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
    for c_arch, accum, name, variant in spec["cases"]:
        if c_arch != arch:
            continue
        over = {} if variant == "adam" else {"optimizer": "sgd",
                                             "learning_rate": 1.0}
        over.update(spec["variant_cfg"].get(variant, {}))
        cfg = dataclasses.replace(base, grad_accum=accum, **over)
        model = make_model(cfg)
        params = model.init(jax.random.key(0))
        key = f"{arch}/{variant}" if variant in spec["variant_cfg"] else arch
        if f"{key}/init/0" not in arrays:
            for i, leaf in enumerate(jax.tree.leaves(params)):
                arrays[f"{key}/init/{i}"] = np.asarray(leaf)
        opt_state = model.init_optimizer().init(params)
        partition.FSDP_THRESHOLD = 0 if variant == "fsdp" else default
        mesh = make_host_mesh(spec["meshes"][name])
        pspecs = partition.param_specs(cfg, mesh, params)
        ospecs = partition.opt_state_specs(cfg, mesh, params, opt_state)
        bspecs = partition.batch_specs(cfg, mesh, batch)
        shard = (placed(mesh, pspecs), placed(mesh, ospecs),
                 placed(mesh, bspecs))
        if name == "2x2":
            step = functools.partial(model.train_step_deferred, mesh)
            hints = sharding_hints(mesh, moe_a2a=True)
        else:
            step, hints = model.train_step, sharding_hints(mesh)
        with mesh, hints:
            new, opt, mets = jax.jit(step, in_shardings=shard)(
                params, opt_state, batch)
        case = "/".join(filter(None, (arch, str(accum), name, variant)))
        for i, leaf in enumerate(jax.tree.leaves(new)):
            arrays[f"{case}/new/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(opt)):
            arrays[f"{case}/opt/{i}"] = np.asarray(leaf)
        for k, v in mets.items():
            arrays[f"{case}/metric/{k}"] = np.asarray(v)
        if accum == 1 and not variant:
            one, _, _ = jax.jit(model.train_step)(params, opt_state, batch)
            gap = 0.0
            for a, b, p0 in zip(jax.tree.leaves(new), jax.tree.leaves(one),
                                jax.tree.leaves(params)):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                scale = float(np.abs(b - np.asarray(p0, np.float64)).max())
                gap = max(gap, float(np.abs(a - b).max()) / max(scale,
                                                                1e-30))
            arrays[f"{case}/gap"] = np.float64(gap)
partition.FSDP_THRESHOLD = default
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


class PlainMesh:
    """A mesh's shape and axis names (what the spec rules read)."""

    def __init__(self, nm: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": WORLD // nm, "model": nm}


def _train_shape(arch) -> InputShape:
    """The training input shape of an arch's cases: B × S tokens; the
    vision prefix's positions before them; an encoder-decoder's
    ``S_FRAMES`` frames and its decoder's ``input_specs`` share of them."""
    cfg = configs.get_config(arch, reduced=True)
    seq = S
    if cfg.arch_type == "vlm":
        seq += cfg.frontend.num_embeddings
    if cfg.is_encoder_decoder:
        seq = S_FRAMES
    return InputShape("train", seq, B, "train")


def _batch_shapes(arch) -> dict:
    """Each batch entry's shape, as ``Model.input_specs`` of the arch's
    training shape makes it."""
    cfg = configs.get_config(arch, reduced=True)
    return {k: list(v.shape) for k, v in
            make_model(cfg).input_specs(_train_shape(arch)).items()}


def _case(arch, accum, mesh, variant):
    return "/".join(filter(None, (arch, str(accum), mesh, variant)))


def _group(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _model(arch, accum, variant):
    base = configs.get_config(arch, reduced=True)
    over = {} if variant == "adam" else {"optimizer": "sgd",
                                         "learning_rate": 1.0}
    return make_model(dataclasses.replace(base, grad_accum=accum, **over,
                                          **VARIANT_CFG.get(variant, {})))


def _init(arrays, arch, variant):
    """The reference's initial parameters of a case: the arch's, or those
    of a variant that changes its configuration."""
    key = f"{arch}/{variant}" if variant in VARIANT_CFG else arch
    return _group(arrays, f"{key}/init")


def _whole(model, leaves):
    like = model.init(0, "cpu")
    return tree.unflatten(like, [np.asarray(a) for a in leaves])


def _replicated_paths(model, mesh):
    """The key paths of the leaves no spec places over ``model``."""
    from repro_torch.models.build import _param_shapes
    specs = model.param_specs(mesh)
    return [path for path, _ in
            tree.leaves_with_paths(_param_shapes(model.cfg))
            if "model" not in {a for e in partition.spec_at(specs, path)
                               for a in partition.entry_axes(e)}]


# ---------------------------------------------------------------------------
# the bytes sent along model a step, from the shapes
# ---------------------------------------------------------------------------

def expected_model_bytes(cfg, nm: int, rows: int, accum: int,
                         replicated: int) -> int:
    """Bytes that leave a rank along ``model`` in one step of a split
    dense arch (``attn_mlp`` layers) at the residual split over the
    sequence: per microbatch of ``rows`` rows the forward, the remat
    recompute of every layer and the backward.  An all-gather of a piece
    of N f32 elements sends (nm − 1)·N·4 bytes, a reduce-scatter of a
    whole of M elements M·4·(nm − 1)/nm; each backward is its dual, with
    the same bytes; the loss's sums over ``model`` have no backward
    collective and its row-max gather no gradient.  The recompute stops at
    the layer's last saved activation (the MLP's down-projection input),
    so the MLP's exit reduce-scatter is not issued again.  After the
    microbatches the ``replicated`` elements of the leaves no spec splits
    over ``model`` are summed over ``model`` once (an all-gather)."""
    b, d = rows // accum, cfg.d_model
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    f = 4
    piece = b * (S // nm) * d                  # residual piece elements
    gather_x = (nm - 1) * piece * f            # lay.enter
    rs_x = b * S * d * f * (nm - 1) // nm      # lay.leave
    if hq % nm == 0 and hkv % nm == 0:         # heads
        attn = gather_x + rs_x
    else:                                      # context: weights whole
        w = [d * hq * hd, d * hkv * hd, d * hkv * hd, hq * hd * d]
        attn = sum((nm - 1) * n // nm * f for n in w) + gather_x
    mlp_in, mlp_out = gather_x, rs_x
    layer_fwd = attn + mlp_in + mlp_out
    layer = 2 * layer_fwd + (layer_fwd - mlp_out)   # fwd, bwd, recompute
    embed = 2 * rs_x                                # RS and its backward
    ce = 2 * gather_x + (nm - 1) * b * S * f + (nm - 1) * 2 * b * S * f
    return accum * (cfg.num_layers * layer + embed + ce) \
        + (nm - 1) * replicated * f


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _hash(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _collective_pairs(mesh, rank_key: str) -> dict:
    """Each differentiable collective against autograd of the same
    function whole in one process: the max |error| of the gradients,
    relative to their max."""
    from repro_torch.sharding import hints
    comm = MeshCollectives(mesh)
    nm, m = comm.model.world_size, comm.model.rank
    gen = torch.Generator().manual_seed(7)
    x_all = torch.randn((nm * 3, 5), generator=gen)
    w_all = torch.randn((nm, 5, 4), generator=gen)
    out = {}

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    # gather <-> reduce-scatter: each rank its own work on the whole
    x = x_all.chunk(nm)[m].clone().requires_grad_(True)
    y = comm.gather_model(x, 0) @ w_all[m]
    (y.square().sum()).backward()
    xw = x_all.clone().requires_grad_(True)
    sum((xw @ w_all[i]).square().sum() for i in range(nm)).backward()
    out["gather_scatter"] = rel(x.grad, xw.grad.chunk(nm)[m])

    # reduce-scatter <-> all-gather: partial products summed into pieces
    a = torch.randn((nm * 2, 5), generator=gen)
    w = w_all[m].clone().requires_grad_(True)
    piece = comm.reduce_scatter_model(a @ w, 0)
    (piece.sin().sum()).backward()
    ww = w_all.clone().requires_grad_(True)
    full = sum(a @ ww[i] for i in range(nm))
    full.sin().sum().backward()
    out["scatter_gather"] = rel(w.grad, ww.grad[m])

    # sum <-> identity: a sum the same on every rank, used alike
    w = w_all[m].clone().requires_grad_(True)
    s = comm.sum_model(x_all[:2] @ w)
    (s.tanh().sum()).backward()
    ww = w_all.clone().requires_grad_(True)
    sum(x_all[:2] @ ww[i] for i in range(nm)).tanh().sum().backward()
    out["sum_identity"] = rel(w.grad, ww.grad[m])

    # the slice-backward gather: every rank the same work on the whole
    x = x_all.chunk(nm)[m].clone().requires_grad_(True)
    comm.gather_model(x, 0, "slice").exp().sum().backward()
    xw = x_all.clone().requires_grad_(True)
    xw.exp().sum().backward()
    out["gather_slice"] = rel(x.grad, xw.grad.chunk(nm)[m])

    # fork: a tensor the same on every rank entering split work, the loss
    # summed over model (its gradient whole on every rank)
    v = x_all[:4].clone().requires_grad_(True)
    comm.sum_model((comm.fork_model(v) @ w_all[m]).square().sum()).backward()
    vw = x_all[:4].clone().requires_grad_(True)
    sum((vw @ w_all[i]).square().sum() for i in range(nm)).backward()
    out["fork_sum"] = rel(v.grad, vw.grad)

    # first-rank gradient: a term the same on every rank, with partial
    # gradients elsewhere summed over the ranks afterwards
    v = x_all[:4].clone().requires_grad_(True)
    part = (v @ w_all[m]).sum() + comm.first_rank_grad(v.square().sum())
    part.backward()
    g = comm.sum_model(v.grad)
    vw = x_all[:4].clone().requires_grad_(True)
    (sum((vw @ w_all[i]).sum() for i in range(nm))
     + vw.square().sum()).backward()
    out["first_rank"] = rel(g, vw.grad)

    # the data-deferred FSDP gather: a weight over data all-gathered once,
    # each data rank's rows' gradient at the whole size, summed over data
    # once and cut to the rank's slice
    nd, r = comm.data.world_size, comm.data.rank
    w_full = torch.randn((6, 4), generator=gen)
    rows = torch.randn((nd * 2, 6), generator=gen)
    spec = ("data", None)
    w_local = partition.local_slice(w_full, spec, mesh).clone()
    with torch.no_grad():
        whole = partition.gather_leaf(w_local, spec, mesh, comm,
                                      hints.DATA_AXES)
    live = whole.clone().requires_grad_(True)
    (rows.chunk(nd)[r] @ live).cos().sum().backward()
    acc = live.grad.clone()
    comm.sum_data([acc])
    got = partition.local_slice(acc, spec, mesh)
    ww = w_full.clone().requires_grad_(True)
    (rows @ ww).cos().sum().backward()
    out["fsdp_deferred"] = rel(got, partition.local_slice(ww.grad, spec,
                                                          mesh))

    # the sum in pieces: past ``BUCKET_BYTES`` a rank, the same bits as
    # one sum of the whole
    from repro_torch.core import messages
    big = torch.randn((nm * 7 + 3, 5), generator=gen) * (m + 1)
    whole = comm.sum_model(big)
    keep = messages.BUCKET_BYTES
    messages.BUCKET_BYTES = 16 * 4
    try:
        pieces = comm.sum_model(big)
    finally:
        messages.BUCKET_BYTES = keep
    out["sum_pieces"] = float((pieces - whole).abs().max())
    return {f"{rank_key}/{k}": v for k, v in out.items()}


def _odd_sequence(mesh, arrays, arch) -> float:
    """The split step at a sequence ``model`` does not divide (the
    residual whole on every rank: the second convention) against the
    replicated step; the gap as ``_within`` measures it."""
    model = _model(arch, 2, "")
    full = _whole(model, _group(arrays, f"{arch}/init"))
    rows = mesh_lib.batch_rows(mesh, B)
    batch = {k: arrays[f"{arch}/batch/{k}"][rows][:, :ODD_S]
             for k in ("tokens", "targets")}
    new, _, _ = model.train_step_deferred(
        mesh, model_params_to_rank(full, model, mesh, "cpu"), (), batch,
        comm=MeshCollectives(mesh))
    whole = partition.gather(new, model.param_specs(mesh), mesh,
                             MeshCollectives(mesh))
    rep, _, _ = model.train_step_deferred(
        mesh, tree.tree_map(torch.from_numpy, full), (), batch,
        comm=MeshCollectives(mesh))
    worst = 0.0
    for g, w, p0 in zip(tree.leaves(whole), tree.leaves(rep),
                        tree.leaves(full)):
        g, w = g.double().numpy(), w.double().numpy()
        over = float((np.abs(g - w)
                      - np.spacing(np.abs(w).astype(np.float32))).max())
        worst = max(worst, over / max(float(np.abs(w - p0).max()), 1e-30))
    return worst


def _backward_on_another_thread(mesh, arrays) -> bool:
    """The deepseek-moe-16b step (remat, the MoE layer's hints read in the
    recompute) with each backward pass run on another thread, as the
    card's autograd engine runs it: the same bits as on this thread."""
    import threading
    model = _model("deepseek-moe-16b", 2, "")
    full = _whole(model, _group(arrays, "deepseek-moe-16b/init"))
    rows = mesh_lib.batch_rows(mesh, B)
    batch = {k: arrays[f"deepseek-moe-16b/batch/{k}"][rows]
             for k in ("tokens", "targets")}
    here, _, _ = model.train_step_deferred(
        mesh, model_params_to_rank(full, model, mesh, "cpu"), (), batch,
        comm=MeshCollectives(mesh))
    grad = torch.autograd.grad

    def elsewhere(*args, **kwargs):
        out = {}
        worker = threading.Thread(
            target=lambda: out.setdefault("g", grad(*args, **kwargs)))
        worker.start()
        worker.join()
        return out["g"]
    torch.autograd.grad = elsewhere
    try:
        there, _, _ = model.train_step_deferred(
            mesh, model_params_to_rank(full, model, mesh, "cpu"), (), batch,
            comm=MeshCollectives(mesh))
    finally:
        torch.autograd.grad = grad
    return all(torch.equal(a, b) for a, b in zip(tree.leaves(here),
                                                  tree.leaves(there)))


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    base = mesh_lib.init_process_mesh(rank, WORLD, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        meshes = {name: mesh_lib.make_rank_mesh(base, m)
                  for name, m in MESHES.items()}
        arrays = {}
        for path in spec["references"]:
            with np.load(path) as data:
                arrays.update({k: data[k] for k in data.files})
        out, record = {}, {}
        default = partition.FSDP_THRESHOLD
        for arch, accum, name, variant in CASES:
            partition.FSDP_THRESHOLD = 0 if variant == "fsdp" else default
            mesh = meshes[name]
            model = _model(arch, accum, variant)
            full = _whole(model, _init(arrays, arch, variant))
            local = model_params_to_rank(full, model, mesh, "cpu")
            opt = model.init_optimizer().init(local)
            rows = mesh_lib.batch_rows(mesh, B)
            batch = {k: arrays[f"{arch}/batch/{k}"][rows]
                     for k in _batch_shapes(arch)}
            comm = MeshCollectives(mesh)
            calls = []
            inner = comm.sum_data
            comm.sum_data = lambda t, **kw: (calls.append(1),
                                             inner(t, **kw))[1]
            new, opt, mets = model.train_step_deferred(mesh, local, opt,
                                                       batch, comm=comm)
            sent = {c: getattr(comm, f"{c}_bytes")
                    for c in ("model", "line", "sum")}
            specs = model.param_specs(mesh)
            whole = partition.gather(new, specs, mesh, comm)
            case = _case(arch, accum, name, variant)
            for i, leaf in enumerate(tree.leaves(whole)):
                out[f"{case}/new/{i}"] = leaf.numpy()
            if variant == "adam":
                ospecs = model.opt_state_specs(mesh, opt)
                for i, leaf in enumerate(tree.leaves(
                        partition.gather(opt, ospecs, mesh, comm))):
                    out[f"{case}/opt/{i}"] = leaf.numpy()
            same = _replicated_paths(model, mesh)
            leaves = dict(tree.leaves_with_paths(new))
            # the replicated (PR 23) step on the same mesh
            rep_model = _model(arch, accum, variant)
            full_t = tree.tree_map(torch.from_numpy, full)
            rep, _, _ = rep_model.train_step_deferred(
                mesh, full_t, rep_model.init_optimizer().init(full_t), batch,
                comm=MeshCollectives(mesh))
            for i, leaf in enumerate(tree.leaves(rep)):
                out[f"{case}/replicated/{i}"] = leaf.numpy()
            record[case] = {
                "metrics": {k: float(v) for k, v in mets.items()},
                "same_hash": _hash([leaves[p] for p in same]),
                "n_same": len(same),
                "model_bytes": sent["model"],
                "line_bytes": sent["line"],
                "sum_bytes": sent["sum"],
                "sum_data_calls": len(calls),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in tree.leaves(local)),
            }
        partition.FSDP_THRESHOLD = default
        for arch in ODD_ARCHS:
            record[f"odd/{arch}"] = _odd_sequence(meshes["1x4"], arrays,
                                                  arch)
        record["threaded"] = _backward_on_another_thread(meshes["2x2"],
                                                         arrays)
        for name, mesh in meshes.items():
            record.update(_collective_pairs(mesh, f"pairs/{name}"))
        if rank == 0:
            np.savez(os.path.join(spec["out"], "ranks.npz"), **out)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        mesh_lib.destroy(base)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=str(ROOT / "src"))
    procs, paths = [], []
    for i, archs in enumerate(HALVES):
        path = tmp / f"reference{i}.npz"
        spec = {"archs": archs, "cases": CASES, "meshes": MESHES, "b": B,
                "s": S, "variant_cfg": VARIANT_CFG,
                "batches": {a: _batch_shapes(a) for a in archs}}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(path), json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
        paths.append(path)
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "WORKER_OK" in stdout, stderr[-3000:]
    arrays = {}
    for path in paths:
        with np.load(path) as data:
            arrays.update({k: data[k] for k in data.files})
    return [str(p) for p in paths], arrays


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    paths, _ = reference
    out = tmp_path_factory.mktemp("tp_train_ranks")
    mesh_lib.run_ranks(_rank_main, WORLD,
                       ({"references": paths, "out": str(out)},),
                       timeout=JOIN_TIMEOUT_S)
    with np.load(out / "ranks.npz") as data:
        got = {k: data[k] for k in data.files}
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return got, records


def _within(got, want, init, what):
    """Per leaf: |got − want| beyond one f32 spacing of ``want`` within
    TOL · max |want − init|; returns the worst ratio."""
    worst = 0.0
    assert len(got) == len(want) == len(init), what
    for i, (g, w, p0) in enumerate(zip(got, want, init)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = float(np.abs(w - np.asarray(p0, np.float64)).max())
        slack = np.spacing(np.abs(w).astype(np.float32))
        over = float((np.abs(g - w) - slack).max())
        assert np.isfinite(g).all() and over <= TOL * scale, \
            (what, i, over, scale)
        worst = max(worst, over / max(scale, 1e-30))
    return worst


def _held(new, want, init, case, variant, arch):
    """``_within``; for a first Adam step the weights move by lr · g /
    (|g| + eps), so where a gradient sums to within its rounding of zero
    (an embedding row's few lookups cancelling) two sums in other orders
    may move a weight by different fractions of lr.  The moments, linear
    and quadratic in g, are held per leaf apart; the weights move within
    2 · lr of ``want`` everywhere and within the SGD bound in 99.9 % of
    their elements."""
    if variant != "adam":
        return _within(new, want, init, case)
    lr = configs.get_config(arch, reduced=True).learning_rate
    n_off, n_all = 0, 0
    for g, w, p0 in zip(new, want, init):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = float(np.abs(w - np.asarray(p0, np.float64)).max())
        over = np.abs(g - w) - np.spacing(np.abs(w).astype(np.float32))
        assert float(over.max()) <= 2 * lr, (case, float(over.max()))
        n_off += int((over > TOL * scale).sum())
        n_all += over.size
    assert n_off <= 1e-3 * n_all, (case, n_off, n_all)
    print(f"{case}: {n_off} of {n_all} weights past the SGD bound")
    return float("nan")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum,mesh,variant", CASES)
def test_tensor_parallel_step_matches_reference(reference, ranks, arch,
                                                accum, mesh, variant):
    """The new parameters gathered whole within 1e-4 · max |delta| of the
    reference's placed step (its own gap to one device is reported), the
    loss and metrics within 1e-5; the Adam state too where it is used."""
    _, arrays = reference
    got, records = ranks
    case = _case(arch, accum, mesh, variant)
    init = _init(arrays, arch, variant)
    new, want = _group(got, f"{case}/new"), _group(arrays, f"{case}/new")
    worst = _held(new, want, init, case, variant, arch)
    if f"{case}/gap" in arrays:
        print(f"{case}: port {worst:.3g} of max |delta| from the "
              f"reference's placed step; the reference's placed step "
              f"{float(arrays[f'{case}/gap']):.3g} from its one-device step")
    mets = records[0][case]["metrics"]
    ref = {k.rsplit("/", 1)[1]: float(v) for k, v in arrays.items()
           if k.startswith(f"{case}/metric/")}
    assert set(mets) == set(ref)
    for k, w in ref.items():
        assert abs(mets[k] - w) <= LOSS_TOL * max(abs(w), 1e-30), \
            (case, k, mets[k], w)
    if variant == "adam":
        want = _group(arrays, f"{case}/opt")
        have = _group(got, f"{case}/opt")
        assert len(have) == len(want)
        for i, (g, w) in enumerate(zip(have, want)):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert g.shape == w.shape and \
                float(np.abs(g - w).max()) <= TOL * scale, (case, i)


@pytest.mark.parametrize("arch,accum,mesh,variant", CASES)
def test_tensor_parallel_step_matches_replicated_step(reference, ranks,
                                                      arch, accum, mesh,
                                                      variant):
    """The split step within 1e-4 · max |delta| of the port's own
    replicated step (every model rank a whole replica) on the same mesh."""
    _, arrays = reference
    got, _ = ranks
    case = _case(arch, accum, mesh, variant)
    _held(_group(got, f"{case}/new"), _group(got, f"{case}/replicated"),
          _init(arrays, arch, variant), case, variant, arch)


@pytest.mark.parametrize("arch,accum,mesh,variant", CASES)
def test_replicated_leaves_and_one_data_sum(ranks, arch, accum, mesh,
                                            variant):
    """The leaves no spec splits over ``model`` end bit for bit equal on
    every rank; ``sum_data`` runs once a step; each rank holds its
    slices (their bytes below one process's, equal on the ranks of one
    placement)."""
    _, records = ranks
    case = _case(arch, accum, mesh, variant)
    recs = [r[case] for r in records]
    assert recs[0]["n_same"] > 0
    assert len({r["same_hash"] for r in recs}) == 1, case
    assert all(r["sum_data_calls"] == 1 for r in recs), case
    assert all(r["metrics"] == recs[0]["metrics"] for r in recs)
    whole = _model(arch, accum, variant).cfg.param_count() * 4
    assert all(r["param_bytes"] < whole for r in recs), case


@pytest.mark.parametrize("arch,accum,mesh",
                         [(a, acc, m) for a in ("gemma-2b", "qwen2-7b")
                          for acc in ACCUMS for m in MESHES])
def test_bytes_along_model_are_the_arithmetic(ranks, arch, accum, mesh):
    """gemma-2b (the context branch: one KV head) and qwen2-7b (heads at
    nm 2, context at nm 4): every rank sends the bytes the shapes give,
    forward, recompute and backward."""
    _, records = ranks
    from repro_torch.models.build import _param_shapes
    cfg = configs.get_config(arch, reduced=True)
    nm = MESHES[mesh]
    specs = make_model(cfg).param_specs(PlainMesh(nm))
    replicated = sum(leaf.numel() for path, leaf in
                     tree.leaves_with_paths(_param_shapes(cfg))
                     if all(e is None for e in partition.spec_at(specs,
                                                                 path)))
    want = expected_model_bytes(cfg, nm, B // (WORLD // nm), accum,
                                replicated)
    for r in records:
        assert r[_case(arch, accum, mesh, "")]["model_bytes"] == want, \
            (arch, accum, mesh, r[_case(arch, accum, mesh, "")]
             ["model_bytes"], want)


@pytest.mark.parametrize("arch,accum,mesh,variant", CASES)
def test_dry_run_counts_the_ranks_bytes(ranks, arch, accum, mesh, variant):
    """The meta-device dry run of the same step (``launch.dryrun``: each
    rank of a stand-in mesh of the same shape, nothing allocated) counts
    the bytes each gloo rank counted along ``model``, along the other
    lines and summed over ``data``."""
    _, records = ranks
    cfg = _model(arch, accum, variant).cfg
    shape = _train_shape(arch)
    dims = (WORLD // MESHES[mesh], MESHES[mesh])
    default = partition.FSDP_THRESHOLD
    partition.FSDP_THRESHOLD = 0 if variant == "fsdp" else default
    try:
        for rank, rec in enumerate(records):
            with mesh_lib.stand_in_mesh(dims, rank) as stand_in:
                got = dryrun.count_collectives(cfg, shape, stand_in)
            want = rec[_case(arch, accum, mesh, variant)]
            assert [got[f"{c}_bytes"] for c in ("model", "line", "sum")] \
                == [want[f"{c}_bytes"] for c in ("model", "line", "sum")], \
                (rank, got, want)
    finally:
        partition.FSDP_THRESHOLD = default


@pytest.mark.parametrize("pair", ["gather_scatter", "scatter_gather",
                                  "sum_identity", "gather_slice", "fork_sum",
                                  "first_rank", "fsdp_deferred",
                                  "sum_pieces"])
@pytest.mark.parametrize("mesh", MESHES)
def test_differentiable_collectives_match_one_process(ranks, pair, mesh):
    """Each collective's backward against autograd of the same function
    whole in one process, on every rank, within 1e-6 of the gradient's
    max (f32 sums in another order)."""
    _, records = ranks
    for r in records:
        assert r[f"pairs/{mesh}/{pair}"] <= 1e-6, (mesh, pair, r)


@pytest.mark.parametrize("shape", [(2, 3, 11), (1, 5, 64)])
def test_loss_buffer_gives_the_autograd_chain_bits(shape):
    """``layers._ExpSumAt`` (the vocabulary-parallel loss's Σ exp and
    target logit, exp formed in place and the gradient in one buffer)
    against the plain autograd chain it replaces: the same forward and
    the same gradient, bit for bit, targets inside and outside the
    rank's columns."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(shape[-1])
    logits = torch.randn(shape, generator=gen) * 4
    top = logits.amax(-1) + 0.5
    t = torch.randint(-3, shape[-1] + 3, shape[:2], generator=gen)
    inside = (t >= 0) & (t < shape[-1])
    idx = t.clamp(0, shape[-1] - 1)
    g = torch.randn((2,) + shape[:2], generator=gen)
    a = logits.clone().requires_grad_(True)
    got = layers._ExpSumAt.apply(a, top, idx, inside)
    got.backward(g)
    b = logits.clone().requires_grad_(True)
    z = b - top[..., None]
    zt = torch.where(inside, torch.gather(z, -1, idx[..., None])[..., 0],
                     torch.zeros(()))
    want = torch.stack([z.exp().sum(-1), zt])
    want.backward(g)
    assert torch.equal(got, want)
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("arch", ODD_ARCHS)
def test_whole_residual_convention_at_an_indivisible_sequence(ranks, arch):
    """S = 9 on 1 × 4: the split layers run on the residual whole along
    ``model`` (the gradient whole on every rank, forks summed) — within
    1e-4 · max |delta| of the replicated step, on every rank."""
    _, records = ranks
    for r in records:
        assert r[f"odd/{arch}"] <= TOL, (arch, r[f"odd/{arch}"])


def test_backward_on_another_thread_gives_the_same_step(ranks):
    """A card runs the backward pass on its own autograd thread, where the
    remat recompute must read the hints the forward read (a context
    variable does not cross threads by itself): the same bits."""
    _, records = ranks
    assert all(r["threaded"] for r in records)


def test_launcher_trains_tensor_parallel_and_restores_placed(tmp_path):
    """``launch.train --reduced --processes 4 --model-axis 2 --backend gloo
    --device cpu`` places the parameters by ``param_specs`` (half the
    bytes a rank), trains tensor-parallel, writes a checkpoint whole that
    ``--resume`` places again; the losses equal one process's within
    1e-5."""
    from repro_torch import checkpoint
    from repro_torch.launch import train as train_launcher
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--batch",
            "4", "--seq", "32"]
    run = train_launcher.main(argv + [
        "--steps", "3", "--processes", "4", "--model-axis", "2", "--backend",
        "gloo", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    one = train_launcher.main(argv + ["--steps", "4"])
    assert run["mesh"] == {"data": 2, "model": 2}
    whole = configs.get_config("gemma-2b", reduced=True).param_count() * 4
    assert whole * 0.45 < run["param_bytes"] < whole * 0.55
    assert run["opt_bytes"] == 2 * run["param_bytes"] + 4
    assert all(b == run["model_bytes"][0] > 0 for b in run["model_bytes"])
    for a, b in zip(run["losses"], one["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (a, b)
    # the checkpoint is the reference's format, whole
    state = {"params": one["params"], "opt": one["opt_state"]}
    back = checkpoint.restore(tmp_path, state)
    assert [t.shape for t in tree.leaves(back)] == \
        [t.shape for t in tree.leaves(state)]
    resumed = train_launcher.main(argv + [
        "--steps", "1", "--processes", "4", "--model-axis", "2", "--backend",
        "gloo", "--ckpt-dir", str(tmp_path), "--resume"])
    assert abs(resumed["losses"][0] - one["losses"][3]) <= \
        LOSS_TOL * abs(one["losses"][3])
