"""Prefill and decode over a ``data`` × ``model`` mesh of processes under
``sharding_hints(mesh, moe_a2a=True)``, against the JAX package's under
the same hints on the same mesh shape.

One JAX subprocess on four forced host devices draws each architecture's
reduced parameters (f32) and a batch (B = 2, S = 32), then, inside
``with mesh, sharding_hints(mesh, moe_a2a=True)`` on the 2 × 2 and 1 × 4
meshes of ``make_host_mesh``, runs the jitted forward (``last_only``: the
prefill's logits) and, for the split archs (deepseek-moe-16b, qwen2-7b,
gemma-2b, mamba2-1.3b and deepseek-v3-671b) and the three families of
their own (recurrentgemma-9b, internvl2-2b, seamless-m4t-medium), four
decode steps from ``init_cache`` (the caches a prefill returns; the
encoder-decoder's memory caches drawn at random, the same on both
sides).  Those exercise the split
layers: the MoE all-to-all, both ``hint_qkv`` branches (qwen2-7b's 2 KV
heads take the heads branch on 2 × 2 and the context branch on 1 × 4;
gemma-2b's one KV head always the context branch), MLA on the rank's
heads (its decode on the rank's slices of the latent cache), the SSD
mixer on the rank's heads (its decode on the rank's slice of d_state and
of the conv channels), both gathered whole where 4 ranks do not divide
their heads (6 MLA heads, 10 SSD heads), the RG-LRU on the rank's
channels (its local MQA attention in the context branch, windowed, at a
query offset; its decode on the rank's conv-state channels with h whole),
the vision prefix in the sequence-split residual of P + S positions, the
encoder on its own layout of frames with the decoder's cross-attention on
the rank's heads (its decode on the rank's slices of the memory caches),
the sequence-split residual and the vocabulary-split embedding.  Every
other family runs one forward at 1 × 4 and at 2 × 2.  It writes the
parameters, batches and outputs to an .npz.

One spawn of four gloo ranks (no JAX in the ranks: they import this
module, which imports none) places the reference's parameters on each
rank by ``param_specs`` (``convert.model_params_to_rank``), runs
``Model.prefill`` and ``decode_step`` under the hints, and all-gathers
each rank's block of the logits (``partition.logits_spec``).  The FSDP
leg (input dims over ``data``) runs with ``partition.FSDP_THRESHOLD``
lowered in the ranks only: the reference's values do not depend on the
placement.  deepseek-moe-16b also runs on 2 × 2 under the hints without
``moe_a2a`` (the scatter dispatch with the whole batch's capacity).  The
ranks also check that ``Model.init(mesh=...)`` gives the slices of the
one-process init bit for bit, and that ``partition.gather`` of the placed
tree is the tree, and count the layers gathered whole
(``transformer.gather_layer(whole=True)``).  Held: every logit within 1e-5
· max of the reference's; no layer gathered whole where ``split_arch``
holds; the RG-LRU's h the same on every model rank after the decode
steps; and each rank's bytes of the prefill and of one decode step, counter by
counter, equal to what the meta-device dry run of the same calls counts
for that rank (``launch.dryrun``, in this process).
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
from repro_torch.configs import InputShape
from repro_torch.convert import model_params_to_rank
from repro_torch.core.messages import COUNTERS
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.build import make_model
from repro_torch.sharding import hints, partition
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"2x2": 2, "1x4": 4}          # name -> model axis
SPLIT = ("deepseek-moe-16b", "qwen2-7b", "gemma-2b", "mamba2-1.3b",
         "deepseek-v3-671b")
FAMILIES = ("recurrentgemma-9b", "internvl2-2b", "seamless-m4t-medium")
OTHERS = ("moonshot-v1-16b-a3b", "nemotron-4-15b")
B, S, S_ENC, MAX_LEN, STEPS = 2, 32, 16, 48, 4
TOL = 1e-5
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 150.0
# (arch, mesh, variant): "" the hints with moe_a2a; "fsdp" the same with
# input dims over data; "portable" the hints without moe_a2a (the scatter
# dispatch, the whole batch's capacity); "hd6" head_dim 6, which 4 model
# ranks do not divide, so cache_specs puts deepseek's 4 KV heads over model
# and leaves qwen2's 2 whole; "h6" (MLA) and "h10" (d_model 160: the SSD
# mixer's 10 heads) heads that 2 model ranks divide and 4 do not, so 1 x 4
# gathers those layers whole; "ff510" the hybrid's MLP 510 wide (the same:
# split at 2 x 2, gathered at 1 x 4); "w8" the hybrid's local attention
# window 8, which masks inside the context branch's query rows
ODD_HEADS = [("deepseek-v3-671b", mesh, "h6") for mesh in MESHES] \
    + [("mamba2-1.3b", mesh, "h10") for mesh in MESHES] \
    + [("recurrentgemma-9b", mesh, v) for v in ("ff510", "w8")
       for mesh in MESHES]
RUNS = ([(arch, mesh, "") for arch in SPLIT for mesh in MESHES]
        + [(arch, "2x2", "fsdp") for arch in SPLIT]
        + [("deepseek-moe-16b", "2x2", "portable")]
        + [(arch, "1x4", "hd6") for arch in SPLIT[:2]]
        + ODD_HEADS
        + [(arch, mesh, "") for arch in FAMILIES + OTHERS
           for mesh in MESHES])
VARIANT_CFG = {"hd6": {"head_dim": 6},
               "h6": {"num_heads": 6, "num_kv_heads": 6},
               "h10": {"d_model": 160},
               "ff510": {"d_ff": 510},
               "w8": {"hybrid": {"local_window": 8}}}
GATHERED_AT_4 = ("h6", "h10", "ff510")
DECODED = SPLIT + FAMILIES
CASES = ([(arch, mesh, step) for arch in DECODED for mesh in MESHES
          for step in ["prefill"] + [f"decode/{t}" for t in range(STEPS)]])

_WORKER = r"""
import dataclasses, json, sys
import jax
import numpy as np
from repro import configs
from repro.launch.mesh import make_host_mesh
from repro.models.build import make_model
from repro.sharding.hints import sharding_hints

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()
b, s = spec["b"], spec["s"]
arrays = {}
for key, run in spec["runs"].items():
    cfg = configs.get_config(run["arch"], reduced=True)
    over = dict(run["overrides"])
    if "hybrid" in over:
        over["hybrid"] = dataclasses.replace(cfg.hybrid, **over["hybrid"])
    cfg = dataclasses.replace(cfg, **over)
    model = make_model(cfg)
    params = model.init(jax.random.key(0))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        arrays[f"{key}/init/{i}"] = np.asarray(leaf)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.frontend.num_embeddings, cfg.d_model)) \
            .astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(b, spec["s_enc"], cfg.d_model)) \
            .astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, (b, spec["steps"])) \
        .astype(np.int32)
    if cfg.is_encoder_decoder:
        shape = model.init_cache(b, spec["max_len"])["dec"]["cross_k"].shape
        for k in ("cross_k", "cross_v"):
            arrays[f"{key}/{k}"] = rng.normal(size=shape).astype(np.float32)
    arrays.update({f"{key}/batch/{k}": v for k, v in batch.items()})
    arrays[f"{key}/steps"] = steps
    for case, model_axis, decode, a2a in run["cases"]:
        mesh = make_host_mesh(model_axis)
        with mesh, sharding_hints(mesh, moe_a2a=a2a):
            logits, _, _ = jax.jit(lambda p, x: model.forward(
                p, x, last_only=True))(params, batch)
            arrays[f"{run['arch']}/{case}/prefill"] = np.asarray(logits)
            if decode:
                caches = model.init_cache(b, spec["max_len"])
                if cfg.is_encoder_decoder:
                    caches["dec"].update(
                        {k: jax.numpy.asarray(arrays[f"{key}/{k}"])
                         for k in ("cross_k", "cross_v")})
                step = jax.jit(model.decode_step)
                for t in range(spec["steps"]):
                    logits, caches = step(params, caches,
                                          steps[:, t:t + 1])
                    arrays[f"{run['arch']}/{case}/decode/{t}"] = \
                        np.asarray(logits)
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


def _group(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _config(arch, variant):
    """The reduced config of ``arch`` with a variant's changes."""
    cfg = configs.get_config(arch, reduced=True)
    over = dict(VARIANT_CFG.get(variant, {}))
    if "hybrid" in over:
        over["hybrid"] = dataclasses.replace(cfg.hybrid, **over["hybrid"])
    return dataclasses.replace(cfg, **over)


def _model_key(arch, variant):
    """The key of a run's parameters and batch: the arch, or the arch and
    a variant that changes its configuration."""
    return f"{arch}/{variant}" if variant in VARIANT_CFG else arch


def _bits(tree_a, tree_b) -> bool:
    return all(torch.equal(a, b) for a, b in
               zip(tree.leaves(tree_a), tree.leaves(tree_b)))


def _counters(comm) -> dict:
    return {c: getattr(comm, f"{c}_bytes") for c in COUNTERS}


def _since(comm, before: dict) -> dict:
    """The bytes each counter of ``comm`` moved since ``before``."""
    return {c: n - before[c] for c, n in _counters(comm).items()}


def _whole_layers(calls: list):
    """``transformer.gather_layer`` counting its calls with ``whole``
    into ``calls``."""
    inner = transformer.gather_layer

    def counting(p, specs, lay, whole):
        calls.append(bool(whole))
        return inner(p, specs, lay, whole)
    return counting


def _memory_caches(caches, arrays, key, model, mesh):
    """The encoder-decoder's memory caches set to this rank's slices of
    the reference's (random) ones."""
    specs = model._rank_cache_specs(caches, B, False, mesh)
    for k in ("cross_k", "cross_v"):
        caches["dec"][k].copy_(partition.local_slice(
            torch.from_numpy(arrays[f"{key}/{k}"]), specs["dec"][k], mesh))


def _state_hash(caches) -> str:
    """A hash of the RG-LRU states h of every layer (whole on every model
    rank)."""
    import hashlib
    h = hashlib.sha256()
    for kind, tree_ in sorted(caches.items()):
        for path, leaf in tree.leaves_with_paths(tree_):
            if path[-1] == "h":
                h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    base = mesh_lib.init_process_mesh(rank, WORLD, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    whole: list = []
    transformer.gather_layer = _whole_layers(whole)
    try:
        meshes = {name: mesh_lib.make_rank_mesh(base, m)
                  for name, m in MESHES.items()}
        with np.load(spec["reference"]) as data:
            arrays = {k: data[k] for k in data.files}
        out, record = {}, {}
        default = partition.FSDP_THRESHOLD
        for arch, name, variant in RUNS:
            partition.FSDP_THRESHOLD = 0 if variant == "fsdp" else default
            mesh = meshes[name]
            key = _model_key(arch, variant)
            cfg = _config(arch, variant)
            model = make_model(cfg)
            like = model.init(0, "cpu")
            full = tree.unflatten(like, [np.asarray(a) for a in
                                         _group(arrays, f"{key}/init")])
            local = model_params_to_rank(full, model, mesh, "cpu")
            batch = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
                     for k, v in arrays.items()
                     if k.startswith(f"{key}/batch/")}
            steps = torch.from_numpy(arrays[f"{key}/steps"])
            case = "/".join(filter(None, (arch, name, variant)))
            with hints.sharding_hints(mesh, moe_a2a=variant != "portable") \
                    as comm:
                spec_l = partition.logits_spec(cfg, mesh, B)
                before = _counters(comm)
                whole.clear()
                logits, caches = model.prefill(local, batch, MAX_LEN)
                counted = {"prefill": _since(comm, before)}
                out[f"{case}/prefill"] = partition.gather_leaf(
                    logits, spec_l, mesh, comm).numpy()
                if arch in DECODED:
                    if cfg.is_encoder_decoder:
                        _memory_caches(caches, arrays, key, model, mesh)
                    for t in range(STEPS):
                        before = _counters(comm)
                        logits, caches = model.decode_step(
                            local, caches, steps[:, t:t + 1])
                        if t == 0:
                            counted["decode"] = _since(comm, before)
                        out[f"{case}/decode/{t}"] = partition.gather_leaf(
                            logits, spec_l, mesh, comm).numpy()
                n_whole = sum(whole)
                # placement: init(mesh=) slices the one-process init, and
                # gather inverts place, bit for bit
                specs = model.param_specs(mesh)
                drawn = model.init(3, "cpu")
                record[case] = {
                    "init_slices": _bits(model.init(3, "cpu", mesh=mesh),
                                         partition.place(drawn, specs,
                                                         mesh)),
                    "gather_place": _bits(partition.gather(
                        partition.place(drawn, specs, mesh), specs, mesh,
                        comm), drawn),
                    "a2a_bytes": comm.a2a_bytes,
                    "model_bytes": comm.model_bytes,
                    "counted": counted,
                    "whole_layers": n_whole,
                    "split": transformer.split_arch(cfg, MESHES[name]),
                    "state_hash": _state_hash(caches)}
        partition.FSDP_THRESHOLD = default
        if rank == 0:
            np.savez(os.path.join(spec["out"], "ranks.npz"), **out)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        mesh_lib.destroy(base)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_forward") / "reference.npz"
    runs: dict = {}
    for arch, name, variant in RUNS:
        run = runs.setdefault(_model_key(arch, variant), {
            "arch": arch, "overrides": VARIANT_CFG.get(variant, {}),
            "cases": []})
        if variant != "fsdp":
            run["cases"].append(("/".join(filter(None, (name, variant))),
                                 MESHES[name], arch in DECODED,
                                 variant != "portable"))
    spec = {"runs": runs, "b": B, "s": S, "s_enc": S_ENC,
            "max_len": MAX_LEN, "steps": STEPS}
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
    out = tmp_path_factory.mktemp("mesh_forward_ranks")
    mesh_lib.run_ranks(_rank_main, WORLD,
                       ({"reference": str(path), "out": str(out)},),
                       timeout=JOIN_TIMEOUT_S)
    with np.load(out / "ranks.npz") as data:
        got = {k: data[k] for k in data.files}
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return got, records


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert np.isfinite(got).all() and err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch,mesh,step", CASES)
def test_split_layers_match_reference(reference, ranks, arch, mesh, step):
    """The split archs and the RG-LRU hybrid, the vision prefix and the
    encoder-decoder: the prefill's last-token logits and each of 4 decode
    steps' equal the reference's under the same hints within 1e-5 ·
    max."""
    _, want = reference
    got, _ = ranks
    _close(got[f"{arch}/{mesh}/{step}"], want[f"{arch}/{mesh}/{step}"],
           (arch, mesh, step))


@pytest.mark.parametrize("arch", SPLIT)
def test_fsdp_leg_matches_reference(reference, ranks, arch):
    """Input dims over ``data`` too (``FSDP_THRESHOLD`` lowered in the
    ranks): the same logits on 2 × 2, prefill and decode."""
    _, want = reference
    got, _ = ranks
    for step in ["prefill"] + [f"decode/{t}" for t in range(STEPS)]:
        _close(got[f"{arch}/2x2/fsdp/{step}"], want[f"{arch}/2x2/{step}"],
               (arch, step))


def test_portable_dispatch_matches_reference(reference, ranks):
    """``sharding_hints(mesh)`` without ``moe_a2a``: the all-to-all is
    gated off and the scatter dispatch runs over the whole batch (its
    capacity from the global token count), prefill and decode, as the
    reference's under the same hints."""
    _, want = reference
    got, _ = ranks
    for step in ["prefill"] + [f"decode/{t}" for t in range(STEPS)]:
        key = f"deepseek-moe-16b/2x2/portable/{step}"
        _close(got[key], want[key], step)


@pytest.mark.parametrize("arch", SPLIT[:2])
def test_decode_on_head_split_and_whole_caches(reference, ranks, arch):
    """head_dim 6 on 1 × 4: deepseek-moe-16b's caches hold one KV head a
    rank (heads over ``model``), qwen2-7b's stay whole along ``model``;
    prefill and 4 decode steps as the reference's."""
    _, want = reference
    got, _ = ranks
    for step in ["prefill"] + [f"decode/{t}" for t in range(STEPS)]:
        key = f"{arch}/1x4/hd6/{step}"
        _close(got[key], want[key], key)


@pytest.mark.parametrize("arch,mesh,variant", ODD_HEADS)
def test_heads_that_do_not_divide_match_reference(reference, ranks, arch,
                                                  mesh, variant):
    """MLA with 6 heads, the SSD mixer with 10 and the hybrid's MLP 510
    wide: split over 2 model ranks, gathered whole over 4
    (``split_arch``); the hybrid's window 8 inside the context branch's
    query rows; prefill and 4 decode steps as the reference's."""
    _, want = reference
    got, _ = ranks
    for step in ["prefill"] + [f"decode/{t}" for t in range(STEPS)]:
        key = f"{arch}/{mesh}/{variant}/{step}"
        _close(got[key], want[key], key)


@pytest.mark.parametrize("arch,mesh", [(arch, mesh) for arch in OTHERS
                                       for mesh in MESHES])
def test_gathered_families_match_reference(reference, ranks, arch, mesh):
    """The other GQA families, placed by ``param_specs``: one forward at
    1 × 4 and at 2 × 2."""
    _, want = reference
    got, _ = ranks
    _close(got[f"{arch}/{mesh}/prefill"], want[f"{arch}/{mesh}/prefill"],
           (arch, mesh))


@pytest.mark.parametrize("arch,mesh,variant", RUNS)
def test_placement_is_the_one_process_init(ranks, arch, mesh, variant):
    """On every rank, ``Model.init(mesh=...)`` holds the slices of the
    one-process init bit for bit, ``gather`` of ``place`` is the identity,
    and the split archs moved bytes along ``model`` (the MoE ones in the
    all-to-all, unless it is gated off)."""
    _, records = ranks
    case = "/".join(filter(None, (arch, mesh, variant)))
    a2a = configs.get_config(arch, reduced=True).moe is not None \
        and variant != "portable"
    for rec in records:
        assert rec[case]["init_slices"] and rec[case]["gather_place"], case
        assert rec[case]["model_bytes"] > 0
        assert (rec[case]["a2a_bytes"] > 0) == a2a, case


@pytest.mark.parametrize("arch,mesh,variant", RUNS)
def test_split_route_gathers_no_layer_whole(ranks, arch, mesh, variant):
    """Where ``transformer.split_arch`` holds, no layer of the prefill or
    of the decode steps was all-gathered whole
    (``gather_layer(whole=True)``) on any rank; where it does not (6 MLA
    heads, 10 SSD heads, an MLP 510 wide over 4 ranks) every layer
    was."""
    _, records = ranks
    case = "/".join(filter(None, (arch, mesh, variant)))
    for rec in records:
        if rec[case]["split"]:
            assert rec[case]["whole_layers"] == 0, case
        else:
            assert rec[case]["whole_layers"] > 0, case
    assert records[0][case]["split"] == (variant not in GATHERED_AT_4
                                         or mesh == "2x2")


@pytest.mark.parametrize("mesh", MESHES)
def test_rglru_state_is_whole_on_every_model_rank(ranks, mesh):
    """After the decode steps every rank of a model line holds the same
    RG-LRU states h (all-gathered from the ranks' channels each step, and
    written back whole)."""
    _, records = ranks
    nm = MESHES[mesh]
    case = f"recurrentgemma-9b/{mesh}"
    for row in range(WORLD // nm):
        line = {records[row * nm + m][case]["state_hash"]
                for m in range(nm)}
        assert len(line) == 1, (mesh, row)


@pytest.mark.parametrize("arch,mesh,variant",
                         [run for run in RUNS
                          if run[0] in SPLIT + ("recurrentgemma-9b",)])
def test_dry_run_counts_the_ranks_bytes(ranks, arch, mesh, variant):
    """The meta-device dry run (``launch.dryrun``: each rank of a stand-in
    mesh of the same shape, nothing allocated) of the prefill's forward
    and of one decode step from its caches counts, on every rank, the
    bytes that rank's collectives counted in the spawn, counter by
    counter (along ``model``, the all-to-all, the other lines)."""
    _, records = ranks
    cfg = _config(arch, variant)
    shapes = {"prefill": InputShape("prefill", S, B, "prefill"),
              "decode": InputShape("decode", MAX_LEN, B, "decode")}
    dims = (WORLD // MESHES[mesh], MESHES[mesh])
    case = "/".join(filter(None, (arch, mesh, variant)))
    default = partition.FSDP_THRESHOLD
    partition.FSDP_THRESHOLD = 0 if variant == "fsdp" else default
    try:
        for rank, rec in enumerate(records):
            for step, shape in shapes.items():
                with mesh_lib.stand_in_mesh(dims, rank) as stand_in:
                    got = dryrun.count_collectives(
                        cfg, shape, stand_in, optimized=variant != "portable")
                assert {c: got[f"{c}_bytes"] for c in COUNTERS} == \
                    rec[case]["counted"][step], (rank, step, got)
    finally:
        partition.FSDP_THRESHOLD = default
