"""Data-parallel ``Model.train_step_deferred`` over a ``data`` × ``model``
mesh of processes, against the JAX package's on the same mesh.

One JAX subprocess on four forced host devices runs the reference's
``train_step_deferred`` (``shard_map`` over the data axes, one psum after
the microbatches) for each case: gemma-2b, qwen2-7b and deepseek-moe-16b
at their reduced configurations (f32), ``grad_accum`` 1 and 2, on the
2 × 2 and 4 × 1 meshes of ``make_host_mesh``, from the reference's
initial parameters under SGD at learning rate 1 (so the new parameters
carry the gradient, as in tests/test_torch_train_step.py).  It writes the
initial parameters, the global batch and every case's new parameters and
metrics to an .npz.

One spawn of four gloo ranks (no JAX in the ranks: they import this
module, which imports none) takes every case from those parameters, each
rank its rows of the batch (``launch.mesh.batch_rows``).  Held:

  * per leaf, the new parameters within 1e-5 · max |delta| of the
    reference's, beside one f32 spacing of the new value (the test of
    tests/test_torch_train_step.py); loss and metrics within 1e-5
    relative;
  * the new parameters bit for bit the same on every rank (the buckets'
    all-gather summed in rank order, broadcast along ``model``).
"""
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
from repro_torch.core.messages import MeshCollectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.build import make_model
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"2x2": 2, "4x1": 1}          # name -> model axis
ARCHS = ("gemma-2b", "qwen2-7b", "deepseek-moe-16b")
ACCUMS = (1, 2)
B, S = 8, 16
TOL = 1e-5
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0
CASES = [(arch, accum, mesh) for arch in ARCHS for accum in ACCUMS
         for mesh in MESHES]

_WORKER = r"""
import dataclasses, functools, json, sys
import jax
import numpy as np
from repro import configs
from repro.launch.mesh import make_host_mesh
from repro.models.build import make_model

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()
arrays = {}
for arch in spec["archs"]:
    base = configs.get_config(arch, reduced=True)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, base.vocab_size, (spec["b"], spec["s"]))
             .astype(np.int32) for k in ("tokens", "targets")}
    arrays.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
    for accum in spec["accums"]:
        cfg = dataclasses.replace(base, optimizer="sgd", learning_rate=1.0,
                                  grad_accum=accum)
        model = make_model(cfg)
        params = model.init(jax.random.key(0))
        for i, leaf in enumerate(jax.tree.leaves(params)):
            arrays[f"{arch}/init/{i}"] = np.asarray(leaf)
        for name, model_axis in spec["meshes"].items():
            mesh = make_host_mesh(model_axis)
            with mesh:
                new, _, mets = jax.jit(functools.partial(
                    model.train_step_deferred, mesh))(params, (), batch)
            case = f"{arch}/{accum}/{name}"
            for i, leaf in enumerate(jax.tree.leaves(new)):
                arrays[f"{case}/new/{i}"] = np.asarray(leaf)
            for k, v in mets.items():
                arrays[f"{case}/metric/{k}"] = np.asarray(v)
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


def _group(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _model(arch, accum):
    import dataclasses
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              optimizer="sgd", learning_rate=1.0,
                              grad_accum=accum)
    return make_model(cfg)


def _params(model, leaves):
    """The reference's parameters in the port's tree (the same leaf
    order: sorted keys)."""
    like = model.init(0, "cpu")
    return tree.unflatten(like, [torch.from_numpy(np.array(a))
                                 for a in leaves])


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    base = mesh_lib.init_process_mesh(rank, WORLD, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        meshes = {name: mesh_lib.make_rank_mesh(base, m)
                  for name, m in MESHES.items()}
        with np.load(spec["reference"]) as data:
            arrays = {k: data[k] for k in data.files}
        out, record = {}, {}
        for arch, accum, name in CASES:
            mesh = meshes[name]
            model = _model(arch, accum)
            params = _params(model, _group(arrays, f"{arch}/init"))
            rows = mesh_lib.batch_rows(mesh, B)
            batch = {k: arrays[f"{arch}/batch/{k}"][rows]
                     for k in ("tokens", "targets")}
            comm = MeshCollectives(mesh)
            new, _, mets = model.train_step_deferred(mesh, params, (), batch,
                                                     comm=comm)
            case = f"{arch}/{accum}/{name}"
            h = hashlib.sha256()
            for i, leaf in enumerate(tree.leaves(new)):
                h.update(leaf.numpy().tobytes())
                out[f"{case}/new/{i}"] = leaf.numpy()
            record[case] = {"hash": h.hexdigest(),
                            "metrics": {k: float(v) for k, v in mets.items()},
                            "rows": [rows.start, rows.stop],
                            "sum_bytes": comm.sum_bytes}
        # the pipeline places this rank's rows of each global batch
        from repro_torch.data import TokenPipeline, synthetic_token_batches
        placed = []
        for name, mesh in meshes.items():
            pipe = TokenPipeline(synthetic_token_batches(512, B, S, seed=4),
                                 device="cpu", mesh=mesh)
            whole = synthetic_token_batches(512, B, S, seed=4)
            rows = mesh_lib.batch_rows(mesh, B)
            for _ in range(3):
                got, want = next(pipe), next(whole)
                placed.append(all(
                    np.array_equal(got[k].numpy(), want[k][rows])
                    for k in want) and got["tokens"].shape[0] == B
                    // mesh.shape["data"])
        record["pipeline"] = placed
        if rank == 0:
            np.savez(os.path.join(spec["out"], "ranks.npz"), **out)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        mesh_lib.destroy(base)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_train") / "reference.npz"
    spec = {"archs": ARCHS, "accums": ACCUMS, "meshes": MESHES, "b": B,
            "s": S}
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
    out = tmp_path_factory.mktemp("mesh_train_ranks")
    mesh_lib.run_ranks(_rank_main, WORLD,
                       ({"reference": str(path), "out": str(out)},),
                       timeout=JOIN_TIMEOUT_S)
    with np.load(out / "ranks.npz") as data:
        states = {k: data[k] for k in data.files}
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return states, records


@pytest.mark.parametrize("arch,accum,mesh", CASES)
def test_deferred_step_over_ranks_matches_reference(reference, ranks, arch,
                                                    accum, mesh):
    _, arrays = reference
    states, records = ranks
    case = f"{arch}/{accum}/{mesh}"
    init = _group(arrays, f"{arch}/init")
    want = _group(arrays, f"{case}/new")
    got = _group(states, f"{case}/new")
    assert len(got) == len(want) == len(init)
    for i, (p0, w, g) in enumerate(zip(init, want, got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape
        scale = float(np.abs(w - np.asarray(p0, np.float64)).max())
        slack = np.spacing(np.abs(w).astype(np.float32))
        over = float((np.abs(g - w) - slack).max())
        assert over <= TOL * scale, (case, i, over, scale)
    mets = records[0][case]["metrics"]
    ref = {k.rsplit("/", 1)[1]: float(v) for k, v in arrays.items()
           if k.startswith(f"{case}/metric/")}
    assert set(mets) == set(ref)
    for k, w in ref.items():
        assert abs(mets[k] - w) <= TOL * abs(w), (case, k, mets[k], w)


@pytest.mark.parametrize("arch,accum,mesh", CASES)
def test_every_rank_holds_the_same_parameter_bits(ranks, arch, accum, mesh):
    """Each rank summed its microbatches over its own rows (the data ranks'
    rows cover the batch once) and ends with the same bits and metrics;
    ``TokenPipeline(mesh=...)`` gives each rank its rows of every global
    batch."""
    _, records = ranks
    case = f"{arch}/{accum}/{mesh}"
    recs = [r[case] for r in records]
    assert all(r["pipeline"] == [True] * 6 for r in records)
    assert len({r["hash"] for r in recs}) == 1
    assert all(r["metrics"] == recs[0]["metrics"] for r in recs)
    n_dp = WORLD // MESHES[mesh]
    assert sorted({tuple(r["rows"]) for r in recs}) == [
        (d * B // n_dp, (d + 1) * B // n_dp) for d in range(n_dp)]
    assert all(r["sum_bytes"] == recs[0]["sum_bytes"] > 0 for r in recs)


def test_launcher_trains_over_two_gloo_ranks():
    """``launch.train --processes 2 --backend gloo --device cpu``: two data
    ranks, each placing its rows of every pipeline batch, step with
    train_step_deferred; the losses rank 0 reports are the one-process
    launcher's within 1e-5 relative (the same global batches, the gradient
    summed over the ranks in another order)."""
    from repro_torch.launch import train as train_launcher
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps",
            "3", "--batch", "4", "--seq", "32"]
    ranks = train_launcher.main(argv + ["--processes", "2", "--backend",
                                        "gloo"])
    one = train_launcher.main(argv)
    assert ranks["mesh"] == {"data": 2, "model": 1}
    assert ranks["sum_bytes"] > 0
    for a, b in zip(ranks["losses"], one["losses"]):
        assert abs(a - b) <= TOL * abs(b), (a, b)
    with pytest.raises(ValueError, match="gloo"):
        train_launcher.main(argv + ["--processes", "2", "--backend",
                                    "nccl"])
