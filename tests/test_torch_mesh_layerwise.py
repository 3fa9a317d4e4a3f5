"""The paper's layerwise ADMM over a ``data`` × ``model`` mesh of
processes (``LayerwiseADMMTrainer(mesh=...)``: blocks over ``model``,
batch rows over ``data``), against the JAX package's.

One JAX subprocess on four forced host devices runs the reference's
trainer on the same mesh (``make_host_mesh``: its ``_constraint_spec``
places Z's blocks over ``model`` and rows over ``data``) for each case and
writes its state after n iterations and after one more, and that state's
metrics.  The cases: gemma-2b (n = 2) and qwen2-7b (n = 5) reduced on
2 × 2; gemma-2b reduced to 4 layers on 1 × 4 (n = 3), so that the middle
ranks have a neighbour on each side; and deepseek-moe-16b (n = 4) on 2 × 2,
where its dense block and its MoE block sit on different model ranks
(the segment boundary between them) — the reference cannot place that
config on a mesh (``_shard_z`` asks for a one-block segment over two model
devices and jit refuses the uneven sharding), so that case's reference
runs on one device, which computes the same function.  The depths are
tests/test_torch_layerwise*.py's, chosen so that no line search of the
compared iteration sits on a tie; for the 4-layer config some search of
the iteration after 0, 1, 2, 4 or 6 iterations flips between the two
packages at one process already, after 3 or 5 none does.

One spawn of four gloo ranks (no JAX in the ranks) takes each case's
reference state after n iterations, keeps its part (``shard_state``) and
runs one iteration and the metrics.  Held: every τ, θ and τ_R equal; each
rank's stack, Z, readout and U within 1e-4 · max of the reference leaf;
the composed CE and residual within 1e-5 relative, the same on every
rank; every block's W bit for bit the same on the data ranks that hold it
(the W gradient and each probe summed over ``data`` in rank order); and
``init``'s pipelined forward against the one-process ``init``'s within
1e-5 · max.
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

from repro_torch.configs import get_config
from repro_torch.core import layerwise
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
NU = RHO = 1e-2
B, S = 4, 32
STATE_TOL = 1e-4
METRIC_TOL = 1e-5
INIT_TOL = 1e-5
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0
# name -> (arch, layers, model axis, iterations before, reference on mesh)
CASES = {
    "gemma-2b 2x2": ("gemma-2b", 2, 2, 2, True),
    "qwen2-7b 2x2": ("qwen2-7b", 2, 2, 5, True),
    "gemma-2b-4-layers 1x4": ("gemma-2b", 4, 4, 3, True),
    "deepseek-moe-16b 2x2": ("deepseek-moe-16b", 2, 2, 4, False),
}

_WORKER = r"""
import dataclasses, json, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.core import layerwise
from repro.core.subproblems import ADMMConfig
from repro.launch.mesh import make_host_mesh

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4, jax.devices()
arrays = {}
for name, (arch, layers, model_axis, n, on_mesh) in spec["cases"].items():
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              num_layers=layers)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (spec["b"], spec["s"]))
             .astype(np.int32) for k in ("tokens", "targets")}
    mesh = make_host_mesh(model_axis) if on_mesh else None
    tr = layerwise.LayerwiseADMMTrainer(
        cfg, ADMMConfig(nu=spec["nu"], rho=spec["rho"]), mesh=mesh)
    targets = jnp.asarray(batch["targets"])
    st, z0 = tr.init(jax.random.key(0),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    it = jax.jit(lambda s: tr.iteration(s, z0, targets))
    for _ in range(n):
        st = it(st)
    nxt = it(st)
    for tag, state in (("before", st), ("after", nxt)):
        for i, leaf in enumerate(jax.tree.leaves(state)):
            arrays[f"{name}/{tag}/{i}"] = np.asarray(leaf)
    arrays[f"{name}/z0"] = np.asarray(z0)
    arrays[f"{name}/metrics"] = np.asarray(
        [float(v) for v in tr.metrics(nxt, z0, targets)])
    arrays.update({f"{name}/batch/{k}": v for k, v in batch.items()})
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


def _group(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _cfg(arch, layers):
    return dataclasses.replace(get_config(arch, reduced=True),
                               num_layers=layers)


def _one_process(arch, layers, batch):
    """The one-process trainer and its initial state (the tree every
    state of this config has)."""
    tr = layerwise.LayerwiseADMMTrainer(_cfg(arch, layers),
                                        ADMMConfig(nu=NU, rho=RHO))
    st, z0 = tr.init(0, batch, "cpu")
    return tr, st, z0


def _parts(tr, state) -> dict:
    """This rank's part of a state, keyed by where it sits in the whole:
    ``stack/kind/i`` (blocks lo:hi), ``zs/kind`` (blocks lo:hi, rows),
    ``taus/kind``, ``thetas/kind``; on the last model rank ``readout/i``,
    ``u`` (rows) and ``tau_r``."""
    out = {}
    for seg, _, _, _ in tr.local:
        k = seg.kind
        for i, leaf in enumerate(tree.leaves(state.stack[k])):
            out[f"stack/{k}/{i}"] = leaf.numpy()
        out[f"zs/{k}"] = state.zs[k].numpy()
        out[f"taus/{k}"] = state.taus[k].numpy()
        out[f"thetas/{k}"] = state.thetas[k].numpy()
    if state.readout is not None:
        for i, leaf in enumerate(tree.leaves(state.readout)):
            out[f"readout/{i}"] = leaf.numpy()
        out["u"] = state.u.numpy()
        out["tau_r"] = state.tau_r.numpy()
    return out


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    base = mesh_lib.init_process_mesh(rank, WORLD, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        meshes = {m: mesh_lib.make_rank_mesh(base, m) for m in (2, 4)}
        with np.load(spec["reference"]) as data:
            arrays = {k: data[k] for k in data.files}
        out, record = {}, {}
        for name, (arch, layers, model_axis, _, _) in CASES.items():
            batch = {k: arrays[f"{name}/batch/{k}"]
                     for k in ("tokens", "targets")}
            one, like, z0_one = _one_process(arch, layers, batch)
            st = tree.unflatten(like, [
                torch.from_numpy(np.array(a))
                for a in _group(arrays, f"{name}/before")])
            z0 = torch.from_numpy(arrays[f"{name}/z0"])
            tr = layerwise.LayerwiseADMMTrainer(
                _cfg(arch, layers), ADMMConfig(nu=NU, rho=RHO),
                mesh=meshes[model_axis])
            local, lz0 = tr.shard_state(st, z0)
            nxt = tr.iteration(local, lz0, batch["targets"])
            ce, res = tr.metrics(nxt, lz0, batch["targets"])
            for key, arr in _parts(tr, nxt).items():
                out[f"{name}/{key}"] = arr
            # init's pipelined forward against the one-process init
            ist, iz0 = tr.init(0, batch)
            init_gap = max(
                float((ist.zs[s.kind] - like_z[lo:hi, tr._rows]).abs().max()
                      / like_z.abs().max())
                for s, lo, hi, _ in tr.local
                for like_z in (like.zs[s.kind],))
            init_gap = max(init_gap, float(
                (iz0 - z0_one[tr._rows]).abs().max()))
            w_hash = {}
            for s, lo, hi, _ in tr.local:
                for b in range(hi - lo):
                    h = hashlib.sha256()
                    for leaf in tree.leaves(nxt.stack[s.kind]):
                        h.update(leaf[b].numpy().tobytes())
                    w_hash[f"{s.kind}/{lo + b}"] = h.hexdigest()
            record[name] = {
                "local": [[s.kind, lo, hi] for s, lo, hi, _ in tr.local],
                "rows": [tr._rows.start, tr._rows.stop],
                "last": tr._last, "metrics": [float(ce), float(res)],
                "init_gap": init_gap, "w_hash": w_hash,
                "sum_bytes": tr.comm.sum_bytes,
                "sent_bytes": tr.comm.sent_bytes}
        np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        mesh_lib.destroy(base)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_layerwise") / "reference.npz"
    spec = {"cases": CASES, "b": B, "s": S, "nu": NU, "rho": RHO}
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
    out = tmp_path_factory.mktemp("mesh_layerwise_ranks")
    mesh_lib.run_ranks(_rank_main, WORLD,
                       ({"reference": str(path), "out": str(out)},),
                       timeout=JOIN_TIMEOUT_S)
    parts = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as data:
            parts.append({k: data[k] for k in data.files})
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return parts, records


def _want(arrays, name):
    """The reference's next state as the port's tree of numpy arrays."""
    arch, layers = CASES[name][:2]
    batch = {k: arrays[f"{name}/batch/{k}"] for k in ("tokens", "targets")}
    _, like, _ = _one_process(arch, layers, batch)
    return tree.unflatten(like, [np.asarray(a) for a in
                                 _group(arrays, f"{name}/after")])


def _close(got, want, scale_of):
    scale = float(np.abs(scale_of).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= STATE_TOL * scale, \
        (float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("name", list(CASES))
def test_iteration_over_ranks_matches_reference(reference, ranks, name):
    _, arrays = reference
    parts, records = ranks
    want = _want(arrays, name)
    seen = set()
    for part, rec in zip(parts, records):
        rec = rec[name]
        r0, r1 = rec["rows"]
        for kind, lo, hi in rec["local"]:
            seen.update((kind, b) for b in range(lo, hi))
            np.testing.assert_array_equal(part[f"{name}/taus/{kind}"],
                                          want.taus[kind][lo:hi])
            np.testing.assert_array_equal(part[f"{name}/thetas/{kind}"],
                                          want.thetas[kind][lo:hi])
            for i, w in enumerate(tree.leaves(want.stack[kind])):
                _close(part[f"{name}/stack/{kind}/{i}"], w[lo:hi], w)
            w = want.zs[kind]
            _close(part[f"{name}/zs/{kind}"], w[lo:hi, r0:r1], w)
        if rec["last"]:
            np.testing.assert_array_equal(part[f"{name}/tau_r"], want.tau_r)
            for i, w in enumerate(tree.leaves(want.readout)):
                _close(part[f"{name}/readout/{i}"], w, w)
            _close(part[f"{name}/u"], want.u[r0:r1], want.u)
    # the ranks' blocks cover the network
    assert seen == {(k, b) for k, z in want.zs.items()
                    for b in range(z.shape[0])}


@pytest.mark.parametrize("name", list(CASES))
def test_metrics_over_ranks_match_reference(reference, ranks, name):
    """The composed network's CE and residual, pipelined along ``model``
    and summed over ``data``: within 1e-5 of the reference's, and the same
    on every rank."""
    _, arrays = reference
    _, records = ranks
    want = arrays[f"{name}/metrics"]
    got = [r[name]["metrics"] for r in records]
    assert all(g == got[0] for g in got)
    for g, w in zip(got[0], want):
        assert abs(g - float(w)) <= METRIC_TOL * abs(float(w)), (g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_data_ranks_hold_the_same_w_and_init_matches(ranks, name):
    """Every block's new W has the same bits on each data rank that holds
    it; the mesh's pipelined ``init`` gives the one-process Z and Z_0
    within 1e-5 · max; the model ranks' blocks are the near-equal
    contiguous ranges; the ranks summed and sent something."""
    _, records = ranks
    recs = [r[name] for r in records]
    by_block: dict = {}
    for rec in recs:
        for block, h in rec["w_hash"].items():
            by_block.setdefault(block, set()).add(h)
        assert rec["init_gap"] <= INIT_TOL, rec["init_gap"]
    assert all(len(h) == 1 for h in by_block.values()), by_block
    arch, layers, model_axis = CASES[name][:3]
    n_blocks = sum(z.count for z in layerwise.LayerwiseADMMTrainer(
        _cfg(arch, layers), ADMMConfig()).segments)
    sizes = sorted({sum(hi - lo for _, lo, hi in rec["local"])
                    for rec in recs})
    assert sizes == sorted({n_blocks // model_axis,
                            -(-n_blocks // model_axis)})
    n_dp = WORLD // model_axis
    assert all(rec["sum_bytes"] > 0 for rec in recs) or n_dp == 1
    assert all(rec["sent_bytes"] > 0 for rec in recs) or model_axis == 1


def test_train_admm_over_four_gloo_ranks():
    """``launch.train_admm --processes 4 --model-axis 2`` on the two-segment
    MoE stack: rank 0's composed CE after each logged iteration within
    1e-5 of the one-process run's, and the Adam comparison equal."""
    from repro_torch.launch import train_admm
    argv = ["--arch", "deepseek-moe-16b", "--iters", "3", "--device", "cpu"]
    ranks = train_admm.main(argv + ["--processes", "4", "--model-axis", "2",
                                    "--backend", "gloo"])
    one = train_admm.main(argv)
    assert len(ranks["admm_ce"]) == len(one["admm_ce"]) == 2
    for a, b in zip(ranks["admm_ce"], one["admm_ce"]):
        assert abs(a - b) <= METRIC_TOL * abs(b), (a, b)
    assert ranks["adam_ce"] == one["adam_ce"]
    assert ranks["sum_bytes"] > 0 and ranks["sent_bytes"] > 0
