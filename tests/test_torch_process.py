"""The paper's agents as separate processes: the process transport.

Four ranks of a ``torch.distributed`` group (gloo, the CPU, a file store)
each host one shard of the port's Parallel ADMM trainer: two of the eight
communities, their own lanes, their own receive plane, nothing else.  They
take one step from the JAX trainer's state after ``WARM`` = 5 steps, in
every mode of tests/test_torch_multishard.py, and are held against:

  * the JAX parallel trainer (one subprocess on four forced host devices,
    tests/test_torch_multishard.py's worker): τ/θ equal, W/Z/U within that
    file's rtol 1e-4 / atol 1e-5;
  * the loopback transport at four shards from the same state: τ/θ equal,
    every tensor within 1e-6 · max |x| (the W gradient is a sum of
    per-shard products across processes, one product over the stacked
    lanes on the loopback);
  * ``comm_stats`` equal to the loopback's, the bytes the ranks sent
    (``sent_bytes``) equal to the plan's wire bytes, and W bit for bit the
    same on every rank.

All modes run in one spawn of four ranks (no JAX in the ranks: they import
this module, which imports none).  Each rank also runs the transport's
rounds on random payloads against the loopback's, bitwise, and records one
step under the op-trace recorder for the linter.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.analysis import trainer as atrainer
from repro_torch.convert import state_from_numpy
from repro_torch.core import gcn, graph, messages
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS, PARTS, WARM = 4, 8, 5
DIMS = (16, 32, 4)
DEEP = (16, 32, 24, 4)
NU = RHO = 1e-3
GROUP_TIMEOUT_S = 60.0          # a collective that never completes fails
JOIN_TIMEOUT_S = 120.0          # ranks still running then are killed
# tests/test_torch_multishard.py's modes (held equal to them below)
MODES = {
    "allgather": ("p2p", dict(transport="allgather", use_kernel=True), DIMS),
    "dense-allgather": ("dense", dict(use_kernel=True), DIMS),
    "dense-einsum": ("dense", dict(use_kernel=False), DIMS),
    "strided": ("p2p", dict(use_kernel=True), DIMS),
    "packed": ("packed", dict(use_kernel=True), DIMS),
    "fused": ("packed", dict(fused=True, use_kernel=True), DIMS),
    "comm-bf16": ("packed", dict(comm_bf16=True, use_kernel=True), DIMS),
    "minibatch": ("minibatch", dict(batch_fraction=0.5, stale_decay=0.7,
                                    use_kernel=True), DIMS),
    "overlap": ("packed", dict(overlap=True, use_kernel=True), DIMS),
    "deep-fused-overlap": ("packed", dict(fused=True, overlap=True,
                                          use_kernel=True), DEEP),
}
# the linter runs on a rank's recorded step in these modes
LINT_MODES = ("allgather", "strided", "packed", "fused", "overlap",
              "minibatch")
# keys only the process trainer's comm_stats carry (measured per step)
MEASURED = ("sent_bytes", "rank_sent_bytes", "transport_s", "staging_s")


def _graph():
    g, _ = graph.synthetic_powerlaw_communities(
        PARTS, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    return g


def _trainer(mode, mesh=None):
    preset, kw, dims = MODES[mode]
    return ParallelADMMTrainer(
        gcn.GCNConfig(dims), ADMMConfig(nu=NU, rho=RHO), _graph(), PARTS,
        seed=0, device="cpu", n_shards=SHARDS, mesh=mesh,
        config=getattr(TrainerConfig, preset)(**kw))


def _state(arrays, prefix):
    def group(name):
        keys = sorted((k for k in arrays if k.startswith(f"{prefix}/{name}/")),
                      key=lambda k: int(k.rsplit("/", 1)[1]))
        return [arrays[k] for k in keys]
    return (group("weights"), group("zs"), arrays[f"{prefix}/u"],
            group("taus"), group("thetas"))


def _leaves(state):
    return state.weights + state.zs + (state.u,) + state.taus + state.thetas


def _stats(cs):
    return json.loads(json.dumps(cs, default=lambda o: o.item(),
                                 sort_keys=True))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _transport_checks(mesh, rng) -> dict:
    """The process transport against the loopback on random payloads, for
    every wire: strided and packed exchanges (f32, bf16, staged) and the
    all-gather — this rank's rows of the loopback's result, bit for bit."""
    tt = _trainer("packed")
    lay = tt.layout
    plan = tt._plan
    k, n = plan.lanes_per_shard, plan.n_pad
    rank = mesh.rank
    pt = messages.ProcessTransport(mesh)
    lt = messages.Loopback(SHARDS)
    lanes = slice(rank * k, (rank + 1) * k)
    out = {}
    x = torch.as_tensor(rng.standard_normal((PARTS, n, 5)),
                        dtype=torch.float32)
    pr, rpr = plan.plane_rows, plan.recv_plane_rows
    planes = torch.as_tensor(tt.packed_layout.pack_state(
        lay.pack(rng.standard_normal((tt.graph.num_nodes, 5)))),
        dtype=torch.float32)
    ptab = pt.tables(plan, torch.device("cpu"))
    ltab = lt.tables(plan, torch.device("cpu"))
    for bf16 in (False, True):
        want = lt.exchange(plan, x, bf16, ltab)[rank]
        got = pt.exchange(plan, x[lanes], bf16, ptab)
        out[f"exchange bf16={bf16}"] = bool(torch.equal(got, want))
        want = lt.exchange_packed(plan, planes, bf16, True, ltab)
        got = pt.exchange_packed(plan, planes[rank * pr:(rank + 1) * pr],
                                 bf16, True, ptab)
        out[f"staged packed bf16={bf16}"] = len(got) == len(want) and all(
            torch.equal(g, w[rank * rpr:(rank + 1) * rpr])
            for g, w in zip(got, want))
        got = pt.exchange_packed(plan, planes[rank * pr:(rank + 1) * pr],
                                 bf16, False, ptab)
        out[f"packed bf16={bf16}"] = bool(torch.equal(
            got, want[-1][rank * rpr:(rank + 1) * rpr]))
        out[f"allgather bf16={bf16}"] = bool(torch.equal(
            pt.allgather(x[lanes], bf16), lt.allgather(x, bf16)))
    # the bf16 wire halves the bytes: one f32 and one bf16 pass of each
    # p2p exchange kind, the all-gather's every row
    out["sent_bytes"] = pt.sent_bytes
    return out


def _lint(tt) -> dict:
    tape, exp = atrainer.record_step(tt)
    report = registry.run_rules(registry.AnalysisContext(
        trace=tape, expectations=exp, config="rank"))
    return {"errors": [f"{f.rule}: {f.message}" for f in report.errors()],
            "exchanges": len(tape.of_kind("exchange", "exchange_packed")),
            "shard_sums": len(tape.of_kind("shard_sum")),
            "hosted_shards": exp.get("hosted_shards")}


def _rank_main(rank, store, spec):
    torch.set_num_threads(1)
    mesh = mesh_lib.init_process_mesh(rank, SHARDS, "gloo", store,
                                      device="cpu", timeout=GROUP_TIMEOUT_S)
    try:
        import torch.distributed as dist
        with np.load(spec["reference"]) as data:
            arrays = {k: data[k] for k in data.files}
        # the same payloads on every rank: each holds its lanes' rows
        meta = {"transport": _transport_checks(
            mesh, np.random.default_rng(0))}
        for mode in spec["modes"]:
            tt = _trainer(mode, mesh)
            for _ in range(WARM if tt._sampler is not None else 0):
                tt.step()
            ages = getattr(tt, "_ages", np.zeros(0, np.int64))
            rec = {"round": tt._round, "ages": ages.tolist()}
            tt.state = state_from_numpy(*_state(arrays, f"{mode}/warm"),
                                        device="cpu", lanes=tt._lanes)
            rec["metrics_warm"] = tt.epoch_metrics()
            tt.step()
            w_bytes = [w.numpy().tobytes() for w in tt.state.weights]
            rec["w_same"] = [w_bytes == other for other in
                             _all_objects(dist, mesh, w_bytes)]
            rec["stats"] = _stats(tt.comm_stats)
            rec["metrics_next"] = tt.epoch_metrics()
            rec["after_round"] = tt._round
            rec["after_ages"] = ages.tolist()
            full = tt.full_state()
            if mode in spec["lint"]:
                rec["lint"] = _lint(tt)
            if rank == 0:
                np.savez(os.path.join(spec["out"], f"{mode}.npz"),
                         *[t.numpy() for t in _leaves(full)])
            meta[mode] = rec
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(meta, f)
    finally:
        mesh_lib.destroy(mesh)


def _all_objects(dist, mesh, obj):
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _raise_on_rank_1(rank, store):
    mesh = mesh_lib.init_process_mesh(rank, 2, "gloo", store, device="cpu",
                                      timeout=GROUP_TIMEOUT_S)
    try:
        if rank == 1:
            raise RuntimeError("rank 1 fails")
    finally:
        mesh_lib.destroy(mesh)


def _hang(rank, store):
    time.sleep(3600)


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every mode's JAX run at four shards, from one subprocess."""
    from test_torch_multishard import _WORKER
    from test_torch_multishard import MODES as MULTISHARD_MODES
    assert MODES == MULTISHARD_MODES
    path = tmp_path_factory.mktemp("process") / "reference.npz"
    spec = {"shards": SHARDS, "parts": PARTS, "nu": NU, "rho": RHO,
            "warm": WARM, "modes": MODES,
            "peak_flops": messages.PEAK_FLOPS, "link_bw": messages.LINK_BW}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(path),
                           json.dumps(spec)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0 and "WORKER_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return path, arrays, json.loads(str(arrays.pop("meta")))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Four gloo ranks, every mode: rank 0's gathered states and every
    rank's record."""
    path, _, _ = reference
    out = tmp_path_factory.mktemp("ranks")
    spec = {"reference": str(path), "out": str(out), "modes": list(MODES),
            "lint": list(LINT_MODES)}
    mesh_lib.run_ranks(_rank_main, SHARDS, (spec,), timeout=JOIN_TIMEOUT_S)
    metas = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(SHARDS)]
    states = {}
    for mode in MODES:
        with np.load(out / f"{mode}.npz") as data:
            states[mode] = [data[f"arr_{i}"] for i in range(len(data.files))]
    return states, metas


@pytest.fixture(scope="module")
def loopback(reference):
    """mode -> (the loopback trainer at four shards after its step from
    the reference's warm state, its next state)."""
    _, arrays, _ = reference
    cache = {}

    def get(mode):
        if mode not in cache:
            tt = _trainer(mode)
            for _ in range(WARM if tt._sampler is not None else 0):
                tt.step()
            tt.state = state_from_numpy(*_state(arrays, f"{mode}/warm"),
                                        device="cpu")
            tt.step()
            cache[mode] = (tt, [t.numpy() for t in _leaves(tt.state)])
        return cache[mode]
    return get


def _split(leaves, dims):
    n = len(dims) - 1
    return (leaves[:n], leaves[n:2 * n], leaves[2 * n], leaves[2 * n + 1:
                                                              3 * n + 1],
            leaves[3 * n + 1:])


@pytest.mark.parametrize("mode", list(MODES))
def test_process_step_matches_reference(reference, ranks, mode):
    """One step of four processes from the JAX state after 5 steps: τ and
    θ equal to the JAX parallel trainer's, W/Z/U within rtol 1e-4 / atol
    1e-5, the metrics and Lagrangian within 1e-5 relative."""
    _, arrays, meta = reference
    states, metas = ranks
    ws, zs, u, taus, thetas = _split(states[mode], MODES[mode][2])
    want = _state(arrays, f"{mode}/next")
    assert [float(t) for t in taus] == [float(t) for t in want[3]]
    for a, b in zip(want[4], thetas):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(want[0] + want[1] + [want[2]], ws + zs + [u]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    got = metas[0][mode]
    for key, ref_key in (("metrics_warm", "warm_metrics"),
                         ("metrics_next", "next_metrics")):
        tr, te, lag, res = got[key]
        for a, b in zip(meta[mode][ref_key], (tr, te, res, lag)):
            assert abs(a - b) <= 1e-5 * max(abs(a), abs(b), 1e-30), \
                (mode, key, a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_process_step_matches_loopback(ranks, loopback, mode):
    """The same step on the loopback transport: τ and θ equal, every
    tensor within 1e-6 · max |x|; the metrics every rank reports are rank
    0's."""
    states, metas = ranks
    tt, want = loopback(mode)
    n = len(MODES[mode][2]) - 1
    for i, (a, b) in enumerate(zip(want, states[mode])):
        assert a.shape == b.shape, i
        if i >= 2 * n + 1:                       # τ and θ
            np.testing.assert_array_equal(b, a)
        else:
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= 1e-6 * scale, (mode, i)
    assert all(m[mode]["metrics_next"] == metas[0][mode]["metrics_next"]
               for m in metas)


@pytest.mark.parametrize("mode", list(MODES))
def test_process_comm_stats_and_sent_bytes(ranks, loopback, mode):
    """``comm_stats`` equal to the loopback's after the step, key for key,
    on every rank; the bytes the ranks sent in the step equal the wire of
    the plan it ran (under minibatching the sampled batch's restricted
    plan); the all-gather moves each rank's k lanes to every rank, S · M
    payload blocks where the reference prices M² (equal at k = 1)."""
    _, metas = ranks
    tt, _ = loopback(mode)
    want = _stats(tt.comm_stats)
    for rank_meta in metas:
        got = dict(rank_meta[mode]["stats"])
        measured = {k: got.pop(k) for k in MEASURED}
        assert got == want
        assert measured["rank_sent_bytes"] == \
            metas[0][mode]["stats"]["rank_sent_bytes"]
    sent = metas[0][mode]["stats"]["sent_bytes"]
    assert sent == sum(metas[0][mode]["stats"]["rank_sent_bytes"])
    cs = tt.comm_stats
    if cs["transport"] == "allgather":
        assert sent * PARTS == cs["full_bytes"] * SHARDS
    elif cs["minibatch"]["enabled"]:
        from repro_torch.core.parallel import gathered_widths
        wire = messages.exchange_bytes(tt._active_plan,
                                       gathered_widths(tt.cfg))
        assert sent == wire["wire_bytes"] < cs["wire_bytes"]
    else:
        assert sent == cs["wire_bytes"] > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_w_bitwise_identical_on_every_rank(ranks, mode):
    """The W psum sums every rank's part in rank order, so every rank holds
    the same bits (and took the same τ decisions)."""
    _, metas = ranks
    for rank_meta in metas:
        assert rank_meta[mode]["w_same"] == [True] * SHARDS


def test_minibatch_cycle_matches_loopback(ranks, loopback):
    """Every rank draws the loopback's shard batches: the same round and
    staleness ages before and after the step."""
    _, metas = ranks
    tt = _trainer("minibatch")
    for _ in range(WARM):
        tt.step()
    before = (tt._round, tt._ages.tolist())
    after_tt, _ = loopback("minibatch")
    for rank_meta in metas:
        rec = rank_meta["minibatch"]
        assert (rec["round"], rec["ages"]) == before
        assert rec["after_round"] == after_tt._round
        assert rec["after_ages"] == after_tt._ages.tolist()


def test_transport_rounds_are_the_loopback_rounds_bitwise(ranks):
    """Random payloads through every wire of the process transport (the
    strided and packed exchanges, staged and not, f32 and bf16, and the
    all-gather) equal each rank's rows of the loopback's result bit for
    bit; the bf16 wire is ``bf16_wire``'s bits."""
    _, metas = ranks
    for rank, rank_meta in enumerate(metas):
        checks = rank_meta["transport"]
        sent = checks.pop("sent_bytes")
        assert checks and all(checks.values()), (rank, checks)
        assert sent > 0


@pytest.mark.parametrize("mode", LINT_MODES)
def test_linter_finds_no_error_on_a_rank(ranks, mode):
    """One rank's recorded step (rank 0 and every other) under the
    existing rules: no error finding; the rank records its own rounds and
    its psums, and its bounds are one shard's."""
    _, metas = ranks
    for rank_meta in metas:
        lint = rank_meta[mode]["lint"]
        assert lint["errors"] == [], (mode, lint)
        assert lint["hosted_shards"] == 1
        assert lint["shard_sums"] > 0
        if MODES[mode][1].get("transport") != "allgather":
            assert lint["exchanges"] > 0


def test_process_tables_are_the_loopback_tables_shard_by_shard():
    """``process_tables`` holds each shard's rows of ``loopback_tables``,
    unshifted: own copies, and per round the rows it sends and where the
    rows it receives land (the strided and the packed plane tables)."""
    tt = _trainer("packed")
    plan = tt._plan
    k, n = plan.lanes_per_shard, plan.n_pad
    limit, pr, rpr = plan.r_pad * n, plan.plane_rows, plan.recv_plane_rows
    lt = messages.loopback_tables(plan, torch.device("cpu"))
    for s in range(SHARDS):
        pt = messages.process_tables(plan, s, torch.device("cpu"))
        assert torch.equal(pt["own_dst"] + s * (limit + 1),
                           lt["own_dst"][s])
        live = lt["own_plane_dst"] // rpr == s
        assert torch.equal(pt["own_plane_dst"] + s * rpr,
                           lt["own_plane_dst"][live])
        assert torch.equal(pt["own_plane_src"], lt["own_plane_src"][live]
                           - s * pr)
        for key, rows_src, rows_dst in (("rounds", k * n, limit + 1),
                                        ("plane_rounds", pr, rpr)):
            seen = set()
            for ri, pairs, rows_pad, dst, send, src, recv in pt[key]:
                seen.add(ri)
                lsend, lrecv = lt[key][ri]
                srcs = [p[0] for p in plan.rounds[ri].pairs]
                dsts = [p[1] for p in plan.rounds[ri].pairs]
                assert pairs == plan.rounds[ri].pairs
                assert rows_pad == plan.rounds[ri].rows_pad
                if dst is not None:
                    assert (s, dst) in pairs
                    assert torch.equal(send + s * rows_src,
                                       lsend[srcs.index(s)])
                if src is not None:
                    assert (src, s) in pairs
                    want = lrecv[dsts.index(s)]
                    if key == "plane_rounds":
                        got = torch.where(recv < rpr, recv + s * rpr,
                                          SHARDS * rpr)
                    else:
                        got = recv + s * rows_dst
                    assert torch.equal(got, want)
            assert seen == {ri for ri, r in enumerate(plan.rounds)
                            if any(s in p for p in r.pairs)}


def test_shard_state_of_a_shared_state():
    """``state_from_numpy(lanes=...)`` is a rank's part of a shared state:
    the M / k parts end to end are the state again (packed and strided)."""
    for mode in ("packed", "strided"):
        tt = _trainer(mode)
        leaves = [t.numpy() for t in _leaves(tt.state)]
        n = len(DIMS) - 1
        st = (leaves[:n], leaves[n:2 * n], leaves[2 * n],
              leaves[2 * n + 1:3 * n + 1], leaves[3 * n + 1:])
        k = PARTS // SHARDS
        parts = [state_from_numpy(*st, device="cpu",
                                  lanes=slice(s * k, (s + 1) * k))
                 for s in range(SHARDS)]
        for i, whole in enumerate(leaves):
            if n <= i < 2 * n + 1 or i >= 3 * n + 1:       # Z, U, θ
                joined = np.concatenate([_leaves(p)[i].numpy()
                                         for p in parts])
            else:
                joined = _leaves(parts[1])[i].numpy()
            np.testing.assert_array_equal(joined, whole)


def test_launcher_trains_on_4_processes(capfd):
    """``--processes 4 --backend gloo`` through the CLI: rank 0's log,
    the ``processes 4 (gloo)`` line, and the bytes sent in the last step
    equal to the plan's wire."""
    from repro_torch.launch import train_gcn
    log = train_gcn.main(["--dataset", "amazon_photo_mini", "--parts", "4",
                          "--processes", "4", "--backend", "gloo",
                          "--hidden", "16", "--epochs", "2", "--compressed",
                          "--packed", "--use-kernel", "--partitioner",
                          "bfs_kl", "--device", "cpu"])
    assert len(log["epoch"]) == 2
    assert all(np.isfinite(log[key]).all() for key in
               ("lagrangian", "residual", "train_acc", "test_acc"))
    out = capfd.readouterr().out
    assert "shards: 4 [p2p]; processes 4 (gloo)" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("processes: sent"))
    sent = line.split("sent ")[1].split(" MB")[0]
    wire = line.split("the plan's wire ")[1].split(" MB")[0]
    assert sent == wire


def test_launcher_refuses_nccl_without_a_card_per_rank():
    """NCCL never runs on the CPU, nor with more ranks than cards: the
    launcher raises and names gloo, before it starts a rank."""
    from repro_torch.launch import train_gcn
    with pytest.raises(ValueError, match="--backend gloo"):
        train_gcn.main(["--parts", "4", "--processes", "4", "--backend",
                        "nccl", "--compressed", "--packed", "--device",
                        "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="--backend gloo"):
            mesh_lib.check_backend("nccl", 2, None)


def test_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    from repro_torch.util.device import rank_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(0)
    assert rank_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="timeout"):
        mesh_lib.init_process_mesh(0, 1, "gloo", "unused", device="cpu",
                                   timeout=600)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_lib.run_ranks(_raise_on_rank_1, 2, timeout=JOIN_TIMEOUT_S)


def test_a_hung_rank_is_killed_and_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh_lib.run_ranks(_hang, 2, timeout=3.0)
    assert time.monotonic() - t0 < 60.0
