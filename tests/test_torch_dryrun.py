"""The meta-device dry run (``launch/dryrun.py``): one rank's step of an
arch × input shape on a mesh of ranks that do not exist, counted without
allocating anything.

  * meta equals real: for every architecture (reduced) and each of train,
    prefill and decode on a 1 × 1 mesh (B = 2, 16 text positions), the
    meta run's FLOPs (``FlopCounterMode`` and the trace's census) and its
    argument, output and peak bytes equal the same counters over the same
    step on real CPU tensors;
  * against the reference: one JAX subprocess on four forced host devices
    compiles the reference's placed steps at 2 × 2 (its ``build_lowered``,
    on the reduced configs and small shapes) for gemma-2b and
    deepseek-moe-16b, train, prefill and decode.  XLA's per-device
    ``argument_size_in_bytes`` (equal to Σ ``shard_shape`` bytes on this
    backend) is the port's ``argument_bytes`` for train and decode; for
    prefill the port holds the global batch on every rank and XLA drops
    the unused targets, so the parameters are held there.  ``params``,
    ``active_params``, ``model_flops`` and ``analytic_hbm_bytes`` equal
    the reference's functions;
  * production: gemma-2b ``train_4k`` on 16 × 16 and deepseek-v3-671b
    ``decode_32k`` on 2 × 16 × 16 through ``run_one``: the JSON's keys,
    and ``argument_bytes`` equal to Σ ``local_shape`` × itemsize;
  * ``long_500k`` decode (one sequence over 16 or 32 data ranks): the
    specs a decode step derives from a rank's cache shapes are the ones
    its caches were placed by, for every arch;
  * split compute: on a 1 × 4 stand-in mesh a rank's FLOPs of the reduced
    train, prefill and decode steps of mamba2-1.3b and deepseek-v3-671b
    are at most half of one process's (the SSD mixer and MLA run on the
    rank's heads, not whole on every rank);
  * refusals: a stand-in mesh in a process already in a group, and
    training batches that do not divide.

The bytes along each axis are held against gloo ranks in the spawns of
tests/test_torch_tp_train.py (training) and tests/test_torch_mesh_forward.py
(prefill and decode).
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch import configs
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.build import _param_shapes, make_model
from repro_torch.sharding import partition
from repro_torch.util import tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = ("train", "prefill", "decode")
REF_ARCHS = ("gemma-2b", "deepseek-moe-16b")
REF_B, REF_S = 8, 16
KEYS = {"arch", "shape", "mesh", "chips", "rank", "step", "notes",
        "lower_s", "compile_s", "params", "active_params", "memory", "cost",
        "census", "analytic_hbm_bytes", "model_flops", "collectives",
        "fits_h100_80gb"}

_WORKER = r"""
import json, sys
import jax
# before the reference's dry run is imported: it asks for 512 devices
assert len(jax.devices()) == 4, jax.devices()
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro import configs
from repro.configs.shapes import InputShape
from repro.launch import dryrun, roofline
from repro.launch.mesh import make_host_mesh
from repro.models.build import make_model
from repro.sharding import partition

spec = json.loads(sys.argv[1])
shapes = {step: InputShape(step, spec["s"], spec["b"], step)
          for step in spec["steps"]}
# build_lowered itself, on the reduced configs and the small shapes
dryrun.get_config = lambda arch: configs.get_config(arch, reduced=True)
dryrun.INPUT_SHAPES = shapes
mesh = make_host_mesh(2)
out = {}
for arch in spec["archs"]:
    for step, shape in shapes.items():
        with mesh:
            cfg, lowered, _ = dryrun.build_lowered(arch, step, mesh)
            compiled = lowered.compile()
        mem = compiled.memory_analysis()
        params = jax.eval_shape(make_model(cfg).init, jax.random.key(0))
        pspecs = partition.param_specs(cfg, mesh, params)
        param_bytes = sum(
            int(np.prod(NamedSharding(mesh, s).shard_shape(p.shape)))
            * p.dtype.itemsize for p, s in zip(
                jax.tree.leaves(params),
                jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(
                    x, PartitionSpec))))
        out[f"{arch}/{step}"] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "param_bytes": param_bytes,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "model_flops": roofline.model_flops(cfg, shape, step),
            "analytic_hbm_bytes": roofline.analytic_hbm_bytes(
                cfg, shape, step, 4)}
print("RESULT " + json.dumps(out))
"""


PRODUCTION = [("gemma-2b", "train_4k", False),
              ("deepseek-v3-671b", "decode_32k", True)]
_RUN_ONE = r"""
import sys, time
from pathlib import Path
from repro_torch.launch import dryrun
arch, shape, multi_pod, out = sys.argv[1:]
t0 = time.perf_counter()
dryrun.run_one(arch, shape, multi_pod == "1", Path(out))
print(f"SECONDS {time.perf_counter() - t0:.1f}")
"""


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The JAX reference worker and the two full-size dry runs, each in a
    process of its own, started together before the module's first test
    (they run while the in-process tests do)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src = str(ROOT / "src")
    spec = {"archs": REF_ARCHS, "steps": STEPS, "b": REF_B, "s": REF_S}
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))}
    for arch, shape, multi_pod in PRODUCTION:
        procs[arch, shape] = subprocess.Popen(
            [sys.executable, "-c", _RUN_ONE, arch, shape,
             str(int(multi_pod)), str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=src))
    yield tmp, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finished(proc) -> str:
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


def _reduced_shape(cfg, step: str) -> InputShape:
    """B = 2 and 16 text positions (a vision prefix comes on top)."""
    s = 16 + (cfg.frontend.num_embeddings if cfg.arch_type == "vlm" else 0)
    return InputShape(step, s, 2, step)


def _counts(res: dict) -> dict:
    mem = res["memory"]
    return {"flops": res["cost"]["flops"],
            "census_flops": res["census"]["flops"],
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "peak_bytes": mem["peak_bytes"]}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", configs.list_archs())
def test_meta_run_counts_what_a_real_run_counts(arch, step):
    """The same step on ``meta`` and on real CPU tensors (zeros) on a
    1 × 1 mesh: FLOPs and argument, output and peak bytes equal."""
    cfg = configs.get_config(arch, reduced=True)
    shape = _reduced_shape(cfg, step)
    got = {}
    for device in ("meta", "cpu"):
        with mesh_lib.stand_in_mesh((1, 1), device=device) as mesh:
            got[device] = _counts(dryrun.measure(cfg, shape, mesh,
                                                 device=device))
    assert got["meta"] == got["cpu"], (arch, step, got)
    assert got["meta"]["flops"] > 0 and got["meta"]["peak_bytes"] >= \
        got["meta"]["argument_bytes"] > 0


@pytest.fixture(scope="module")
def reference(started):
    line = [ln for ln in _finished(started[1]["reference"]).splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_rank_bytes_and_model_terms_match_reference(reference, arch, step):
    """At 2 × 2, every rank's argument bytes are XLA's per-device
    argument size (prefill: the parameters, the batch being global on the
    port's ranks), and the model terms are the reference's."""
    want = reference[f"{arch}/{step}"]
    cfg = configs.get_config(arch, reduced=True)
    shape = InputShape(step, REF_S, REF_B, step)
    for rank in range(4):
        with mesh_lib.stand_in_mesh((2, 2), rank) as mesh:
            got = dryrun.measure(cfg, shape, mesh)
        mem = got["memory"]
        if step == "prefill":
            assert mem["arguments"]["params"] == want["param_bytes"]
            assert mem["arguments"]["batch"] == sum(
                math.prod(v.shape) * v.element_size() for v in
                make_model(cfg).input_specs(shape).values())
            # XLA keeps only the tokens' shard of the batch
            assert want["argument_bytes"] == want["param_bytes"] \
                + REF_B // 2 * REF_S * 4
        else:
            assert mem["argument_bytes"] == want["argument_bytes"], \
                (arch, step, rank, mem, want)
        for key in ("params", "active_params", "model_flops",
                    "analytic_hbm_bytes"):
            assert got[key] == want[key], (key, got[key], want[key])


class _Shape:
    """A mesh's shape and axis names (what ``local_shape`` reads)."""

    def __init__(self, names, dims):
        self.axis_names = names
        self.shape = dict(zip(names, dims))


def _local_bytes(leaves_and_specs, mesh) -> int:
    return sum(math.prod(partition.local_shape(t.shape, spec, mesh))
               * t.element_size() for t, spec in leaves_and_specs)


@pytest.mark.parametrize("arch,shape_name,multi_pod", PRODUCTION)
def test_production_combination_runs(started, arch, shape_name, multi_pod):
    """A full-size combination through ``run_one`` (in a process of its
    own): the JSON holds the reference's keys, and the argument bytes are
    the arithmetic of this rank's local shapes."""
    tmp, procs = started
    seconds = _finished(procs[arch, shape_name]).split()[-1]
    names, dims = mesh_lib.PRODUCTION_SHAPES[multi_pod]
    mesh_name = "x".join(map(str, dims))
    res = json.loads((tmp / f"{arch}__{shape_name}__{mesh_name}.json")
                     .read_text())
    assert set(res) == KEYS and res["mesh"] == mesh_name
    assert res["chips"] == math.prod(dims) and res["rank"] == 0
    shape = configs.INPUT_SHAPES[shape_name]
    cfg, _ = dryrun.adapt_config(arch, shape)
    mesh = _Shape(names, dims)
    whole = _param_shapes(cfg)
    specs = make_model(cfg).param_specs(mesh)
    params = _local_bytes([(t, partition.spec_at(specs, p)) for p, t in
                           tree.leaves_with_paths(whole)], mesh)
    n_dp = math.prod(dims[:-1])
    if shape.step == "train":
        f32 = sum(math.prod(partition.local_shape(
            t.shape, partition.spec_at(specs, p), mesh)) * 4
            for p, t in tree.leaves_with_paths(whole))
        rest = 2 * f32 + 4 + 2 * shape.global_batch // n_dp \
            * shape.seq_len * 4
    else:
        caches = make_model(cfg).cache_specs(shape)
        cspecs = partition.cache_specs(cfg, mesh, caches)
        rest = _local_bytes([(t, partition.spec_at(cspecs, p)) for p, t in
                             tree.leaves_with_paths(caches)], mesh) \
            + shape.global_batch * 4
    mem = res["memory"]
    assert mem["arguments"]["params"] == params
    assert mem["argument_bytes"] == params + rest, (mem, params, rest)
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert res["cost"]["flops"] > 0 and res["collectives"]["total_bytes"] \
        == res["census"]["collective_bytes"] > 0
    print(f"{arch} {shape_name} {mesh_name}: {seconds} s (stand-ins "
          f"{res['lower_s']:.1f} s, step {res['compile_s']:.1f} s), peak "
          f"{mem['peak_bytes'] / 1e9:.2f} GB a rank")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.list_archs())
def test_long_context_decode_finds_its_cache_specs(arch, multi_pod):
    """``long_500k`` decodes one sequence over 16 (32) data ranks: the
    caches' sequence dim goes over ``data`` where it divides, and
    ``decode_step`` derives the specs back from a rank's local shapes.
    Every arch's local shapes name one global cache length, the one
    ``init_cache(mesh=...)`` used."""
    shape = configs.INPUT_SHAPES["long_500k"]
    cfg, _ = dryrun.adapt_config(arch, shape)
    model = make_model(cfg)
    rolling = cfg.arch_type not in dryrun.SUBQUADRATIC
    _, dims = mesh_lib.PRODUCTION_SHAPES[multi_pod]
    with mesh_lib.stand_in_mesh(dims, rank=dims[-1] + 1) as mesh:
        local = model.init_cache(1, shape.seq_len, rolling=rolling,
                                 device="meta", mesh=mesh)
        found = model._rank_cache_specs(local, 1, rolling, mesh)
    want = partition.cache_specs(cfg, mesh, model.cache_specs(
        shape, rolling=rolling))
    assert found == want


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tracker_counts_the_softmax_backward_scratch(device, strided):
    """A softmax backward's peak above its inputs: its output and the
    card kernel's output-sized grad · output buffer, and a contiguous
    copy of a strided grad (``memory.SCRATCH``; on the card 2 and 3
    times the output, ``scripts/softmax_scratch.py``), on real and on
    ``meta`` tensors alike; the peak by dtype carries it, and nothing
    stays live after."""
    import torch

    from repro_torch.analysis.memory import MemoryTracker
    out = torch.softmax(torch.ones((6, 40), device=device), -1)
    grad = torch.ones((40, 6), device=device).t() if strided \
        else torch.ones((6, 40), device=device)
    tracker = MemoryTracker()
    base = tracker.hold(out, grad)
    with tracker:
        res = torch.ops.aten._softmax_backward_data(grad, out, -1,
                                                    torch.float32)
    n = out.numel() * 4
    assert tracker.peak - base == (3 if strided else 2) * n
    assert tracker.peak_by_dtype["float32"] == tracker.peak
    assert tracker.live - base == n and res.shape == out.shape


def test_expert_counts_are_bincount_and_run_on_meta():
    """The MoE's expert counts over ranks (``bincount``, which has no meta
    kernel, as a scatter-add of ones): the same int64 counts, and a
    shape on ``meta``."""
    import torch

    from repro_torch.models import moe
    ids = torch.randint(0, 8, (64,), generator=torch.Generator()
                        .manual_seed(0))
    got = moe.expert_counts(ids, 11)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.bincount(ids, minlength=11))
    assert moe.expert_counts(ids.to("meta"), 11).shape == (11,)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ("mamba2-1.3b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "internvl2-2b",
                                  "seamless-m4t-medium"))
def test_split_archs_split_the_compute(arch, step):
    """A rank of 1 × 4 does at most half the FLOPs of one process on the
    same reduced step (B = 8, S = 16; the vision prefix's 16 positions
    before 16 tokens; 16 frames): the compute, not only the values, is
    split over ``model``."""
    cfg = configs.get_config(arch, reduced=True)
    seq = REF_S + (cfg.frontend.num_embeddings if cfg.arch_type == "vlm"
                   and step != "decode" else 0)
    shape = InputShape(step, seq, REF_B, step)
    flops = {}
    for dims in ((1, 1), (1, 4)):
        with mesh_lib.stand_in_mesh(dims, 0) as mesh:
            flops[dims] = dryrun.measure(cfg, shape, mesh)["cost"]["flops"]
    assert 0 < flops[(1, 4)] <= flops[(1, 1)] / 2, (arch, step, flops)


def test_stand_in_mesh_refuses_a_process_in_a_group(tmp_path):
    """The stand-in world is this process's default group: a process that
    is already in one is refused, and the group is left as it was."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            with mesh_lib.stand_in_mesh((16, 16)):
                pass
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with mesh_lib.stand_in_mesh((2, 16, 16), rank=511) as mesh:
        assert mesh.coords == {"pod": 1, "data": 15, "model": 15}
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()


@pytest.mark.parametrize("batch,accum", [(6, 2), (8, 3)])
def test_training_batch_that_does_not_divide_is_refused(batch, accum):
    """6 rows over 2 data ranks leave 3 a rank, which 2 microbatches do
    not split; 8 leave 4, which 3 do not; 3 rows do not divide over 2
    data ranks: each fails loudly before the step runs."""
    cfg = dataclasses.replace(configs.get_config("gemma-2b", reduced=True),
                              grad_accum=accum)
    with mesh_lib.stand_in_mesh((2, 2)) as mesh:
        with pytest.raises(ValueError, match="microbatches"):
            dryrun.build_step(cfg, InputShape("t", 16, batch, "train"), mesh)
        with pytest.raises(ValueError, match="does not divide"):
            dryrun.build_step(cfg, InputShape("t", 16, 3, "train"), mesh)
