"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A fresh interpreter imports every module of ``repro_torch`` (and loads
``chip_smoke.py`` as a module) and must end with no ``jax``/``jax.*`` and no
``repro``/``repro.*`` module loaded.  The trainers and the server default
to the card and refuse to carry on quietly on the CPU.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    print(len(names), bad, " ".join(names))
    sys.exit(1 if bad else 0)
""")


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHECK,
                           str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30, proc.stdout
    for name in ("repro_torch.core.serial", "repro_torch.core.subproblems",
                 "repro_torch.optim.optimizers",
                 "repro_torch.kernels.community_spmm",
                 "repro_torch.core.messages", "repro_torch.sharding.partition",
                 "repro_torch.core.layerwise",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.data.pipeline", "repro_torch.analysis",
                 "repro_torch.analysis.findings",
                 "repro_torch.analysis.registry",
                 "repro_torch.analysis.trace",
                 "repro_torch.analysis.trainer",
                 "repro_torch.analysis.rules",
                 "repro_torch.analysis.rules.collective",
                 "repro_torch.analysis.rules.kernel",
                 "repro_torch.analysis.rules.memory",
                 "repro_torch.analysis.rules.precision",
                 "repro_torch.launch.roofline",
                 "repro_torch.launch.analyze",
                 "repro_torch.analysis.memory",
                 "repro_torch.launch.dryrun"):
        assert name in proc.stdout.split(), name


def test_trainer_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    from repro.core import graph as jgraph
    from repro_torch.core import gcn
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.core.subproblems import ADMMConfig
    g, _ = jgraph.synthetic_powerlaw_communities(
        4, nodes_per_part=8, feat_dim=4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelADMMTrainer(gcn.GCNConfig((4, 8, g.num_classes)),
                            ADMMConfig(), g, 4,
                            config=TrainerConfig.packed(use_kernel=True))


@pytest.mark.parametrize("trainer", ["serial", "baseline"])
def test_serial_trainers_without_device_raise_when_cuda_is_absent(trainer):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    from repro.core import graph as jgraph
    from repro_torch.core import gcn
    from repro_torch.core.serial import BaselineTrainer, SerialADMMTrainer
    from repro_torch.core.subproblems import ADMMConfig
    g, _ = jgraph.synthetic_powerlaw_communities(
        4, nodes_per_part=8, feat_dim=4, seed=0)
    cfg = gcn.GCNConfig((4, 8, g.num_classes))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if trainer == "serial":
            SerialADMMTrainer(cfg, ADMMConfig(), g)
        else:
            BaselineTrainer(cfg, g, "adam", 1e-3)


def test_server_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    from repro.core import graph as jgraph
    from repro_torch.core import gcn
    from repro_torch.serve import CommunityServer
    g, part = jgraph.synthetic_powerlaw_communities(
        4, nodes_per_part=8, feat_dim=4, seed=0)
    cfg = gcn.GCNConfig((4, 8, g.num_classes))
    layout = jgraph.build_community_layout(g.num_nodes, g.edges, part,
                                           compressed=True,
                                           pad_mode="bucketed")
    ws = [np.zeros((4, 8), np.float32), np.zeros((8, g.num_classes),
                                                 np.float32)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CommunityServer(cfg, layout, ws, g.features)
