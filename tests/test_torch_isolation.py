"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A fresh interpreter imports every module of ``repro_torch`` (and loads
``chip_smoke.py`` as a module) and must end with no ``jax``/``jax.*`` and no
``repro``/``repro.*`` module loaded.  The trainer defaults to the card and
refuses to carry on quietly on the CPU.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

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
    print(len(names), bad)
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
    assert n_modules >= 15, proc.stdout


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
