"""Architecture registry: ``--arch <id>`` resolution for every launcher
(a copy of ``repro.configs.registry``; ``"gcn-paper"`` names the port's
``configs/gcn_paper.py``)."""
from __future__ import annotations

import importlib


_ARCH_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "nemotron-4-15b": "nemotron_4_15b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-1.3b": "mamba2_1_3b",
    "gemma-2b": "gemma_2b",
    "qwen2-7b": "qwen2_7b",
    "internvl2-2b": "internvl2_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gcn-paper": "gcn_paper",
}


def list_archs() -> list[str]:
    return [a for a in _ARCH_MODULES if a != "gcn-paper"]


def get_config(arch: str, reduced: bool = False):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.reduced() if reduced else mod.config()
