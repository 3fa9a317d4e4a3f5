"""The port's TrainerConfig and the trainer's deprecated flag kwargs,
against the JAX package: every case of tests/test_trainer_config.py.

Each invalid flag combination raises the same ``ValueError`` message from
both packages' ``TrainerConfig`` and through the port's old-kwargs shim;
the shim warns once with the reference's ``DeprecationWarning`` text,
resolves to the config the explicit path builds, and refuses unknown flags
and flags mixed with ``config=`` as the reference does.
"""
import argparse
import dataclasses
import warnings

import pytest

from repro.core.parallel import TrainerConfig as RefConfig
from repro_torch.core import gcn, graph
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig


def _trainer(config=None, **kw):
    g, part = graph.synthetic_powerlaw_communities(
        num_parts=4, nodes_per_part=12, attach=1, seed=0, feat_dim=8,
        size_skew=0.5)
    cfg = gcn.GCNConfig(layer_dims=(8, 8, g.num_classes))
    return ParallelADMMTrainer(cfg, ADMMConfig(nu=1e-3, rho=1e-3), g,
                               num_parts=4, seed=0, part=part, device="cpu",
                               config=config, **kw)


INVALID = [
    dict(transport="bogus"),
    dict(transport="p2p", compressed=False),
    dict(packed=True, compressed=False),
    dict(packed=True, compressed=True, transport="allgather"),
    dict(overlap=True),
    dict(fused=True),
    dict(pad_mode="weird"),
    dict(adjacency_bf16=True, compressed=False),
    dict(compressed=True, packed=True, batch_fraction=0.0),
    dict(compressed=True, packed=True, batch_fraction=1.5),
    dict(compressed=True, batch_fraction=0.5),
    dict(stale_decay=0.0),
    dict(stale_decay=1.5),
]
SHIM_FLAGS = {"transport", "compressed", "packed", "overlap", "pad_mode",
              "adjacency_bf16"}


def _message(cls, kw) -> str:
    with pytest.raises(ValueError) as e:
        cls(**kw)
    return str(e.value)


@pytest.mark.parametrize("kw", INVALID, ids=[str(k) for k in INVALID])
def test_invalid_combos_raise_the_reference_message(kw):
    assert _message(TrainerConfig, kw) == _message(RefConfig, kw)


@pytest.mark.parametrize("kw", [k for k in INVALID if set(k) <= SHIM_FLAGS],
                         ids=[str(k) for k in INVALID
                              if set(k) <= SHIM_FLAGS])
def test_invalid_combos_raise_through_the_shim(kw):
    with pytest.raises(ValueError) as e, \
            pytest.warns(DeprecationWarning, match="TrainerConfig"):
        _trainer(**kw)
    assert str(e.value) == _message(RefConfig, kw)


def test_transport_none_resolution():
    for kw in ({}, {"compressed": True}):
        assert TrainerConfig(**kw).transport == RefConfig(**kw).transport
    assert TrainerConfig().transport == "allgather"
    assert TrainerConfig(compressed=True).transport == "p2p"


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("preset,kw", [
    ("dense", {}), ("p2p", {}), ("packed", {}), ("minibatch", {}),
    ("minibatch", {"batch_fraction": 0.5}),
    ("packed", {"comm_bf16": True}),
    ("minibatch", {"batch_fraction": 0.5, "overlap": True}),
    ("packed", {"fused": True, "overlap": True})])
def test_presets_equal_the_reference(preset, kw):
    assert _fields(getattr(TrainerConfig, preset)(**kw)) == _fields(
        getattr(RefConfig, preset)(**kw))


def test_config_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        TrainerConfig().compressed = True


def test_from_cli_args_reads_dest_names():
    ns = argparse.Namespace(compressed=True, transport="p2p",
                            pad_mode="bucketed", packed=True,
                            batch_fraction=0.5, stale_decay=0.75,
                            sample_seed=3, unrelated="ignored")
    assert TrainerConfig.from_cli_args(ns) == TrainerConfig(
        compressed=True, transport="p2p", packed=True, batch_fraction=0.5,
        stale_decay=0.75, sample_seed=3)
    assert _fields(TrainerConfig.from_cli_args(ns)) == _fields(
        RefConfig.from_cli_args(ns))
    assert TrainerConfig.from_cli_args(argparse.Namespace()) \
        == TrainerConfig()


def test_shim_resolves_to_the_same_config_and_warns_once():
    with pytest.warns(DeprecationWarning) as rec:
        old = _trainer(compressed=True, transport="p2p", packed=True)
    assert [str(w.message) for w in rec] == [
        "ParallelADMMTrainer flag kwargs are deprecated; pass "
        "config=TrainerConfig(...) instead"]
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        new = _trainer(config=TrainerConfig.packed())   # no warning
    assert old.config == new.config == TrainerConfig.packed()
    for attr in ("compressed", "transport", "packed", "overlap",
                 "pad_mode"):
        assert getattr(old, attr) == getattr(new, attr)


def test_use_kernel_flag_warns_as_the_reference_does():
    with pytest.warns(DeprecationWarning, match="TrainerConfig"):
        tr = _trainer(compressed=True, use_kernel=True)
    assert tr.config == TrainerConfig(compressed=True, use_kernel=True)
    assert tr.use_kernel


def test_shim_rejects_config_plus_legacy_and_unknown_kwargs():
    with pytest.raises(ValueError, match="not both"):
        _trainer(config=TrainerConfig(), compressed=True)
    with pytest.raises(TypeError, match="unexpected keyword"):
        _trainer(bogus_flag=True)
    # fused is no legacy flag: it came with TrainerConfig
    with pytest.raises(TypeError, match="unexpected keyword"):
        _trainer(fused=True)


def test_default_construction_warns_nothing():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        tr = _trainer()
    assert tr.config == TrainerConfig()
    assert tr.comm_stats["minibatch"] == {"enabled": False}
