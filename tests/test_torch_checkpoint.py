"""Checkpoints cross between the JAX package and the port, in the
reference's on-disk format: ``ckpt_{step:08d}.npz`` of ``leaf_{i}`` arrays
and a ``.json`` of ``{step, leaves: [{key, path, dtype, shape, spec}]}``.

A JAX-written checkpoint of parameters and Adam state, with f32, bf16 and
int32 leaves, restores in the port bitwise; an f32 checkpoint written by
the port restores in JAX bitwise and its JSON is the reference's, text for
text; a bf16 checkpoint written by the port holds, member for member, the
bytes of the reference's npz (the archive's headers carry the write time,
so the files as a whole differ).  The reference's own ``restore`` cannot
read a bf16 leaf back (numpy has no cast from its raw ``<V2`` words), so
the bf16 direction is held on the bytes.
"""
import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models.build import make_model as jmake_model
from repro_torch import checkpoint
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.util import tree


def _jax_state(dtype: str):
    """{"params", "opt"} of reduced gemma-2b in ``dtype`` with an Adam
    state moved off zero, as the reference builds them."""
    cfg = dataclasses.replace(jconfigs.get_config("gemma-2b", reduced=True),
                              dtype=dtype)
    m = jmake_model(cfg)
    params = m.init(jax.random.key(0))
    opt = m.init_optimizer()
    st = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    _, st = opt.update(grads, st, params)
    return {"params": params, "opt": st}


def _to_port(state):
    np_state = jax.tree.map(np.asarray, state)
    return {"params": model_params_from_numpy(np_state["params"], "cpu"),
            "opt": opt_state_from_numpy(np_state["opt"], "cpu")}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {i.filename: (i.compress_type, z.read(i.filename))
                for i in z.infolist()}


def test_jax_checkpoint_restores_in_port_bitwise(tmp_path):
    state = _jax_state("bfloat16")
    jckpt.save(tmp_path, state, step=7)
    like = _to_port(jax.tree.map(jnp.zeros_like, state))
    back = checkpoint.restore(tmp_path, like)
    want = _to_port(state)
    dtypes = set()
    for a, b in zip(tree.leaves(back), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        dtypes.add(a.dtype)
    assert dtypes == {torch.bfloat16, torch.float32, torch.int32}


def test_port_f32_checkpoint_restores_in_jax_bitwise(tmp_path):
    state = _jax_state("float32")
    checkpoint.save(tmp_path / "port", _to_port(state), step=3)
    jckpt.save(tmp_path / "ref", state, step=3)
    assert (tmp_path / "port/ckpt_00000003.json").read_text() == \
        (tmp_path / "ref/ckpt_00000003.json").read_text()
    back = jckpt.restore(tmp_path / "port",
                         jax.tree.map(jnp.zeros_like, state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _members(tmp_path / "port/ckpt_00000003.npz") == \
        _members(tmp_path / "ref/ckpt_00000003.npz")


def test_port_bf16_checkpoint_is_the_reference_bytes(tmp_path):
    state = _jax_state("bfloat16")
    checkpoint.save(tmp_path / "port", _to_port(state), step=1)
    jckpt.save(tmp_path / "ref", state, step=1)
    meta = json.loads((tmp_path / "port/ckpt_00000001.json").read_text())
    assert "bfloat16" in {m["dtype"] for m in meta["leaves"]}
    assert (tmp_path / "port/ckpt_00000001.json").read_text() == \
        (tmp_path / "ref/ckpt_00000001.json").read_text()
    assert _members(tmp_path / "port/ckpt_00000001.npz") == \
        _members(tmp_path / "ref/ckpt_00000001.npz")
    back = checkpoint.restore(tmp_path / "port", _to_port(state))
    for a, b in zip(tree.leaves(back), tree.leaves(_to_port(state))):
        assert torch.equal(a, b)


def test_latest_step_and_refusals(tmp_path):
    assert checkpoint.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, {"a": torch.zeros(2)})
    for step in (2, 10, 5):
        checkpoint.save(tmp_path, {"a": torch.full((2,), float(step))},
                        step=step)
    assert checkpoint.latest_step(tmp_path) == jckpt.latest_step(tmp_path) \
        == 10
    assert float(checkpoint.restore(tmp_path, {"a": torch.zeros(2)})["a"][0]) \
        == 10.0
    assert float(checkpoint.restore(tmp_path, {"a": torch.zeros(2)},
                                    step=5)["a"][0]) == 5.0
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(tmp_path, {"a": torch.zeros(3)})
