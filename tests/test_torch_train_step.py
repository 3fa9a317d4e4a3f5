"""The port's ``Model.train_step`` against the JAX package's, for every
architecture of ``configs.list_archs()`` (half of them here, half in
tests/test_torch_train_step_families.py) at its reduced configuration
(f32), from the same parameters and the same train batch (the vision
prefix, the encoder-decoder's frames and the MTP loss included), with
``grad_accum`` 1 and 2.

Under ``optimizer="sgd"`` and learning rate 1 each step's delta is −g, so
the new parameters carry the gradient.  Per leaf the two packages' new
parameters agree within 1e-5 · max |delta| of the leaf, beside one f32
spacing of the new value: each side rounds p − g once, and where |g| is
far below |p| (norm scales of 1 against gradients of 1e-3) that rounding
alone is up to 2.6e-5 of max |g| in the reference itself.  Loss and
metrics agree within 1e-5 relative.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models.build import make_model as jmake_model
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models.build import make_model
from repro_torch.util import tree

TOL = 1e-5
B, S, S_ENC = 4, 16, 24


def train_batch(cfg, seed=0) -> dict:
    """A train batch of numpy arrays in the format of ``input_specs``."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.frontend.num_embeddings, cfg.d_model)) \
            .astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, S_ENC, cfg.d_model)) \
            .astype(np.float32)
    return batch


def assert_steps_close(p, new_port, new_ref, tol=TOL):
    """Each leaf's new value from the port within ``tol`` · max |delta| of
    the reference's, beside one f32 spacing of the reference's value."""
    ref = jax.tree_util.tree_flatten_with_path(new_ref)[0]
    got = tree.leaves_with_paths(new_port)
    assert [jax.tree_util.keystr(k) for k, _ in ref] == \
        ["".join(f"[{k!r}]" for k in path) for path, _ in got]
    for (path, want), (_, have), p0 in zip(ref, got, jax.tree.leaves(p)):
        want = np.asarray(want, np.float64)
        have = have.detach().double().numpy()
        scale = float(np.abs(want - np.asarray(p0, np.float64)).max())
        slack = np.spacing(np.abs(want).astype(np.float32))
        over = np.abs(have - want) - slack
        assert float(over.max()) <= tol * scale, \
            (jax.tree_util.keystr(path), float(over.max()), scale)


def assert_metrics_close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert abs(g - w) <= tol * abs(w), (k, g, w)


def sgd_pair(arch: str, **changes):
    """(JAX model, port model, JAX params, port params): SGD at lr 1."""
    kw = dict(optimizer="sgd", learning_rate=1.0, **changes)
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), **kw)
    tcfg = dataclasses.replace(configs.get_config(arch, reduced=True), **kw)
    jm, tm = jmake_model(jcfg), make_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


def check_train_step(arch: str, accum: int) -> None:
    jm, tm, jp, tp = sgd_pair(arch, grad_accum=accum)
    batch = train_batch(jm.cfg)
    j_new, j_opt, j_met = jax.jit(jm.train_step)(jp, (), batch)
    t_new, t_opt, t_met = tm.train_step(tp, (), batch)
    assert j_opt == () and t_opt == ()
    assert_steps_close(jp, t_new, j_new)
    assert_metrics_close(t_met, j_met)


# the architectures are split over two files (the other half:
# tests/test_torch_train_step_families.py) to keep each file's run short
ARCHS = sorted(jconfigs.list_archs())
FIRST_HALF = ARCHS[: len(ARCHS) // 2]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", FIRST_HALF)
def test_train_step_gradients_match_reference(arch, accum):
    check_train_step(arch, accum)
