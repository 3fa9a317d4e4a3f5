"""The port's sharding rules (``sharding.partition``: ``param_specs``,
``opt_state_specs``, ``batch_specs``, ``cache_specs``) against the JAX
package's, entry for entry, on every architecture of ``configs`` at its
full and its reduced configuration, over five meshes: the production 16 ×
16 and 2 × 16 × 16, and 2 × 2, 1 × 4 and 4 × 1.

The rules read only a mesh's ``shape`` and ``axis_names``, so both
packages get the same plain object, and the leaves' shapes: the reference's
from ``jax.eval_shape`` and its ``input_specs`` / ``cache_specs``, the
port's from ``Model.init`` under ``FakeTensorMode`` and its meta-tensor
``input_specs`` / ``cache_specs`` (no allocation on either side).  Batch
and cache specs are taken at every ``INPUT_SHAPES`` entry (rolling caches
for ``long_500k``).  A reference spec is compared as the tuple of its
entries (``PartitionSpec`` writes a one-name tuple as the name; so does
the port's ``partition.P``).
"""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models.build import make_model as jmake_model
from repro.sharding import partition as jpartition
from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.models.build import make_model
from repro_torch.sharding import partition
from repro_torch.util import tree


@dataclasses.dataclass(frozen=True)
class PlainMesh:
    names: tuple
    dims: tuple

    @property
    def axis_names(self):
        return self.names

    @property
    def shape(self):
        return dict(zip(self.names, self.dims))


MESHES = [PlainMesh(("data", "model"), (16, 16)),
          PlainMesh(("pod", "data", "model"), (2, 16, 16)),
          PlainMesh(("data", "model"), (2, 2)),
          PlainMesh(("data", "model"), (1, 4)),
          PlainMesh(("data", "model"), (4, 1))]


def _jax_specs(spec_tree):
    pairs = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(k), tuple(p)) for k, p in pairs]


def _port_specs(spec_tree, shapes):
    """The port's specs at the leaf paths of ``shapes`` (the spec tree
    mirrors it; a spec is a tuple, so it is indexed, not flattened)."""
    out = []
    for path, _ in tree.leaves_with_paths(shapes):
        node = spec_tree
        for k in path:
            node = node[k]
        out.append(("".join(f"[{k!r}]" for k in path), node))
    return out


def _reference(arch, reduced):
    cfg = jconfigs.get_config(arch, reduced=reduced)
    model = jmake_model(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    opt = jax.eval_shape(model.init_optimizer().init, params)
    batches = {n: model.input_specs(s) for n, s in INPUT_SHAPES.items()}
    caches = {n: model.cache_specs(s, rolling=n == "long_500k")
              for n, s in INPUT_SHAPES.items()}
    return cfg, params, opt, batches, caches


def _port(arch, reduced):
    cfg = configs.get_config(arch, reduced=reduced)
    model = make_model(cfg)
    with FakeTensorMode():
        params = model.init(0, "cpu")
        opt = model.init_optimizer().init(params)
    batches = {n: model.input_specs(s) for n, s in INPUT_SHAPES.items()}
    caches = {n: model.cache_specs(s, rolling=n == "long_500k")
              for n, s in INPUT_SHAPES.items()}
    return cfg, params, opt, batches, caches


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(configs.list_archs()))
def test_spec_rules_equal_reference(arch, reduced):
    jcfg, jparams, jopt, jbatches, jcaches = _reference(arch, reduced)
    tcfg, tparams, topt, tbatches, tcaches = _port(arch, reduced)
    assert jcfg.param_count() == tcfg.param_count()
    for mesh in MESHES:
        where = (arch, reduced, mesh.dims)
        assert _port_specs(partition.param_specs(tcfg, mesh, tparams),
                           tparams) == \
            _jax_specs(jpartition.param_specs(jcfg, mesh, jparams)), where
        got = partition.opt_state_specs(tcfg, mesh, tparams, topt)
        want = jpartition.opt_state_specs(jcfg, mesh, jparams, jopt)
        assert _port_specs(got, topt) == _jax_specs(want), where
        if not tree.leaves(topt):
            assert got == want == (), where
        for name in INPUT_SHAPES:
            assert _port_specs(partition.batch_specs(
                tcfg, mesh, tbatches[name]), tbatches[name]) == _jax_specs(
                jpartition.batch_specs(jcfg, mesh, jbatches[name])), \
                (where, name)
            assert _port_specs(partition.cache_specs(
                tcfg, mesh, tcaches[name]), tcaches[name]) == _jax_specs(
                jpartition.cache_specs(jcfg, mesh, jcaches[name])), \
                (where, name)


def test_rules_assign_what_the_reference_strategy_says():
    """A few entries spelled out (gemma-2b at full width on 16 × 16): the
    embedding's vocabulary over ``model``; an up projection's output and a
    down projection's input over ``model``; norms replicated; the train
    batch over ``data``; a decode cache's batch over ``data`` and its KV
    head dim over ``model``; above the FSDP threshold (deepseek-v3-671b) a
    second axis on the other feature dim."""
    cfg = configs.get_config("gemma-2b")
    model = make_model(cfg)
    with FakeTensorMode():
        params = model.init(0, "cpu")
    mesh = MESHES[0]
    specs = partition.param_specs(cfg, mesh, params)
    assert specs["embedding"]["table"] == ("model", None)
    mlp = specs["stack"]["attn_mlp"]["mlp"]
    assert mlp["up"] == (None, None, "model")
    assert mlp["down"] == (None, "model", None)
    assert specs["final_norm"]["scale"] == (None,)
    batch = partition.batch_specs(cfg, mesh, model.input_specs(
        INPUT_SHAPES["train_4k"]))
    assert batch["tokens"] == ("data", None)
    pod = partition.batch_specs(cfg, MESHES[1], model.input_specs(
        INPUT_SHAPES["train_4k"]))
    assert pod["tokens"] == (("pod", "data"), None)
    cache = partition.cache_specs(cfg, mesh, model.cache_specs(
        INPUT_SHAPES["decode_32k"]))["attn_mlp"]
    assert cache["k"] == (None, "data", None, None, "model")
    big = configs.get_config("deepseek-v3-671b")
    assert big.param_count() > partition.FSDP_THRESHOLD
    with FakeTensorMode():
        big_params = make_model(big).init(0, "cpu")
    big_specs = partition.param_specs(big, mesh, big_params)
    assert big_specs["embedding"]["table"] == ("model", "data")
