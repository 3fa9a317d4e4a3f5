"""One layerwise ADMM iteration of the port against the JAX package's on
the SSM stack (mamba2-1.3b) and the two-segment MoE stack
(deepseek-moe-16b: ``attn_mlp`` then ``attn_moe``, coupled across the
segment boundary), from the reference's state after 5 and 4 iterations.
Tolerances and the choice of depth: tests/test_torch_layerwise.py.
"""
import pytest

from test_torch_layerwise import check_one_iteration


@pytest.mark.parametrize("arch,n_before",
                         [("mamba2-1.3b", 5), ("deepseek-moe-16b", 4)])
def test_iteration_matches_reference(arch, n_before):
    check_one_iteration(arch, n_before)
