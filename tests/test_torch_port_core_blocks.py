"""The two core blocks no model of either package uses, held to the JAX
package's through the weight bridge: `ConditionedResidualBlock` (with and
without the time and class shifts, with and without the 1x1 residual
projection) and `SpatialSelfAttention2D` (its packed qkv split into q, k,
v as the denoiser's attention is). The flax params, every leaf perturbed,
go through `flax_to_state_dict` into the port's module; the forward must
agree within tests/test_torch_port_core.py's tolerance, and
`state_dict_to_flax` must give the reference's tree back exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.core import ConditionedResidualBlock as JaxConditioned
from flowerdiff.core import SpatialSelfAttention2D as JaxSpatial
from flowerdiff_torch.core import ConditionedResidualBlock, SpatialSelfAttention2D
from flowerdiff_torch.utils.weights import state_dict_to_flax
from test_torch_port_core import TOL, _load, _nchw, _nhwc, _perturbed


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _round_trip(module, params):
    got, want = dict(_leaves(state_dict_to_flax(module))), dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 12)])
@pytest.mark.parametrize("shifts", ["both", "time", "none"])
def test_conditioned_residual_block_matches_flax(cin, cout, shifts):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 6, cin)).astype(np.float32)
    t_emb, c_emb = (rng.normal(size=(2, 16)).astype(np.float32) for _ in range(2))
    jm = JaxConditioned(cin, cout, cond_dim=16)
    params = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t_emb),
                                jnp.asarray(c_emb)), 1)
    t_in = None if shifts == "none" else t_emb
    c_in = c_emb if shifts == "both" else None
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                              None if t_in is None else jnp.asarray(t_in),
                              None if c_in is None else jnp.asarray(c_in)))
    module = _load(ConditionedResidualBlock(cin, cout, cond_dim=16), params)
    assert (module.residual_proj is None) == (cin == cout)
    with torch.no_grad():
        got = _nhwc(module(_nchw(x), None if t_in is None else torch.from_numpy(t_in),
                           None if c_in is None else torch.from_numpy(c_in)))
    np.testing.assert_allclose(got, ref, **TOL)
    _round_trip(module, params)


@pytest.mark.parametrize("heads", [1, 4])
def test_spatial_self_attention_matches_flax(heads):
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 16)).astype(np.float32)
    jm = JaxSpatial(16, num_heads=heads)
    params = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 4)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    module = _load(SpatialSelfAttention2D(16, num_heads=heads), params)
    with torch.no_grad():
        got = _nhwc(module(_nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)
    _round_trip(module, params)


def test_blocks_refuse_widths_that_do_not_split_into_heads():
    with pytest.raises(ValueError, match="heads"):
        SpatialSelfAttention2D(10, num_heads=4)
