"""flowerdiff_torch core modules and weight bridge against the JAX reference.

The same numpy weights and inputs (seeded) go through the flax module and
its port; NHWC on the JAX side, NCHW inside the port. f32 throughout:
tolerance atol 1e-5 plus rtol 1e-5 (summation order differs between XLA's
CPU kernels and PyTorch's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.core import attention as jattn
from flowerdiff.core import embeddings as jemb
from flowerdiff.core import layers as jlayers
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff_torch.core import attention, embeddings, layers
from flowerdiff_torch.utils.weights import flax_to_state_dict, init_numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(params, seed):
    """flax params as numpy, every leaf moved by N(0, 0.05): nonzero biases
    and non-unit norm scales."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        params)


def _load(module, tree):
    module.load_state_dict(flax_to_state_dict(tree, module), strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


CONV_CASES = {
    "layernorm2d": (lambda: jlayers.LayerNorm2d(6), lambda: layers.LayerNorm2d(6)),
    "calayer": (lambda: jlayers.CALayer(16), lambda: layers.CALayer(16)),
    "spatial_attention": (lambda: jlayers.SpatialAttention(), lambda: layers.SpatialAttention()),
    "residual_block": (lambda: jlayers.ResidualBlock(16), lambda: layers.ResidualBlock(16)),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_layers_match_flax(name):
    make_j, make_t = CONV_CASES[name]
    ch = 6 if name == "layernorm2d" else 16
    x = np.random.default_rng(0).normal(size=(2, 8, 8, ch)).astype(np.float32)
    jm = make_j()
    params = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(_load(make_t(), params)(_nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_swish_matches_flax():
    x = np.linspace(-8, 8, 101, dtype=np.float32)
    np.testing.assert_allclose(layers.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.swish(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("dim", [16, 17])
def test_sinusoidal_embedding_matches(dim):
    t = np.array([0, 1, 7, 500, 999], np.int32)
    ref = np.asarray(jemb.sinusoidal_time_embedding(jnp.asarray(t), dim))
    got = embeddings.sinusoidal_time_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_embedding_modules_match_flax():
    rng = np.random.default_rng(2)
    t = np.array([0, 3, 250, 999], np.int32)
    c = np.array([0, 4, 9, 2], np.int32)
    col = np.array([1, 0, 3, 2], np.int32)
    cases = [
        (jemb.TimeEmbedding(16), embeddings.TimeEmbedding(16), (t,)),
        (jemb.ClassEmbedding(10, 16), embeddings.ClassEmbedding(10, 16), (c,)),
        (jemb.MultiConditionEmbedding(10, 4, 16),
         embeddings.MultiConditionEmbedding(10, 4, 16), (c, col)),
    ]
    for jm, tm, args in cases:
        params = _perturbed(jm.init(jax.random.key(0), *map(jnp.asarray, args)),
                            int(rng.integers(1 << 30)))
        ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args)))
        with torch.no_grad():
            got = _load(tm, params)(*[torch.from_numpy(a.astype(np.int64)) for a in args])
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("seq", [1, 5])
def test_multihead_attention_matches_flax(seq):
    x = np.random.default_rng(3).normal(size=(3, seq, 16)).astype(np.float32)
    jm = jattn.MultiHeadSelfAttention(16, num_heads=4)
    params = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 4)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = _load(attention.MultiHeadSelfAttention(16, num_heads=4), params)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_init_numpy_params_tree_matches_flax_init(variant):
    kw = dict(latent_dim=32, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=5)
    if variant == "v3":
        kw.update(shared_cond_proj=False, num_colors=3)
    x, t, c = jnp.zeros((2, 32)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32)
    args = (x, t, c, c) if variant == "v3" else (x, t, c)
    ref = jax.eval_shape(lambda: JaxDenoiser(**kw).init(jax.random.key(0), *args))
    mine = init_numpy_params("denoiser", seed=0, **kw)
    assert _shapes(mine) == _shapes(ref)
    biases = [v["bias"] for k, v in mine["params"].items()
              if isinstance(v, dict) and "bias" in v]
    assert biases and all(np.abs(b).max() > 0 for b in biases)


def test_init_numpy_params_vae_tree_matches_flax_decoder():
    kw = dict(latent_dim=16, channels=(8, 16, 24, 32), head_width=32)
    ref = jax.eval_shape(lambda: JaxVAE(**kw).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jax.random.key(1)))
    mine = init_numpy_params("vae", seed=0, **kw)
    assert _shapes(mine["params"]["decoder"]) == _shapes(ref["params"]["decoder"])


def test_init_numpy_params_kaiming_std():
    tree = init_numpy_params("denoiser", seed=5)["params"]
    k = tree["block_fc_2"]["kernel"]  # (1024, 1024) at flagship width
    assert k.shape == (1024, 1024)
    np.testing.assert_allclose(k.std(), np.sqrt(2.0 / 1.04 / 1024), rtol=0.01)
    np.testing.assert_array_equal(tree["final_norm"]["scale"], 1.0)
