"""flowerdiff_torch denoiser and VAE decoder against `model.apply`.

Weights come from the port's seeded `init_numpy_params` (nonzero biases, so
the null-condition rows of classifier-free guidance keep the projection
biases the reference adds); the same numpy tree goes to flax. f32: the
denoiser within atol 1e-5 times max(1, max|ref|) (f32 sums of O(1)-scaled
products taken in another order), the decoder within atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    hwc_to_chw_index,
    init_numpy_params,
    vae_from_params,
)

SMALL = dict(latent_dim=128, hidden_dims=(128, 256, 128), time_emb_dim=128,
             num_classes=11)


def _variant(variant):
    kw = dict(SMALL)
    if variant == "v2":
        kw["global_skip"] = True
    if variant == "v3":
        kw.update(shared_cond_proj=False, num_colors=4)
    return kw


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
@pytest.mark.parametrize("masked", [False, True])
def test_denoiser_matches_flax(variant, masked):
    kw = _variant(variant)
    tree = init_numpy_params("denoiser", seed=1, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    t = np.array([0, 10, 100, 500, 999, 1, 2, 3], np.int32)
    c = (np.arange(8) % 11).astype(np.int32)
    col = (np.arange(8) % 4).astype(np.int32)
    args = (x, t, c, col) if variant == "v3" else (x, t, c)
    mask = np.array([1, 0] * 4, np.float32) if masked else None

    jm = JaxDenoiser(**kw)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                              *map(jnp.asarray, args),
                              cond_mask=None if mask is None else jnp.asarray(mask)))
    model = denoiser_from_params(tree, device="cpu", **kw)
    targs = [torch.from_numpy(a if a.dtype == np.float32 else a.astype(np.int64))
             for a in args]
    with torch.no_grad():
        got = model(*targs, cond_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_null_condition_keeps_projection_biases():
    """cond_mask=0 zeroes the class embedding, not the shared projection's
    bias: with biases zeroed the output changes."""
    tree = init_numpy_params("denoiser", seed=2, **SMALL)
    model = denoiser_from_params(tree, device="cpu", **SMALL)
    x = torch.randn(4, 128, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([5, 50, 500, 900])
    c = torch.tensor([1, 2, 3, 4])
    mask = torch.zeros(4)
    with torch.no_grad():
        base = model(x, t, c, cond_mask=mask)
        model.final_cond_proj.bias.zero_()
        changed = model(x, t, c, cond_mask=mask)
    assert float((base - changed).abs().max()) > 1e-3


def test_hwc_to_chw_index():
    c, h, w = 3, 2, 2
    hwc = np.arange(h * w * c).reshape(h, w, c)
    np.testing.assert_array_equal(hwc.reshape(-1)[hwc_to_chw_index(c, h, w)],
                                  hwc.transpose(2, 0, 1).reshape(-1))


def test_decoder_matches_flax():
    kw = dict(latent_dim=32, channels=(16, 32, 64, 128), head_width=64)
    tree = init_numpy_params("vae", seed=3, **kw)
    z = np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32)
    ref = np.asarray(JaxVAE(**kw).apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(z),
                                        method=JaxVAE.decode))
    vae = vae_from_params(tree, device="cpu", **kw)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)
