"""The port's slice as a whole: SamplingService against a JAX oracle.

Same seeded weights on both sides, injected x_init, no step noise; the JAX
oracle is the guided, x0-clipped `p_sample_mean` recursion over
`model.apply`, z-score denormalisation, `vae.apply(decode)` and the uint8
quantisation of serving.py:107-113. The port runs its kernel path (plain
twins on the CPU) through bucketing and padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion.ddpm import p_sample_mean as jax_p_sample_mean
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.serving import SamplingService as JaxService
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.api import FusedDiffusionSampler
from flowerdiff_torch.serving import SamplingService
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    vae_from_params,
)

DEN = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=64, num_classes=11)
VAE = dict(latent_dim=64, channels=(8, 16, 32, 64), head_width=64)
# Guidance multiplies the kernels' bf16 error in eps by up to 1 + 2s; at
# s = 3 the uint8 images agree to one level on >99.9% of pixels (at the
# flagship's 7.0, ~99.2%). The flagship scale is held on the card instead
# (chip_smoke.py, kernel sampler vs the f32 model).
GUIDANCE, CLIP, STEPS = 3.0, 3.0, 5


def _port(buckets=(4, 8), guidance=GUIDANCE):
    den_tree = init_numpy_params("denoiser", seed=10, **DEN)
    vae_tree = init_numpy_params("vae", seed=11, **VAE)
    rng = np.random.default_rng(12)
    stats = (rng.normal(0, 0.5, 64).astype(np.float32),
             rng.uniform(0.8, 1.5, 64).astype(np.float32))
    svc = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                          vae_from_params(vae_tree, device="cpu", **VAE),
                          sched=linear_schedule(STEPS), buckets=buckets,
                          latent_stats=stats, clip_x0=CLIP,
                          guidance_scale=guidance, quantize_uint8=True, use_fused=True,
                          device="cpu")
    return svc, den_tree, vae_tree, stats


def _jax_oracle(den_tree, vae_tree, stats, x, c):
    apply, sched = jax.jit(JaxDenoiser(**DEN).apply), jax_schedule(STEPS)
    p = jax.tree.map(jnp.asarray, den_tree)
    xr, cj, b = jnp.asarray(x), jnp.asarray(c), x.shape[0]
    for t in range(STEPS - 1, -1, -1):
        tv = jnp.full((b,), t, jnp.int32)
        e_c = apply(p, xr, tv, cj, cond_mask=jnp.ones((b,)))
        e_u = apply(p, xr, tv, cj, cond_mask=jnp.zeros((b,)))
        xr = jax_p_sample_mean(sched, xr, tv, e_u + GUIDANCE * (e_c - e_u), CLIP)
    lat = xr * stats[1] + stats[0]
    img = JaxVAE(**VAE).apply(jax.tree.map(jnp.asarray, vae_tree), lat,
                              method=JaxVAE.decode)
    return np.asarray(jnp.round(jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8))


def test_sampling_service_matches_jax_oracle():
    svc, den_tree, vae_tree, stats = _port()
    n = 11  # plan [8, 4]: one full bucket and one padded tail
    assert svc.request_plan(n) == [8, 4]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    c = (np.arange(n) * 3 % 11).astype(np.int32)
    got = svc.sample(c, x_init=x, stochastic=False)
    ref = _jax_oracle(den_tree, vae_tree, stats, x, c)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (n, 64, 64, 3)
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    # bf16 kernel operands move a few pixels across a rounding boundary
    assert (diff <= 1).mean() >= 0.99, f"max diff {diff.max()}, mean {diff.mean()}"


def test_guidance_scale_reaches_the_sampler():
    """The reference service drops guidance_scale; the port threads it."""
    guided, *_ = _port(guidance=GUIDANCE)
    plain, *_ = _port(guidance=None)
    x = np.random.default_rng(14).standard_normal((3, 64)).astype(np.float32)
    c = np.array([1, 2, 3])
    a = guided.sample(c, x_init=x, stochastic=False, decode=False)
    b = plain.sample(c, x_init=x, stochastic=False, decode=False)
    assert np.abs(a - b).max() > 1e-3
    inner = guided.sampler._inner
    assert isinstance(inner, FusedDiffusionSampler) and inner.guidance_scale == GUIDANCE


def test_seeded_requests_are_reproducible_and_decode_matches():
    svc, *_ = _port()
    a = svc.sample_classes([1, 5], 3, seed=4)
    assert a.shape == (6, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, svc.sample_classes([1, 5], 3, seed=4))
    assert not np.array_equal(a, svc.sample_classes([1, 5], 3, seed=5))
    lat = svc.sample_latents(np.array([1, 1, 1, 5, 5, 5]), seed=4)
    np.testing.assert_array_equal(svc.decode_latents(lat), a)


@pytest.mark.parametrize("buckets", [(8, 16, 32, 64, 128, 256, 512), (4, 8), (8, 64)])
def test_bucketing_matches_jax_service(buckets):
    den_tree = init_numpy_params("denoiser", seed=0, **DEN)
    vae_tree = init_numpy_params("vae", seed=0, **VAE)
    ref = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                     sched=jax_schedule(STEPS), use_fused=False, buckets=buckets)
    svc = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                          vae_from_params(vae_tree, device="cpu", **VAE),
                          sched=linear_schedule(STEPS), buckets=buckets, device="cpu")
    for n in (1, 3, 4, 5, 8, 9, 50, 64, 65, 70, 129, 513, 1100):
        assert svc.request_plan(n) == ref.request_plan(n)
        if n <= buckets[-1]:
            assert svc.bucket_size(n) == ref.bucket_size(n)
        else:
            with pytest.raises(ValueError):
                svc.bucket_size(n)


def test_quantize_rounds_half_to_even_like_jnp():
    from flowerdiff_torch.serving import quantize_uint8

    img = np.array([0.5, 1.5, 2.5, 254.5, -3.0, 300.0], np.float32) / 255.0
    ref = np.asarray(jnp.round(jnp.clip(jnp.asarray(img), 0.0, 1.0) * 255.0).astype(jnp.uint8))
    np.testing.assert_array_equal(quantize_uint8(torch.from_numpy(img)).numpy(), ref)
