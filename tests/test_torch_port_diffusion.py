"""flowerdiff_torch diffusion math and samplers against the JAX package.

The samplers run without step noise (`stochastic=False`) from an injected
x_init, because the two frameworks draw different random streams by design;
the JAX side is the explicit `p_sample_mean` recursion over `model.apply`,
as tests/test_kernels.py:77-140 hold the Pallas sampler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion import ddpm as jddpm
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import ddpm, linear_schedule
from flowerdiff_torch.diffusion.api import (
    DiffusionSampler,
    FusedDiffusionSampler,
    NormalizedSampler,
)
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

SMALL = dict(latent_dim=128, hidden_dims=(128, 256, 128), time_emb_dim=128,
             num_classes=11)


@pytest.mark.parametrize("n_steps", [5, 1000])
def test_schedule_bit_equal(n_steps):
    mine, ref = linear_schedule(n_steps), jax_schedule(n_steps)
    for name in ("beta", "alpha", "alpha_bar"):
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _step_inputs(seed=0, b=6, lat=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, lat)).astype(np.float32)
    eps = rng.standard_normal((b, lat)).astype(np.float32)
    noise = rng.standard_normal((b, lat)).astype(np.float32)
    t = np.array([0, 1, 5, 200, 998, 999][:b], np.int32)
    return x, eps, noise, t


def test_q_sample_matches():
    x, eps, _, t = _step_inputs()
    ref = jddpm.q_sample(jax_schedule(), jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    got = ddpm.q_sample(linear_schedule(), torch.from_numpy(x),
                        torch.from_numpy(t).long(), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("clip", [None, 3.0])
def test_p_sample_with_injected_noise_matches(clip):
    x, eps, noise, t = _step_inputs(1)
    x = 4 * x  # so the x0 clamp binds
    ref = jddpm.p_sample(jax_schedule(), jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(eps), jnp.asarray(noise), clip)
    got = ddpm.p_sample(linear_schedule(), torch.from_numpy(x),
                        torch.from_numpy(t).long(), torch.from_numpy(eps),
                        torch.from_numpy(noise), clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _jax_recursion(tree, kw, x, c, n_steps, guidance, clip):
    model, sched = JaxDenoiser(**kw), jax_schedule(n_steps)
    p = jax.tree.map(jnp.asarray, tree)
    xr, cj = jnp.asarray(x), jnp.asarray(c)
    b = x.shape[0]
    for t in range(n_steps - 1, -1, -1):
        tv = jnp.full((b,), t, jnp.int32)
        if guidance is None:
            e = model.apply(p, xr, tv, cj)
        else:
            e_c = model.apply(p, xr, tv, cj, cond_mask=jnp.ones((b,)))
            e_u = model.apply(p, xr, tv, cj, cond_mask=jnp.zeros((b,)))
            e = e_u + guidance * (e_c - e_u)
        xr = jddpm.p_sample_mean(sched, xr, tv, e, clip)
    return np.asarray(xr)


@pytest.mark.parametrize("guidance,clip", [(None, None), (2.5, None), (2.5, 1.0)])
def test_samplers_match_jax_recursion(guidance, clip):
    """The plain sampler (f32 model) and the kernel sampler (plain twins on
    the CPU) against the same JAX recursion; nonzero biases, so the null
    rows of guidance carry the projection biases."""
    tree = init_numpy_params("denoiser", seed=4, **SMALL)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    c = (np.arange(8) % 11).astype(np.int32)
    ref = _jax_recursion(tree, SMALL, x, c, 5, guidance, clip)

    model = denoiser_from_params(tree, device="cpu", **SMALL)
    kw = dict(clip_x0=clip, guidance_scale=guidance, device="cpu")
    ct, xt = torch.from_numpy(c.astype(np.int64)), torch.from_numpy(x)
    plain = DiffusionSampler(model, linear_schedule(5), (128,), **kw).sample(
        8, ct, x_init=xt, stochastic=False).numpy()
    fused = FusedDiffusionSampler(model, linear_schedule(5), (128,), **kw).sample(
        8, ct, x_init=xt, stochastic=False).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(plain, ref, atol=1e-4 * scale)
    np.testing.assert_allclose(fused, ref, atol=3e-2 * scale)


def test_fused_sampler_v3_and_v2_run():
    for extra in (dict(global_skip=True), dict(shared_cond_proj=False, num_colors=4)):
        kw = dict(SMALL, **extra)
        model = denoiser_from_params(init_numpy_params("denoiser", seed=6, **kw),
                                     device="cpu", **kw)
        c = torch.arange(4) % 11
        cond = (c, c % 4) if "num_colors" in extra else (c,)
        x = torch.randn(4, 128, generator=torch.Generator().manual_seed(0))
        plain = DiffusionSampler(model, linear_schedule(3), (128,), device="cpu",
                                 guidance_scale=2.0).sample(4, *cond, x_init=x,
                                                            stochastic=False)
        fused = FusedDiffusionSampler(model, linear_schedule(3), (128,), device="cpu",
                                      guidance_scale=2.0).sample(4, *cond, x_init=x,
                                                                 stochastic=False)
        scale = float(plain.abs().max())
        np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=3e-2 * scale)


def test_stochastic_sampling_is_seeded_and_normalized():
    model = denoiser_from_params(init_numpy_params("denoiser", seed=7, **SMALL),
                                 device="cpu", **SMALL)
    inner = FusedDiffusionSampler(model, linear_schedule(4), (128,), device="cpu",
                                  clip_x0=3.0, guidance_scale=3.0)
    mean, std = np.full(128, 2.0, np.float32), np.full(128, 0.5, np.float32)
    norm = NormalizedSampler(inner, mean, std)
    c = torch.arange(5)

    def run(seed):
        return norm.sample(5, c, generator=torch.Generator().manual_seed(seed))

    a, b, other = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, other)
    raw = inner.sample(5, c, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(a.numpy(), (raw * 0.5 + 2.0).numpy(), rtol=0, atol=0)
    assert torch.isfinite(a).all() and float(raw.abs().max()) < 10
