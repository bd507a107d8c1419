"""Two contracts of the port's sampling path against the JAX package, and the
order of the train step's split-K sum, on the CPU.

1. `SamplingService` returns the decoder's float32 images by default and
   uint8 only with `quantize_uint8=True`, as flowerdiff/serving.py does.
2. The kernel sampler's step is the projection kernel (its twin here), the
   stages, the head and the reverse step with the v2 skip: driven through
   `fused_sample` for a v2 model with nonzero biases and held against the
   JAX model's guided reverse steps, with no step noise from a fixed x_init.
3. The order of the split-K sum of the train step's bf16 Y and dX products
   (the library's plan, which the card tests pin): its partial sums added in
   rank order agree with one f32 sum. This documents the order; the card
   tests hold the kernel itself (bit-equal on repeat, the three forms
   against f32 references).
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
from flowerdiff_torch.kernels.full_sampler import latent_proj_plain
from flowerdiff_torch.serving import SamplingService
from flowerdiff_torch.tools.gemm_ab import step_products
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    vae_from_params,
)
from test_torch_port_cuda import SPLITK_PLAN

DEN = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=64, num_classes=11)
VAE = dict(latent_dim=64, channels=(8, 16, 32, 64), head_width=64)
STEPS = 5
# The decoder against flax: f32 sums in another order (tests/test_torch_port_models.py).
DECODE_ATOL = 1e-4
# The kernel sampler against the f32 JAX recursion: bf16 operands in every
# kernel product (tests/test_torch_port_diffusion.py).
SAMPLER_REL = 3e-2


def _trees():
    return (init_numpy_params("denoiser", seed=20, **DEN),
            init_numpy_params("vae", seed=21, **VAE))


def _services(quantize, buckets=(4, 8)):
    den_tree, vae_tree = _trees()
    port = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                           vae_from_params(vae_tree, device="cpu", **VAE),
                           sched=linear_schedule(STEPS), buckets=buckets,
                           quantize_uint8=quantize, device="cpu")
    ref = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                     sched=jax_schedule(STEPS), use_fused=False, buckets=buckets,
                     quantize_uint8=quantize)
    return port, ref, den_tree, vae_tree


def _jax_recursion(tree, kw, x, c, guidance, clip=None):
    model, sched = JaxDenoiser(**kw), jax_schedule(STEPS)
    apply = jax.jit(model.apply)
    p = jax.tree.map(jnp.asarray, tree)
    xr, cj, b = jnp.asarray(x), jnp.asarray(c), x.shape[0]
    for t in range(STEPS - 1, -1, -1):
        tv = jnp.full((b,), t, jnp.int32)
        e_c = apply(p, xr, tv, cj, cond_mask=jnp.ones((b,)))
        e_u = apply(p, xr, tv, cj, cond_mask=jnp.zeros((b,)))
        xr = jax_p_sample_mean(sched, xr, tv, e_u + guidance * (e_c - e_u), clip)
    return np.asarray(xr)


@pytest.mark.parametrize("quantize", [False, True])
def test_decode_latents_follows_the_reference_contract(quantize):
    """f32 images by default, uint8 with quantize_uint8, against the JAX
    service's decode of the same latents (11 rows: a full bucket and a
    padded tail)."""
    port, ref, *_ = _services(quantize)
    lat = np.random.default_rng(22).standard_normal((11, 64)).astype(np.float32)
    got, want = port.decode_latents(lat), np.asarray(ref.decode_latents(lat))
    assert got.shape == want.shape == (11, 64, 64, 3)
    if quantize:
        assert got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        # DECODE_ATOL moves a value across a rounding boundary of 1/255 rarely
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=DECODE_ATOL)


def test_sample_returns_f32_images_by_default():
    """sample(...) of the default service: the decoder's f32 output of the
    guided, denormalised kernel sampler, against the JAX recursion decoded
    by the JAX service (its sampler cannot take an x_init, so the latents
    come from the same oracle as tests/test_torch_port_serving.py's)."""
    den_tree, vae_tree = _trees()
    rng = np.random.default_rng(23)
    stats = (rng.normal(0, 0.5, 64).astype(np.float32),
             rng.uniform(0.8, 1.5, 64).astype(np.float32))
    svc = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                          vae_from_params(vae_tree, device="cpu", **VAE),
                          sched=linear_schedule(STEPS), buckets=(4, 8), latent_stats=stats,
                          guidance_scale=3.0, use_fused=True, device="cpu")
    ref_svc = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                         sched=jax_schedule(STEPS), use_fused=False, buckets=(4, 8))
    n = 6
    x = rng.standard_normal((n, 64)).astype(np.float32)
    c = (np.arange(n) * 2 % 11).astype(np.int32)
    got = svc.sample(c, x_init=x, stochastic=False)
    lat = _jax_recursion(den_tree, DEN, x, c, 3.0) * stats[1] + stats[0]
    want = np.asarray(ref_svc.decode_latents(lat))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (n, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=SAMPLER_REL * float(np.abs(want).max()))
    # the same request quantised: the uint8 contract of the reference
    q = SamplingService(svc.model, svc.vae, sched=linear_schedule(STEPS), buckets=(4, 8),
                        latent_stats=stats, guidance_scale=3.0, quantize_uint8=True,
                        use_fused=True, device="cpu").sample(c, x_init=x, stochastic=False)
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(
        q, np.round(np.clip(got, 0.0, 1.0) * 255.0).astype(np.uint8))


@pytest.mark.parametrize("guidance", [None, 2.5])
def test_kernel_sampler_v2_skip_and_null_rows_follow_the_model(guidance):
    """A v2 model with nonzero biases (the CFG null rows keep the projection
    biases) through `fused_sample`: the projection twin's h and skip, the
    skip added to both halves of eps in the reverse step's twin; against
    the JAX model's guided reverse steps. The step never calls the module's
    own latent projection or final layer."""
    kw = dict(DEN, global_skip=True)
    tree = init_numpy_params("denoiser", seed=24, bias_std=0.3, **kw)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    c = (np.arange(6) % 11).astype(np.int32)
    if guidance is None:
        model, sched = JaxDenoiser(**kw), jax_schedule(STEPS)
        p, xr = jax.tree.map(jnp.asarray, tree), jnp.asarray(x)
        for t in range(STEPS - 1, -1, -1):
            tv = jnp.full((6,), t, jnp.int32)
            xr = jax_p_sample_mean(sched, xr, tv, model.apply(p, xr, tv, jnp.asarray(c)), 1.0)
        ref = np.asarray(xr)
    else:
        ref = _jax_recursion(tree, kw, x, c, guidance, 1.0)
    model = denoiser_from_params(tree, device="cpu", **kw)
    sampler = FusedDiffusionSampler(model, linear_schedule(STEPS), (64,), clip_x0=1.0,
                                    guidance_scale=guidance, device="cpu")

    def refuse(*_):
        raise AssertionError("the kernel sampler's step called a module product")

    hooks = [model.latent_proj.register_forward_hook(refuse),
             model.final.register_forward_hook(refuse)]
    try:
        got = sampler.sample(6, torch.from_numpy(c.astype(np.int64)),
                             x_init=torch.from_numpy(x), stochastic=False).numpy()
    finally:
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(got, ref, atol=SAMPLER_REL * float(np.abs(ref).max()))
    # without the skip the recursion lands elsewhere: the skip is in the step
    no_skip = denoiser_from_params(tree, device="cpu", **DEN)
    other = FusedDiffusionSampler(no_skip, linear_schedule(STEPS), (64,), clip_x0=1.0,
                                  guidance_scale=guidance, device="cpu").sample(
        6, torch.from_numpy(c.astype(np.int64)), x_init=torch.from_numpy(x),
        stochastic=False).numpy()
    assert np.abs(other - ref).max() > 10 * SAMPLER_REL * float(np.abs(ref).max())


def test_latent_proj_twin_is_the_reference_mm():
    """h = bf16(x) Wl + bl as the reference's `_mm` computes it (the CFG copy
    is the same rows twice), and the skip sigmoid(rw) (bf16(x) Wf + bf) as
    flowerdiff/kernels/denoiser_apply.py:142-145 does."""
    rng = np.random.default_rng(26)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    wl, bl = rng.standard_normal((64, 32)).astype(np.float32) / 8, rng.standard_normal(32)
    wf, bf = rng.standard_normal((64, 64)).astype(np.float32) / 8, rng.standard_normal(64)
    bl, bf, rw = bl.astype(np.float32), bf.astype(np.float32), np.float32(0.4)

    def mm(a, w, b):
        return jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) + b

    h, skip = latent_proj_plain(
        torch.from_numpy(x), torch.from_numpy(wl.T.copy()).to(torch.bfloat16),
        torch.from_numpy(bl), copies=2, wf=torch.from_numpy(wf.T.copy()).to(torch.bfloat16),
        bf=torch.from_numpy(bf), rw=torch.tensor(rw))
    ref_h = np.asarray(mm(x, wl, bl))
    ref_skip = np.asarray(jax.nn.sigmoid(rw) * mm(x, wf, bf))
    np.testing.assert_allclose(h.numpy(), np.concatenate([ref_h, ref_h]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(skip.numpy(), ref_skip, rtol=1e-6, atol=1e-6)


def _splitk_sum(a, b, s, kc):
    """sum_k a[m, k] b[n, k] in the order of the split-K kernel's final sum:
    each block's partial over its slice of K in f32, then the partials added
    one block after another in rank order, starting from zero. The order
    inside a partial (the tensor cores' k16 steps) is not modelled."""
    out = torch.zeros((a.shape[0], b.shape[0]))
    for r in range(s):
        out = out + a[:, r * kc:(r + 1) * kc] @ b[:, r * kc:(r + 1) * kc].t()
    return out


@pytest.mark.parametrize("form,m,n,k", [key for key in step_products() if key[0] != "dw"]
                         + [("fwd", 64, 36, 1000), ("fwd", 13, 40, 96)])
def test_splitk_rank_order_sum_matches_one_f32_sum(form, m, n, k):
    """The flagship step's Y and dX products (M = 64 rows), and two ragged K:
    s blocks a cluster (a power of two that divides the 64-row tile, so each
    block finishes 64 / s of its rows), one or two 64-deep tiles a block,
    slices that cover K once; their partials added in rank order within 1e-6
    of the largest value of one f32 sum of the same bf16 operands. The plan
    is the library's, held to SPLITK_PLAN on the card."""
    s, kc = SPLITK_PLAN[k]
    assert s in (1, 2, 4, 8) and 64 % s == 0
    assert kc % 64 == 0 and 1 <= kc // 64 <= 2
    assert (s - 1) * kc < k <= s * kc  # every block but none past the last has work
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(torch.bfloat16).float()
    b = (torch.randn(n, k, generator=g) * k ** -0.5).to(torch.bfloat16).float()
    got = _splitk_sum(a, b, s, kc)
    ref = a @ b.t()
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
