"""The sampler's step loop split from its inputs, and the service's `warmup`
and `sample_async`, on the CPU.

On a CUDA device `FusedDiffusionSampler` replays a CUDA graph of
`run_steps`, which reads x_init, the Philox key and the condition rows from
tensors it is handed (`SamplerInputs`) and writes the final x into one. Here
`run_steps` (plain twins on the CPU) is held bit for bit against the host
loop as it stood before the split, and the service's two new entry points
against the JAX service's behaviour: `warmup` runs the live path once per
bucket (tests/test_serving.py `test_warmup_covers_buckets`), `sample_async`
dispatches every chunk of `request_plan` before its `fetch()` and `fetch()`
equals `sample`. The card tests hold the graph itself against the host loop
(tests/test_torch_port_cuda.py).
"""
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.serving import SamplingService as JaxService
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels.full_sampler import (
    _cond_adds,
    draw_request,
    fused_sample,
    key_tensor,
    prepare_fused_sampler,
    reverse_step,
    reverse_step_plain,
    run_steps,
)
from flowerdiff_torch.serving import SamplingService
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    vae_from_params,
)

DEN = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=64, num_classes=11)
VAE = dict(latent_dim=64, channels=(8, 16, 32, 64), head_width=64)
STEPS = 6


def _old_loop(prep, batch, cond, generator, stochastic, clip_x0, guidance_scale):
    """The host loop of `fused_sample` before the split: x_init and the key
    (as two ints) drawn from the generator, the condition adds, then the
    T steps."""
    model = prep["model"]
    x = torch.randn((batch, model.latent_dim), generator=generator)
    key = torch.randint(0, 2**31 - 1, (2,), generator=generator).tolist()
    guided = guidance_scale is not None
    stage_adds, final_add = _cond_adds(prep, cond, None, guided)
    for t in range(prep["n_steps"] - 1, -1, -1):
        h, skip = prep["proj"](x, 2 if guided else 1)
        for i, stage in enumerate(prep["stages"]):
            h = stage(h, stage_adds[i], row_add=prep["tadds"][i][t])
        eps = prep["head"](h, row_add=prep["tadd_final"][t], rows_add=final_add)
        x = reverse_step(eps, x, t, prep["coefs"][t], guidance_scale=guidance_scale,
                         clip_x0=clip_x0, stochastic=stochastic, key=key, skip=skip)
    return x


@torch.no_grad()
@pytest.mark.parametrize("global_skip", [False, True])
@pytest.mark.parametrize("guidance,stochastic", [(None, True), (2.5, True), (2.5, False)])
def test_split_step_loop_with_buffers_equals_the_old_loop(global_skip, guidance, stochastic):
    kw = dict(DEN, global_skip=global_skip)
    model = denoiser_from_params(init_numpy_params("denoiser", seed=30, bias_std=0.3, **kw),
                                 device="cpu", **kw)
    prep = prepare_fused_sampler(model, linear_schedule(STEPS))
    cond = torch.arange(5) % 11
    ref = _old_loop(prep, 5, cond, torch.Generator().manual_seed(31), stochastic, 1.5,
                    guidance)
    step_kw = dict(stochastic=stochastic, clip_x0=1.5, guidance_scale=guidance)
    inputs = draw_request(prep, 5, cond, generator=torch.Generator().manual_seed(31),
                          guided=guidance is not None)
    assert inputs.key.dtype == torch.int32 and inputs.key.shape == (2,)
    # the loop reads only its inputs' tensors: copies of them into other
    # buffers (a graph's own) give the same bits, written into `out`
    buffers = inputs.clone()
    out = torch.full_like(inputs.x, float("nan"))
    got = run_steps(prep, buffers, out=out, **step_kw)
    assert got is out
    assert torch.equal(out, ref)
    assert torch.equal(buffers.x, inputs.x)  # the starting state is left as it was
    assert torch.equal(fused_sample(prep, 5, cond, generator=torch.Generator().manual_seed(31),
                                    **step_kw), ref)


@pytest.mark.parametrize("key", [(7, 8), (2**31 + 5, 2**32 - 1), (0, 2**31)])
def test_reverse_step_plain_takes_a_tensor_key(key):
    g = torch.Generator().manual_seed(32)
    x, eps = torch.randn(3, 24, generator=g), torch.randn(6, 24, generator=g)
    kw = dict(guidance_scale=3.0, clip_x0=1.5)
    ref = reverse_step_plain(eps, x, 5, (0.99, 0.5, 0.01), key=key, **kw)
    words = key_tensor(key, "cpu")
    assert words.dtype == torch.int32
    for k in (words, words.to(torch.int64), torch.tensor(key, dtype=torch.int64)):
        assert torch.equal(reverse_step_plain(eps, x, 5, (0.99, 0.5, 0.01), key=k, **kw), ref)
        assert torch.equal(reverse_step(eps, x, 5, (0.99, 0.5, 0.01), key=k, **kw), ref)
    other = reverse_step_plain(eps, x, 5, (0.99, 0.5, 0.01), key=(key[0] ^ 1, key[1]), **kw)
    assert not torch.equal(other, ref)


def test_reverse_step_writes_into_out():
    g = torch.Generator().manual_seed(33)
    x, eps = torch.randn(3, 16, generator=g), torch.randn(3, 16, generator=g)
    out = torch.zeros_like(x)
    got = reverse_step(eps, x, 2, (0.99, 0.5, 0.01), key=(1, 2), out=out)
    assert got is out
    assert torch.equal(out, reverse_step_plain(eps, x, 2, (0.99, 0.5, 0.01), key=(1, 2)))


def _service(buckets, quantize=True):
    den = denoiser_from_params(init_numpy_params("denoiser", seed=34, **DEN), device="cpu",
                               **DEN)
    vae = vae_from_params(init_numpy_params("vae", seed=35, **VAE), device="cpu", **VAE)
    return SamplingService(den, vae, sched=linear_schedule(STEPS), buckets=buckets,
                           clip_x0=3.0, guidance_scale=2.0, quantize_uint8=quantize,
                           use_fused=True, device="cpu")


def _spy(svc):
    seen = []
    orig = svc.sampler.sample

    def spy(batch, *cond, **kw):
        seen.append(batch)
        return orig(batch, *cond, **kw)

    svc.sampler.sample = spy
    return seen


@pytest.mark.parametrize("buckets,only", [((4,), None), ((4, 8), None), ((4, 8, 16), (8,))])
def test_warmup_covers_buckets(buckets, only):
    svc = _service(buckets)
    seen = _spy(svc)
    svc.warmup(7, buckets=only)
    assert seen == list(only or buckets)


def test_warmup_with_colors_runs_the_color_path():
    kw = dict(DEN, shared_cond_proj=False, num_colors=4)
    den = denoiser_from_params(init_numpy_params("denoiser", seed=36, **kw), device="cpu", **kw)
    vae = vae_from_params(init_numpy_params("vae", seed=35, **VAE), device="cpu", **VAE)
    svc = SamplingService(den, vae, sched=linear_schedule(STEPS), buckets=(4,), use_fused=True,
                          device="cpu")
    conds = []
    orig = svc.sampler.sample

    def spy(batch, *cond, **kw):
        conds.append(len(cond))
        return orig(batch, *cond, **kw)

    svc.sampler.sample = spy
    svc.warmup(with_colors=True)
    assert conds == [2]


@pytest.mark.parametrize("decode", [False, True])
def test_sample_async_dispatches_every_chunk_before_fetch(decode):
    svc = _service((4, 8))
    classes = (np.arange(19) * 5 % 11).astype(np.int64)
    plan = svc.request_plan(19)
    assert plan == [8, 8, 4]
    seen = _spy(svc)
    fetch = svc.sample_async(classes, seed=3, decode=decode)
    assert seen == plan  # every chunk issued, none fetched yet
    got = fetch()
    assert seen == plan
    ref = svc.sample(classes, seed=3, decode=decode)
    assert got.shape == ref.shape == ((19, 64, 64, 3) if decode else (19, 64))
    np.testing.assert_array_equal(got, ref)


def test_sample_async_plan_matches_jax_request_plan():
    den_tree = init_numpy_params("denoiser", seed=0, **DEN)
    vae_tree = init_numpy_params("vae", seed=0, **VAE)
    ref = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                     sched=jax_schedule(STEPS), use_fused=False, buckets=(4,))
    svc = _service((4,), quantize=False)
    seen = _spy(svc)
    out = svc.sample_async(np.arange(9) % 11, seed=1, decode=False)()
    assert seen == ref.request_plan(9) == [4, 4, 4]
    assert out.shape == (9, 64) and out.dtype == np.float32
