"""flowerdiff_torch's DDIM, partial and trajectory samplers and the service's
sampler options on the CPU against the JAX package, at small widths.

DDIM is held against the reference's own `DiffusionSampler.ddim` with
x_init reproduced from its init key (eta = 0 draws no noise that counts).
The partial and trajectory samplers run without step noise and are held
against the explicit `p_sample_mean` recursion over `model.apply`, each in
its own step order: diffusion/sampler.py's `sample_from(x, t)` runs the
steps t-1 .. 0, diffusion/api.py's `sample_from` and `masked_denoise` run
t_start .. 0. Tolerances are 1e-4 x max|ref| (f32 models on both sides,
sums in another order) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion import ddpm as jddpm
from flowerdiff.diffusion.api import DDIMSampler as JaxDDIM
from flowerdiff.diffusion.api import DiffusionSampler as JaxSampler
from flowerdiff.diffusion.api import NormalizedSampler as JaxNormalized
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.serving import SamplingService as JaxService
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion import sampler as port_sampler
from flowerdiff_torch.diffusion.api import (
    DDIMSampler,
    DiffusionSampler,
    FusedDiffusionSampler,
    NormalizedSampler,
)
from flowerdiff_torch.serving import SamplingService
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    state_dict_to_flax,
    vae_from_params,
)

DEN = dict(latent_dim=32, hidden_dims=(32, 64, 32), time_emb_dim=32, num_classes=7)
VAE = dict(latent_dim=32, channels=(8, 16, 32, 64), head_width=32)  # 64 x 64 images
REL = 1e-4


def _tree(seed=1):
    # nonzero biases: the null rows of guidance carry them
    return init_numpy_params("denoiser", seed=seed, bias_std=0.2, **DEN)


def _cond(b=6):
    return (np.arange(b) * 3 % 7).astype(np.int32)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _jax_eps(tree, guidance):
    apply, p = jax.jit(JaxDenoiser(**DEN).apply), jax.tree.map(jnp.asarray, tree)

    def eps(x, t, c):
        if guidance is None:
            return apply(p, x, t, c)
        b = x.shape[0]
        e_c = apply(p, x, t, c, cond_mask=jnp.ones((b,)))
        e_u = apply(p, x, t, c, cond_mask=jnp.zeros((b,)))
        return e_u + guidance * (e_c - e_u)

    return eps


def _recursion(tree, x, c, ts, guidance, clip, n_steps, collect=False):
    """The p_sample_mean recursion over `model.apply` at the steps `ts`."""
    eps, sched = _jax_eps(tree, guidance), jax_schedule(n_steps)
    xr, cj, states = jnp.asarray(x), jnp.asarray(c), []
    for t in ts:
        tv = jnp.full((x.shape[0],), t, jnp.int32)
        xr = jddpm.p_sample_mean(sched, xr, tv, eps(xr, tv, cj), clip)
        states.append(np.asarray(xr))
    return (np.asarray(xr), np.stack(states)) if collect else np.asarray(xr)


def _port(tree=None, n_steps=20, guidance=None, clip=None, cls=DiffusionSampler):
    model = denoiser_from_params(_tree() if tree is None else tree, device="cpu", **DEN)
    return cls(model, linear_schedule(n_steps), (DEN["latent_dim"],), clip_x0=clip,
               guidance_scale=guidance, device="cpu")


@pytest.mark.parametrize("n_steps", [50, 1000])
def test_ddim_timesteps_match_jax(n_steps):
    for num in (1, 2, 3, 7, 10, 49, 50, n_steps):
        idx = jax.lax.iota(jnp.float32, num)
        ref = jnp.round(idx * ((n_steps - 1) / max(num - 1, 1))).astype(jnp.int32)[::-1]
        got = port_sampler.ddim_timesteps(n_steps, num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert port_sampler.ddim_timesteps(n_steps, 1).tolist() == [0]


@pytest.mark.parametrize("num_steps", [1, 10, 50])
@pytest.mark.parametrize("guidance", [None, 3.0])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_ddim_matches_jax(num_steps, guidance, clip):
    """On a 50-step schedule, eta 0, the reference's jitted
    `DiffusionSampler.ddim`; x_init is its normal draw from split(rng)[0]."""
    tree, c, rng = _tree(), _cond(), jax.random.key(num_steps)
    ref = JaxSampler(JaxDenoiser(**DEN), tree, jax_schedule(50), (32,), clip_x0=clip,
                     guidance_scale=guidance).ddim(rng, 6, jnp.asarray(c), num_steps=num_steps)
    x = np.array(jax.random.normal(jax.random.split(rng)[0], (6, 32), jnp.float32))
    port = _port(n_steps=50, guidance=guidance, clip=clip)
    got = port.ddim(6, torch.from_numpy(c).long(), num_steps=num_steps,
                    x_init=torch.from_numpy(x))
    _close(got, ref)
    if clip is not None:  # the clip binds: without it the result moves
        free = _port(n_steps=50, guidance=guidance).ddim(
            6, torch.from_numpy(c).long(), num_steps=num_steps, x_init=torch.from_numpy(x))
        assert float((free - got).abs().max()) > 100 * REL * float(np.abs(ref).max())


def test_ddim_draws_step_noise_only_with_eta():
    """eta 0 (the api's DDIM) takes nothing from the generator: sigma is 0
    and the reference's draws are multiplied away. eta > 0 takes one draw a
    step, and moves the result; the same seed repeats it."""
    port, c = _port(n_steps=50), torch.from_numpy(_cond()).long()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((6, 32)).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    det = port_sampler.ddim_sample(port.sched, port._eps, (6, 32), c, num_steps=10, x_init=x,
                                   generator=g)
    assert torch.equal(g.get_state(), state)
    assert torch.equal(det, port.ddim(6, c, num_steps=10, x_init=x))

    def noisy(seed):
        return port_sampler.ddim_sample(port.sched, port._eps, (6, 32), c, num_steps=10,
                                        eta=0.5, x_init=x,
                                        generator=torch.Generator().manual_seed(seed))

    a = noisy(2)
    assert torch.equal(a, noisy(2)) and not torch.equal(a, noisy(3))
    assert float((a - det).abs().max()) > 1e-2


@pytest.mark.parametrize("guidance,clip", [(None, None), (3.0, 1.0)])
def test_sampler_sample_from_runs_t_start_steps(guidance, clip):
    tree, c = _tree(), _cond()
    x = np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32)
    port = _port(guidance=guidance, clip=clip)
    got = port_sampler.sample_from(port.sched, port._eps, torch.from_numpy(x), 7,
                                   torch.from_numpy(c).long(), clip_x0=clip, stochastic=False)
    _close(got, _recursion(tree, x, c, range(6, -1, -1), guidance, clip, 20))


@pytest.mark.parametrize("guidance,clip", [(None, None), (3.0, 1.0)])
def test_masked_denoise_takes_each_chains_own_steps(guidance, clip):
    """Chain i takes the steps t_start[i] .. 0; a chain with t_start -1
    stays where it was. Each chain's oracle is its own recursion."""
    tree, c = _tree(), _cond()
    x = np.random.default_rng(3).standard_normal((6, 32)).astype(np.float32)
    t_start = np.array([19, 12, 5, 0, -1, 19])
    port = _port(guidance=guidance, clip=clip)
    got = port.masked_denoise(torch.from_numpy(x), torch.from_numpy(t_start),
                              torch.from_numpy(c).long(), stochastic=False).numpy()
    for i, t0 in enumerate(t_start):
        ref = _recursion(tree, x[i:i + 1], c[i:i + 1], range(t0, -1, -1), guidance, clip, 20)
        _close(got[i:i + 1], ref)
    np.testing.assert_array_equal(got[4], x[4])
    full = port.sample(6, torch.from_numpy(c).long(), x_init=torch.from_numpy(x),
                       stochastic=False).numpy()
    np.testing.assert_array_equal(got[[0, 5]], full[[0, 5]])  # t_start T-1: the whole process
    api = port.sample_from(torch.from_numpy(x), 12, torch.from_numpy(c).long(), stochastic=False)
    np.testing.assert_array_equal(api.numpy()[1], got[1])


def test_sample_with_trajectory_collects_every_state():
    tree, c = _tree(), _cond()
    x = np.random.default_rng(4).standard_normal((6, 32)).astype(np.float32)
    port = _port(guidance=3.0, clip=1.0)
    x0, traj = port.sample_with_trajectory(6, torch.from_numpy(c).long(),
                                           x_init=torch.from_numpy(x), stochastic=False)
    ref_x0, ref_traj = _recursion(tree, x, c, range(19, -1, -1), 3.0, 1.0, 20, collect=True)
    assert traj.shape == (20, 6, 32)
    assert torch.equal(traj[-1], x0)
    _close(x0, ref_x0)
    for i in range(20):  # trajectory[i]: the state after the step at t = 19 - i
        _close(traj[i], ref_traj[i])
    plain = port.sample(6, torch.from_numpy(c).long(), x_init=torch.from_numpy(x),
                        stochastic=False)
    assert torch.equal(plain, x0)


def test_the_two_sample_froms_differ_by_exactly_one_step():
    """diffusion/sampler.py's sample_from(x, t + 1) runs t .. 0, as the
    api's sample_from(x, t) does: equal bit for bit; sampler.sample_from(x,
    t) stops one step short of the api's."""
    c = torch.from_numpy(_cond()).long()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 32)).astype(np.float32))
    port = _port(guidance=2.0, clip=1.0)
    for t in (0, 7, 19):
        api = port.sample_from(x, t, c, stochastic=False)
        one_more = port_sampler.sample_from(port.sched, port._eps, x, t + 1, c, clip_x0=1.0,
                                            stochastic=False)
        assert torch.equal(api, one_more)
        short = port_sampler.sample_from(port.sched, port._eps, x, t, c, clip_x0=1.0,
                                         stochastic=False)
        assert not torch.equal(api, short)
    assert torch.equal(port_sampler.sample_from(port.sched, port._eps, x, 0, c), x)
    # stochastic: one draw a step from the generator, repeatable
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    a = port.masked_denoise(x, torch.full((6,), 7), c, generator=g())
    assert torch.equal(a, port.masked_denoise(x, torch.full((6,), 7), c, generator=g()))
    assert not torch.equal(a, port.masked_denoise(x, torch.full((6,), 7), c, stochastic=False))


@pytest.mark.parametrize("ddim_outside", [True, False])
def test_ddim_and_normalized_samplers_compose_like_jax(ddim_outside):
    """DDIMSampler outside or inside NormalizedSampler: `sample` is the
    denormalised DDIM, against the reference's composition; every other
    entry point passes through."""
    tree, c, rng = _tree(), _cond(), jax.random.key(11)
    r = np.random.default_rng(6)
    mean, std = r.normal(0, 0.5, 32).astype(np.float32), r.uniform(0.5, 2, 32).astype(np.float32)
    jinner = JaxSampler(JaxDenoiser(**DEN), tree, jax_schedule(20), (32,), clip_x0=1.0)
    ref = (JaxDDIM(JaxNormalized(jinner, mean, std), 5) if ddim_outside
           else JaxNormalized(JaxDDIM(jinner, 5), mean, std)).sample(rng, 6, jnp.asarray(c))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], (6, 32))))
    inner = _port(clip=1.0, cls=FusedDiffusionSampler)
    s = (DDIMSampler(NormalizedSampler(inner, mean, std), 5) if ddim_outside
         else NormalizedSampler(DDIMSampler(inner, 5), mean, std))
    ct = torch.from_numpy(c).long()
    got = s.sample(6, ct, x_init=x)
    _close(got, ref)
    assert torch.equal(got, inner.ddim(6, ct, num_steps=5, x_init=x) * s.std + s.mean)
    # the trajectory and masked entry points stay ancestral (plain model)
    x0, traj = s.sample_with_trajectory(6, ct, x_init=x, stochastic=False)
    plain = DiffusionSampler(inner.model, inner.sched, (32,), clip_x0=1.0, device="cpu")
    want = plain.sample(6, ct, x_init=x, stochastic=False) * s.std + s.mean
    assert torch.equal(x0, want) and torch.equal(traj[-1], x0)
    assert s.latent_dim == 32 and s.sched is inner.sched
    z = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    norm = s if not ddim_outside else s._inner
    np.testing.assert_allclose(norm.normalize(norm._denorm(z)).numpy(), z.numpy(), atol=1e-5)
    e = s.eps(x, torch.full((6,), 3), ct)
    assert torch.equal(e, plain.eps(x, torch.full((6,), 3), ct))


def _trees():
    return _tree(seed=20), init_numpy_params("vae", seed=21, **VAE)


def _stats():
    r = np.random.default_rng(23)
    return r.normal(0, 0.5, 32).astype(np.float32), r.uniform(0.8, 1.5, 32).astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True])
def test_ddim_service_matches_the_jax_service(quantize):
    """sampler_kind='ddim' (DDIM outside the codec), 11 images in buckets
    [8, 4]: chunk i of the reference draws x from split(fold_in(rng, i))[0]
    over its whole bucket; the port takes those rows as x_init. Latents
    1e-4 x max; f32 images within 1e-3 of the reference's decode (the
    latents' error through the decoder), uint8 within one level."""
    den_tree, vae_tree = _trees()
    stats, rng, n = _stats(), jax.random.key(7), 11
    kw = dict(buckets=(4, 8), latent_stats=stats, clip_x0=1.0, sampler_kind="ddim",
              ddim_steps=10, quantize_uint8=quantize)
    ref_svc = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                         sched=jax_schedule(20), use_fused=False, **kw)
    svc = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                          vae_from_params(vae_tree, device="cpu", **VAE),
                          sched=linear_schedule(20), device="cpu", **kw)
    assert isinstance(svc.sampler, DDIMSampler) and not svc.use_fused
    assert type(svc.sampler._inner._inner) is DiffusionSampler
    c = (np.arange(n) % 7).astype(np.int32)
    plan = svc.request_plan(n)
    assert plan == ref_svc.request_plan(n) == [8, 4]
    xs = [np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(rng, i))[0],
                                       (b, 32), jnp.float32)) for i, b in enumerate(plan)]
    x = np.concatenate([xs[0][:8], xs[1][:3]])
    lat = svc.sample(c, x_init=x, decode=False)
    _close(lat, ref_svc.sample(jnp.asarray(c), rng, decode=False))
    got, want = svc.sample(c, x_init=x), np.asarray(ref_svc.sample(jnp.asarray(c), rng))
    assert got.dtype == want.dtype and got.shape == want.shape == (n, 64, 64, 3)
    if quantize:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_use_fused_picks_the_kernel_path_on_cuda_only():
    """use_fused=None is the kernel path on a CUDA device and the plain f32
    model elsewhere (the reference: on a TPU). On the CPU the plain model
    matches the JAX recursion at 1e-4, the kernels' twins at their bf16
    3e-2 (tests/test_torch_port_diffusion.py)."""
    den_tree, vae_tree = _trees()
    svcs = {f: SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                               vae_from_params(vae_tree, device="cpu", **VAE),
                               sched=linear_schedule(5), buckets=(8,), guidance_scale=2.0,
                               use_fused=f, device="cpu") for f in (None, False, True)}
    assert not svcs[None].use_fused and type(svcs[None].sampler) is DiffusionSampler
    assert type(svcs[False].sampler) is DiffusionSampler
    assert type(svcs[True].sampler) is FusedDiffusionSampler and svcs[True].use_fused
    c = _cond()
    x = np.random.default_rng(8).standard_normal((6, 32)).astype(np.float32)
    ref = _recursion(den_tree, x, c, range(4, -1, -1), 2.0, None, 5)
    for f, rel in ((None, REL), (True, 3e-2)):
        _close(svcs[f].sample(c, x_init=x, stochastic=False, decode=False), ref, rel)


def test_decode_bf16_is_within_quantisation_of_f32():
    """decode_bf16: the decoder under bf16 autocast, output f32, against
    the f32 decode and the reference's bf16 service: mean abs difference
    under 1/255 and max under 16/255, as tests/test_bf16_resident.py holds
    the reference's bf16 decode."""
    den_tree, vae_tree = _trees()
    z = np.random.default_rng(9).standard_normal((11, 32)).astype(np.float32) * 2.0
    out = {}
    for bf16 in (False, True):
        svc = SamplingService(denoiser_from_params(den_tree, device="cpu", **DEN),
                              vae_from_params(vae_tree, device="cpu", **VAE),
                              sched=linear_schedule(5), buckets=(4, 8), decode_bf16=bf16,
                              device="cpu")
        out[bf16] = svc.decode_latents(z)
        assert out[bf16].dtype == np.float32 and out[bf16].shape == (11, 64, 64, 3)
    ref = JaxService(JaxDenoiser(**DEN), den_tree, JaxVAE(**VAE), vae_tree,
                     sched=jax_schedule(5), use_fused=False, buckets=(4, 8), decode_bf16=True)
    ref16 = np.asarray(ref.decode_latents(jnp.asarray(z)), np.float32)
    for a, b in ((out[True], out[False]), (out[True], ref16), (ref16, out[False])):
        d = np.abs(a - b)
        assert d.mean() < 1 / 255 and d.max() < 16 / 255, (d.mean(), d.max())
    assert not np.array_equal(out[True], out[False])


def test_trainer_samples_ddim_when_its_config_says_so():
    """cfg.sampler='ddim': the trainer's sampler is the DDIM view over the
    z-scored codec, against the reference's DDIMSampler(NormalizedSampler)
    over the same weights."""
    from flowerdiff_torch.train.latent_ddpm import LatentDiffusionConfig, LatentDiffusionTrainer

    kw = dict(DEN, n_steps=20, normalize_latents=True, clip_denoised=1.0, sampler="ddim",
              ddim_steps=4)
    stats = _stats()
    vae = vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE)
    trainer = LatentDiffusionTrainer(LatentDiffusionConfig(**kw), vae, seed=2,
                                     latent_stats=stats, device="cpu")
    for fused in (False, True):
        s = trainer.sampler(fused=fused)
        assert isinstance(s, DDIMSampler) and s.num_steps == 4
        assert isinstance(s._inner, NormalizedSampler)
    params = state_dict_to_flax(trainer.sampling_params)
    rng, c = jax.random.key(3), _cond()
    ref = JaxDDIM(JaxNormalized(JaxSampler(JaxDenoiser(**DEN), params, jax_schedule(20), (32,),
                                           clip_x0=1.0), *stats), 4).sample(
        rng, 6, jnp.asarray(c))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], (6, 32))))
    _close(s.sample(6, torch.from_numpy(c).long(), x_init=x), ref)
    ancestral = LatentDiffusionTrainer(LatentDiffusionConfig(**dict(kw, sampler="ancestral")),
                                       vae, seed=2, latent_stats=stats, device="cpu")
    assert isinstance(ancestral.sampler(), NormalizedSampler)
