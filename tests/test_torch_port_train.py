"""flowerdiff_torch's latent-DDPM training slice on the CPU against the JAX
package, at small widths: losses, the SGDR schedule, the VAE encoder and the
posterior draw, the epoch index plan, module gradients, the clip + AdamW +
SGDR + EMA trajectory against the optax chain, and a tiny trainer. Inputs
are made with numpy from a seed; random draws are injected on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion.ddpm import ddpm_eps_loss as jax_eps_loss
from flowerdiff.diffusion.ddpm import q_sample as jax_q_sample
from flowerdiff.losses.distances import euclidean_distance_loss as jax_euclid
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff.train.latent_ddpm import LatentDiffusionConfig as JaxConfig
from flowerdiff.train.latent_ddpm import create_latent_diffusion_state as jax_create_state
from flowerdiff.train.latent_ddpm import make_latent_encode_fn as jax_encode_fn
from flowerdiff.train.schedules import cosine_warm_restarts_schedule as jax_sgdr
from flowerdiff_torch.data import DeviceDataset, synthetic_flowers
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.ddpm import ddpm_eps_loss
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.losses import euclidean_distance_loss
from flowerdiff_torch.models import FlowerVAE
from flowerdiff_torch.train.fused import epoch_rows
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    LatentDiffusionTrainer,
    create_latent_diffusion_state,
    make_latent_denoise_body,
    make_latent_encode_fn,
)
from flowerdiff_torch.train.schedules import cosine_warm_restarts_schedule
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    state_dict_to_flax,
    vae_from_params,
)

DEN = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=7)
VAE = dict(latent_dim=16, channels=(8, 16), head_width=32, base_size=8)  # 16 x 16 images


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_close(got, ref, rtol, atol):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_euclidean_distance_loss_matches_jax(reduction):
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((6, 4, 5)).astype(np.float32) for _ in range(2))
    y[3] = x[3]  # a zero distance: the 1e-8 inside the sqrt shows
    ref = np.asarray(jax_euclid(jnp.asarray(x), jnp.asarray(y), reduction))
    got = euclidean_distance_loss(torch.from_numpy(x), torch.from_numpy(y), reduction).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)  # same f32 formula
    with pytest.raises(ValueError):
        euclidean_distance_loss(torch.from_numpy(x), torch.from_numpy(y), "max")


@pytest.mark.parametrize("distance", ["euclidean", "mse"])
def test_ddpm_eps_loss_matches_jax_with_injected_draws(distance):
    sched_j, sched_t = jax_schedule(50), linear_schedule(50)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((8, 12)).astype(np.float32)
    cond = rng.integers(0, 5, 8).astype(np.int32)
    key = jax.random.key(7)
    t_key, eps_key = jax.random.split(key)  # the reference's own derivation
    t = np.asarray(jax.random.randint(t_key, (8,), 0, 50))
    eps = np.asarray(jax.random.normal(eps_key, x0.shape, jnp.float32))

    def eps_fn(lib):
        return lambda xt, tt, c: 0.5 * xt + 0.01 * tt[:, None] - 0.1 * c[:, None] * lib.tanh(xt)

    ref = float(jax_eps_loss(sched_j, eps_fn(jnp), key, jnp.asarray(x0), jnp.asarray(cond),
                             distance=distance))
    got = float(ddpm_eps_loss(sched_t, eps_fn(torch), None, torch.from_numpy(x0),
                              torch.from_numpy(cond), distance=distance,
                              t=torch.from_numpy(t.copy()).long(),
                              eps=torch.from_numpy(eps.copy())))
    np.testing.assert_allclose(got, ref, rtol=1e-5)  # f32, sums in another order
    # drawn from a generator: repeatable, and different from the injected draw
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a, b = (float(ddpm_eps_loss(sched_t, eps_fn(torch), g(), torch.from_numpy(x0),
                                torch.from_numpy(cond), distance=distance)) for _ in range(2))
    assert a == b and a != got


def test_sgdr_schedule_matches_jax_over_the_restarts():
    """Steps 0..1200 at 15 steps an epoch, t0 = 10, t_mult = 2: restarts at
    epochs 10, 30 and 70 (steps 150, 450, 1050). f32 on both sides; 1e-6 of
    the base rate covers libm differences in log and cos."""
    ref_fn = jax_sgdr(1e-3, 15, 10, 2)
    got_fn = cosine_warm_restarts_schedule(1e-3, 15, 10, 2)
    steps = np.arange(1201)
    ref = np.asarray(jax.vmap(ref_fn)(jnp.asarray(steps)))
    got = np.array([got_fn(int(s)) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    for restart in (0, 150, 450, 1050):
        assert got[restart] == pytest.approx(1e-3, rel=1e-6)
        if restart:
            assert got[restart - 1] < 1e-5  # the end of the cycle before
    one = cosine_warm_restarts_schedule(1e-3, 4, 3, 1)
    ref_one = jax_sgdr(1e-3, 4, 3, 1)
    np.testing.assert_allclose([one(s) for s in range(40)],
                               [float(ref_one(s)) for s in range(40)], rtol=0, atol=1e-9)


def _vae_pair(logvar_shift=0.0):
    tree = init_numpy_params("vae", seed=2, **VAE)
    head = tree["params"]["encoder"]["logvar_fc2"]
    head["bias"] = (head["bias"] + logvar_shift).astype(np.float32)
    jvae = JaxVAE(num_classes=5, **VAE)
    jparams = jax.tree.map(jnp.asarray, tree["params"])
    return tree, jvae, jparams, vae_from_params(tree, device="cpu", **VAE)


def test_encoder_matches_jax_and_logvar_is_clamped():
    # push some logvar outputs past the clamp on both sides
    tree, jvae, jparams, vae = _vae_pair(logvar_shift=np.linspace(-6, 14, 16))
    rng = np.random.default_rng(3)
    x = rng.random((5, 16, 16, 3)).astype(np.float32)
    mu_r, lv_r = jvae.apply({"params": jparams}, jnp.asarray(x), method=JaxVAE.encode_with_params)
    with torch.no_grad():
        mu, lv = vae.encode_with_params(torch.from_numpy(x))
        raw_mu, raw_lv = vae.encoder(torch.from_numpy(x))
    # f32 convolutions summed in another order
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_r), rtol=1e-4, atol=1e-4)
    assert float(raw_lv.min()) < -2 and float(raw_lv.max()) > 10
    assert float(lv.min()) == -2.0 and float(lv.max()) == 10.0


def test_reparameterize_clamps_before_exp_and_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((4, 6)).astype(np.float32)
    logvar = np.linspace(-8, 16, 24, dtype=np.float32).reshape(4, 6)
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, mu.shape, jnp.float32))
    ref = np.asarray(JaxVAE.reparameterize(key, jnp.asarray(mu), jnp.asarray(logvar)))
    got = FlowerVAE.reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                                   noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, mu + noise * np.exp(0.5 * np.clip(logvar, -2, 10)),
                               rtol=1e-6, atol=1e-6)
    g = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    a, b = (FlowerVAE.reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar), g())
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("zscore", [False, True])
def test_latent_encode_fn_matches_jax_with_injected_noise(zscore):
    tree, jvae, jparams, vae = _vae_pair()
    rng = np.random.default_rng(6)
    x = rng.random((4, 16, 16, 3)).astype(np.float32)
    stats = (rng.standard_normal(16).astype(np.float32),
             (0.5 + rng.random(16)).astype(np.float32)) if zscore else None
    key = jax.random.key(9)
    noise = np.asarray(jax.random.normal(key, (4, 16), jnp.float32))
    ref = np.asarray(jax_encode_fn(jvae)(
        jparams, jnp.asarray(x), key, None if stats is None else tuple(map(jnp.asarray, stats))))
    tstats = None if stats is None else tuple(map(torch.from_numpy, stats))
    enc = make_latent_encode_fn(vae)
    got = enc(torch.from_numpy(x), None, tstats, noise=torch.from_numpy(noise))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the bf16 encoder changes the convolutions only: close, f32, same noise
    low = make_latent_encode_fn(vae, "bfloat16")(torch.from_numpy(x), None, tstats,
                                                noise=torch.from_numpy(noise))
    assert low.dtype == torch.float32
    assert float((low - got).abs().max()) < 0.25 * float(got.abs().max())
    with pytest.raises(ValueError):
        make_latent_encode_fn(vae, "float16")


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_epoch_rows_equal_jax_for_the_same_seed(drop_remainder):
    for seed, n, b, e in ((0, 1020, 64, 3), (123, 37, 8, 2), (5, 5, 8, 2)):
        ref_idx, ref_off, ref_steps = jax_epoch_rows(seed, n, b, e, drop_remainder=drop_remainder)
        idx, steps = epoch_rows(seed, n, b, e, drop_remainder=drop_remainder)
        assert steps == ref_steps and idx.dtype == np.int64
        np.testing.assert_array_equal(idx, np.asarray(ref_idx))
        assert len(ref_off) == idx.shape[0]
    assert epoch_rows(0, 1020, 64, 1)[1] == 15
    plain, _ = epoch_rows(0, 20, 4, 1, shuffle=False)
    np.testing.assert_array_equal(plain.reshape(-1), np.arange(20))


def test_synthetic_flowers_and_dataset_holder():
    from flowerdiff.data.synthetic import synthetic_flowers as jax_synth

    imgs, labels = synthetic_flowers(12, 5, 16, seed=3)
    ref_imgs, ref_labels = jax_synth(12, 5, 16, seed=3)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(labels, ref_labels)
    ds = DeviceDataset(imgs, labels, augment=False, device="cpu")
    assert ds.n == 12 and ds.images.dtype == torch.uint8 and ds.labels.dtype == torch.int64
    assert not ds.augment_enabled and ds.max_rotation_deg == 10.0 and ds.jitter == 0.2
    full, labs = ds.full()
    assert full.dtype == torch.float32 and float(full.max()) <= 1.0 and labs.shape == (12,)
    assert DeviceDataset(imgs, labels, colors=labels % 3, device="cpu").colors is not None
    with pytest.raises(ValueError):
        DeviceDataset(imgs.astype(np.float32), labels, device="cpu")


def _variant(name):
    kw = dict(DEN)
    if name == "v2":
        kw["global_skip"] = True
    if name == "v3":
        kw.update(shared_cond_proj=False, num_colors=4)
    return kw


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_module_autograd_matches_jax_grad(variant):
    """Gradients of the eps-loss through the f32 module (eval mode, cond
    mask with zeros) against jax.grad of model.apply, leaf by leaf through
    `state_dict_to_flax`: rtol 5e-4 / atol 1e-6."""
    kw = _variant(variant)
    tree = init_numpy_params("denoiser", seed=4, bias_std=0.2, **kw)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    eps = rng.standard_normal((8, 64)).astype(np.float32)
    t = rng.integers(0, 1000, 8).astype(np.int32)
    c = rng.integers(0, 7, 8).astype(np.int32)
    col = rng.integers(0, 4, 8).astype(np.int32)
    keep = np.array([1, 1, 0, 1, 0, 1, 1, 1], np.float32)
    cond = (c, col) if variant == "v3" else (c,)
    jmodel = JaxDenoiser(**kw)

    def jloss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                           *map(jnp.asarray, cond), cond_mask=jnp.asarray(keep))
        return jax_euclid(jnp.asarray(eps), out)

    ref_loss, ref = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree["params"]))
    model = denoiser_from_params(tree, device="cpu", **kw)
    out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                *[torch.from_numpy(a).long() for a in cond], cond_mask=torch.from_numpy(keep))
    loss = euclidean_distance_loss(torch.from_numpy(eps), out)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    got = state_dict_to_flax({n: torch.zeros_like(p) if g is None else g
                              for n, p, g in zip(names, model.parameters(), grads)}, model)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    _assert_trees_close(got, jax.tree.map(np.asarray, ref), rtol=5e-4, atol=1e-6)
    # the bridge is its own inverse on the weights
    _assert_trees_close(state_dict_to_flax(model), tree["params"], rtol=0, atol=0)


@pytest.mark.parametrize("body", ["eager", "kernel"])
def test_six_step_trajectory_matches_optax(body):
    """Loss, parameters and EMA over six steps of clip(1.0) + AdamW(SGDR,
    wd) + EMA against the reference's optax chain, from the reference's own
    initial weights, with injected t, eps and condition keep-mask and
    dropout 0. steps_per_epoch 2 and t0 1 put warm restarts at steps 2 and 6.
    A large weight decay makes the decay of q and k (zero gradient) visible.
    Tolerance: rtol 2e-4 / atol 2e-6 on every leaf after six steps (f32 sums
    in another order, amplified by Adam's normalisation of small gradients)."""
    common = dict(dropout_rate=0.0, cond_dropout=0.3, ema_decay=0.9, n_steps=50,
                  steps_per_epoch=2, t0=1, t_mult=2, weight_decay=1e-2, **DEN)
    jstate, jmodel, jsched = jax_create_state(jax.random.key(0), JaxConfig(**common))
    params0 = jax.tree.map(np.asarray, jstate.params)
    # flax starts biases at zero: give them values, so that the null
    # condition's bias terms take part
    rng = np.random.default_rng(10)
    for leaf in params0.values():
        if isinstance(leaf, dict) and "bias" in leaf and "kernel" in leaf:
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    jparams0 = jax.tree.map(jnp.asarray, params0)
    jstate = jstate.replace(params=jparams0, ema_params=jparams0)
    cfg = LatentDiffusionConfig(**common)
    state, model, sched = create_latent_diffusion_state(0, cfg, device="cpu",
                                                        params={"params": params0})
    denoise = (make_latent_denoise_body(model, cfg) if body == "eager"
               else ts.make_kernel_denoise_body(model, cfg, dtype=torch.float32))
    q0 = model.attn_0.q.weight.detach().clone()

    @jax.jit
    def jstep(st, z, labels, t, eps, keep):
        def loss_fn(p):
            out = jmodel.apply({"params": p}, jax_q_sample(jsched, z, t, eps), t, labels,
                               cond_mask=keep)
            return jax_euclid(eps, out)
        loss, grads = jax.value_and_grad(loss_fn)(st.params)
        return st.apply_gradients(grads=grads), loss

    decay = 1.0
    for i in range(6):
        z = rng.standard_normal((8, 64)).astype(np.float32)
        eps = rng.standard_normal((8, 64)).astype(np.float32)
        labels = rng.integers(0, 7, 8).astype(np.int32)
        t = rng.integers(0, 50, 8).astype(np.int32)
        keep = (rng.random(8) >= 0.3).astype(np.float32)
        jstate, jloss = jstep(jstate, *map(jnp.asarray, (z, labels, t, eps, keep)))
        ones = [torch.ones(8, d) for d in DEN["hidden_dims"][:-1] for _ in range(2)]
        draws = (torch.from_numpy(t).long(), torch.from_numpy(eps), torch.from_numpy(keep), ones)
        loss = denoise(state, sched, torch.from_numpy(z), torch.from_numpy(labels).long(), None,
                       draws=draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5, err_msg=f"step {i}")
        decay *= 1.0 - state.schedule(i) * cfg.weight_decay
    assert state.step == 6 and int(jstate.step) == 6
    _assert_trees_close(state_dict_to_flax(model), jax.tree.map(np.asarray, jstate.params),
                        rtol=2e-4, atol=2e-6)
    _assert_trees_close(state_dict_to_flax(state.ema_params, model),
                        jax.tree.map(np.asarray, jstate.ema_params), rtol=2e-4, atol=2e-6)
    # q has zero gradient and still decays by (1 - lr wd) a step, as optax decays it
    np.testing.assert_allclose(model.attn_0.q.weight.numpy(), (q0 * decay).numpy(), rtol=1e-6)
    assert decay < 1.0 - 3e-5  # far outside the 1e-6 above
    assert not torch.equal(state.ema[0], state.params[0])


def _tiny_trainer(**over):
    imgs, labels = synthetic_flowers(40, 5, 16, seed=0)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE)
    kw = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=5,
              dropout_rate=0.1, cond_dropout=0.1, ema_decay=0.99, latent_cache=2,
              cache_refresh_epochs=3, steps_per_epoch=5, n_steps=50, normalize_latents=True,
              clip_denoised=3.0, guidance_scale=2.0)
    kw.update(over)
    rng = np.random.default_rng(0)
    stats = (rng.standard_normal(16).astype(np.float32) * 0.1, np.full(16, 0.8, np.float32))
    trainer = LatentDiffusionTrainer(LatentDiffusionConfig(**kw), vae, seed=3,
                                     latent_stats=stats, device="cpu")
    return trainer, DeviceDataset(imgs, labels, augment=False, device="cpu")


@pytest.mark.parametrize("train_kernel", [False, True])
def test_tiny_trainer_learns_and_refreshes_its_pool(train_kernel):
    trainer, ds = _tiny_trainer(train_kernel=train_kernel, train_kernel_dtype="float32")
    g = torch.Generator().manual_seed(5)
    before = ts.kernel_loss_and_grads.launches
    losses = trainer.run_epochs_fused(ds, 8, None, g, batch_size=8)
    assert ts.kernel_loss_and_grads.launches == before  # a CPU run launches no kernel
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0]
    assert trainer.state.step == 8 * 5
    # refresh every 3 epochs: built at epochs 0, 3 and 6
    assert trainer._pool_builds == 3 and trainer._pool_age == 2
    assert trainer._z_pool.shape == (2, 40, 16) and trainer._z_pool.dtype == torch.float32
    more = trainer.run_epochs_fused(ds, 2, None, g, batch_size=8)
    assert len(more) == 2 and trainer._pool_builds == 4
    # the EMA weights differ from the live ones and are what the sampler gets
    live = dict(zip(trainer.state.names, trainer.state.params))
    ema = trainer.sampling_params
    assert any(not torch.equal(ema[k], live[k]) for k in live)
    for fused in (False, True):
        sampler = trainer.sampler(fused=fused)
        out = sampler.sample(3, torch.tensor([0, 1, 2]), generator=torch.Generator().manual_seed(1))
        assert out.shape == (3, 16) and bool(torch.isfinite(out).all())
    assert torch.equal(trainer.sampling_model().latent_proj.weight, ema["latent_proj.weight"])
    x = torch.zeros(2, 16)
    eps = trainer.eps_fn()(x, torch.tensor([3, 4]), torch.tensor([0, 1]))
    assert eps.shape == (2, 16)


def test_kernel_and_eager_trainers_agree_from_the_same_seed():
    """train_kernel=True (the f32 twin on the CPU) and train_kernel=False
    from the same seeds: the same pool, the same draws, the same losses to
    1e-5 relative over 15 steps."""
    runs = []
    for train_kernel in (True, False):
        trainer, ds = _tiny_trainer(train_kernel=train_kernel, train_kernel_dtype="float32",
                                    dropout_rate=0.3)
        runs.append(trainer.run_epochs_fused(ds, 3, None, torch.Generator().manual_seed(2),
                                             batch_size=8))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


def test_run_epoch_steps_through_the_frozen_encoder():
    trainer, ds = _tiny_trainer(latent_cache=0)
    imgs, labels = ds.full()
    g = torch.Generator().manual_seed(0)
    batches = [(imgs[i:i + 8], labels[i:i + 8]) for i in range(0, 40, 8)]
    first = trainer.run_epoch(batches, g)
    for _ in range(6):
        last = trainer.run_epoch(batches, g)
    assert np.isfinite(first) and last < first and trainer.state.step == 35
    assert all(not p.requires_grad for p in trainer.model.parameters())


def test_trainer_config_defaults_match_the_reference():
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(LatentDiffusionConfig)}
    assert got == ref
    with pytest.raises(ValueError, match="latent_stats"):
        LatentDiffusionTrainer(LatentDiffusionConfig(normalize_latents=True),
                               FlowerVAE(**VAE), device="cpu")


def test_v3_trainer_trains_with_colors_through_the_eager_body():
    """The dual-condition variant has no train kernel: its trainer takes the
    eager autograd body, with the color labels gathered beside the classes."""
    imgs, labels = synthetic_flowers(24, 5, 16, seed=1)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE)
    cfg = LatentDiffusionConfig(latent_dim=16, hidden_dims=(32, 32), time_emb_dim=16,
                                num_classes=5, num_colors=3, shared_cond_proj=False,
                                dropout_rate=0.1, latent_cache=1, steps_per_epoch=3, n_steps=50)
    trainer = LatentDiffusionTrainer(cfg, vae, seed=0, device="cpu")
    ds = DeviceDataset(imgs, labels, colors=labels % 3, augment=False, device="cpu")
    losses = trainer.run_epochs_fused(ds, 6, None, torch.Generator().manual_seed(0), batch_size=8)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert trainer.state.ema is None  # no ema_decay: sampling uses the live weights
    assert trainer.sampling_params["latent_proj.weight"] is trainer.state.params[
        trainer.state.names.index("latent_proj.weight")]


def test_module_dropout_acts_in_train_mode_only():
    kw = dict(DEN, dropout_rate=0.5)
    model = denoiser_from_params(init_numpy_params("denoiser", seed=0, **DEN), device="cpu", **kw)
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    t, c = torch.tensor([1, 5, 9, 30]), torch.tensor([0, 1, 2, 3])
    with torch.no_grad():
        ref = model(x, t, c)
        assert torch.equal(model(x, t, c), ref)  # eval mode: no dropout
        model.train()
        torch.manual_seed(0)
        a = model(x, t, c)
        torch.manual_seed(1)
        b = model(x, t, c)
        assert not torch.equal(a, ref) and not torch.equal(a, b)
        # all-ones injected masks switch the module's own draws off
        ones = [(torch.ones(4, d), torch.ones(4, d)) for d in DEN["hidden_dims"][:-1]]
        np.testing.assert_allclose(model(x, t, c, masks=ones).numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-6)
