"""flowerdiff_torch's augmenting data path and uncached latent training on the
CPU against the JAX package, at small widths: the bilinear rotation, the
augmentation stack with the reference's own draws injected, the epoch's
batch order, the augmented latent pool, both forms of the uncached fused
epochs (held against the port's parts, which are held against JAX), a few
uncached steps against the reference's fused epochs with its draws
injected, the reference's errors and a tiny uncached trainer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.data import pipeline as jpipe
from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff.train.fused import make_fused_latent_epochs as jax_fused_latent_epochs
from flowerdiff.train.latent_ddpm import LatentDiffusionConfig as JaxConfig
from flowerdiff.train.latent_ddpm import create_latent_diffusion_state as jax_create_state
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff_torch.data import DeviceDataset, make_augment_fn, synthetic_flowers
from flowerdiff_torch.data.pipeline import AugmentDraws, grayscale, rotate_bilinear
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.train import fused
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    LatentDiffusionTrainer,
    create_latent_diffusion_state,
    make_latent_denoise_body,
    make_latent_encode_fn,
)
from flowerdiff_torch.utils.device import derived_generator
from flowerdiff_torch.utils.weights import init_numpy_params, state_dict_to_flax, vae_from_params

# JAX on the CPU computes the rotation and the jitter in f32; the port's
# 4-tap gather sums the same four products, the reference's batched form
# sums the same taps among exact zeros: 1e-5 absolute on values in [0, 1].
AUG_ATOL = 1e-5
VAE = dict(latent_dim=16, channels=(8, 16), head_width=32, base_size=8)  # 16 x 16 images
DEN = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=5)


def _images(b=6, h=16, w=12, seed=0):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("deg", [0.0, 10.0, -10.0, 90.0, 180.0])
def test_rotation_matches_jax(deg):
    x = _images()
    angles = np.full(x.shape[0], np.deg2rad(deg), np.float32)
    angles[1] = -angles[1]  # a batch of two angles
    got = rotate_bilinear(torch.from_numpy(x), torch.from_numpy(angles)).numpy()
    batch = np.asarray(jpipe._rotate_bilinear_batch(jnp.asarray(x), jnp.asarray(angles),
                                                    precision=jax.lax.Precision.HIGHEST))
    single = np.stack([np.asarray(jpipe._rotate_bilinear(jnp.asarray(im), jnp.asarray(a)))
                       for im, a in zip(x, angles)])
    np.testing.assert_allclose(got, single, rtol=0, atol=AUG_ATOL)
    np.testing.assert_allclose(got, batch, rtol=0, atol=AUG_ATOL)
    if deg == 0.0:
        np.testing.assert_array_equal(got, x)
    if deg == 180.0:  # about the centre of the pixel grid: the flip of both axes
        np.testing.assert_allclose(got, x[:, ::-1, ::-1], rtol=0, atol=AUG_ATOL)


def _jax_draws(key, b, max_rotation_deg, jitter, flip):
    """The reference's draws, from its own key splits (make_augment_fn)."""
    k_flip, k_rot, k_b, k_c, k_s = jax.random.split(key, 5)
    lo = -max_rotation_deg * jnp.pi / 180.0
    factors = [np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=1 - jitter,
                                             maxval=1 + jitter)).reshape(b)
               for k in (k_b, k_c, k_s)] if jitter > 0 else [None] * 3
    draws = (np.asarray(jax.random.bernoulli(k_flip, 0.5, (b,))) if flip else None,
             np.asarray(jax.random.uniform(k_rot, (b,), minval=lo, maxval=-lo))
             if max_rotation_deg > 0 else None, *factors)
    return AugmentDraws(*(None if d is None else torch.from_numpy(np.array(d)) for d in draws))


@pytest.mark.parametrize("branches", [
    dict(), dict(flip=False), dict(max_rotation_deg=0.0), dict(jitter=0.0),
    dict(flip=False, max_rotation_deg=0.0, jitter=0.0)])
def test_augment_matches_jax_with_injected_draws(branches):
    kw = dict(dict(max_rotation_deg=10.0, jitter=0.2, flip=True), **branches)
    x = _images(b=8)
    x[0] = 1.0  # brightness > 1 clips
    key = jax.random.key(3)
    ref = np.asarray(jpipe.make_augment_fn(**kw)(jnp.asarray(x), key))
    draws = _jax_draws(key, 8, **kw)
    got = make_augment_fn(**kw)(torch.from_numpy(x), draws=draws).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=AUG_ATOL)
    if kw["jitter"] > 0:
        assert got.min() >= 0.0 and got.max() <= 1.0 and (got == 1.0).any()
    if kw == dict(max_rotation_deg=0.0, jitter=0.0, flip=False):
        np.testing.assert_array_equal(got, x)


def test_augment_draws_come_from_the_generator_and_skip_switched_off_branches():
    x = torch.from_numpy(_images(b=64))
    full = make_augment_fn(10.0, 0.2)
    a = full(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, full(x, torch.Generator().manual_seed(1)))
    assert not torch.equal(a, full(x, torch.Generator().manual_seed(2)))
    d = full.draw(4096, torch.Generator().manual_seed(3))
    max_rad = np.deg2rad(10.0)
    assert abs(float(d.flip.float().mean()) - 0.5) < 5 * 0.5 / 64
    assert float(d.angle.abs().max()) <= max_rad and abs(float(d.angle.mean())) < 5 * max_rad / 64
    for f in (d.fb, d.fc, d.fs):
        assert 0.8 <= float(f.min()) and float(f.max()) <= 1.2 and abs(float(f.mean()) - 1) < 0.01
    # a branch that is off takes no draw: the generator stays where it was
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    assert torch.equal(make_augment_fn(0.0, 0.0, flip=False)(x, g), x)
    assert torch.equal(g.get_state(), state)
    only_flip = make_augment_fn(0.0, 0.0).draw(8, g)
    assert only_flip.angle is None and only_flip.fb is None and only_flip.flip is not None
    gray = grayscale(x)
    assert gray.shape == (64, 16, 12, 1)
    np.testing.assert_allclose(gray.numpy()[..., 0], x.numpy() @ np.array([0.299, 0.587, 0.114],
                                                                          np.float32), atol=1e-6)


@pytest.mark.parametrize("n,batch", [(37, 8), (5, 8), (32, 8)])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batches_order_labels_and_images_equal_jax(n, batch, drop_remainder):
    """The same numpy seed gives the reference's batches bit for bit with
    augment=False (each image distinct, so equal images mean equal order),
    a dataset smaller than one batch included (it yields one short batch
    without drop_remainder and, as in the reference, none with it)."""
    imgs, labels = synthetic_flowers(n, 5, 16, seed=n)
    ref = list(jpipe.DeviceDataset(imgs, labels, augment=False).batches(
        11, batch, drop_remainder=drop_remainder))
    got = list(DeviceDataset(imgs, labels, augment=False, device="cpu").batches(
        11, batch, drop_remainder=drop_remainder))
    assert len(got) == len(ref) == (n // batch if drop_remainder else -(-n // batch))
    for (gi, gl), (ri, rl) in zip(got, ref):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert len(np.unique(imgs.reshape(n, -1), axis=0)) == n


def test_augmented_batches_draw_from_their_derived_generators():
    imgs, labels = synthetic_flowers(20, 5, 16, seed=1)
    ds = DeviceDataset(imgs, labels, colors=labels % 3, device="cpu")
    got = list(ds.batches(np.random.default_rng(7), 8))
    rng = np.random.default_rng(7)
    order = rng.permutation(20)
    seed = int(rng.integers(0, 2**31))
    assert len(got) == 2
    for start, (im, lab, col) in zip((0, 8), got):
        idx = torch.from_numpy(order[start:start + 8])
        ref = ds.assemble(idx, derived_generator("cpu", seed, start))
        assert torch.equal(im, ref[0]) and torch.equal(lab, ref[1]) and torch.equal(col, ref[2])
        plain = torch.from_numpy(imgs[order[start:start + 8]]).float() * (1.0 / 255.0)
        assert not torch.equal(im, plain) and im.min() >= 0 and im.max() <= 1


def _vae():
    return vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE)


def _stats(rng):
    return (torch.from_numpy(rng.standard_normal(16).astype(np.float32) * 0.1),
            torch.from_numpy(np.full(16, 0.8, np.float32)))


def test_augmented_cache_builder_is_augment_then_encode():
    """Slot by slot and chunk by chunk: the augmentation's draws, then the
    posterior noise, from one generator, bit for bit; f32 pool."""
    imgs, _ = synthetic_flowers(13, 5, 16, seed=2)
    images = torch.from_numpy(imgs)
    vae, stats = _vae(), _stats(np.random.default_rng(0))
    cfg = LatentDiffusionConfig(latent_cache=2, **DEN)
    pool = fused.make_latent_cache_builder(vae, cfg, chunk=5)(
        images, torch.Generator().manual_seed(3), stats)
    assert pool.shape == (2, 13, 16) and pool.dtype == torch.float32
    g = torch.Generator().manual_seed(3)
    augment, encode = make_augment_fn(10.0, 0.2), make_latent_encode_fn(vae)
    for k in range(2):
        parts = [encode(augment(images[i:i + 5].float() * (1.0 / 255.0), g), g, stats)
                 for i in range(0, 13, 5)]
        assert torch.equal(pool[k], torch.cat(parts))
    plain = fused.make_latent_cache_builder(vae, cfg, augment=False, chunk=5)(
        images, torch.Generator().manual_seed(3), stats)
    assert not torch.equal(plain, pool)


def _uncached(**over):
    kw = dict(DEN, dropout_rate=0.2, cond_dropout=0.2, n_steps=50, steps_per_epoch=3,
              normalize_latents=True)
    kw.update(over)
    cfg = LatentDiffusionConfig(**kw)
    state, model, sched = create_latent_diffusion_state(0, cfg, device="cpu")
    imgs, labels = synthetic_flowers(24, 5, 16, seed=4)
    return cfg, state, model, sched, torch.from_numpy(imgs), torch.from_numpy(labels).long()


def test_per_step_form_is_gather_then_encode_then_step():
    """The per-step form against the port's parts, drawing from one
    generator in the same order: equal losses and weights, bit for bit."""
    rng = np.random.default_rng(5)
    stats = _stats(rng)
    idx = torch.from_numpy(fused.epoch_rows(6, 24, 8, 2)[0])
    vae = _vae()
    cfg, state, model, sched, images, labels = _uncached()
    fn = fused.make_fused_latent_epochs(model, vae, sched, cfg, steps_per_epoch=3)
    got = fn(state, images, labels, None, idx, torch.Generator().manual_seed(8), stats)
    cfg, ref_state, ref_model, sched, images, labels = _uncached()
    augment, encode = make_augment_fn(10.0, 0.2), make_latent_encode_fn(vae)
    denoise = make_latent_denoise_body(ref_model, cfg)
    g = torch.Generator().manual_seed(8)
    ref = []
    for row in idx:
        z = encode(augment(images[row].float() * (1.0 / 255.0), g), g, stats)
        ref.append(denoise(ref_state, sched, z, labels[row], None, g))
    assert got.shape == (6,) and torch.equal(got, torch.stack(ref))
    assert all(torch.equal(a, b) for a, b in zip(state.params, ref_state.params))


@pytest.mark.parametrize("train_kernel", [False, True])
def test_epoch_encode_form_equals_the_per_step_form(train_kernel):
    """One batched encode of an epoch's 24 augmented images, then three
    steps, against the per-step form from the same generator: the same
    draws, so the losses and weights agree up to the convolutions' sums in
    another order (and, with the kernel body, the f32 twin's sums): 1e-5
    relative, as the kernel and eager trainers agree in
    tests/test_torch_port_train.py."""
    rng = np.random.default_rng(6)
    stats = _stats(rng)
    idx = torch.from_numpy(fused.epoch_rows(9, 24, 8, 2)[0])
    vae = _vae()
    runs = []
    for epoch_encode in (False, True):
        cfg, state, model, sched, images, labels = _uncached(
            epoch_encode=epoch_encode, train_kernel=train_kernel and epoch_encode,
            train_kernel_dtype="float32")
        fn = fused.make_fused_latent_epochs(model, vae, sched, cfg, steps_per_epoch=3)
        runs.append((fn(state, images, labels, None, idx, torch.Generator().manual_seed(4),
                        stats), state))
    (a, sa), (b, sb) = runs
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5)
    for p, q in zip(sb.params, sa.params):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-4, atol=1e-6)


def test_uncached_steps_match_the_reference_with_injected_draws():
    """Three augmented steps of the reference's per-step fused epochs
    (dropout 0, condition dropout 0.3, z-scored latents) against the port's
    parts fed the reference's own draws: augmentation from
    fold_in(data_key, offset), then fold_in(fold_in(rng, offset), step)
    split into the posterior noise, the loss's t and eps, and the condition
    keep-mask. Losses rtol 1e-4 (f32 convolutions and the rotation summed
    in another order); weights after three steps rtol 2e-4 / atol 2e-6, as
    the six-step optax test."""
    common = dict(DEN, dropout_rate=0.0, cond_dropout=0.3, n_steps=50, steps_per_epoch=3,
                  t0=1, weight_decay=1e-2, normalize_latents=True)
    jstate, jmodel, jsched = jax_create_state(jax.random.key(0), JaxConfig(**common))
    params0 = jax.tree.map(np.asarray, jstate.params)
    rng = np.random.default_rng(10)
    for leaf in params0.values():
        if isinstance(leaf, dict) and "bias" in leaf and "kernel" in leaf:
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params0))
    vae_tree = init_numpy_params("vae", seed=1, **VAE)
    jvae = JaxVAE(num_classes=5, **VAE)
    imgs, labels = synthetic_flowers(24, 5, 16, seed=7)
    stats = (rng.standard_normal(16).astype(np.float32) * 0.1, np.full(16, 0.8, np.float32))
    idx, offsets, steps = jax_epoch_rows(3, 24, 8, 1)
    key, data_key = jax.random.key(21), jax.random.key(22)
    fn = jax_fused_latent_epochs(jmodel, jvae, jsched, JaxConfig(**common),
                                 steps_per_epoch=steps)
    jstate, jlosses = fn(jstate, jax.tree.map(jnp.asarray, vae_tree["params"]), jsched,
                         jnp.asarray(imgs), jnp.asarray(labels, jnp.int32), None, idx, offsets,
                         key, data_key, tuple(map(jnp.asarray, stats)))

    cfg = LatentDiffusionConfig(**common)
    state, model, sched = create_latent_diffusion_state(0, cfg, device="cpu",
                                                        params={"params": params0})
    gather = fused._make_gather(True, 10.0, 0.2)
    encode, denoise = make_latent_encode_fn(_vae()), make_latent_denoise_body(model, cfg)
    tstats = tuple(map(torch.from_numpy, stats))
    images, labs = torch.from_numpy(imgs), torch.from_numpy(labels).long()
    ones = [torch.ones(8, d) for d in DEN["hidden_dims"][:-1] for _ in range(2)]
    losses = []
    for r, off in enumerate(np.asarray(offsets)):
        row = torch.from_numpy(np.asarray(idx[r]).astype(np.int64))
        aug = _jax_draws(jax.random.fold_in(data_key, int(off)), 8, 10.0, 0.2, True)
        step_key = jax.random.fold_in(jax.random.fold_in(key, int(off)), state.step)
        enc_key, loss_key, _, cfg_key = jax.random.split(step_key, 4)
        t_key, eps_key = jax.random.split(loss_key)
        draws = (torch.from_numpy(np.array(jax.random.randint(t_key, (8,), 0, 50))).long(),
                 torch.from_numpy(np.array(jax.random.normal(eps_key, (8, 16), jnp.float32))),
                 torch.from_numpy(np.array(jax.random.bernoulli(cfg_key, 0.7, (8,)),
                                           np.float32)), ones)
        noise = torch.from_numpy(np.array(jax.random.normal(enc_key, (8, 16), jnp.float32)))
        z = encode(gather(images, row, draws=aug), None, tstats, noise=noise)
        losses.append(float(denoise(state, sched, z, labs[row], None, draws=draws)))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-4)
    got = dict(_leaves(state_dict_to_flax(model)))
    for name, ref in _leaves(jax.tree.map(np.asarray, jstate.params)):
        np.testing.assert_allclose(got[name], ref, rtol=2e-4, atol=2e-6, err_msg=name)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_the_reference_errors_are_raised():
    vae = _vae()
    cfg, state, model, sched, *_ = _uncached(train_kernel=True)
    with pytest.raises(ValueError, match="requires epoch_encode"):
        fused.make_fused_latent_epochs(model, vae, sched, cfg)
    fused.make_fused_latent_epochs(model, vae, sched, cfg, epoch_encode=True)
    v3 = dict(DEN, shared_cond_proj=False, num_colors=3)
    cfg3 = LatentDiffusionConfig(train_kernel=True, epoch_encode=True, **v3)
    _, model3, sched3 = create_latent_diffusion_state(0, cfg3, device="cpu")
    with pytest.raises(ValueError, match="v1/v2"):
        fused.make_fused_latent_epochs(model3, vae, sched3, cfg3, has_colors=True)
    fused.make_fused_latent_epochs(model3, vae, sched3, dataclasses.replace(
        cfg3, train_kernel=False), has_colors=True)


def _tiny_trainer(**over):
    imgs, labels = synthetic_flowers(40, 5, 16, seed=0)
    kw = dict(DEN, dropout_rate=0.1, cond_dropout=0.1, ema_decay=0.99, steps_per_epoch=5,
              n_steps=50, normalize_latents=True, clip_denoised=3.0, guidance_scale=2.0)
    kw.update(over)
    rng = np.random.default_rng(0)
    stats = (rng.standard_normal(16).astype(np.float32) * 0.1, np.full(16, 0.8, np.float32))
    trainer = LatentDiffusionTrainer(LatentDiffusionConfig(**kw), _vae(), seed=3,
                                     latent_stats=stats, device="cpu")
    return trainer, DeviceDataset(imgs, labels, device="cpu")


@pytest.mark.parametrize("form", ["per_step", "epoch_encode", "epoch_encode_kernel"])
def test_tiny_uncached_trainer_learns(form):
    trainer, ds = _tiny_trainer(epoch_encode=form != "per_step",
                                train_kernel=form == "epoch_encode_kernel",
                                train_kernel_dtype="float32",
                                encode_dtype="bfloat16" if form != "per_step" else None)
    assert ds.augment_enabled
    before = ts.kernel_loss_and_grads.launches
    losses = trainer.run_epochs_fused(ds, 8, None, torch.Generator().manual_seed(5),
                                      batch_size=8)
    assert ts.kernel_loss_and_grads.launches == before  # a CPU run launches no kernel
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0]
    assert trainer.state.step == 8 * 5 and trainer._z_pool is None
    assert trainer.last_step_losses.shape == (40,)
    out = trainer.sampler().sample(3, torch.tensor([0, 1, 2]),
                                   generator=torch.Generator().manual_seed(1))
    assert out.shape == (3, 16) and bool(torch.isfinite(out).all())


def test_cached_trainer_builds_its_pool_from_augmented_images():
    """The cached path follows the dataset's augmentation: its first pool is
    the augmenting builder's, from the trainer's generator."""
    trainer, ds = _tiny_trainer(latent_cache=2, cache_refresh_epochs=3)
    losses = trainer.run_epochs_fused(ds, 2, None, torch.Generator().manual_seed(5),
                                      batch_size=8)
    assert len(losses) == 2 and np.all(np.isfinite(losses)) and trainer._pool_builds == 1
    build = fused.make_latent_cache_builder(trainer.vae, trainer.cfg)
    ref = build(ds.images, torch.Generator().manual_seed(5), trainer.latent_stats)
    assert torch.equal(trainer._z_pool, ref)
    plain = fused.make_latent_cache_builder(trainer.vae, trainer.cfg, augment=False)
    assert not torch.equal(plain(ds.images, torch.Generator().manual_seed(5),
                                 trainer.latent_stats), ref)
