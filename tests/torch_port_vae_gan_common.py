"""Shared inputs, fixtures and helpers of the VAE-GAN slice's CPU tests
against the JAX package (tests/test_torch_port_vae_gan.py, _steps.py and
_fused.py), at a tiny width: channels (8, 16, 24, 32), latent 8, 10
classes, 64x64 images (the discriminator's fixed ladder needs 64), batch 4.

Inputs come from a numpy seed and the weights from the reference's own
init, carried across by the bridge. Random draws are injected: the
reparameterisation noise is recomputed from the reference's keys; on the
reference side flax `Dropout` is patched to the identity and on the port
side the classifier's masks are given as None, which applies no dropout (the
two dropout streams cannot be aligned; the masks themselves are held in the
classifier's own test).
"""
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from flowerdiff.losses import center as jcenter
from flowerdiff.losses import gan as jgan
from flowerdiff.losses.kl import kl_divergence as jax_kl
from flowerdiff.models.discriminator import Discriminator64 as JaxDisc
from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.models.vae import LatentClassifier as JaxClassifier
from flowerdiff.models.vgg import VGGFeatures as JaxVGGFeatures
from flowerdiff.models.vgg import VGGPerceptual as JaxVGG
from flowerdiff.train import schedules as jsched
from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff.train.fused import make_fused_vae_gan_epochs as jax_fused_epochs
from flowerdiff.train.latent_ddpm import LatentDiffusionConfig as JaxLatentConfig
from flowerdiff.train.latent_ddpm import create_latent_diffusion_state as jax_latent_state
from flowerdiff.diffusion.ddpm import q_sample as jax_q_sample
from flowerdiff.losses.distances import euclidean_distance_loss as jax_euclid
from flowerdiff.train.vae_gan import VAEGANConfig as JaxConfig
from flowerdiff.train.vae_gan import create_vae_gan_state as jax_create_state
from flowerdiff.train.vae_gan import gates_array as jax_gates
from flowerdiff.train.vae_gan import make_vae_gan_step as jax_make_step
from flowerdiff_torch.data import DeviceDataset, synthetic_flowers
from flowerdiff_torch.losses import (
    bce_loss,
    center_loss,
    discriminator_loss,
    generator_adv_loss,
    kl_divergence,
    standalone_center_loss,
    update_centers,
)
from flowerdiff_torch.models import Discriminator64, FlowerVAE, VGGPerceptual
from flowerdiff_torch.models.vgg import describe_vgg_weights, load_vgg_params
from flowerdiff_torch.train import fused
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    create_latent_diffusion_state,
    make_latent_denoise_body,
)
from flowerdiff_torch.train.schedules import onecycle_schedule, vae_gan_loss_gates
from flowerdiff_torch.train.vae_gan import (
    METRICS,
    VAEGANConfig,
    VAEGANTrainer,
    create_vae_gan_state,
    gates_array,
    make_vae_gan_step,
    make_vae_gan_step_body,
)
from flowerdiff_torch.utils.weights import (
    init_numpy_params,
    load_discriminator,
    state_dict_to_flax,
    vae_from_params,
)

B, LATENT, CLASSES, IMG = 4, 8, 10, 64


ARCH = dict(latent_dim=LATENT, channels=(8, 16, 24, 32), head_width=32)
COMMON = dict(num_classes=CLASSES, total_steps=20, **ARCH)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture()
def no_dropout(monkeypatch):
    def identity(self, x, deterministic=True, rng=None):  # noqa: ARG001
        return x

    monkeypatch.setattr(fnn.Dropout, "__call__", identity)


@pytest.fixture(scope="module")
def jax_init():
    """The reference's initial state at the tiny width, as numpy trees."""
    state, _, _ = jax_create_state(jax.random.key(0), JaxConfig(**COMMON))
    return (jax.tree.map(np.asarray, state.gen.params),
            jax.tree.map(np.asarray, state.disc.params))


@pytest.fixture(scope="module")
def vgg_pair():
    jvgg = JaxVGG()
    return jvgg, VGGPerceptual(device="cpu")


def _port(jax_init, vgg=None, cfg=None):
    cfg = cfg or VAEGANConfig(**COMMON)
    vae = FlowerVAE(num_classes=CLASSES, **ARCH)
    gp, dp = jax_init
    state, vae, disc = create_vae_gan_state(0, cfg, vae=vae, device="cpu",
                                            g_params={"params": copy.deepcopy(gp)},
                                            d_params={"params": copy.deepcopy(dp)})
    return state, vae, disc, make_vae_gan_step_body(vae, disc, cfg, vgg)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32),
             rng.integers(0, CLASSES, B).astype(np.int32)) for _ in range(n)]


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# Leaves whose reference gradient is rounding noise in the first steps, so
# that Adam's normalised step moves them by +-lr in a direction that any
# other summation order may flip: the bias of every convolution that feeds a
# LayerNorm2d (its per-(sample, channel) normalisation removes the bias: zero
# gradient in exact arithmetic), and the channel gates' kernels, whose input
# is the spatial mean of a LayerNorm2d's output, that is its bias, zero at
# init.
NOISE_LEAVES = re.compile(r"((stem_conv|down\d+_conv|res\d+/conv[12])/bias"
                          r"|/ca/(squeeze|excite)/kernel)$")
# Each other leaf: its weights' rms difference within W_RTOL of the rms of
# the reference's move from the init, and its Adam first moments' within
# MU_RTOL of the reference's. The worst readings here were 2.3e-2 (weights,
# the best state after 2 steps of the one-cycle's smallest rates, where an
# element with a near-zero gradient may take Adam's step the other way) and
# 5.7e-3 (moments, D after 5 steps on noise images).
W_RTOL, MU_RTOL = 5e-2, 2e-2


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_leaves_close(got, want, init, got_mu, want_mu, steps, what, lr=1e-4):
    """Each leaf of flax-named trees on its own: the rms of its weights'
    difference within W_RTOL of the rms of the reference's move from
    `init`, and the rms of its Adam first moments' difference (the running
    mean of the gradient, whose scale Adam's step alone does not show)
    within MU_RTOL of the reference's. A NOISE_LEAVES leaf: every weight
    within 2 lr a step of the reference (the largest move Adam can make the
    other way), and its first moment below 1e-6 on both sides, far below
    any true gradient's here."""
    got, want, init, got_mu, want_mu = (dict(_leaves(t)) for t in
                                        (got, want, init, got_mu, want_mu))
    assert set(got) == set(want) == set(got_mu) == set(want_mu)
    for k in want:
        d, dmu = got[k] - want[k], got_mu[k] - want_mu[k]
        if NOISE_LEAVES.search(k):
            assert np.abs(d).max() <= 2 * lr * steps, (what, k, np.abs(d).max())
            assert max(np.abs(got_mu[k]).max(), np.abs(want_mu[k]).max()) < 1e-6, (what, k)
        else:
            assert _rms(d) <= W_RTOL * _rms(want[k] - init[k]), (what, k, _rms(d))
            assert _rms(dmu) <= MU_RTOL * _rms(want_mu[k]), (what, k, _rms(dmu))


def _port_mu(state, vae, disc):
    """The port's Adam first moments as flax-named trees (G's, D's)."""
    return (state_dict_to_flax(dict(zip(state.gen.names, state.gen.mu)), module=vae),
            state_dict_to_flax(dict(zip(state.disc.names, state.disc.mu)), module=disc))


def _jax_mu(jstate):
    """The reference's Adam first moments: G's chain(clip, adamw), D's adam."""
    return jstate.gen.opt_state[1][0].mu, jstate.disc.opt_state[0].mu


def _reference_steps(jax_init, vgg_pair, batches, epochs, dtype="float32"):
    """The reference's jitted step from the same init: (final state, losses,
    the noise its keys draw each step, split(fold_in(rng_i, step))[0], and
    (G weights, D weights, centers, G's and D's Adam first moments) after
    each step, copied to numpy)."""
    jvgg, _ = vgg_pair
    cfg = JaxConfig(compute_dtype=dtype, **COMMON)
    jstate, jvae, jdisc = jax_create_state(jax.random.key(0), cfg)
    gp, dp = jax_init
    jstate = jstate.replace(gen=jstate.gen.replace(params=jax.tree.map(jnp.asarray, gp)),
                            disc=jstate.disc.replace(params=jax.tree.map(jnp.asarray, dp)))
    step = jax_make_step(jvae, jdisc, cfg, jvgg)
    key = jax.random.key(42)
    out, eps, after = [], [], []
    for i, ((imgs, labels), epoch) in enumerate(zip(batches, epochs)):
        rng_i = jax.random.fold_in(key, i)
        reparam, _ = jax.random.split(jax.random.fold_in(rng_i, int(jstate.step)))
        eps.append(np.asarray(jax.random.normal(reparam, (B, LATENT))))
        jstate, m = step(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                         jax_gates(jsched.vae_gan_loss_gates(epoch, 300)), rng_i, jvgg.params)
        out.append({k: float(v) for k, v in m.items()})
        after.append(jax.tree.map(np.array, (jstate.gen.params, jstate.disc.params,
                                             jstate.centers, *_jax_mu(jstate))))
    return jstate, out, eps, after


# Epochs 170 and 250 of 300: every gate on and the centers updating
TRAJECTORY_EPOCHS = (0, 50, 100, 170, 250)


def _jax_aug_draws(key, b):
    """make_augment_fn's draws (rotation 10 degrees, jitter 0.2, flip)."""
    from flowerdiff_torch.data.pipeline import AugmentDraws

    k_flip, k_rot, k_b, k_c, k_s = jax.random.split(key, 5)
    lim = 10.0 * jnp.pi / 180.0
    fs = [np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=0.8, maxval=1.2)).reshape(b)
          for k in (k_b, k_c, k_s)]
    return AugmentDraws(_t(jax.random.bernoulli(k_flip, 0.5, (b,))),
                        _t(jax.random.uniform(k_rot, (b,), minval=-lim, maxval=lim)),
                        *map(_t, fs))


def _rel(a, b, scale):
    return float(np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(a, b)))) / scale


def fused_epochs_case(jax_init, vgg_pair, track_best):
    """The body of test_fused_epochs_match_the_reference (its two cases:
    tests/test_torch_port_vae_gan_fused.py and _best.py)."""
    jvgg, vgg = vgg_pair
    images, labels = synthetic_flowers(8, CLASSES, IMG, seed=3)
    idx, offsets, steps = jax_epoch_rows(5, 8, B, 2)
    gates = np.repeat(np.asarray([jax_gates(jsched.vae_gan_loss_gates(170 + e, 300))
                                  for e in range(2)]), steps, axis=0)
    cfg = JaxConfig(**COMMON)
    jstate, jvae, jdisc = jax_create_state(jax.random.key(0), cfg)
    gp, dp = jax_init
    jstate = jstate.replace(gen=jstate.gen.replace(params=jax.tree.map(jnp.asarray, gp)),
                            disc=jstate.disc.replace(params=jax.tree.map(jnp.asarray, dp)))
    fn = jax_fused_epochs(jvae, jdisc, cfg, jvgg, steps_per_epoch=steps, track_best=track_best)
    key, data_key = jax.random.key(21), jax.random.key(22)
    args = (jstate, jnp.asarray(images), jnp.asarray(labels), idx, offsets, jnp.asarray(gates),
            key, data_key, jvgg.params)
    draws = []
    for r, off in enumerate(np.asarray(offsets)):
        reparam, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, int(off)), r))
        draws.append((_jax_aug_draws(jax.random.fold_in(data_key, int(off)), B),
                      (_t(jax.random.normal(reparam, (B, LATENT))), (None, None))))
    if track_best:
        best0 = jax.tree.map(jnp.copy, jstate)
        jstate, jm, jbl, jbi, jbest = fn(*args, jnp.float32(1e9), best0)
    else:
        jstate, jm = fn(*args)

    state, vae, disc, _ = _port(jax_init)
    fn_t = fused.make_fused_vae_gan_epochs(vae, disc, VAEGANConfig(**COMMON), vgg,
                                           steps_per_epoch=steps, track_best=track_best)
    targs = (state, _t(images), _t(labels).long(), _t(np.asarray(idx)).long(), _t(gates))
    if track_best:
        m, bl, bi, best = fn_t(*targs, draws=draws, best_loss=torch.tensor(1e9),
                               best_state=state.snapshot())
    else:
        m = fn_t(*targs, draws=draws)
    for k in METRICS:
        rtol = 1e-3 if k in ("gan", "d_loss") else 1e-4
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=rtol, err_msg=k)

    def close(st, vae, disc, ref, what):
        ref = jax.tree.map(np.asarray, ref)
        for mod, want, init, got_mu, want_mu in zip(
                (vae, disc), (ref.gen.params, ref.disc.params), jax_init,
                _port_mu(st, vae, disc), _jax_mu(ref)):
            _assert_leaves_close(state_dict_to_flax(mod), want, init, got_mu, want_mu,
                                 st.step, what)
        np.testing.assert_allclose(st.centers.numpy(), ref.centers, atol=1e-5, err_msg=what)

    close(state, vae, disc, jstate, "end")
    if track_best:
        means = m["total"].numpy().reshape(2, steps).mean(axis=1)
        assert int(bi) == int(jbi) == (1 if means[1] < means[0] else 0)
        np.testing.assert_allclose(float(bl), float(jbl), rtol=1e-4)
        # the best state holds that epoch's end: copy it into a fresh state
        fresh, fvae, fdisc, _ = _port(jax_init)
        fresh.restore(best)
        assert fresh.step == int(jbest.gen.step) == 2 * (int(bi) + 1)
        close(fresh, fvae, fdisc, jbest, "best")
