"""flowerdiff_torch's VAE-GAN training slice on the CPU against the JAX
package, at a tiny width: channels (8, 16, 24, 32), latent 8, 10 classes,
64x64 images (the discriminator's fixed ladder needs 64), batch 4. The
losses, the one-cycle schedule and the loss gates, the discriminator, the
VGG features from the in-repo asset, the classifier head, the VAE's full
pass, the weight bridge both ways, a 5-step trajectory of the step, the
fused epochs in both forms, both trainers' bf16 lanes and a tiny trainer.

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


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("loss", ["kl", "gan", "center", "update_centers", "standalone"])
def test_losses_match_jax(loss):
    """Each loss on the same numpy inputs; the clamps of the KL (mu beyond
    10, logvar beyond [-2, 10], a per-sample KL beyond 100) are exercised,
    and the center update leaves the classes absent from the batch as they
    were. Same f32 formulas: rtol 1e-6."""
    rng = np.random.default_rng(1)
    if loss == "kl":
        mu = (rng.standard_normal((6, 8)) * 4).astype(np.float32)
        mu[0, 0] = 30.0
        logvar = np.linspace(-6, 14, 48, dtype=np.float32).reshape(6, 8)
        ref, got = jax_kl(mu, logvar), kl_divergence(_t(mu), _t(logvar))
    elif loss == "gan":
        real, fake = (rng.standard_normal(9).astype(np.float32) * 5 for _ in range(2))
        real[0], fake[0] = 80.0, -80.0  # log1p(exp(-|x|)) stays finite
        ref = np.array([jgan.bce_loss(real, np.float32(0.3) * np.ones_like(real)),
                        jgan.discriminator_loss(real, fake), jgan.generator_adv_loss(fake)])
        got = torch.stack([bce_loss(_t(real), 0.3 * torch.ones(9)),
                           discriminator_loss(_t(real), _t(fake)), generator_adv_loss(_t(fake))])
    else:
        z = rng.standard_normal((12, 8)).astype(np.float32)
        labels = np.array([0, 0, 2, 2, 2, 5, 7, 7, 0, 9, 5, 2], np.int32)  # 1, 3, 4, 6, 8 absent
        centers = rng.standard_normal((CLASSES, 8)).astype(np.float32) * 0.3
        if loss == "center":
            ref, got = (jcenter.center_loss(z, labels, centers),
                        center_loss(_t(z), _t(labels).long(), _t(centers)))
        elif loss == "update_centers":
            ref = jcenter.update_centers(centers, z, labels)
            got = update_centers(_t(centers), _t(z), _t(labels).long())
            absent = [1, 3, 4, 6, 8]
            np.testing.assert_array_equal(got.numpy()[absent], centers[absent])
            assert not np.allclose(got.numpy()[0], centers[0])
        else:
            ref = jcenter.standalone_center_loss(z, labels, centers, min_distance=1.5)
            got = standalone_center_loss(_t(z), _t(labels).long(), _t(centers), min_distance=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("total_steps", [18000, 100, 20])
def test_onecycle_schedule_matches_optax(total_steps):
    """The schedule against the reference's optax one-cycle at its edges and
    phase changes: the first steps, the peak at int(0.3 T), the end at T and
    after it (the final value). f32 on both sides; the cosine's libm and the
    cancellation near the ends differ by an ulp or two of the peak rate:
    atol 2e-7 x max_lr."""
    lr, t = 1e-4, total_steps
    peak = int(0.3 * t)
    steps = sorted({0, 1, 2, peak - 1, peak, peak + 1, t // 2, t - 2, t - 1, t, t + 1, t + 100})
    ref_fn = jax.jit(jsched.onecycle_schedule(lr, t))
    ref = np.array([float(ref_fn(jnp.int32(s))) for s in steps])
    fn = onecycle_schedule(lr, t)
    got = np.array([fn(s) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7 * lr)
    assert got[steps.index(peak)] == pytest.approx(lr, rel=1e-6)
    assert got[0] == pytest.approx(lr / 25, rel=1e-5)  # f32 cancellation: 1e-4 - 9.6e-5
    assert got[-1] == pytest.approx(lr / 25 / 1000, rel=1e-5)
    with pytest.raises(ValueError):
        onecycle_schedule(lr, 0)


def test_loss_gates_match_the_reference():
    for epoch in (0, 39, 40, 59, 60, 79, 80, 159, 160, 1199):
        ref = tuple(jsched.vae_gan_loss_gates(epoch, 1200))
        assert tuple(vae_gan_loss_gates(epoch, 1200)) == ref
        got = gates_array(vae_gan_loss_gates(epoch, 1200))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_gates(
            jsched.vae_gan_loss_gates(epoch, 1200))))
    assert tuple(vae_gan_loss_gates(160, 1200))[1:] == (1.0, 1.0, 1.0, 1.0)


# ---------------------------------------------------------------- modules


def test_discriminator_matches_jax(jax_init):
    """Logits (B,) of Discriminator64 from the reference's init with
    perturbed GroupNorm affines and biases (so that leaving one out would
    show). f32 convolutions summed in another order: rtol 1e-4."""
    _, dp = jax_init
    rng = np.random.default_rng(2)
    dp = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                      if a.ndim == 1 else a, dp)
    x = rng.uniform(size=(3, IMG, IMG, 3)).astype(np.float32)
    ref = np.asarray(JaxDisc().apply({"params": dp}, jnp.asarray(x)))
    disc = load_discriminator(Discriminator64(device="cpu"), {"params": dp})
    with torch.no_grad():
        got = disc(_t(x))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert disc.norm1.eps == 1e-6
    _assert_trees_equal(state_dict_to_flax(disc), dp)


def test_vgg_features_and_perceptual_match_jax(vgg_pair, tmp_path):
    """VGG16 features[:16] from the in-repo asset and the perceptual loss:
    rtol 1e-4 (f32 convolutions). Without an asset the filters are seeded
    random and say so."""
    jvgg, vgg = vgg_pair
    assert jvgg.pretrained and vgg.pretrained
    rng = np.random.default_rng(3)
    x, y = (rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    ref_f = np.asarray(jvgg.features(jnp.asarray(x)))  # NHWC
    with torch.no_grad():
        got_f = vgg.features(_t(x)).permute(0, 2, 3, 1).numpy()
    assert got_f.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(got_f, ref_f, rtol=1e-4, atol=1e-4 * np.abs(ref_f).max())
    ref = float(jvgg(jnp.asarray(x), jnp.asarray(y)))
    got = vgg(_t(x), _t(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=1e-4)
    assert not any(p.requires_grad for p in vgg.parameters())
    params, pretrained = load_vgg_params()
    np.testing.assert_array_equal(params["conv3_3"]["kernel"],
                                  np.asarray(jvgg.params["params"]["conv3_3"]["kernel"]))
    missing = str(tmp_path / "none.npz")
    params, pretrained = load_vgg_params(missing, seed=1)
    assert not pretrained and describe_vgg_weights(missing) == "random-filters"
    assert describe_vgg_weights() != "random-filters"
    rand = VGGPerceptual(params, pretrained, device="cpu")
    assert not rand.pretrained and np.isfinite(float(rand(_t(x), _t(y))))
    # the reference module on the same random filters gives the same features
    ref_r = np.asarray(JaxVGGFeatures().apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got_r = rand.features_net(_t(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_r, ref_r, rtol=1e-4, atol=1e-4 * np.abs(ref_r).max())


def test_classifier_matches_jax_in_eval_mode_and_with_flax_masks(jax_init):
    """The classifier head from the reference's init (biases perturbed) in
    eval mode, then in train mode with the masks flax's Dropout drew, read
    from capture_intermediates, injected. rtol 1e-5."""
    gp, _ = jax_init
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                          if a.ndim == 1 else a, gp["classifier"])
    z = rng.standard_normal((6, LATENT)).astype(np.float32)
    jcls = JaxClassifier(CLASSES)
    vae = vae_from_params({"params": {**gp, "classifier": params}}, device="cpu",
                          num_classes=CLASSES, **ARCH)
    ref = np.asarray(jcls.apply({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        got = vae.classify(_t(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    ref, inter = jcls.apply({"params": params}, jnp.asarray(z), deterministic=False,
                            rngs={"dropout": jax.random.key(5)},
                            capture_intermediates=True, mutable=["intermediates"])
    drops = inter["intermediates"]
    masks = tuple(_t(np.asarray(drops[name]["__call__"][0]) != 0) for name in ("drop1", "drop2"))
    assert 0.5 < float(masks[0].float().mean()) < 0.9  # keep 0.7
    with torch.no_grad():
        got = vae.classify(_t(z), deterministic=False, masks=masks)
        drawn = vae.classify(_t(z), deterministic=False,
                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(drawn, got)
    with pytest.raises(ValueError, match="classifier"):
        FlowerVAE(**ARCH).classify(_t(z))


def test_full_pass_matches_jax_with_the_reference_noise(jax_init):
    """FlowerVAE.autoencode against the reference's __call__ (recon, mu,
    logvar, z) with its reparameterisation noise recomputed from its key:
    rtol 1e-4 (f32 convolutions)."""
    gp, _ = jax_init
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    key = jax.random.key(6)
    ref = JaxVAE(num_classes=CLASSES, **ARCH).apply({"params": gp}, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, (B, LATENT)))
    vae = vae_from_params({"params": gp}, device="cpu", num_classes=CLASSES, **ARCH)
    with torch.no_grad():
        got = vae.autoencode(_t(x), noise=_t(eps))
    for name, g, r in zip(("recon", "mu", "logvar", "z"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
    assert got[0].shape == (B, IMG, IMG, 3)


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_weight_bridge_both_ways(jax_init, vgg_pair):
    """A generator trained a step in the port goes back through
    state_dict_to_flax, loads into the reference's FlowerVAE and gives the
    port's reconstruction (rtol 1e-4); the bridge is its own inverse, bit
    for bit, for the generator and the discriminator; the trained tree
    loads into a classifier-less FlowerVAE for the latent paths; the
    seeded `init_numpy_params` kinds have the reference's tree shapes."""
    state, vae, disc, body = _port(jax_init)
    (imgs, labels), = _batches(1)
    body(state, _t(imgs), _t(labels).long(), gates_array(vae_gan_loss_gates(200, 300)),
         draws=(torch.randn(B, LATENT), (None, None)))
    tree = state_dict_to_flax(vae)
    _assert_trees_equal(state_dict_to_flax(vae_from_params(
        {"params": tree}, device="cpu", num_classes=CLASSES, **ARCH)), tree)
    dtree = state_dict_to_flax(disc)
    _assert_trees_equal(state_dict_to_flax(load_discriminator(
        Discriminator64(device="cpu"), {"params": dtree})), dtree)
    # the Adam moments are keyed like the module: the dict form with `module`
    mu = state_dict_to_flax(dict(zip(state.gen.names, state.gen.mu)), module=vae)
    assert {k for k, _ in _leaves(mu)} == {k for k, _ in _leaves(tree)}

    x = np.random.default_rng(8).uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    eps = np.random.default_rng(9).standard_normal((B, LATENT)).astype(np.float32)
    with torch.no_grad():
        got = vae.autoencode(_t(x), noise=_t(eps))[0].numpy()

    def full_pass(m, x, e):  # the reference's __call__ with the noise given
        mu, logvar = m.encoder(x)
        return m.decoder(mu + e * jnp.exp(0.5 * jnp.clip(logvar, -2.0, 10.0)))

    ref = JaxVAE(num_classes=CLASSES, **ARCH).apply({"params": tree}, jnp.asarray(x),
                                                     jnp.asarray(eps), method=full_pass)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    latent_vae = vae_from_params({"params": tree}, device="cpu", **ARCH)
    assert latent_vae.classifier is None
    with torch.no_grad():
        np.testing.assert_array_equal(latent_vae.decode(_t(eps)).numpy(),
                                      vae.decode(_t(eps)).numpy())
    # the seeded kinds: the reference's init_all tree and Discriminator64's
    gp, dp = jax_init
    shapes = lambda tree: {k: v.shape for k, v in _leaves(tree)}  # noqa: E731
    gen = init_numpy_params("generator", seed=3, bias_std=0.0, num_classes=CLASSES, **ARCH)
    assert shapes(gen["params"]) == shapes(gp)
    assert shapes(init_numpy_params("discriminator", seed=3)["params"]) == shapes(dp)
    assert all(not v.any() for k, v in _leaves(gen["params"]) if k.endswith("bias"))


# ---------------------------------------------------------------- the step


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


def test_five_step_trajectory_matches_the_reference(jax_init, vgg_pair, no_dropout):
    """Five steps of make_vae_gan_step (VGG on; the gates of epochs 0, 50,
    100, 170 and 250 of 300, so the last two have every term on and update
    the centers; the one-cycle over 20 steps). Each step: every loss term
    and D's loss within rtol 1e-4, except D's loss and the adversarial term,
    rtol 1e-3 (on these noise images some of D's gradients are near f32
    rounding, where the two sides' summation orders differ). After each
    step: the centers within 1e-5, and each leaf of the generator and the
    discriminator, weights and Adam moments, as `_assert_leaves_close`
    holds it."""
    batches = _batches(5)
    jstate, ref, eps, after = _reference_steps(jax_init, vgg_pair, batches,
                                               TRAJECTORY_EPOCHS)
    state, vae, disc, body = _port(jax_init, vgg_pair[1])
    for i, ((imgs, labels), epoch, e) in enumerate(zip(batches, TRAJECTORY_EPOCHS, eps)):
        m = body(state, _t(imgs), _t(labels).long(), gates_array(vae_gan_loss_gates(epoch, 300)),
                 draws=(_t(e), (None, None)))
        for k in METRICS:
            rtol = 1e-3 if k in ("gan", "d_loss") else 1e-4
            np.testing.assert_allclose(float(m[k]), ref[i][k], rtol=rtol, err_msg=f"{k} {i}")
        g_ref, d_ref, c_ref, g_mu, d_mu = after[i]
        np.testing.assert_allclose(state.centers.numpy(), c_ref, atol=1e-5, err_msg=f"{i}")
        for mod, want, init, got_mu, want_mu in zip((vae, disc), (g_ref, d_ref), jax_init,
                                                    _port_mu(state, vae, disc), (g_mu, d_mu)):
            _assert_leaves_close(state_dict_to_flax(mod), want, init, got_mu, want_mu, i + 1,
                                 f"step {i}")
    assert state.step == 5 == int(jstate.step)
    assert float(state.centers.abs().sum()) > 0  # the last two steps updated them


def test_adversarial_term_sees_the_updated_discriminator(jax_init):
    """The step's adversarial term is BCE(D(recon), 1) with D AFTER its
    Adam step: recomputed from the pre-step generator and the post-step
    discriminator it matches to 1e-6, and against the pre-step
    discriminator it would be far off (D's rate raised to 1e-2 so that one
    step moves it). No gradient lands in D's parameters."""
    cfg = VAEGANConfig(d_lr=1e-2, **COMMON)
    state, vae, disc, body = _port(jax_init, cfg=cfg)
    (imgs, labels), = _batches(1, seed=11)
    eps = torch.randn(B, LATENT, generator=torch.Generator().manual_seed(1))
    vae0, disc0 = copy.deepcopy(vae), copy.deepcopy(disc)
    m = body(state, _t(imgs), _t(labels).long(), gates_array(vae_gan_loss_gates(200, 300)),
             draws=(eps, (None, None)))
    with torch.no_grad():
        recon = vae0.autoencode(_t(imgs), noise=eps)[0]
        new, old = generator_adv_loss(disc(recon)), generator_adv_loss(disc0(recon))
    np.testing.assert_allclose(float(m["gan"]), float(new), rtol=1e-6)
    assert abs(float(old) - float(new)) > 1e-2
    assert all(p.grad is None for p in disc.parameters())
    assert all(p.grad is None for p in vae.parameters())


# ---------------------------------------------------------------- fused epochs


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


@pytest.mark.parametrize("track_best", [False, True])
def test_fused_epochs_match_the_reference(jax_init, vgg_pair, no_dropout, track_best):
    """make_fused_vae_gan_epochs: 2 epochs x 2 steps over 8 augmented
    synthetic images (epoch 170 of 300: every term on, centers updating)
    against the reference's fused epochs, its augmentation draws
    (fold_in(data_key, offset)) and noise (fold_in(fold_in(rng, offset),
    step)) injected. Per-step losses as the trajectory test; each leaf's
    weights and moments after 4 steps, and the centers, as there. With
    track_best: the same best epoch, its loss, and the best state's leaves
    and centers."""
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


# ---------------------------------------------------------------- bf16


def _rel(a, b, scale):
    return float(np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(a, b)))) / scale


def test_vae_gan_bf16_step_is_within_twice_the_reference_gap(jax_init, vgg_pair, no_dropout):
    """compute_dtype='bfloat16', one step with every gate on: the port's
    gradients against the reference's bf16 gradients, within twice the
    reference's own bf16-to-f32 gap (the relative global norm, the
    generator's and the discriminator's apart). The gradients are read from
    Adam's first moments after the step, mu = (1 - b1) g on both sides (the
    generator's after its clip). Torch autocast rounds at other places than
    flax's dtype (norm outputs stay f32), so the two bf16 runs agree only to
    bf16's own scale. (Losses after more steps are no measure: D's Adam
    steps of size lr on rounding-noise gradients make them scatter.) The
    losses are finite; parameters and moments stay f32."""
    batches = _batches(1, seed=12)
    refs = {dt: _reference_steps(jax_init, vgg_pair, batches, (200,), dt)
            for dt in ("float32", "bfloat16")}
    eps = refs["float32"][2]
    cfg = VAEGANConfig(compute_dtype="bfloat16", **COMMON)
    state, vae, disc, body = _port(jax_init, vgg_pair[1], cfg=cfg)
    (imgs, labels), = batches
    m = body(state, _t(imgs), _t(labels).long(), gates_array(vae_gan_loss_gates(200, 300)),
             draws=(_t(eps[0]), (None, None)))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(t.dtype == torch.float32 for t in state.tensors())
    port = {"gen": state_dict_to_flax(dict(zip(state.gen.names, state.gen.mu)), module=vae),
            "disc": state_dict_to_flax(dict(zip(state.disc.names, state.disc.mu)), module=disc)}
    for part in ("gen", "disc"):
        ref32, ref16 = (dict(_leaves(jax.tree.map(np.asarray, refs[dt][0].gen.opt_state[1][0].mu
                                                  if part == "gen" else
                                                  refs[dt][0].disc.opt_state[0].mu)))
                        for dt in ("float32", "bfloat16"))
        got = dict(_leaves(port[part]))
        names = sorted(ref32)
        scale = float(np.sqrt(sum(np.sum(ref32[k] ** 2) for k in names)))
        gap = _rel([ref16[k] for k in names], [ref32[k] for k in names], scale)
        dist = _rel([got[k] for k in names], [ref16[k] for k in names], scale)
        assert 0 < gap < 1 and dist <= 2 * gap, (part, dist, gap)


def test_latent_bf16_step_is_within_twice_the_reference_gap():
    """LatentDiffusionConfig(compute_dtype='bfloat16') in the eager body:
    the gradient of one step, from the reference's init with perturbed
    biases and injected t, eps and condition mask, against the reference's
    bf16 gradient, within twice the reference's own bf16-to-f32 gap (the
    relative global norm); the moments and weights stay f32. Any other
    compute_dtype raises."""
    den = dict(latent_dim=32, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=7)
    common = dict(dropout_rate=0.0, cond_dropout=0.3, n_steps=50, **den)
    rng = np.random.default_rng(13)
    z = rng.standard_normal((8, 32)).astype(np.float32)
    eps = rng.standard_normal((8, 32)).astype(np.float32)
    labels = rng.integers(0, 7, 8).astype(np.int32)
    t = rng.integers(0, 50, 8).astype(np.int32)
    keep = (rng.random(8) >= 0.3).astype(np.float32)
    jstate, jmodel, jsch = jax_latent_state(jax.random.key(0), JaxLatentConfig(**common))
    params0 = jax.tree.map(np.asarray, jstate.params)
    for leaf in params0.values():
        if isinstance(leaf, dict) and "bias" in leaf and "kernel" in leaf:
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    grads = {}
    for dtype, module in (("float32", jmodel), ("bfloat16", jmodel.clone(dtype=jnp.bfloat16))):
        def loss_fn(p, module=module):
            out = module.apply({"params": p}, jax_q_sample(jsch, z, t, eps), t, labels,
                               cond_mask=keep)
            return jax_euclid(eps, out)

        grads[dtype] = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params0))
    cfg = LatentDiffusionConfig(compute_dtype="bfloat16", **common)
    state, model, sched = create_latent_diffusion_state(0, cfg, device="cpu",
                                                        params={"params": params0})
    captured = []
    state.apply_gradients = captured.append
    ones = [torch.ones(8, d) for d in den["hidden_dims"][:-1] for _ in range(2)]
    make_latent_denoise_body(model, cfg)(state, sched, _t(z), _t(labels).long(), None,
                                         draws=(_t(t).long(), _t(eps), _t(keep), ones))
    port = dict(_leaves(state_dict_to_flax(captured[0], model)))
    ref16, ref32 = (dict(_leaves(jax.tree.map(np.asarray, grads[d])))
                    for d in ("bfloat16", "float32"))
    names = sorted(ref32)
    scale = float(np.sqrt(sum(np.sum(ref32[k] ** 2) for k in names)))
    gap = _rel([ref16[k] for k in names], [ref32[k] for k in names], scale)
    dist = _rel([port[k] for k in names], [ref16[k] for k in names], scale)
    assert 0 < gap < 0.1 and dist <= 2 * gap, (dist, gap)
    assert all(g.dtype == torch.float32 for g in captured[0].values())
    with pytest.raises(ValueError, match="compute_dtype"):
        create_latent_diffusion_state(0, dataclasses.replace(cfg, compute_dtype="float16"),
                                      device="cpu")


# ---------------------------------------------------------------- trainer


def test_tiny_trainer_trains_tracks_its_best_state_and_is_reproducible():
    """VAEGANTrainer on device='cpu' (no VGG, seeded init): run_epoch over
    host batches, then run_epochs_fused over an augmented DeviceDataset
    with the best-state policy. The best epoch is the one the epoch means
    say; two trainers from one seed give bit-equal metrics and weights;
    remat recomputes the encoder's blocks and changes no number."""
    images, labels = synthetic_flowers(8, CLASSES, IMG, seed=4)
    ds = DeviceDataset(images, labels, device="cpu")
    cfg = VAEGANConfig(use_perceptual=False, **COMMON)

    def run(**over):
        trainer = VAEGANTrainer(dataclasses.replace(cfg, **over), seed=2, device="cpu")
        imgs, labs = ds.full()
        first = trainer.run_epoch([(imgs[i:i + B], labs[i:i + B]) for i in range(0, 8, B)],
                                  200, 300, seed=1)
        out, best = trainer.run_epochs_fused(ds, 200, 300, 2, seed=3, batch_size=B,
                                             best=(first["total"], None))
        return trainer, first, out, best

    trainer, first, out, (bl, bi, best) = run()
    assert trainer.vgg is None and trainer.state.step == 2 + 4
    assert set(first) == set(METRICS) and all(np.isfinite(v) for v in first.values())
    means = [first["total"]] + [o["total"] for o in out]
    pick = int(np.argmin(means))
    assert bi == (None if pick == 0 else 200 + pick - 1)
    assert bl == pytest.approx(means[pick], rel=1e-6)
    assert int(best.step) == 2 + 2 * pick
    again, first2, out2, _ = run()
    assert first2 == first and out2 == out
    for a, b in zip(trainer.state.tensors(), again.state.tensors()):
        assert torch.equal(a, b)
    remat, first3, out3, _ = run(remat=True)
    assert remat.vae.encoder.remat
    np.testing.assert_allclose([o["total"] for o in out3], [o["total"] for o in out], rtol=1e-6)
    with pytest.raises(ValueError, match="compute_dtype"):
        VAEGANTrainer(dataclasses.replace(cfg, compute_dtype="float16"), device="cpu")


def test_seeded_step_draws_from_the_derived_generator(jax_init):
    """make_vae_gan_step draws the noise, then the classifier's keep masks,
    from the generator of (seed, step): equal seeds give equal metrics,
    another seed other ones."""
    cfg = VAEGANConfig(**COMMON)
    (imgs, labels), = _batches(1, seed=14)
    gates = gates_array(vae_gan_loss_gates(200, 300))
    out = []
    for seed in (1, 1, 2):
        state, vae, disc, _ = _port(jax_init)
        step = make_vae_gan_step(vae, disc, cfg)
        out.append(step(state, _t(imgs), _t(labels).long(), gates, seed)["total"])
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])


def test_config_defaults_match_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(VAEGANConfig)}
    assert got == ref
