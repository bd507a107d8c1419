"""flowerdiff_torch's VAE-GAN training slice on the CPU against the JAX
package: the losses, the one-cycle schedule and the loss gates, the
discriminator, the VGG features from the in-repo asset, the classifier
head, the VAE's full pass, the weight bridge both ways, the adversarial
term against the updated discriminator, the seeded step's draws and the
configuration's defaults. The 5-step trajectory, both trainers' bf16 lanes
and a tiny trainer are in test_torch_port_vae_gan_steps.py, the fused
epochs in test_torch_port_vae_gan_fused.py; the inputs, fixtures and
helpers they share in torch_port_vae_gan_common.py.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_vae_gan_common import (  # noqa: F401 (fixtures)
    ARCH,
    B,
    CLASSES,
    COMMON,
    Discriminator64,
    FlowerVAE,
    IMG,
    JaxClassifier,
    JaxConfig,
    JaxDisc,
    JaxVAE,
    JaxVGGFeatures,
    LATENT,
    VAEGANConfig,
    VGGPerceptual,
    _assert_trees_equal,
    _batches,
    _leaves,
    _port,
    _t,
    bce_loss,
    center_loss,
    describe_vgg_weights,
    discriminator_loss,
    gates_array,
    generator_adv_loss,
    init_numpy_params,
    jax_gates,
    jax_init,
    jax_kl,
    jcenter,
    jgan,
    jsched,
    kl_divergence,
    load_discriminator,
    load_vgg_params,
    make_vae_gan_step,
    onecycle_schedule,
    standalone_center_loss,
    state_dict_to_flax,
    update_centers,
    vae_from_params,
    vae_gan_loss_gates,
    vgg_pair,
)


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
