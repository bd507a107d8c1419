"""flowerdiff_torch's VAE-GAN step on the CPU against the JAX package: a
5-step trajectory of `make_vae_gan_step` leaf by leaf, the latent
trainer's bf16 lane within twice the reference's own bf16-to-f32 gap, and
a tiny trainer (inputs and helpers: torch_port_vae_gan_common.py; the
VAE-GAN's bf16 lane: test_torch_port_vae_gan_bf16.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_vae_gan_common import (  # noqa: F401 (fixtures)
    B,
    CLASSES,
    COMMON,
    DeviceDataset,
    IMG,
    JaxLatentConfig,
    LatentDiffusionConfig,
    METRICS,
    TRAJECTORY_EPOCHS,
    VAEGANConfig,
    VAEGANTrainer,
    _assert_leaves_close,
    _batches,
    _leaves,
    _port,
    _port_mu,
    _reference_steps,
    _rel,
    _t,
    create_latent_diffusion_state,
    gates_array,
    jax_euclid,
    jax_init,
    jax_latent_state,
    jax_q_sample,
    make_latent_denoise_body,
    no_dropout,
    state_dict_to_flax,
    synthetic_flowers,
    vae_gan_loss_gates,
    vgg_pair,
)


# ---------------------------------------------------------------- the step


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


# ---------------------------------------------------------------- bf16


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
