"""The latent and pixel fused chunks of the port at world size 2 (two
spawned gloo CPU ranks, tests/torch_port_dist_common.py) against world size
1 and against the JAX package's chunks, with the reference's draws
injected; and at world size 1 in a one-rank group, bit-equal to no process
group (the VAE-GAN's chunk: tests/test_torch_port_parallel_train.py).

- latent, uncached: three steps through the port's parts (gather, encode,
  the denoise body) with the reference's augmentation, posterior noise and
  step draws (as tests/test_torch_port_augment.py holds world size 1), and
  the fused per-step window from the port's own generator;
- pixel (v5 at base 8): 2 epochs of 2 steps at a global batch of 4, with
  the reference's draws and from the port's own; and 2 epochs epoch by
  epoch (`DeviceDataset.batches`, `run_epoch`), without augmentation.

World size 2 against 1: tests/test_fused.py's mesh tolerances (losses rtol
5e-5 / atol 1e-6, parameters rtol 5e-4 / atol 1e-5). Against JAX: the
world-size-1 tests' (latent losses rtol 1e-4, pixel 1e-5). The two ranks'
losses and parameters are bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowerdiff.models.vae import FlowerVAE as JaxVAE
from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff.train.fused import make_fused_latent_epochs as jax_fused_latent
from flowerdiff.train.fused import make_fused_pixel_epochs as jax_fused_pixel
from flowerdiff.train.latent_ddpm import LatentDiffusionConfig as JaxLatentConfig
from flowerdiff.train.latent_ddpm import create_latent_diffusion_state as jax_latent_state
from flowerdiff.train.pixel_ddpm import PixelDiffusionConfig as JaxPixelConfig
from flowerdiff.train.pixel_ddpm import create_pixel_diffusion_state as jax_pixel_state
from flowerdiff_torch.data import synthetic_flowers
from flowerdiff_torch.utils.weights import init_numpy_params
from torch_port_dist_common import assert_close, assert_equal, train_worlds
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)
from torch_port_vae_gan_common import B, _jax_aug_draws, _t

DEN = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=5)
LATENT_VAE = dict(latent_dim=16, channels=(8, 16), head_width=32, base_size=8, num_classes=5)
PIXEL = dict(img_size=16, n_steps=50, base_channels=8, time_emb_dim=16, learnable_residual=True)


def _latent_case():
    common = dict(DEN, dropout_rate=0.0, cond_dropout=0.3, n_steps=50, steps_per_epoch=3,
                  t0=1, weight_decay=1e-2, normalize_latents=True)
    jstate, jmodel, jsched_ = jax_latent_state(jax.random.key(0), JaxLatentConfig(**common))
    params0 = jax.tree.map(np.asarray, jstate.params)
    rng = np.random.default_rng(10)
    for leaf in params0.values():
        if isinstance(leaf, dict) and "bias" in leaf and "kernel" in leaf:
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params0))
    vae_tree = init_numpy_params("vae", seed=1, **{k: v for k, v in LATENT_VAE.items()
                                                   if k != "num_classes"})
    imgs, labels = synthetic_flowers(24, 5, 16, seed=7)
    stats = (rng.standard_normal(16).astype(np.float32) * 0.1, np.full(16, 0.8, np.float32))
    idx, offsets, steps = jax_epoch_rows(3, 24, 8, 1)
    key, data_key = jax.random.key(21), jax.random.key(22)
    ones = [_t(np.ones((8, d), np.float32)) for d in DEN["hidden_dims"][:-1] for _ in range(2)]
    aug, noise, draws = [], [], []
    for r, off in enumerate(np.asarray(offsets)):
        aug.append(_jax_aug_draws(jax.random.fold_in(data_key, int(off)), 8))
        step_key = jax.random.fold_in(jax.random.fold_in(key, int(off)), r)
        enc_key, loss_key, _, cfg_key = jax.random.split(step_key, 4)
        t_key, eps_key = jax.random.split(loss_key)
        draws.append((_t(jax.random.randint(t_key, (8,), 0, 50)).long(),
                      _t(jax.random.normal(eps_key, (8, 16), jnp.float32)),
                      _t(np.asarray(jax.random.bernoulli(cfg_key, 0.7, (8,)), np.float32)),
                      ones))
        noise.append(_t(jax.random.normal(enc_key, (8, 16), jnp.float32)))
    payload = dict(cfg=common, vae_arch=LATENT_VAE, vae_tree=vae_tree, images=imgs,
                   labels=labels, stats=stats, params=params0, steps=steps,
                   idx=[np.asarray(r).astype(np.int64) for r in np.asarray(idx)],
                   aug=aug, noise=noise, draws=draws)

    def run():
        jvae = JaxVAE(**LATENT_VAE)
        fn = jax_fused_latent(jmodel, jvae, jsched_, JaxLatentConfig(**common),
                              steps_per_epoch=steps)
        st, losses = fn(jstate, jax.tree.map(jnp.asarray, vae_tree["params"]), jsched_,
                        jnp.asarray(imgs), jnp.asarray(labels, jnp.int32), None, idx, offsets,
                        key, data_key, tuple(map(jnp.asarray, stats)))
        return np.asarray(losses)

    return payload, run


def _pixel_case():
    jstate, jmodel, jsched_ = jax_pixel_state(jax.random.key(0), JaxPixelConfig(**PIXEL))
    tree = init_numpy_params("pixel", seed=4, learnable_residual=True,
                             base_channels=PIXEL["base_channels"],
                             time_emb_dim=PIXEL["time_emb_dim"])
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree["params"]))
    images, _ = synthetic_flowers(8, 5, 16, seed=3)
    idx, offsets, steps = jax_epoch_rows(5, 8, B, 2)
    rng, data_key = jax.random.key(21), jax.random.key(22)
    draws = []
    for r, off in enumerate(np.asarray(offsets)):
        t_key, eps_key = jax.random.split(jax.random.fold_in(jax.random.fold_in(rng, int(off)),
                                                             r))
        draws.append((_jax_aug_draws(jax.random.fold_in(data_key, int(off)), B),
                      (_t(jax.random.randint(t_key, (B,), 0, 50)).long(),
                       _t(jax.random.normal(eps_key, (B, 16, 16, 3))))))
    payload = dict(cfg=PIXEL, images=images, idx=np.asarray(idx), steps=steps, tree=tree,
                   draws=draws)

    def run():
        fn = jax_fused_pixel(jmodel, JaxPixelConfig(**PIXEL), steps_per_epoch=steps)
        _st, losses = fn(jstate, jsched_, jnp.asarray(images), idx, offsets, rng, data_key)
        return np.asarray(losses)

    return payload, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    (latent, run_latent), (pixel, run_pixel) = _latent_case(), _pixel_case()
    return train_worlds({"latent": latent, "pixel": pixel, "pixel_loop": pixel},
                        tmp_path_factory,
                        lambda: {"latent": run_latent(), "pixel": run_pixel()})


@pytest.mark.parametrize("chunk,jax_rtol", [("latent", 1e-4), ("pixel", 1e-5)])
@pytest.mark.parametrize("form", ["injected", "seeded"])
def test_diffusion_chunks_at_world_size_two(runs, chunk, jax_rtol, form):
    """Losses and parameters of world size 2 against world size 1, the
    ranks bit-equal; with the injected draws, the losses against JAX."""
    ws1 = runs["alone"][chunk][form]
    rank0, rank1 = (r[chunk][form] for r in runs["two"])
    np.testing.assert_allclose(rank0[0], ws1[0], rtol=5e-5, atol=1e-6)
    assert_close(rank0[1], ws1[1])
    assert_equal([rank1[0]] + rank1[1], [rank0[0]] + rank0[1])
    if form == "injected":
        np.testing.assert_allclose(rank0[0], runs["jax"][chunk], rtol=jax_rtol)


def test_epoch_by_epoch_training_at_world_size_two(runs):
    """`DeviceDataset.batches` on the mesh hands each rank its rows of the
    global batch and its draws; `run_epoch(mesh=)` averages the gradients:
    two pixel epochs as world size 1 trains them, the ranks bit-equal."""
    ws1 = runs["alone"]["pixel_loop"]
    rank0, rank1 = (r["pixel_loop"] for r in runs["two"])
    np.testing.assert_allclose(rank0[0], ws1[0], rtol=5e-5, atol=1e-6)
    assert_close(rank0[1], ws1[1])
    assert_equal([rank1[0]] + rank1[1], [rank0[0]] + rank0[1])
    assert_equal([runs["one"][0]["pixel_loop"][0]] + runs["one"][0]["pixel_loop"][1],
                 [ws1[0]] + ws1[1])


@pytest.mark.parametrize("chunk", ["latent", "pixel"])
def test_world_size_one_group_is_bit_equal_to_no_group(runs, chunk):
    (one,), alone = runs["one"], runs["alone"]
    for form in ("injected", "seeded"):
        assert_equal([one[chunk][form][0]] + one[chunk][form][1],
                     [alone[chunk][form][0]] + alone[chunk][form][1])
