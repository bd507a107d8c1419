"""The VAE-GAN's fused chunk of the port at world size 2 (two spawned gloo
CPU ranks, tests/torch_port_dist_common.py) against world size 1 and
against the JAX package's chunk, the reference's draws injected as
tests/torch_port_vae_gan_common.py::fused_epochs_case does; at world size
1 in a one-rank group, bit-equal to no process group; and the guards of the
latent cache and the train-step kernel (the latent and pixel chunks:
tests/test_torch_port_parallel_train_diffusion.py).

The chunk: tiny width, no perceptual term, no dropout (the JAX side's flax
Dropout is the identity, the port's masks None), 2 epochs of 2 steps at a
global batch of 4; again from the port's own generators (no injection),
where world size 2 must follow world size 1 as closely. World size 2
against 1: tests/test_fused.py's mesh tolerances (metrics rtol 5e-5 / atol
1e-6, the generator within 3 updates a leaf, the centers rtol 5e-4 / atol
1e-5). Against JAX: the world-size-1 test's (metrics rtol 1e-4, 1e-3 for
the adversarial terms; centers 1e-5). The two ranks' states and metrics are
bit-equal. The latent cache and the train-step kernel raise at world size 2
with the reference's words, and run at world size 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn

from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff_torch.data import synthetic_flowers
from torch_port_dist_common import assert_close, assert_equal, train_worlds
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)
from torch_port_vae_gan_common import (
    COMMON,
    B,
    CLASSES,
    IMG,
    LATENT,
    JaxConfig,
    _jax_aug_draws,
    _t,
    jax_create_state,
    jax_fused_epochs,
    jax_gates,
    jsched,
)

DEN = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=5)
LATENT_VAE = dict(latent_dim=16, channels=(8, 16), head_width=32, base_size=8, num_classes=5)


def _vae_gan_case():
    """(payload, run): run() -> JAX's metrics and centers."""
    cfg = dict(COMMON, use_perceptual=False)
    images, labels = synthetic_flowers(8, CLASSES, IMG, seed=3)
    idx, offsets, steps = jax_epoch_rows(5, 8, B, 2)
    gates = np.repeat(np.asarray([jax_gates(jsched.vae_gan_loss_gates(170 + e, 300))
                                  for e in range(2)]), steps, axis=0)
    jstate, jvae, jdisc = jax_create_state(jax.random.key(0), JaxConfig(**cfg))
    gp, dp = (jax.tree.map(np.asarray, t) for t in (jstate.gen.params, jstate.disc.params))
    key, data_key = jax.random.key(21), jax.random.key(22)
    draws = []
    for r, off in enumerate(np.asarray(offsets)):
        reparam, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, int(off)), r))
        draws.append((_jax_aug_draws(jax.random.fold_in(data_key, int(off)), B),
                      (_t(jax.random.normal(reparam, (B, LATENT))), (None, None))))
    payload = dict(cfg=cfg, images=images, labels=labels, idx=np.asarray(idx), gates=gates,
                   steps=steps, gp=gp, dp=dp, draws=draws)

    def run():
        fn = jax_fused_epochs(jvae, jdisc, JaxConfig(**cfg), None, steps_per_epoch=steps)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=True, rng=None: x)
            st, m = fn(jstate, jnp.asarray(images), jnp.asarray(labels), idx, offsets,
                       jnp.asarray(gates), key, data_key, None)
        return {k: np.asarray(v) for k, v in m.items()}, np.asarray(st.centers)

    return payload, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload, run = _vae_gan_case()
    images, labels = synthetic_flowers(8, 5, 16, seed=7)
    guards = dict(cfg=dict(DEN, n_steps=50), vae_arch=LATENT_VAE, images=images,
                  labels=labels)
    return train_worlds({"vae_gan": payload, "guards": guards}, tmp_path_factory, run)


def _close_to_update_scale(init, a, b, k=3.0):
    """tests/test_fused.py's per-leaf bound: |a - b| <= k max|update|."""
    for x0, xa, xb in zip(init, a, b, strict=True):
        upd = max(np.max(np.abs(xa - x0)), np.max(np.abs(xb - x0)))
        assert np.max(np.abs(xa - xb)) <= k * upd + 1e-12


@pytest.mark.parametrize("form", ["injected", "seeded"])
def test_vae_gan_chunk_at_world_size_two(runs, form):
    """Metrics (so the best epoch too) and centers of world size 2 against
    world size 1, the generator within 3 updates a leaf; with the injected
    draws, the metrics and centers against JAX."""
    alone = runs["alone"]["vae_gan"]
    ws1, (rank0, rank1) = alone[form], [r["vae_gan"][form] for r in runs["two"]]
    for k in ws1[0]:
        np.testing.assert_allclose(rank0[0][k], ws1[0][k], rtol=5e-5, atol=1e-6, err_msg=k)
    _close_to_update_scale(alone["init"], rank0[1], ws1[1])
    assert_close(rank0[2][-1:], ws1[2][-1:])  # the centers
    for k in ws1[0]:
        np.testing.assert_array_equal(rank1[0][k], rank0[0][k])
    assert_equal(rank1[2], rank0[2])
    if form == "injected":
        jm, jcenters = runs["jax"]
        for k in jm:
            rtol = 1e-3 if k in ("gan", "d_loss") else 1e-4
            np.testing.assert_allclose(rank0[0][k], jm[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(rank0[2][-1], jcenters, atol=1e-5)


def test_world_size_one_group_is_bit_equal_to_no_group(runs):
    (one,), alone = runs["one"], runs["alone"]["vae_gan"]
    for form in ("injected", "seeded"):
        for k, v in alone[form][0].items():
            np.testing.assert_array_equal(one["vae_gan"][form][0][k], v)
        assert_equal(one["vae_gan"][form][2], alone[form][2])


def test_cache_and_kernel_raise_above_one_rank_only(runs):
    for rank in runs["two"]:
        assert rank["guards"]["cache"] == (
            "latent_cache is the single-chip fast path; use the uncached fused path under "
            "a multi-device mesh")
        assert rank["guards"]["kernel"].startswith("cfg.train_kernel is the single-chip fast "
                                                   "path; multi-GPU training uses the eager "
                                                   "step body")
    for out in (runs["one"][0]["guards"], runs["alone"]["guards"]):
        assert out == {"cache": None, "kernel": None}
