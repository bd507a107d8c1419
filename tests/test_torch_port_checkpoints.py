"""flowerdiff_torch's checkpoints on the CPU: the step-directory manager's
semantics (each case of tests/test_checkpoints.py, plus the `_incomplete`
skip and a shape check on restore), exact resume (train K steps, save,
restore into a fresh state, one more step: bit-equal to K + 1 unbroken
steps) for the latent state with EMA, the VAE-GAN state and the pixel
state, and a checkpoint of the JAX package carried into the port through
the weight bridge and continued, against the JAX package continued."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.train.checkpoints import CheckpointManager as JaxCheckpointManager
from flowerdiff.train.checkpoints import state_to_tree as jax_state_to_tree
from flowerdiff.train.pixel_ddpm import PixelDiffusionConfig as JaxPixelConfig
from flowerdiff.train.pixel_ddpm import create_pixel_diffusion_state as jax_pixel_state
from flowerdiff.train.pixel_ddpm import make_pixel_diffusion_step as jax_pixel_step
from flowerdiff_torch.train.checkpoints import (
    CheckpointManager,
    parse_epoch_from_filename,
    state_to_tree,
    tree_into_state,
    tree_into_vae_gan_state,
    vae_gan_state_to_tree,
)
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    create_latent_diffusion_state,
    make_latent_diffusion_step_body,
)
from flowerdiff_torch.train.pixel_ddpm import (
    PixelDiffusionConfig,
    create_pixel_diffusion_state,
    make_pixel_diffusion_step,
    make_pixel_diffusion_step_body,
)
from flowerdiff_torch.train.schedules import vae_gan_loss_gates
from flowerdiff_torch.train.vae_gan import (
    VAEGANConfig,
    create_vae_gan_state,
    gates_array,
    make_vae_gan_step,
)
from flowerdiff_torch.utils.weights import (
    init_numpy_params,
    load_adam_moments,
    state_dict_to_flax,
    vae_from_params,
)

PIXEL = dict(img_size=16, n_steps=50, base_channels=8, time_emb_dim=16)


# ------------------------------------------------------------------ manager


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"a": torch.arange(5, dtype=torch.float32), "b": {"c": torch.tensor(3.5)}}
    mgr.save(3, tree)
    assert mgr.exists() and mgr.latest_step() == 3
    out = mgr.restore(like=tree)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(5, dtype=np.float32))
    assert float(out["b"]["c"]) == 3.5
    host = mgr.restore_host()
    assert isinstance(host["a"], np.ndarray) and float(host["b"]["c"]) == 3.5
    with pytest.raises(ValueError):
        mgr.restore(like={"a": torch.zeros(4), "b": {"c": torch.tensor(0.0)}})


def test_overwrite_same_step_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"x": torch.zeros(3)}
    mgr.save(1, tree)
    mgr.save(1, {"x": torch.ones(3)})
    out = mgr.restore(1, like=tree)
    np.testing.assert_array_equal(out["x"].numpy(), np.ones(3))
    # no .new / .old staging directory left behind
    leftovers = [n for n in os.listdir(mgr.directory) if not n.startswith("step_")]
    assert leftovers == []


def test_prune_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for s in range(6):
        mgr.save(s, {"x": torch.zeros(2)})
    assert mgr.all_steps() == [3, 4, 5]


def test_crash_recovery_sweep(tmp_path):
    """A `.old` orphan (a crash between the promote renames) is restored;
    stale `.new` staging is swept; a step directory still marked
    `_incomplete` is not listed."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"x": torch.arange(3, dtype=torch.float32)}
    mgr.save(2, tree)
    os.rename(mgr._step_dir(2), mgr._step_dir(2) + ".old")
    os.makedirs(mgr._step_dir(2) + ".new")
    os.makedirs(mgr._step_dir(7))
    open(os.path.join(mgr._step_dir(7), "_incomplete"), "w").close()
    mgr2 = CheckpointManager(str(tmp_path / "ck"))
    assert mgr2.all_steps() == [2]
    out = mgr2.restore(2, like=tree)
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(3, dtype=np.float32))
    leftovers = [n for n in os.listdir(mgr2.directory) if not n.startswith("step_")]
    assert leftovers == []
    with pytest.raises(FileNotFoundError):
        mgr2.restore(7)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_parse_epoch_from_filename():
    assert parse_epoch_from_filename("a/conditional_diffusion_epoch_450.pt") == 450
    assert parse_epoch_from_filename("vae_gan_final.pt") is None


# ------------------------------------------------------------------ exact resume


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)


def test_latent_diffusion_exact_resume(tmp_path):
    """The latent state with an EMA: 3 steps, save, one more step; a fresh
    state restored from the save takes the same step: params, moments, EMA
    weights and step bit-equal."""
    cfg = LatentDiffusionConfig(latent_dim=8, hidden_dims=(16, 32, 16), time_emb_dim=8,
                                num_classes=5, n_steps=20, steps_per_epoch=2,
                                ema_decay=0.9, cond_dropout=0.2)
    arch = dict(latent_dim=8, channels=(8, 16, 24, 32), head_width=32)
    vae = vae_from_params(init_numpy_params("vae", seed=4, **arch), device="cpu", **arch)
    images = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(6))
    labels = torch.tensor([0, 1, 2, 3])

    def fresh():
        state, model, sched = create_latent_diffusion_state(3, cfg, device="cpu")
        return state, make_latent_diffusion_step_body(model, vae, sched, cfg)

    def step(state, fn, i):
        fn(state, images, labels, None, torch.Generator().manual_seed(50 + i))

    state, fn = fresh()
    for i in range(3):
        step(state, fn, i)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, state_to_tree(state))
    step(state, fn, 3)

    state2, fn2 = fresh()
    tree_into_state(state2, mgr.restore(like=state_to_tree(state2)))
    assert state2.step == 3 and state2.ema is not None
    step(state2, fn2, 3)
    _assert_states_equal(state, state2)
    assert all(torch.equal(x, y) for x, y in zip(state.ema, state2.ema))


def test_vae_gan_exact_resume(tmp_path):
    """Generator and discriminator states and the EMA centers: 3 steps with
    every gate on (the centers updating), save, one more; the restored
    fresh state's step is bit-equal."""
    cfg = VAEGANConfig(num_classes=5, latent_dim=8, channels=(8, 16, 24, 32), head_width=32,
                       total_steps=16, use_perceptual=False)
    images = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(8))
    labels = torch.tensor([0, 1, 2, 3])
    gates = gates_array(vae_gan_loss_gates(200, 300))

    def fresh():
        state, vae, disc = create_vae_gan_state(7, cfg, device="cpu")
        return state, make_vae_gan_step(vae, disc, cfg)

    state, step = fresh()
    for _ in range(3):
        step(state, images, labels, gates, 100)
    assert float(state.centers.abs().sum()) > 0
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, vae_gan_state_to_tree(state))
    step(state, images, labels, gates, 100)

    state2, step2 = fresh()
    tree_into_vae_gan_state(state2, mgr.restore(like=vae_gan_state_to_tree(state2)))
    assert state2.step == 3 and state2.disc.step == 3
    step2(state2, images, labels, gates, 100)
    _assert_states_equal(state.gen, state2.gen)
    _assert_states_equal(state.disc, state2.disc)
    assert torch.equal(state.centers, state2.centers)


def test_pixel_exact_resume(tmp_path):
    cfg = PixelDiffusionConfig(learnable_residual=True, **PIXEL)
    images = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(9))

    def fresh():
        state, model, sched = create_pixel_diffusion_state(1, cfg, device="cpu")
        return state, make_pixel_diffusion_step(model, sched)

    state, step = fresh()
    for _ in range(3):
        step(state, images, 11)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, state_to_tree(state))
    step(state, images, 11)
    state2, step2 = fresh()
    tree_into_state(state2, mgr.restore(like=state_to_tree(state2)))
    step2(state2, images, 11)
    _assert_states_equal(state, state2)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """A pixel state trained 2 steps by the JAX package and saved by its
    CheckpointManager (Orbax), read back with `restore_host`, into the
    port through the bridge (weights, and Adam's moments and count by
    `load_adam_moments`), then one more step on each side with the same
    draws: the same loss (rtol 1e-5: f32 sums in another order) and, leaf
    by leaf, weights within 1e-3 of the rms of the step's move and first
    moments within 1e-4 of their rms (tests/test_torch_port_pixel.py's
    limits)."""
    jcfg = JaxPixelConfig(**PIXEL)
    jstate, jmodel, jsched = jax_pixel_state(jax.random.key(0), jcfg)
    jstep = jax_pixel_step(jmodel, jsched)
    x = jnp.asarray(np.random.default_rng(13).uniform(size=(4, 16, 16, 3)), jnp.float32)
    for i in range(2):
        jstate, _ = jstep(jstate, jsched, x, jax.random.key(i))
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    jmgr.save(2, jax.tree.map(jnp.copy, jax_state_to_tree(jstate)))
    host = jmgr.restore_host(like=jax_state_to_tree(jstate))
    adam = host["opt_state"][0]

    state, model, sched = create_pixel_diffusion_state(0, PixelDiffusionConfig(**PIXEL),
                                                       device="cpu",
                                                       params={"params": host["params"]})
    load_adam_moments(state, adam.mu, adam.nu, int(adam.count))
    assert state.step == 2
    before = jax.tree.map(np.asarray, jstate.params)
    t_key, eps_key = jax.random.split(jax.random.fold_in(jax.random.key(2), 2))
    draws = (torch.from_numpy(np.array(jax.random.randint(t_key, (4,), 0, 50))).long(),
             torch.from_numpy(np.array(jax.random.normal(eps_key, (4, 16, 16, 3)))))
    jstate, jloss = jstep(jstate, jsched, x, jax.random.key(2))
    loss = make_pixel_diffusion_step_body(model)(state, sched, torch.from_numpy(np.array(x)),
                                                 draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = state_dict_to_flax(model)
    got_mu = state_dict_to_flax(dict(zip(state.names, state.mu)), model)
    want, want_mu = jax.tree.map(np.asarray, (jstate.params, jstate.opt_state[0].mu))

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    for name in want:
        for leaf in want[name]:
            g, w = np.asarray(got[name][leaf]), want[name][leaf]
            assert rms(g - w) <= 1e-3 * rms(w - before[name][leaf]), (name, leaf)
            assert rms(np.asarray(got_mu[name][leaf]) - want_mu[name][leaf]) <= \
                1e-4 * rms(want_mu[name][leaf]), (name, leaf)
    assert state.step == 3 == int(jstate.step)
