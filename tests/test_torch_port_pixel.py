"""flowerdiff_torch's pixel family (v4/v5) on the CPU against the JAX
package, at a tiny width: base_channels 8, time_emb_dim 16, 16x16 images,
T = 50, batch 4.

The PixelUNet forward (v4, v5; f32 and bf16) through the weight bridge,
the bridge both ways and its layout rule, 5 steps of the pixel-DDPM step
with the reference's own t / eps draws injected, the fused epochs with the
reference's augmentation draws injected, the deterministic sampler and
DDIM, and the PixelSamplingService end to end with chunking.

Weights come from the port's seeded initialiser with nonzero biases (so a
bias left out shows) or from the reference's own init, carried across as
numpy trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import ddpm as jddpm
from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion.api import DiffusionSampler as JaxSampler
from flowerdiff.models.pixel_unet import PixelUNet as JaxPixelUNet
from flowerdiff.serving import PixelSamplingService as JaxPixelService
from flowerdiff.train.fused import epoch_rows as jax_epoch_rows
from flowerdiff.train.fused import make_fused_pixel_epochs as jax_fused_pixel
from flowerdiff.train.pixel_ddpm import PixelDiffusionConfig as JaxPixelConfig
from flowerdiff.train.pixel_ddpm import create_pixel_diffusion_state as jax_pixel_state
from flowerdiff.train.pixel_ddpm import make_pixel_diffusion_step as jax_pixel_step
from flowerdiff_torch.data import synthetic_flowers
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.api import DiffusionSampler
from flowerdiff_torch.models.pixel_unet import PixelUNet
from flowerdiff_torch.serving import PixelSamplingService
from flowerdiff_torch.train import fused
from flowerdiff_torch.train.pixel_ddpm import (
    PixelDiffusionConfig,
    PixelDiffusionTrainer,
    create_pixel_diffusion_state,
    make_pixel_diffusion_step,
    make_pixel_diffusion_step_body,
)
from flowerdiff_torch.utils.weights import (
    flax_to_state_dict,
    init_numpy_params,
    load_pixel_unet,
    pixel_unet_from_params,
    state_dict_to_flax,
)
from torch_port_vae_gan_common import _jax_aug_draws, _leaves, _t

IMG, B, T = 16, 4, 50
ARCH = dict(base_channels=8, time_emb_dim=16)


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, IMG, IMG, 3)).astype(np.float32)


def _pair(residual, seed=0, dtype="float32"):
    """(the reference's model and params, the port's model) from one seeded
    tree with nonzero biases."""
    tree = init_numpy_params("pixel", seed=seed, learnable_residual=residual, **ARCH)
    jm = JaxPixelUNet(learnable_residual=residual,
                      dtype=None if dtype == "float32" else jnp.bfloat16, **ARCH)
    tm = pixel_unet_from_params(tree, device="cpu", learnable_residual=residual,
                                compute_dtype=dtype, **ARCH)
    return jm, jax.tree.map(jnp.asarray, tree["params"]), tm


def _forward_pair(residual, dtype):
    jm, jp, tm = _pair(residual, dtype=dtype)
    x = _images(B, 1) * 2 - 1
    t = np.array([0, 7, 31, 49], np.int32)
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), jnp.asarray(t)), np.float32)
    with torch.no_grad():
        got = tm(_t(x), _t(t).long())
    return got, ref


@pytest.mark.parametrize("residual", [False, True], ids=["v4", "v5"])
def test_pixel_unet_forward_matches_jax(residual):
    """f32: within 1e-5 of max|ref| (the same f32 products summed in another
    order; a scrambled skip concatenation or a missing stage bias moves the
    output by O(max|ref|))."""
    got, ref = _forward_pair(residual, "float32")
    assert got.dtype == torch.float32 and got.shape == (B, IMG, IMG, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("residual", [False, True], ids=["v4", "v5"])
def test_pixel_unet_bf16_is_within_twice_the_reference_gap(residual):
    """bf16: the port's bf16 model against the reference's bf16 model within
    twice the reference's own bf16-to-f32 gap (both round the convolutions'
    operands to bf16, but at other points: flax adds the conv bias in bf16
    after rounding the product, torch's autocast inside the convolution),
    with the time MLP, stage biases and output conv in f32 (the output is
    f32)."""
    got, ref = _forward_pair(residual, "bfloat16")
    _, ref32 = _forward_pair(residual, "float32")
    assert got.dtype == torch.float32
    gap = np.abs(ref - ref32).max()
    assert gap > 0
    assert np.abs(got.numpy() - ref).max() <= 2 * gap


def test_bridge_round_trips_a_pixel_tree_both_ways():
    """The reference's own init (v5) into the port and back, and the port's
    seeded tree out and in: bit-equal, `res_ratio` included."""
    state, _, _ = jax_pixel_state(jax.random.key(0), JaxPixelConfig(
        learnable_residual=True, img_size=IMG, **ARCH))
    ref = jax.tree.map(np.asarray, state.params)
    model = load_pixel_unet(PixelUNet(learnable_residual=True, **ARCH), {"params": ref})
    back = state_dict_to_flax(model)
    assert dict(_leaves(back)).keys() == dict(_leaves(ref)).keys()
    for (k, a), (_, b) in zip(_leaves(back), _leaves(ref)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert float(model.res_ratio.detach()) == pytest.approx(0.1)
    tree = init_numpy_params("pixel", seed=3, **ARCH)["params"]
    again = state_dict_to_flax(load_pixel_unet(PixelUNet(**ARCH), tree))
    for (k, a), (_, b) in zip(_leaves(again), _leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_bridge_picks_the_conv_layout_by_module_type():
    """A Conv2d named like a transposed conv (`up1_conv`) takes the plain
    layout and a ConvTranspose2d named like a plain one (`down`) the
    flipped one: each module's output matches flax's Conv / ConvTranspose
    with the same kernel. The pixel UNet's `up1` / `up2` in the plain
    layout would not load."""
    from flax import linen as fnn

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up1_conv = torch.nn.Conv2d(4, 6, 3, padding=1)
            self.down = torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1)

    rng = np.random.default_rng(0)
    tree = {"up1_conv": {"kernel": rng.normal(size=(3, 3, 4, 6)).astype(np.float32),
                         "bias": rng.normal(size=6).astype(np.float32)},
            "down": {"kernel": rng.normal(size=(4, 4, 6, 4)).astype(np.float32),
                     "bias": rng.normal(size=4).astype(np.float32)}}
    toy = Toy()
    toy.load_state_dict(flax_to_state_dict(tree, toy), strict=True)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    h = np.asarray(fnn.Conv(6, (3, 3), padding="SAME").apply({"params": tree["up1_conv"]}, x))
    y = np.asarray(fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME").apply(
        {"params": tree["down"]}, h))
    with torch.no_grad():
        th = toy.up1_conv(_t(x).permute(0, 3, 1, 2))
        ty = toy.down(th)
    np.testing.assert_allclose(th.permute(0, 2, 3, 1).numpy(), h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), y, rtol=1e-5, atol=1e-5)
    plain = init_numpy_params("pixel", seed=1, **ARCH)
    for name in ("up1", "up2"):  # the plain conv layout: (out, in, kh, kw)
        k = plain["params"][name]["kernel"]
        plain["params"][name]["kernel"] = k.transpose(0, 1, 3, 2)
    with pytest.raises(RuntimeError, match="up1.weight"):
        load_pixel_unet(PixelUNet(**ARCH), plain)


# ------------------------------------------------------------------ training


def _jax_state(residual=False):
    cfg = JaxPixelConfig(img_size=IMG, n_steps=T, learnable_residual=residual, **ARCH)
    state, model, sched = jax_pixel_state(jax.random.key(0), cfg)
    tree = init_numpy_params("pixel", seed=4, learnable_residual=residual, **ARCH)
    return state.replace(params=jax.tree.map(jnp.asarray, tree["params"])), model, sched, tree


def _jax_draws(rng, step, b=B):
    """The reference step's draws: split(fold_in(rng, step)) -> t, eps."""
    t_key, eps_key = jax.random.split(jax.random.fold_in(rng, step))
    return (_t(jax.random.randint(t_key, (b,), 0, T)).long(),
            _t(jax.random.normal(eps_key, (b, IMG, IMG, 3))))


# The step against the reference, per leaf: the rms of the weights'
# difference within 1e-3 of the rms of the reference's move from the init,
# and of the Adam first moments' within 1e-4 of their rms. Both sides take
# the same f32 gradients up to summation order (the losses agree to 1e-6),
# but Adam's update is lr * m / sqrt(v): an element whose gradient is
# within rounding of zero steps up to 2 lr the other way, which the rms
# bound on the weights allows for.
W_RTOL, MU_RTOL = 1e-3, 1e-4


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_leaves_close(state, model, jstate, init, what):
    got = dict(_leaves(state_dict_to_flax(model)))
    got_mu = dict(_leaves(state_dict_to_flax(dict(zip(state.names, state.mu)), model)))
    want = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    want_mu = dict(_leaves(jax.tree.map(np.asarray, jstate.opt_state[0].mu)))
    init = dict(_leaves(init["params"]))
    assert set(got) == set(want) == set(got_mu)
    for k in want:
        assert _rms(got[k] - want[k]) <= W_RTOL * _rms(want[k] - init[k]), (what, k)
        assert _rms(got_mu[k] - want_mu[k]) <= MU_RTOL * _rms(want_mu[k]), (what, k)


@pytest.mark.parametrize("residual", [False, True], ids=["v4", "v5"])
def test_five_pixel_steps_match_the_reference(residual):
    """make_pixel_diffusion_step: 5 steps from one tree, the reference's
    keys fold_in(key, i) and its draws injected: each loss within rtol 1e-5
    (f32 MSE over the same eps and prediction), then each leaf's weights
    and Adam first moments on their own (W_RTOL, MU_RTOL)."""
    jstate, jmodel, jsched, tree = _jax_state(residual)
    jstep = jax_pixel_step(jmodel, jsched)
    cfg = PixelDiffusionConfig(img_size=IMG, n_steps=T, learnable_residual=residual, **ARCH)
    state, model, sched = create_pixel_diffusion_state(0, cfg, device="cpu", params=tree)
    body = make_pixel_diffusion_step_body(model)
    imgs, _ = synthetic_flowers(5 * B, 5, IMG, seed=2)
    imgs = imgs.astype(np.float32) / 255.0
    key = jax.random.key(9)
    for i in range(5):
        x = imgs[i * B:(i + 1) * B]
        rng_i = jax.random.fold_in(key, i)
        draws = _jax_draws(rng_i, int(jstate.step))
        jstate, jloss = jstep(jstate, jsched, jnp.asarray(x), rng_i)
        loss = body(state, sched, _t(x), draws=draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
        _assert_leaves_close(state, model, jstate, tree, f"step {i}")
    assert state.step == 5 == int(jstate.step)


def test_fused_pixel_epochs_match_the_reference():
    """make_fused_pixel_epochs: 2 epochs x 2 steps over 8 augmented
    synthetic images against the reference's fused epochs, its
    augmentation draws (fold_in(data_key, offset)) and t / eps
    (split(fold_in(fold_in(rng, offset), step))) injected: per-step losses
    within rtol 1e-5, then each leaf as the step test holds it. The seeded
    form runs too, and differs."""
    jstate, jmodel, jsched, tree = _jax_state()
    images, _ = synthetic_flowers(8, 5, IMG, seed=3)
    idx, offsets, steps = jax_epoch_rows(5, 8, B, 2)
    rng, data_key = jax.random.key(21), jax.random.key(22)
    fn = jax_fused_pixel(jmodel, JaxPixelConfig(img_size=IMG, n_steps=T, **ARCH),
                         steps_per_epoch=steps)
    draws = []
    for r, off in enumerate(np.asarray(offsets)):
        draws.append((_jax_aug_draws(jax.random.fold_in(data_key, int(off)), B),
                      _jax_draws(jax.random.fold_in(rng, int(off)), r)))
    jstate, jlosses = fn(jstate, jsched, jnp.asarray(images), idx, offsets, rng, data_key)

    cfg = PixelDiffusionConfig(img_size=IMG, n_steps=T, **ARCH)
    state, model, sched = create_pixel_diffusion_state(0, cfg, device="cpu", params=tree)
    fn_t = fused.make_fused_pixel_epochs(model, steps_per_epoch=steps)
    losses = fn_t(state, sched, _t(images), _t(np.asarray(idx)).long(), draws=draws)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    _assert_leaves_close(state, model, jstate, tree, "end")
    seeded = fused.make_fused_pixel_epochs(model, steps_per_epoch=steps)(
        state, sched, _t(images), _t(np.asarray(idx)).long(), seed=3)
    assert torch.isfinite(seeded).all() and state.step == 8
    assert not torch.equal(seeded, losses)


def test_trainer_runs_fused_epochs_and_its_loop_reproducibly():
    """PixelDiffusionTrainer (v5): run_epochs_fused on an augmenting
    DeviceDataset twice from one seed gives the same epoch means bit for
    bit; run_epoch over plain batches moves the step count; the sampler
    holds a copy of the weights of its time."""
    from flowerdiff_torch.data import DeviceDataset

    cfg = PixelDiffusionConfig(img_size=IMG, n_steps=T, learnable_residual=True, **ARCH)
    images, labels = synthetic_flowers(16, 5, IMG, seed=1)
    runs = []
    for _ in range(2):
        tr = PixelDiffusionTrainer(cfg, seed=0, device="cpu")
        runs.append(tr.run_epochs_fused(DeviceDataset(images, labels, device="cpu"), 2,
                                        seed=5, batch_size=B))
    assert runs[0] == runs[1] and len(runs[0]) == 2 and np.isfinite(runs[0]).all()
    assert tr.state.step == 8
    sampler = tr.sampler()
    batches = [(_t(images[:B].astype(np.float32) / 255.0), None)] * 2
    loss = tr.run_epoch(batches, seed=1)
    assert np.isfinite(loss) and tr.state.step == 10
    live = dict(tr.model.named_parameters())
    assert any(not torch.equal(p, live[n]) for n, p in sampler.model.named_parameters())
    x = torch.zeros((1, IMG, IMG, 3))
    t = torch.tensor([3])
    assert torch.equal(tr.eps_fn()(x, t), tr.model(x, t).detach())
    assert sampler.clip_x0 == 1.0 and sampler.event_shape == (IMG, IMG, 3)


def test_seeded_step_draws_from_the_derived_generator():
    """make_pixel_diffusion_step(seed) draws t, then eps, from the
    generator of (seed..., step): the same loss as the body given those
    draws."""
    from flowerdiff_torch.utils.device import derived_generator

    cfg = PixelDiffusionConfig(img_size=IMG, n_steps=T, **ARCH)
    x = _t(_images(B, 2))
    losses = []
    for seeded in (True, False):
        state, model, sched = create_pixel_diffusion_state(0, cfg, device="cpu")
        if seeded:
            losses.append(float(make_pixel_diffusion_step(model, sched)(state, x, (3, 4))))
        else:
            g = derived_generator("cpu", 3, 4, 0)
            t = torch.randint(0, T, (B,), generator=g)
            eps = torch.randn(x.shape, generator=g)
            losses.append(float(make_pixel_diffusion_step_body(model)(
                state, sched, x, draws=(t, eps))))
    assert losses[0] == losses[1]


# ------------------------------------------------------------------ sampling


def _mean_recursion(jm, jp, x, clip):
    """The reference's deterministic reverse process: the p_sample_mean
    recursion over model.apply, t = T-1 .. 0."""
    sched = jax_schedule(T)

    @jax.jit
    def step(xr, tv):
        return jddpm.p_sample_mean(sched, xr, tv, jm.apply({"params": jp}, xr, tv), clip)

    xr = jnp.asarray(x)
    for t in range(T - 1, -1, -1):
        xr = step(xr, jnp.full((x.shape[0],), t, jnp.int32))
    return np.asarray(xr)


@pytest.mark.parametrize("clip", [1.0, None])
def test_deterministic_sampler_matches_the_reference_recursion(clip):
    """The port's sampler with x_init fixed and stochastic=False against the
    p_sample_mean recursion over the reference model, 50 steps (v5, x0 clip
    1.0 and unclipped): within 1e-4 of max|ref| (f32 convolutions summed in
    another order, carried through 50 steps)."""
    jm, jp, tm = _pair(True, seed=6)
    x = np.random.default_rng(7).standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    ref = _mean_recursion(jm, jp, x, clip)
    s = DiffusionSampler(tm, linear_schedule(T), (IMG, IMG, 3), clip_x0=clip, device="cpu")
    got = s.sample(B, x_init=_t(x), stochastic=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_ddim_matches_the_reference():
    """DDIM, 10 steps, x0 clip 1.0: the port from the reference's own
    starting draw (split(rng)[0]) against the reference's `ddim`, within
    1e-4 of max|ref|."""
    jm, jp, tm = _pair(False, seed=8)
    rng = jax.random.key(3)
    ref = np.asarray(JaxSampler(jm, {"params": jp}, jax_schedule(T), (IMG, IMG, 3),
                                clip_x0=1.0).ddim(rng, B, num_steps=10))
    x0 = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, IMG, IMG, 3)))
    s = DiffusionSampler(tm, linear_schedule(T), (IMG, IMG, 3), clip_x0=1.0, device="cpu")
    got = s.ddim(B, num_steps=10, x_init=_t(x0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("quantize", [False, True])
def test_ddim_service_matches_the_jax_service_with_chunking(quantize):
    """PixelSamplingService(sampler_kind='ddim') against the reference's
    service on a 5-image request at buckets (2, 4), planned [4, 2] on both
    sides, chunk i of the port started from the reference's draw for chunk
    i (split(fold_in(rng, i))[0]): f32 images within 1e-4, uint8 within one
    level (a value within rounding of a level boundary)."""
    jm, jp, tm = _pair(True, seed=9)
    sched_j = jax_schedule(T)
    kw = dict(buckets=(2, 4), sampler_kind="ddim", ddim_steps=10, img_size=IMG,
              quantize_uint8=quantize)
    jsvc = JaxPixelService(jm, {"params": jp}, sched_j, **kw)
    svc = PixelSamplingService(tm, linear_schedule(T), device="cpu", **kw)
    assert svc.request_plan(5) == jsvc.request_plan(5) == [4, 2]
    assert svc.request_plan(9) == jsvc.request_plan(9)
    rng = jax.random.key(11)
    ref = np.asarray(jsvc.sample_images(5, rng))
    inits = [np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(rng, i))[0],
                                          (b, IMG, IMG, 3)))[:take]
             for i, (b, take) in enumerate(((4, 4), (2, 1)))]
    got = svc.sample(np.zeros(5), x_init=np.concatenate(inits))
    assert got.shape == ref.shape == (5, IMG, IMG, 3) and got.dtype == ref.dtype
    if quantize:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    else:
        assert 0.0 <= got.min() and got.max() <= 1.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_ancestral_service_end_to_end():
    """The ancestral service (T = 50, clip 1.0): a 5-image request at
    buckets (2, 4) is two chunks, each the deterministic recursion from its
    rows of x_init (within 1e-4 of the reference recursion, clipped to
    [0, 1]); stochastic requests are reproducible for a seed, differ across
    seeds, and `sample_images` and `sample_async` agree after `warmup`."""
    jm, jp, tm = _pair(False, seed=10)
    svc = PixelSamplingService(tm, linear_schedule(T), buckets=(2, 4), img_size=IMG,
                               device="cpu")
    x = np.random.default_rng(12).standard_normal((5, IMG, IMG, 3)).astype(np.float32)
    got = svc.sample(np.zeros(5), x_init=x, stochastic=False)
    ref = np.clip(_mean_recursion(jm, jp, x, 1.0), 0.0, 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    svc.warmup(seed=1, buckets=(2,))
    a = svc.sample_images(3, seed=4)
    b = svc.sample_async(np.zeros(3), seed=4)()
    assert a.shape == (3, IMG, IMG, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, svc.sample_images(3, seed=5))
    with pytest.raises(ValueError):
        svc.sample(np.zeros(2), colors=np.zeros(2))
