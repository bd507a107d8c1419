"""flowerdiff_torch's train-step module on the CPU (its plain twin under
autograd) against the JAX package: `jax.grad(forward_loss)` and the Pallas
kernel `_kernel_loss_and_grads` in interpret mode, on the same weights,
draws and masks, made with numpy from a seed. The CUDA kernels are held
against the twin on the card (chip_smoke.py, tests/test_torch_port_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.kernels.train_step import _DATA_NAMES as JAX_DATA_NAMES
from flowerdiff.kernels.train_step import _kernel_loss_and_grads as jax_kernel
from flowerdiff.kernels.train_step import _nest as jax_nest
from flowerdiff.kernels.train_step import _weights_spec as jax_weights_spec
from flowerdiff.kernels.train_step import forward_loss as jax_forward_loss
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    create_latent_diffusion_state,
    make_latent_denoise_body,
)
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

B = 8
CFG = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=7)
# Widths whose rows are not whole 16-byte units (latent 62, time embedding
# 30), which the card's bf16 lane plans onto the products that tensor maps
# do not feed; under the v2 skip the last hidden width is the latent's.
RAGGED = dict(latent_dim=62, hidden_dims=(64, 128, 64), time_emb_dim=30, num_classes=7)
WIDTHS = {"even": CFG, "ragged": RAGGED}
RATE = 0.3
# Gradient limits per leaf. f32 lane: the JAX tests' own (tests/test_train_kernel.py:71).
# bf16 lane: both sides round the same operands and the same dX / dW to bf16,
# but their f32 sums run in another order, so a value near a rounding boundary
# lands one bf16 ulp (2^-8 relative) away and carries on through the later
# products: 2e-2 of the leaf's largest gradient.
F32_TOL = dict(rtol=5e-4, atol=1e-6)
BF16_REL = 2e-2


def _case(global_skip, seed=0, widths=CFG):
    """Weights with nonzero biases and perturbed LN affines (flax's zero
    biases would hide a dropped term), draws, masks with a zero cond row."""
    kw = dict(widths, global_skip=global_skip)
    if global_skip:
        kw["hidden_dims"] = kw["hidden_dims"][:-1] + (kw["latent_dim"],)
    lat = kw["latent_dim"]
    rng = np.random.default_rng(seed)
    tree = init_numpy_params("denoiser", seed=seed + 1, bias_std=0.3, **kw)
    for name, leaf in tree["params"].items():
        if "scale" in leaf:
            leaf["scale"] = (leaf["scale"] + 0.2 * rng.standard_normal(leaf["scale"].shape)
                             ).astype(np.float32)
    n_stages = len(kw["hidden_dims"]) - 1
    sched = linear_schedule(50)
    t = rng.integers(0, 50, B)
    abar = sched.alpha_bar.numpy()[t][:, None]
    half = kw["time_emb_dim"] // 2
    data = {
        "z": rng.standard_normal((B, lat)).astype(np.float32),
        "t_f": t.astype(np.float32)[:, None],
        "sa": np.sqrt(abar).astype(np.float32),
        "s1a": np.sqrt(1.0 - abar).astype(np.float32),
        "eps": rng.standard_normal((B, lat)).astype(np.float32),
        "labels": rng.integers(0, 7, B).astype(np.int32),
        "cond_mask": np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)[:, None],
        "freqs": np.exp(np.arange(half, dtype=np.float32)
                        * np.float32(-np.log(10000.0) / (half - 1))).reshape(1, half),
    }
    masks = []
    for d in kw["hidden_dims"][:-1]:
        mb = (rng.random((B, d)) >= RATE).astype(np.float32) / (1 - RATE)
        ma = (rng.random((B, 8)) >= RATE).astype(np.float32) / (1 - RATE)
        masks += [mb, np.repeat(ma, d // 8, axis=1)]
    return kw, tree, n_stages, data, masks


def _jax_side(tree, n_stages, data, masks, dtype, global_skip, interpret):
    named = dict(jax_weights_spec(jax.tree.map(jnp.asarray, tree), n_stages))
    jdata = {k: jnp.asarray(v) for k, v in data.items() if k != "labels"}
    jdata["onehot"] = jax.nn.one_hot(jnp.asarray(data["labels"]), CFG["num_classes"],
                                     dtype=jnp.float32)
    jmasks = [jnp.asarray(m) for m in masks]
    if interpret:
        args = tuple(jdata[k] for k in JAX_DATA_NAMES)
        loss, grads = jax_kernel(named, args, tuple(jmasks), n_stages=n_stages, dtype=dtype,
                                 global_skip=global_skip, interpret=True)
    else:
        full = dict(jdata, m_blk=jmasks[0::2], m_attn=jmasks[1::2])
        loss, grads = jax.value_and_grad(lambda w: jax_forward_loss(
            jax_nest(w, n_stages), full, n_stages=n_stages, dtype=dtype,
            global_skip=global_skip))(named)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _torch_side(kw, tree, data, masks, dtype):
    model = denoiser_from_params(tree, device="cpu", **kw)
    named = dict(ts.weights_spec(model))
    loss, grads = ts.kernel_loss_and_grads(
        named, {k: torch.from_numpy(v) for k, v in data.items()},
        [torch.from_numpy(m) for m in masks], dtype=dtype, global_skip=kw["global_skip"])
    return model, float(loss), grads


def _as_jax_layout(name, g):
    """A port gradient in the reference's `_weights_spec` layout: kernels
    (in, out), vectors as (1, d) rows, rw (1, 1)."""
    g = g.numpy()
    if name == "table":
        return g
    return g.T if g.ndim == 2 else g.reshape(1, -1)


@pytest.mark.parametrize("widths", ["even", "ragged"])
@pytest.mark.parametrize("oracle", ["jax_grad", "pallas_interpret"])
@pytest.mark.parametrize("global_skip", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_twin_loss_and_grads_match_jax(lane, global_skip, oracle, widths):
    kw, tree, n_stages, data, masks = _case(global_skip, widths=WIDTHS[widths])
    jdt, tdt = (jnp.float32, torch.float32) if lane == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref_loss, ref = _jax_side(tree, n_stages, data, masks, jdt, global_skip,
                              interpret=oracle == "pallas_interpret")
    _, loss, grads = _torch_side(kw, tree, data, masks, tdt)
    assert len(grads) == len(ref) == 11 + 14 * n_stages + 9
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5 if lane == "float32" else 2e-3)
    for name, r in ref.items():
        got = _as_jax_layout(name, grads[name])
        assert got.shape == r.shape, name
        if lane == "float32":
            np.testing.assert_allclose(got, r, err_msg=name, **F32_TOL)
        else:
            assert np.abs(got - r).max() <= BF16_REL * np.abs(r).max() + 1e-9, name
    if not global_skip:
        assert not np.any(ref["rw"]) and not grads["rw"].any()


def test_dropping_a_term_moves_the_twin_past_the_limits():
    """The limits above mean something: the twin without a dropout mask or
    without the cond mask is far outside them. (The doubled bias is held by
    the comparison of `bt`'s gradient with the reference's, above.)"""
    kw, tree, n_stages, data, masks = _case(False)
    _, loss, grads = _torch_side(kw, tree, data, masks, torch.float32)
    ones = [np.ones_like(m) for m in masks]
    variants = {
        "block mask": (data, [ones[0]] + masks[1:]),
        "attention mask": (data, masks[:1] + [ones[1]] + masks[2:]),
        "cond mask": (dict(data, cond_mask=np.ones_like(data["cond_mask"])), masks),
    }
    for what, (d, m) in variants.items():
        _, loss2, grads2 = _torch_side(kw, tree, d, m, torch.float32)
        moved = max(float((grads2[k] - grads[k]).abs().max() / (grads[k].abs().max() + 1e-12))
                    for k in grads)
        assert moved > 10 * BF16_REL, (what, moved)


def test_grads_to_tree_gives_every_parameter_a_gradient():
    kw, tree, n_stages, data, masks = _case(False)
    model, _, grads = _torch_side(kw, tree, data, masks, torch.float32)
    full = ts.grads_to_tree(grads, model)
    assert set(full) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert full[name].shape == p.shape
        if ".q." in name or ".k." in name or name == "residual_weight":
            assert not full[name].any(), name
        else:
            assert full[name].any(), name
    assert torch.equal(full["attn_0.v.weight"], grads["s0.wv"])
    # under the global skip the residual weight has a gradient
    kw2, tree2, _, data2, masks2 = _case(True)
    model2, _, grads2 = _torch_side(kw2, tree2, data2, masks2, torch.float32)
    assert float(ts.grads_to_tree(grads2, model2)["residual_weight"]) != 0.0


def test_kernel_supported_and_v3_raises():
    v3 = dict(CFG, shared_cond_proj=False, num_colors=4)
    model = denoiser_from_params(init_numpy_params("denoiser", **v3), device="cpu", **v3)
    assert not ts.kernel_supported(model)
    with pytest.raises(ValueError, match="v1/v2"):
        ts.make_kernel_denoise_body(model, LatentDiffusionConfig())
    v1 = denoiser_from_params(init_numpy_params("denoiser", **CFG), device="cpu", **CFG)
    assert ts.kernel_supported(v1)
    with pytest.raises(ValueError, match="lane"):
        ts.make_kernel_denoise_body(v1, LatentDiffusionConfig(), dtype=torch.float16)


def test_draw_step_inputs_shapes_and_mask_structure():
    model = denoiser_from_params(init_numpy_params("denoiser", **CFG), device="cpu",
                                 dropout_rate=RATE, **CFG)
    z = torch.zeros(B, 64)
    g = torch.Generator().manual_seed(0)
    t, eps, keep, masks = ts.draw_step_inputs(model, 50, 0.5, z, g)
    assert t.shape == (B,) and int(t.min()) >= 0 and int(t.max()) < 50
    assert eps.shape == z.shape and keep.shape == (B,)
    assert set(keep.tolist()) <= {0.0, 1.0}
    assert len(masks) == 2 * model.n_stages
    for i, d in enumerate(CFG["hidden_dims"][:-1]):
        mb, ma = masks[2 * i], masks[2 * i + 1]
        assert mb.shape == ma.shape == (B, d)
        for m in (mb, ma):
            assert bool(((m == 0) | ((m - 1 / (1 - RATE)).abs() < 1e-6)).all())
        heads = ma.reshape(B, 8, d // 8)
        assert torch.equal(heads, heads[:, :, :1].expand_as(heads))
    # the same generator state gives the same draws; rate 0 gives ones
    again = ts.draw_step_inputs(model, 50, 0.5, z, torch.Generator().manual_seed(0))
    assert torch.equal(again[1], eps) and all(torch.equal(a, b) for a, b in zip(again[3], masks))
    model.dropout_rate = 0.0
    _, _, keep1, ones = ts.draw_step_inputs(model, 50, 0.0, z, g)
    assert bool(keep1.all()) and all(bool((m == 1).all()) for m in ones)


@pytest.mark.parametrize("global_skip", [False, True], ids=["v1", "v2"])
def test_kernel_body_equals_eager_body_from_the_same_generator_state(global_skip):
    """Given the same generator state the kernel body (its f32 twin here)
    and the eager autograd body over the module draw the same inputs, take
    the same step and end at the same weights and EMA: loss 1e-5 relative,
    parameters rtol 5e-4 / atol 1e-6 after three steps."""
    cfg = LatentDiffusionConfig(dropout_rate=RATE, cond_dropout=0.3, ema_decay=0.9,
                                n_steps=50, steps_per_epoch=2, global_skip=global_skip, **CFG)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((B, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, B))
    runs = []
    for kernel in (True, False):
        state, model, sched = create_latent_diffusion_state(5, cfg, device="cpu")
        body = (ts.make_kernel_denoise_body(model, cfg, dtype=torch.float32) if kernel
                else make_latent_denoise_body(model, cfg))
        g = torch.Generator().manual_seed(11)
        losses = [float(body(state, sched, z, labels, None, g)) for _ in range(3)]
        runs.append((losses, state))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    for a, b, e_a, e_b in zip(runs[0][1].params, runs[1][1].params, runs[0][1].ema,
                              runs[1][1].ema):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)
        np.testing.assert_allclose(e_a.numpy(), e_b.numpy(), **F32_TOL)
    assert runs[0][1].step == 3
