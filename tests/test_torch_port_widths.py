"""The sampler's kernel path at every denoiser the JAX kernels take, on the
CPU: `FusedDiffusionSampler(device="cpu")` (the reverse-process kernel's
plain version, the step loop on the kernels' twins) against the JAX
package's `fused_sample` in interpret mode, at the --tiny preset's widths,
ragged widths, six stages and latent 254; and the zero padding the card's
bindings give the weights (`pad_process`, `pad_stage`; the head and the
projection pad with the same `latent_stage.padded`). The
kernels themselves run at these widths only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.kernels.full_sampler import fused_sample as jax_fused_sample
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.api import FusedDiffusionSampler
from flowerdiff_torch.kernels.full_sampler import (
    PROCESS_COLS,
    launch_counts,
    pad_process,
    prepare_fused_sampler,
    process_plan,
    process_widths,
)
from flowerdiff_torch.kernels.latent_stage import pad_stage, stage_widths
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

# (latent, hidden): the --tiny preset (configs.tiny_preset), ragged widths,
# six stages, latent 254 with the flagship's hidden widths
SHAPES = [(32, (32, 64, 32)), (96, (96, 200, 96)), (64, (64, 128, 128, 128, 128, 128, 64)),
          (254, (256, 512, 1024, 512, 256))]
STEPS, BATCH, SCALE, CLIP = 5, 4, 2.0, 3.0
# Relative to max|JAX|: tests/test_torch_port_persistent.py's JAX_TOL (bf16
# operands on both sides, f32 sums in other orders, the guidance scale
# amplifying the branches' difference, LayerNorm eps 1e-5 against 1e-6).
JAX_TOL = 3e-2


def _net(latent, hidden):
    return dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=32 if latent == 32 else 64,
                num_classes=11, shared_cond_proj=True)


def _models(latent, hidden):
    den = _net(latent, hidden)
    tree = init_numpy_params("denoiser", seed=5, bias_std=0.3, **den)
    # The JAX kernel's null rows drop the condition projections' biases,
    # the port's keep them (the model's rule): zero them on both sides.
    for name in [f"time_proj_{i}" for i in range(len(hidden) - 1)] + ["final_cond_proj"]:
        tree["params"][name]["bias"] = np.zeros_like(tree["params"][name]["bias"])
    model = denoiser_from_params(tree, device="cpu", **den)
    return model, JaxDenoiser(**den), jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("latent,hidden", SHAPES)
def test_cpu_kernel_path_matches_jax_fused_sample(latent, hidden):
    model, jmodel, jparams = _models(latent, hidden)
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((BATCH, latent)).astype(np.float32)
    cond = (np.arange(BATCH) * 3) % 11
    ref = np.asarray(jax_fused_sample(jmodel, jparams, jax_schedule(STEPS), jax.random.key(0),
                                      BATCH, jnp.asarray(cond), stochastic=False,
                                      interpret=True, x_init=jnp.asarray(x0), clip_x0=CLIP,
                                      guidance_scale=SCALE))
    sampler = FusedDiffusionSampler(model, linear_schedule(STEPS), (latent,), clip_x0=CLIP,
                                    guidance_scale=SCALE, device="cpu")
    before = launch_counts()
    got = sampler.sample(BATCH, torch.from_numpy(cond), x_init=torch.from_numpy(x0),
                         stochastic=False).numpy()
    assert launch_counts() == before, "the plain version launched a kernel"
    assert got.shape == ref.shape == (BATCH, latent) and np.isfinite(got).all()
    tol = JAX_TOL * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= tol
    # the card's plan for the same denoiser exists at both buckets
    for batch in (8, 64):
        assert process_plan(latent, hidden, False, batch, True).waves == 1


def _same_then_zero(padded, true):
    """The true block of `padded` is `true` bit for bit, the rest zero."""
    block = tuple(slice(0, n) for n in true.shape)
    assert padded.dtype == true.dtype and torch.equal(padded[block], true)
    rest = padded.clone()
    rest[block] = 0
    assert not rest.any()


@pytest.mark.parametrize("latent,hidden,skip", [(32, (32, 64, 32), True),
                                                (96, (96, 200, 96), False),
                                                (254, (256, 512, 1024, 512, 254), True)])
def test_padding_is_zero_and_keeps_the_true_block(latent, hidden, skip):
    """`pad_process` at every column split: the weights, vectors and time
    tables padded with zeros to `process_widths`, their true blocks
    unchanged, the prep's own tensors where no padding is needed; the same
    for `pad_stage` at `stage_widths`."""
    den = dict(_net(latent, hidden), global_skip=skip)
    model = denoiser_from_params(init_numpy_params("denoiser", seed=2, bias_std=0.3, **den),
                                 device="cpu", **den)
    prep = prepare_fused_sampler(model, linear_schedule(STEPS))
    wl, bl, _, _, rw = prep["proj"].weights
    _, _, _, _, g, b, wf, bf = prep["head"].weights
    for cols in PROCESS_COLS:
        ops = pad_process(prep, cols)
        assert (ops.latent, ops.hidden) == process_widths(latent, hidden, cols)
        true = [wl] + [st.weights[j] for st in prep["stages"] for j in (0, 6, 8, 10)] + [wf]
        for p, t in zip(ops.weights, true):
            _same_then_zero(p, t)
            assert (p is t) == (p.shape == t.shape)
        for p, t in zip(ops.fixed, (bl, rw, prep["tadd_final"], g, b, bf)):
            if t is None:
                assert p is None
            else:
                _same_then_zero(p, t)
        for i, (tadd, vec) in enumerate(ops.stages):
            _same_then_zero(tadd, prep["tadds"][i])
            st = prep["stages"][i].weights
            for p, j in zip(vec, (1, 2, 3, 4, 5, 7, 9, 11)):
                _same_then_zero(p, st[j])
    for i, stage in enumerate(prep["stages"]):
        d, dout = hidden[i], hidden[i + 1]
        dk, dok = stage_widths(d, dout)
        padded = pad_stage(d, dout, stage.weights)
        assert padded[0].shape == (dk, dk) and padded[10].shape == (dok, dk)
        for p, t in zip(padded, stage.weights):
            _same_then_zero(p, t)
