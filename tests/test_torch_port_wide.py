"""Lopsided denoisers past 4096 and the product-form head past 2048, on the CPU.

The JAX sampler kernel (flowerdiff/kernels/full_sampler.py::_pallas_reverse)
holds every operand whole in 100 MiB of VMEM, and nothing else bounds its
widths: beside narrow stages a last hidden width or a latent passes 4096
(`jax_process_bytes`, tests/test_torch_port_depth.py). Here: the JAX edges
of the nets the port's wide layout was made for; `process_plan` at each of
those nets at every bucket where the JAX kernel holds it, guided or not (a
plan of the wide layout, in shared memory, the rows covered, each width
padded by less than a unit); the CPU kernel path (the twins) against JAX's
`fused_sample` in interpret mode at a lopsided net past 4096; the
product-form head's twin against JAX's `fused_head` in interpret mode at
d_last, d_emb and latent past 2048. The kernels run at these widths only on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.kernels.full_sampler import fused_sample as jax_fused_sample
from flowerdiff.kernels.latent_stage import fused_head as jax_fused_head
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.api import FusedDiffusionSampler
from flowerdiff_torch.kernels.full_sampler import (
    MAX_STAGE_WIDTH,
    MAX_WIDTH,
    launch_counts,
    max_units,
    process_plan,
    process_smem,
    process_widths,
    wide_passes,
)
from flowerdiff_torch.kernels.latent_stage import SMEM_LIMIT, fused_head
from flowerdiff_torch.serving import DEFAULT_BUCKETS
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

from test_torch_port_depth import T, VMEM, jax_process_bytes
from torch_port_threads import one_thread_per_process  # noqa: F401

# (name, latent, hidden, skip): the lopsided nets the JAX kernel holds past
# 4096, each at its edge or inside it
WIDE = [("last width 25706", 8, (8, 8, 25706), False),
        ("last width 6000", 8, (8, 8, 6000), False),
        ("latent 1,047,802", 1047802, (8, 8), False),
        ("latent 191,198", 191198, (8, 8), False),
        ("latent 16384, the flagship's hidden", 16384, (256, 512, 1024, 512, 256), False),
        ("last width 14900", 256, (256, 512, 1024, 512, 14900), False),
        ("v2, latent 5120", 5120, (256, 512, 5120), True)]


def _edge(latent, hidden, batch, wide_latent):
    """The widest latent (or last width) the JAX kernel holds at `batch`."""
    lo, hi = 1, 1 << 23
    while hi - lo > 1:
        w = (lo + hi) // 2
        net = (w, hidden) if wide_latent else (latent, hidden[:-1] + (w,))
        lo, hi = (w, hi) if jax_process_bytes(*net, batch, T) <= VMEM else (lo, w)
    return lo


def test_the_wide_nets_are_at_the_jax_edge():
    """The edges of the nets in WIDE: a last width of 25,706 at the 8 bucket
    (24,365 at 64, 17,188 at 512), a latent of 1,047,802 at 8 (191,198 at
    64, 25,350 at 512), the flagship's hidden widths under a latent of
    75,087 at 8 (14,994 at 512), a last width of 14,900 at 8 (14,216 at 64);
    the v2 net at 5120 held at 8 to 256. Every edge lies below MAX_WIDTH."""
    assert [_edge(8, (8, 8, 0), b, False) for b in (8, 64, 512)] == [25706, 24365, 17188]
    assert [_edge(0, (8, 8), b, True) for b in (8, 64, 512)] == [1047802, 191198, 25350]
    flagship = (256, 512, 1024, 512, 256)
    assert [_edge(0, flagship, b, True) for b in (8, 512)] == [75087, 14994]
    assert [_edge(256, (256, 512, 1024, 512, 0), b, False) for b in (8, 64)] == [14900, 14216]
    assert all(jax_process_bytes(5120, (256, 512, 5120), b, T) <= VMEM for b in (8, 256))
    assert jax_process_bytes(5120, (256, 512, 5120), 512, T) > VMEM
    assert max(_edge(0, (8, 1), 1, True), _edge(8, (8, 0), 1, False)) < MAX_WIDTH


@pytest.mark.parametrize("name,latent,hidden,skip", WIDE, ids=[w[0] for w in WIDE])
def test_process_plan_takes_the_wide_nets_the_jax_kernel_holds(name, latent, hidden, skip):
    """At every bucket the services launch, guided or not, where the JAX
    kernel holds the net in 100 MiB: a plan of the wide layout, in shared
    memory, its clusters covering the rows, the latent and the last width
    padded to m64 units (by less than 64), the stage inputs as the narrow
    layouts pad them, every slice and pass within the instance's units."""
    taken = 0
    for batch in DEFAULT_BUCKETS:
        if jax_process_bytes(latent, hidden, batch, T) > VMEM:
            continue
        for guided in (True, False):
            plan = process_plan(latent, hidden, skip, batch, guided)
            assert plan.wide and plan.streamed
            lat_p, hid_p = process_widths(latent, hidden, plan.cols, wide=True)
            assert plan.smem == process_smem(lat_p, hid_p, skip, plan.cols, plan.rows,
                                             plan.qbufs, plan.slots, True, True)
            assert plan.smem <= SMEM_LIMIT and plan.waves >= 1
            rows = batch * (2 if guided else 1)
            assert plan.clusters * plan.rows >= rows
            units = max_units(plan.rows)
            for w, p in ((latent, lat_p), (hidden[-1], hid_p[-1])):
                assert p % 64 == 0 and 0 <= p - w < 64
                assert wide_passes(p, plan.cols, units) * units * 64 * plan.cols >= p
            for w, p in zip(hidden[:-1], hid_p[:-1]):
                assert w <= p < w + max(64, 8 * plan.cols) and p // plan.cols <= 64 * units
            taken += 1
    assert taken >= 2  # at least the 8 bucket, guided and not


def test_the_flagship_keeps_its_narrow_plans():
    """A net every narrow layout holds keeps its plan of before: the
    flagship's at the 8 and 64 buckets, resident."""
    flagship = (256, 512, 1024, 512, 256)
    assert tuple(process_plan(256, flagship, False, 8, True)) == (2, 16, 8, 2, 5, 215992, 1,
                                                                  False, False)
    assert tuple(process_plan(256, flagship, False, 64, True)) == (8, 8, 16, 2, 3, 220888, 1,
                                                                   False, False)


def test_the_port_refuses_past_its_bounds_naming_them():
    """Past MAX_WIDTH (a latent or last width no net the JAX kernel holds
    reaches at any batch) and past MAX_STAGE_WIDTH (a stage input)."""
    with pytest.raises(ValueError, match=str(MAX_WIDTH)):
        process_plan(MAX_WIDTH + 1, (8, 8), False, 1, False)
    with pytest.raises(ValueError, match=str(MAX_STAGE_WIDTH)):
        process_plan(8, (8, MAX_STAGE_WIDTH + 8, 8), False, 8, True)


# The CPU kernel path against the JAX package's fused sampler

STEPS, BATCH, SCALE, CLIP = 4, 3, 2.0, 3.0
# tests/test_torch_port_widths.py's JAX_TOL: bf16 operands on both sides, f32
# sums in other orders, the guidance scale amplifying the branches'
# difference, LayerNorm eps 1e-5 against 1e-6.
JAX_TOL = 3e-2


def test_cpu_kernel_path_matches_jax_fused_sample_past_4096():
    """Latent 40 under hidden (48, 48, 4200): the last width past 4096, as
    the wide layout takes it on the card (its plan exists at the 8 bucket)."""
    latent, hidden = 40, (48, 48, 4200)
    den = dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=64, num_classes=11,
               shared_cond_proj=True)
    tree = init_numpy_params("denoiser", seed=5, bias_std=0.3, **den)
    # The JAX kernel's null rows drop the condition projections' biases,
    # the port's keep them (the model's rule): zero them on both sides.
    for name in [f"time_proj_{i}" for i in range(len(hidden) - 1)] + ["final_cond_proj"]:
        tree["params"][name]["bias"] = np.zeros_like(tree["params"][name]["bias"])
    model = denoiser_from_params(tree, device="cpu", **den)
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((BATCH, latent)).astype(np.float32)
    cond = (np.arange(BATCH) * 3) % 11
    ref = np.asarray(jax_fused_sample(JaxDenoiser(**den), jax.tree.map(jnp.asarray, tree),
                                      jax_schedule(STEPS), jax.random.key(0), BATCH,
                                      jnp.asarray(cond), stochastic=False, interpret=True,
                                      x_init=jnp.asarray(x0), clip_x0=CLIP,
                                      guidance_scale=SCALE))
    sampler = FusedDiffusionSampler(model, linear_schedule(STEPS), (latent,), clip_x0=CLIP,
                                    guidance_scale=SCALE, device="cpu")
    before = launch_counts()
    got = sampler.sample(BATCH, torch.from_numpy(cond), x_init=torch.from_numpy(x0),
                         stochastic=False).numpy()
    assert launch_counts() == before, "the plain version launched a kernel"
    assert got.shape == ref.shape == (BATCH, latent) and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= JAX_TOL * float(np.abs(ref).max())
    assert process_plan(latent, hidden, False, 8, True).wide


# The product-form head (make_fast_denoiser's) past 2048

JAX_KERNEL_EPS = 1e-5  # the JAX kernels' LayerNorm epsilon, passed to the port to match


def test_product_form_head_twin_matches_pallas_interpret_past_2048():
    """d_last 2112, d_emb 2080, latent 2056, both base products and the
    adds: the twin the card's head_kernel is held to, against JAX's
    `fused_head` in interpret mode, within tests/test_torch_port_kernels.py's
    limits for the head."""
    rng = np.random.default_rng(3)
    b, dl, de, lat = 5, 2112, 2080, 2056

    def mk(*shape, scale=0.05):
        return rng.normal(size=shape, scale=scale).astype(np.float32)

    arrs = [mk(b, dl), mk(b, de), mk(b, de), mk(de, dl), mk(dl), mk(de, dl), mk(dl),
            1 + mk(dl), mk(dl), mk(dl, lat), mk(lat)]
    weights = {3, 5, 9}  # (in, out) for JAX, (out, in) bf16 for the port
    j = [jnp.asarray(a, jnp.bfloat16 if i in weights else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a.T.copy()).to(torch.bfloat16) if i in weights
         else torch.from_numpy(a) for i, a in enumerate(arrs)]
    ref = np.asarray(jax_fused_head(*j, interpret=True))
    got = fused_head(*t, eps=JAX_KERNEL_EPS).numpy()
    assert got.shape == ref.shape == (b, lat)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
