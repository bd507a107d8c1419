"""The reverse-process kernel on the CPU (kernels/full_sampler.py): its plan
(`process_plan`, `process_plans`, `process_smem`, `process_rows`), which the
CUDA kernel (csrc/reverse_process.cu) takes as it is, and its plain version
(`ReverseProcess` on a CPU model: the step loop on the kernels' twins)
against the JAX package's fused sampler in interpret mode. The kernel itself
runs only on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
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
from flowerdiff_torch.kernels.full_sampler import (
    MAX_STAGES,
    PROCESS_ROWS,
    ReverseProcess,
    WAVE_CLUSTERS,
    draw_request,
    launch_counts,
    prepare_fused_sampler,
    process_plan,
    process_plans,
    process_rows,
    process_smem,
    process_step_us,
    process_units,
    process_widths,
    run_steps,
)
from flowerdiff_torch.kernels.latent_stage import SMEM_LIMIT
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

LATENT, HIDDEN = 256, (256, 512, 1024, 512, 256)  # the flagship's widths
# The buckets the services launch: the flagship's (8, 64) guided, the v1
# HTTP service's (1, 2, 4, 8, 16, 32, 64) unguided, and the ladder's 128.
SERVICE_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("guided", [True, False])
def test_process_plan_covers_every_row_once_and_keeps_cfg_pairs_in_a_cluster(guided):
    for batch in range(1, 129 if guided else 257):
        plan = process_plan(LATENT, HIDDEN, False, batch, guided)
        rows = process_rows(plan, batch, guided)
        assert len(rows) == plan.clusters and all(len(r) == plan.rows for r in rows)
        held = sorted(r for cluster in rows for r in cluster if r >= 0)
        assert held == list(range(batch * (2 if guided else 1))), (batch, plan)
        assert all(any(r >= 0 for r in cluster) for cluster in rows), "an empty cluster"
        if guided:
            half = plan.rows // 2
            for cluster in rows:
                for r in range(half):
                    # sample b's conditional row r and its null row r + half
                    assert cluster[r + half] == (cluster[r] + batch if cluster[r] >= 0 else -1)


@pytest.mark.parametrize("skip", [False, True])
def test_process_plans_cut_whole_noise_groups(skip):
    """Each block's slice of x (and of every product) is a multiple of 8
    columns: whole 16-byte exchange units, and whole Philox groups of 4,
    so that a group's four normals lie in one block."""
    for plan in process_plans(LATENT, HIDDEN, skip, 64, True):
        assert LATENT % plan.cols == 0 and (LATENT // plan.cols) % 8 == 0
        assert all(w % plan.cols == 0 and (w // plan.cols) % 8 == 0
                   and w // plan.cols <= 128 for w in HIDDEN)
    assert {p.cols for p in process_plans(LATENT, HIDDEN, skip, 64, True)} == {8, 16}


@pytest.mark.parametrize("guided,skip", [(True, False), (False, False), (True, True),
                                         (False, True)])
def test_process_plan_fits_shared_memory_and_counts_its_waves(guided, skip):
    for batch in range(1, 129 if guided else 257):
        plans = process_plans(LATENT, HIDDEN, skip, batch, guided)
        assert plans
        for plan in plans:
            assert plan.rows in PROCESS_ROWS and 2 <= plan.slots <= 32
            assert plan.smem == process_smem(LATENT, HIDDEN, skip, plan.cols, plan.rows,
                                             plan.qbufs, plan.slots)
            assert plan.smem <= SMEM_LIMIT
            assert plan.waves == -(-plan.clusters // WAVE_CLUSTERS[plan.cols])
        chosen = process_plan(LATENT, HIDDEN, skip, batch, guided)
        assert chosen in plans
        if batch in SERVICE_BATCHES and batch * (2 if guided else 1) <= 128:
            assert chosen.waves == 1, (batch, chosen)


def test_process_smem_grows_with_each_region():
    base = process_smem(LATENT, HIDDEN, False, 16, 16, 2, 2)
    # a slot and its two mbarriers
    assert process_smem(LATENT, HIDDEN, False, 16, 16, 2, 3) == base + 32768 + 16
    assert process_smem(LATENT, HIDDEN, False, 16, 16, 1, 2) == base - 16 * 1024 * 2  # a buffer
    assert process_smem(LATENT, HIDDEN, False, 16, 32, 2, 2) > base
    # the skip adds a product, not a region
    assert process_smem(LATENT, HIDDEN, True, 16, 16, 2, 2) == base


def test_process_plan_ranks_by_waves_and_cost():
    for batch, guided in ((8, True), (64, True), (64, False)):
        plans = process_plans(LATENT, HIDDEN, False, batch, guided)
        best = process_plan(LATENT, HIDDEN, False, batch, guided)
        cost = best.waves * process_step_us(LATENT, HIDDEN, False, best)
        assert all(cost <= p.waves * process_step_us(LATENT, HIDDEN, False, p) for p in plans)


@pytest.mark.parametrize("hidden,latent,skip", [((256, 512, 4097, 512, 256), 256, False),
                                                ((64,) * (MAX_STAGES + 2), 64, False),
                                                ((256, 512, 128), 256, True)])
def test_process_plan_refuses_widths_the_kernel_cannot_take(hidden, latent, skip):
    """Past the kernel's bounds: a width above MAX_WIDTH (4096), MAX_STAGES +
    1 stages, a v2 skip whose last hidden width is not the latent's."""
    with pytest.raises(ValueError):
        process_plan(latent, hidden, skip, 8, True)


# Denoisers the JAX kernels sample (full_sampler.py holds whole arrays in
# VMEM): the --tiny preset, ragged widths, six stages, latent 254 with the
# flagship's hidden widths, with and without a skip of 254, a 2048-wide stage.
WIDTHS = [(32, (32, 64, 32), False), (96, (96, 200, 96), False),
          (64, (64, 128, 128, 128, 128, 128, 64), False), (254, HIDDEN, False),
          (254, (254, 512, 1024, 512, 254), True), (256, (256, 2048, 256), False)]


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("latent,hidden,skip", WIDTHS)
def test_process_plan_takes_every_denoiser_the_jax_kernel_takes(latent, hidden, skip, batch,
                                                                guided):
    plan = process_plan(latent, hidden, skip, batch, guided)
    assert plan.waves == 1 and plan.smem <= SMEM_LIMIT == 232448
    lat_p, hid_p = process_widths(latent, hidden, plan.cols)
    assert plan.smem == process_smem(lat_p, hid_p, skip, plan.cols, plan.rows, plan.qbufs,
                                     plan.slots)
    for w, p in zip((latent, *hidden), (lat_p, *hid_p)):
        # whole k64 tiles and 8-column slices, the padding less than one unit
        assert p % 64 == 0 and p % (8 * plan.cols) == 0 and 0 <= p - w < max(64, 8 * plan.cols)
        assert p // plan.cols <= 64 * process_units(plan.rows, max(latent, *hidden)) <= 256
    assert process_rows(plan, batch, guided)[0][0] == 0


# The plain version against the JAX package's fused sampler

DEN = dict(latent_dim=128, hidden_dims=(128, 256, 128), time_emb_dim=128, num_classes=11,
           shared_cond_proj=True)
STEPS, BATCH, SCALE, CLIP = 5, 8, 2.5, 1.0
# Relative to max|JAX|: the tolerance of the JAX fused sampler against the
# f32 model in tests/test_kernels.py. bf16 operands on both sides, f32 sums
# in other orders, the guidance scale amplifying the two branches'
# difference, and the JAX kernel's LayerNorm eps 1e-5 against the model's
# 1e-6 (ROADMAP's rule; either eps reads 1.4e-2 to 1.6e-2 here, mean 1.7e-3).
JAX_TOL = 3e-2


def _models():
    tree = init_numpy_params("denoiser", seed=5, bias_std=0.3, **DEN)
    # The JAX kernel's null rows drop the condition projections' biases,
    # the port's keep them (the model's rule): zero them on both sides.
    for name in ("time_proj_0", "time_proj_1", "final_cond_proj"):
        tree["params"][name]["bias"] = np.zeros_like(tree["params"][name]["bias"])
    den = denoiser_from_params(tree, device="cpu", **DEN)
    return den, JaxDenoiser(**DEN), jax.tree.map(jnp.asarray, tree)


def test_reverse_process_plain_matches_jax_interpret():
    den, jmodel, jparams = _models()
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((BATCH, DEN["latent_dim"])).astype(np.float32)
    cond = (np.arange(BATCH) * 3) % DEN["num_classes"]
    ref = np.asarray(jax_fused_sample(jmodel, jparams, jax_schedule(STEPS), jax.random.key(0),
                                      BATCH, jnp.asarray(cond), stochastic=False,
                                      interpret=True, x_init=jnp.asarray(x0), clip_x0=CLIP,
                                      guidance_scale=SCALE))
    prep = prepare_fused_sampler(den, linear_schedule(STEPS))
    process = ReverseProcess(prep)
    inputs = draw_request(prep, BATCH, torch.from_numpy(cond), x_init=torch.from_numpy(x0),
                          guided=True)
    before = launch_counts()
    got = process(inputs, stochastic=False, clip_x0=CLIP, guidance_scale=SCALE)
    assert launch_counts() == before, "the plain version launched a kernel"
    tol = JAX_TOL * float(np.abs(ref).max())
    assert got.shape == ref.shape and float(np.abs(got.numpy() - ref).max()) <= tol
    # the same call leaving out the guidance or the clip lands far outside
    for kw in (dict(clip_x0=CLIP, guidance_scale=1.0), dict(clip_x0=None, guidance_scale=SCALE)):
        other = process(inputs, stochastic=False, **kw).numpy()
        assert float(np.abs(other - ref).max()) > 2 * tol, kw
    # on the CPU the plain version is the step loop on the twins, bit for bit
    assert torch.equal(got, run_steps(prep, inputs, stochastic=False, clip_x0=CLIP,
                                      guidance_scale=SCALE))
    assert process.bound == {} and process.plan_for(BATCH, True) == process_plan(
        128, (128, 256, 128), False, BATCH, True)
