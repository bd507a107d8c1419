"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. Run them on
a machine with an H100 with `python -m pytest tests/test_torch_port_cuda.py`.
Widths are small, ragged ones among them (the kernels pad at bind), and up
to 4096, depths up to 340 stages; chip_smoke.py covers the flagship shapes.
"""
import re

import numpy as np
import pytest
import torch

from flowerdiff_torch.kernels.full_sampler import (
    bind_latent_proj,
    latent_proj,
    latent_proj_plain,
    reverse_step,
    reverse_step_plain,
)
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.tools.gemm_ab import step_products
from flowerdiff_torch.kernels.latent_stage import (
    bind_head,
    bind_stage,
    fused_head,
    fused_head_plain,
    fused_stage,
    fused_stage_plain,
    stage_map_encodes,
    stage_plan,
    stage_plans,
)
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    residual_stream,
    vae_from_params,
)

pytestmark = pytest.mark.cuda

# (s, kc) of the bf16 lane's split-K product over K: clusters of s blocks,
# block r summing k in [r kc, r kc + kc). The library's plan
# (`test_splitk_plan_at_the_flagship`); test_torch_port_faults.py models the
# order of the sum with it on the CPU.
SPLITK_PLAN = {1024: (8, 128), 512: (8, 64), 256: (4, 64), 1000: (8, 128), 200: (4, 64),
               96: (2, 64), 64: (1, 64), 36: (1, 64)}

# The bf16 lane's Y and dX shapes of the flagship step that run on the wgmma
# kernel, (form, M, N, K) -> (blocks a cluster, k tiles a block): N * K of
# 512 x 512 and up, but Y at N = 1024, K = 512; the others stay on the
# split-K kernel (PERF.md, the products' A/B).
WGMMA_YX = {("fwd", 64, 512, 512): (8, 1), ("dx", 64, 512, 512): (8, 1),
            ("fwd", 64, 1024, 256): (4, 1), ("dx", 64, 1024, 512): (8, 1),
            ("fwd", 64, 512, 1024): (8, 2), ("dx", 64, 512, 1024): (8, 2),
            ("dx", 64, 256, 1024): (8, 2), ("fwd", 64, 1024, 1024): (8, 2),
            ("dx", 64, 1024, 1024): (8, 2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _r(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _stage_args(gen, b, d, d_out):
    w = dict(scale=d ** -0.5, dtype=torch.bfloat16)
    return (_r(gen, b, d), _r(gen, b, d), _r(gen, d, d, **w), _r(gen, d, scale=0.1),
            1 + _r(gen, d, scale=0.1), _r(gen, d, scale=0.1), 1 + _r(gen, d, scale=0.1),
            _r(gen, d, scale=0.1), _r(gen, d, d, **w), _r(gen, d, scale=0.1),
            _r(gen, d, d, **w), _r(gen, d, scale=0.1), _r(gen, d_out, d, **w),
            _r(gen, d_out, scale=0.1))


# The denoiser's four stages at flagship width, hidden (256, 512, 1024, 512, 256)
FLAGSHIP_STAGES = [(256, 512), (512, 1024), (1024, 512), (512, 256)]


# Other plans: (1024, 768) at 16 rows (a slice of 48 Wd rows, less than an
# m64 tile) and at 128 (4 clusters of 32 rows, two ring slots), (512, 1536)
# at 128 (Wd's slice of three m64 tiles, 192 rows).
OTHER_STAGES = [(16, 1024, 768), (128, 1024, 768), (128, 512, 1536)]
# Widths the kernel pads (bind_stage: d to a multiple of 64, d_out to one of 8
# or 64), ragged d and d_out, the --tiny preset's, and 2048.
RAGGED_STAGES = [(8, 32, 64), (16, 64, 32), (13, 96, 200), (16, 200, 96), (128, 254, 512),
                 (16, 512, 254), (3, 1, 7), (16, 2048, 256), (128, 256, 2048),
                 (32, 2047, 2048)]
# Past 2048 (16 column slices of up to 256; at 128 rows in more than one
# wave): the flagship's shape with a 3456-wide middle, latent 2560, the
# widest one-stage net the JAX kernel holds, 4096, a 2112-wide stage.
WIDE_STAGES = [(16, 512, 3456), (128, 3456, 512), (16, 2560, 2560), (128, 2601, 2601),
               (8, 4096, 4096), (16, 2112, 64), (16, 64, 2112)]
# d_out past 4096: Wd's slice past a block's m64 tiles at every split, so in
# column passes (the wide instances): the last stages of the lopsided nets
# the JAX kernel holds (8 -> 25706, 512 -> 14900, 512 -> 5120) at both
# buckets' rows, a ragged one, and at 64 and 128 rows (one m64 tile a pass).
PASS_STAGES = [(16, 8, 25706), (128, 512, 14900), (16, 512, 5120), (128, 512, 5120),
               (3, 48, 4200), (64, 64, 4104), (8, 2048, 6000)]
# The sampler's row counts: the 8 and 64 buckets with CFG (16, 128), the
# unguided v1 service's 8, 32 and 64.
SAMPLER_ROWS = (8, 16, 32, 64, 128)


@pytest.mark.parametrize("b,d,d_out", [(1, 64, 64), (13, 128, 256), (32, 256, 64)]
                         + [(b, d, o) for d, o in FLAGSHIP_STAGES
                            for b in sorted({1, 100, *SAMPLER_ROWS})]
                         + OTHER_STAGES + RAGGED_STAGES + WIDE_STAGES + PASS_STAGES)
def test_stage_kernel_matches_twin(gen, b, d, d_out):
    args = _stage_args(gen, b, d, d_out)
    row = _r(gen, d)
    run = bind_stage(*args[2:])
    before = fused_stage.launches
    got = run(args[0], args[1], row)
    assert fused_stage.launches == before + 1
    ref = fused_stage_plain(*args, row_add=row)
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    assert torch.equal(fused_stage(*args, row_add=row), got)


@pytest.mark.parametrize("b,d,d_out", [(128, 256, 512), (16, 1024, 512), (64, 512, 256)])
def test_every_stage_plan_matches_twin(gen, b, d, d_out):
    """Each plan `stage_plans` offers (every column split and rows a block,
    up to 128 rows a block), forced on the bound stage: the twin within the
    same limit, the same bits when repeated."""
    args = _stage_args(gen, b, d, d_out)
    row = _r(gen, d)
    run = bind_stage(*args[2:])
    ref = fused_stage_plain(*args, row_add=row)
    plans = stage_plans(d, d_out, b)
    assert any(plan.rows == 128 for plan in plans) or b < 128
    for plan in plans:
        got = run(args[0], args[1], row, plan=plan)
        assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max()), plan
        assert torch.equal(run(args[0], args[1], row, plan=plan), got), plan


@pytest.mark.parametrize("b", [16, 100])
def test_stage_kernel_is_deterministic(gen, b):
    """No atomics: the same call twice gives the same bits."""
    args = _stage_args(gen, b, 1024, 512)
    row = _r(gen, 1024)
    run = bind_stage(*args[2:])
    assert torch.equal(run(args[0], args[1], row), run(args[0], args[1], row))


@pytest.mark.parametrize("rows", [16, 128])
@pytest.mark.parametrize("d,d_out", FLAGSHIP_STAGES)
def test_every_flagship_stage_launch_runs_the_wgmma_kernel(gen, d, d_out, rows):
    """The route: each flagship cell of the 8 and 64 buckets (16, 128 rows)
    is one launch of `stage_kernel` (the instance of its plan's rows a
    block) with the plan `stage_plan` makes, and encodes no tensor map (the
    binding did)."""
    args = _stage_args(gen, rows, d, d_out)
    row = _r(gen, d)
    e0 = stage_map_encodes()
    run = bind_stage(*args[2:])
    assert stage_map_encodes() > e0
    plan = run.plan_for(rows)
    assert plan == stage_plan(d, d_out, rows)
    run(args[0], args[1], row)
    torch.cuda.synchronize()
    e0 = stage_map_encodes()
    for _ in range(3):  # CUPTI now and then hands back a profile with no device row: again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(args[0], args[1], row)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert stage_map_encodes() == e0
    units = 1 if plan.rows == 128 else 2 if plan.rows == 64 else 4
    want = f"stage_kernel<{plan.rows}, {units}>"
    assert len(names) == 1 and want in names[0], names


@pytest.mark.parametrize("b,dl,de,lat", [(9, 64, 32, 128), (128, 256, 256, 256),
                                         (16, 1024, 33, 128), (9, 2048, 255, 254),
                                         (5, 200, 97, 96), (17, 30, 7, 5),
                                         (9, 2112, 2080, 2056), (17, 4500, 64, 96),
                                         (5, 256, 33, 5000), (16, 25706, 64, 8),
                                         (3, 64, 4200, 40)])
def test_head_kernel_matches_twin(gen, b, dl, de, lat):
    """Every form of the head: with both base products, one of them, or
    none (the sampler's table form), with and without the adds. A call with
    either product runs the whole-row kernel and counts in
    fused_head.product_launches; a call with neither runs the column-tile
    kernel; both count in fused_head.launches. Past 2048 (d_last, d_emb or
    latent) the product form keeps its rows in device memory, past 4096
    (d_last) the table form runs K in passes."""
    w = dict(scale=0.1, dtype=torch.bfloat16)
    args = (_r(gen, b, dl), _r(gen, b, de), _r(gen, b, de), _r(gen, dl, de, **w),
            _r(gen, dl), _r(gen, dl, de, **w), _r(gen, dl), 1 + _r(gen, dl, scale=0.1),
            _r(gen, dl), _r(gen, lat, dl, **w), _r(gen, lat))
    no_products = args[:1] + (None,) * 6 + args[7:]
    t_only = args[:2] + (None,) + args[3:5] + (None, None) + args[7:]
    c_only = args[:1] + (None,) + args[2:3] + (None, None) + args[5:]
    adds = dict(row_add=_r(gen, dl), rows_add=_r(gen, b, dl))
    for a, kw, product in ((args, {}, 1), (args, adds, 1), (t_only, adds, 1),
                           (c_only, adds, 1), (no_products, adds, 0)):
        before, products = fused_head.launches, fused_head.product_launches
        got = bind_head(*a[3:])(a[0], a[1], a[2], **kw)
        assert fused_head.launches == before + 1
        assert fused_head.product_launches == products + product
        ref = fused_head_plain(*a, **kw)
        assert got.shape == (b, lat)
        assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
        assert torch.equal(fused_head(*a, **kw), got)


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("guided", [False, True])
def test_reverse_step_kernel_matches_twin(gen, guided, with_skip):
    b, lat = 5, 24
    x = _r(gen, b, lat)
    eps = _r(gen, 2 * b if guided else b, lat)
    skip = _r(gen, b, lat) if with_skip else None
    kw = dict(guidance_scale=4.0 if guided else None, clip_x0=1.5, key=(7, 8), skip=skip)
    for t in (0, 1, 400):
        got = reverse_step(eps, x, t, (0.99, 0.5, 0.01), **kw)
        ref = reverse_step_plain(eps, x, t, (0.99, 0.5, 0.01), **kw)
        assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("rows", [16, 128])
def test_latent_proj_kernel_matches_twin(gen, rows, guided, with_skip):
    """The step's projection at the flagship's 256 x 256 and at both
    buckets' stage rows (x has half the rows when guided), with and without
    the v2 skip. Both sides multiply the same bf16 values exactly in f32 and
    sum in another order: 1e-4 of the largest value (rounding x to bf16 or
    not moves it by ~1e-3)."""
    lat, hid = 256, 256
    b = rows // 2 if guided else rows
    bf = torch.bfloat16
    x = _r(gen, b, lat)
    wl, bl = _r(gen, hid, lat, scale=lat ** -0.5, dtype=bf), _r(gen, hid, scale=0.5)
    skip_w = {}
    if with_skip:
        skip_w = dict(wf=_r(gen, lat, lat, scale=lat ** -0.5, dtype=bf), bf=_r(gen, lat, scale=0.5),
                      rw=_r(gen, 1, scale=0.5).reshape(()))
    copies = 2 if guided else 1
    run = bind_latent_proj(wl, bl, **skip_w)
    before = latent_proj.launches
    h, skip = run(x, copies)
    assert latent_proj.launches == before + 1
    ref_h, ref_skip = latent_proj_plain(x, wl, bl, copies=copies, **skip_w)
    assert h.shape == (rows, hid)
    assert float((h - ref_h).abs().max()) <= 1e-4 * float(ref_h.abs().max())
    if guided:
        assert torch.equal(h[:b], h[b:])
    if with_skip:
        assert skip.shape == (b, lat)
        assert float((skip - ref_skip).abs().max()) <= 1e-4 * float(ref_skip.abs().max())
    else:
        assert skip is None and ref_skip is None
    again = latent_proj(x, wl, bl, copies=copies, **skip_w)
    assert torch.equal(again[0], h)


# The sampler's step at both buckets and at the batch sizes between: B
# latents give 2B stage rows under guidance (2, 6, 16 and 128), ragged row
# tiles of 16 included.
STEP_BATCHES = [1, 3, 8, 64]


def _proj_case(gen, b, lat, hid, with_skip):
    bf = torch.bfloat16
    x = _r(gen, b, lat)
    wl, bl = _r(gen, hid, lat, scale=lat ** -0.5, dtype=bf), _r(gen, hid, scale=0.5)
    skip_w = {}
    if with_skip:
        skip_w = dict(wf=_r(gen, lat, lat, scale=lat ** -0.5, dtype=bf),
                      bf=_r(gen, lat, scale=0.5), rw=_r(gen, 1, scale=0.5).reshape(()))
    return x, wl, bl, skip_w


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("b,lat,hid", [(b, 256, 256) for b in STEP_BATCHES]
                         + [(3, 24, 40), (5, 200, 100), (64, 520, 256), (8, 1024, 72),
                            (8, 254, 512), (64, 254, 256), (16, 2048, 256), (3, 2047, 2048),
                            (5, 30, 32), (16, 2560, 2560), (3, 4095, 64), (64, 2601, 2601),
                            (8, 4096, 256)])
def test_latent_proj_tiles_match_twin_and_repeat(gen, b, lat, hid, guided, with_skip):
    """The projection's 16 x 16 tiles at every batch of the step (ragged row
    tiles), and at widths with ragged column tiles (H not a multiple of 16),
    ragged k chunks (L not a multiple of 32), two or four k chunks a warp
    (L above 256 or 512) and two passes of 2048 (L above 2048); limits as
    test_latent_proj_kernel_matches_twin.
    The same call twice gives the same bits."""
    x, wl, bl, skip_w = _proj_case(gen, b, lat, hid, with_skip)
    copies = 2 if guided else 1
    run = bind_latent_proj(wl, bl, **skip_w)
    h, skip = run(x, copies)
    ref_h, ref_skip = latent_proj_plain(x, wl, bl, copies=copies, **skip_w)
    assert h.shape == (copies * b, hid)
    assert float((h - ref_h).abs().max()) <= 1e-4 * float(ref_h.abs().max())
    if guided:
        assert torch.equal(h[:b], h[b:])
    if with_skip:
        assert float((skip - ref_skip).abs().max()) <= 1e-4 * float(ref_skip.abs().max())
    h2, skip2 = run(x, copies)
    assert torch.equal(h2, h) and (skip is None or torch.equal(skip2, skip))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("b,lat,hid,with_skip", [(8, 6000, 64, True), (3, 40000, 8, False),
                                                 (8, 16384, 256, False),
                                                 (8, 1047802, 8, False)])
def test_latent_proj_past_4096_matches_twin_and_repeats(gen, b, lat, hid, with_skip, guided):
    """The projection with L in as many passes of 2048 as it needs: the
    lopsided nets' latents (up to the 1,047,802 the JAX kernel holds at the
    8 bucket), with the v2 skip at 6000; a repeat bit-equal. The limit is
    test_latent_proj_kernel_matches_twin's 1e-4 of the largest value up to
    L = 4096, and grows past it as sqrt(L / 4096): both sides sum L exact
    products in f32 in other orders, and such sums part by ~sqrt(L)
    roundings (at 1,047,802 the card read 1.6e-4 of the largest value)."""
    x, wl, bl, skip_w = _proj_case(gen, b, lat, hid, with_skip)
    copies = 2 if guided else 1
    run = bind_latent_proj(wl, bl, **skip_w)
    before = latent_proj.launches
    h, skip = run(x, copies)
    assert latent_proj.launches == before + 1
    ref_h, ref_skip = latent_proj_plain(x, wl, bl, copies=copies, **skip_w)
    assert h.shape == (copies * b, hid)
    rel = 1e-4 * max(1.0, (lat / 4096) ** 0.5)
    assert float((h - ref_h).abs().max()) <= rel * float(ref_h.abs().max())
    if with_skip:
        assert float((skip - ref_skip).abs().max()) <= rel * float(ref_skip.abs().max())
    h2, skip2 = run(x, copies)
    assert torch.equal(h2, h) and (skip is None or torch.equal(skip2, skip))


def _head_case(gen, rows, dl, lat, de=32):
    w = dict(scale=dl ** -0.5, dtype=torch.bfloat16)
    weights = dict(wt=_r(gen, dl, de, **w), bt=_r(gen, dl, scale=0.5),
                   wc=_r(gen, dl, de, **w), bc=_r(gen, dl, scale=0.5),
                   g=1 + _r(gen, dl, scale=0.2), b=_r(gen, dl, scale=0.5),
                   wf=_r(gen, lat, dl, **w), bf=_r(gen, lat, scale=0.5))
    return _r(gen, rows, dl), _r(gen, dl), _r(gen, rows, dl, scale=0.5), weights


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("b,dl,lat", [(b, 256, 256) for b in STEP_BATCHES]
                         + [(3, 96, 40), (8, 512, 264), (64, 32, 8), (8, 1024, 256),
                            (64, 2048, 254), (3, 254, 254), (8, 200, 96), (5, 30, 7),
                            (8, 3456, 256), (16, 2560, 2560), (3, 4095, 7), (64, 4096, 256),
                            (8, 25706, 8), (8, 14900, 256), (3, 4200, 40), (64, 5120, 5120),
                            (8, 8, 40000), (3, 4097, 7)])
def test_head_table_form_tiles_match_twin_and_repeat(gen, b, dl, lat, guided):
    """The sampler's head (no base products; time row and condition rows as
    adds) on the column-tile kernel: 16 rows x 16 columns a block, at every
    batch of the step and at widths with a ragged column tile (latent not a
    multiple of 16) and two k chunks a warp (d_last 512). The limit of the
    head's card tests, 2e-2 of max|twin|: the LayerNorm output is rounded to
    bf16 on both sides, and a value at a rounding boundary can land one ulp
    away. Each add left out moves the twin past it; a repeat is bit-equal."""
    rows = 2 * b if guided else b
    h, row_add, rows_add, w = _head_case(gen, rows, dl, lat)
    run = bind_head(**w)
    before, products = fused_head.launches, fused_head.product_launches
    got = run(h, row_add=row_add, rows_add=rows_add)
    assert fused_head.launches == before + 1 and fused_head.product_launches == products
    ref = fused_head_plain(h, None, None, **w, row_add=row_add, rows_add=rows_add)
    assert got.shape == (rows, lat)
    tol = 2e-2 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol
    for drop in (dict(row_add=row_add), dict(rows_add=rows_add)):
        moved = fused_head_plain(h, None, None, **w, **drop)
        assert float((moved - ref).abs().max()) > 2 * tol
    assert torch.equal(run(h, row_add=row_add, rows_add=rows_add), got)


def test_wrappers_reject_bad_cuda_inputs(gen):
    d, bf = 64, torch.bfloat16
    vec = _r(gen, d)
    weights = (_r(gen, d, d, dtype=bf), vec, vec, vec, vec, vec,
               _r(gen, d, d, dtype=bf), vec, _r(gen, d, d, dtype=bf), vec,
               _r(gen, d, d, dtype=bf), vec)
    h = _r(gen, 4, d)
    with pytest.raises(ValueError, match="dtype"):
        fused_stage(h.double(), None, *weights)
    with pytest.raises(ValueError, match="shape"):
        fused_stage(h, _r(gen, 3, d), *weights)
    with pytest.raises(ValueError, match="dtype"):
        fused_stage(h, None, *((weights[0].float(),) + weights[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        fused_stage(_r(gen, d, 4).t(), None, *weights)
    with pytest.raises(ValueError, match="16-byte"):
        fused_stage(_r(gen, 4 * d + 1)[1:].view(4, d), None, *weights)
    with pytest.raises(ValueError):
        reverse_step(_r(gen, 4, d), h, 3, (0.9, 0.5, 0.1), guidance_scale=2.0)
    with pytest.raises(ValueError):
        reverse_step(_r(gen, d, 4).t(), h, 3, (0.9, 0.5, 0.1))
    # the widths past the kernels' 4096: the projection's L, the head's
    # d_last and latent, the stage's d and d_out; the head's form with t/c
    # products past its 2048, at the call
    for lat in (4097, 5000):
        with pytest.raises(ValueError, match="latent width"):
            bind_latent_proj(_r(gen, 16, lat, dtype=bf), _r(gen, 16))
    for dl, lat in ((4128, 64), (64, 4104)):
        hw = _head_case(gen, 4, dl, lat)[3]
        with pytest.raises(ValueError, match="width"):
            bind_head(**{**hw, "wt": None, "bt": None, "wc": None, "bc": None})
    h, _, _, hw = _head_case(gen, 4, 2080, 64)
    with pytest.raises(ValueError, match="2048"):
        bind_head(**hw)(h, t_base=_r(gen, 4, 32))
    for d, d_out in ((4097, 64), (64, 4097)):
        with pytest.raises(ValueError, match="widths"):
            bind_stage(*_stage_args(gen, 1, d, d_out)[2:])


# ---------------------------------------------------------------------------
# The train-step kernels (csrc/train_step.cuh, bound by csrc/train_step.cu)

def _bf(x):
    return x.to(torch.bfloat16).float()


# Every Linear (in, out) of the flagship train step at its 64 rows: their
# three forms cover the 24 (form, M, N, K) shapes of its bf16 products
# (`gemm_ab.step_products`, fwd M = 64, N = out, K = in; dW M = out, N = in,
# K = 64; dX M = 64, N = in, K = out).
FLAGSHIP_LINEARS = sorted({(k, n) if form == "fwd" else (n, m) if form == "dw" else (n, k)
                           for form, m, n, k in step_products()})
# Odd row counts and ragged tiles, K that is not a multiple of the split or
# of the 64-deep tile (Y at K = 1000 or 200, dX at K = 36 or 40).
RAGGED_LINEARS = [(1, 32, 32), (13, 96, 40), (67, 100, 36), (64, 1000, 36), (64, 200, 1000)]
PRODUCT_CASES = RAGGED_LINEARS + [(64, k, n) for k, n in FLAGSHIP_LINEARS]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rows,k,n", PRODUCT_CASES)
def test_product_three_forms_match_f32_references(gen, exact, rows, k, n):
    """Y = X W^T + b, dX = dY W, dW = dY^T X with db = colsum(dY), at odd row
    counts and ragged tiles and at every shape of the flagship step, each
    on the kernel its plan names. Exact lane: f32 sums in another order,
    rtol 1e-5 of the largest value. bf16 lane: the references round the
    same operands to bf16, and the dX / dW outputs are rounded to bf16
    after the whole sum (one bf16 ulp = 2^-8 relative, plus the summation
    order). db is summed in f32 in row order in both lanes."""
    _check_three_forms(gen, exact, rows, k, n, "plan")


@pytest.mark.parametrize("route", ["splitk", "wgmma"])
@pytest.mark.parametrize("rows,k,n", PRODUCT_CASES)
def test_product_routes_match_f32_references(gen, route, rows, k, n):
    """The bf16 lane's Y and dX forms forced onto either kernel (the two
    that the plan chooses between) hold the same references."""
    _check_three_forms(gen, False, rows, k, n, route)


def _check_three_forms(gen, exact, rows, k, n, route):
    x, w, b = _r(gen, rows, k), _r(gen, n, k, scale=k ** -0.5), _r(gen, n)
    dy, mul, res = _r(gen, rows, n), _r(gen, rows, n), _r(gen, rows, n)
    rnd = (lambda t: t) if exact else _bf
    tol = 1e-5 if exact else 2.0 ** -7

    def close(got, ref):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())

    close(ts.linear_forward(x, w, b, exact=exact, scale=2.0, mul=mul, res=res, route=route),
          (rnd(x) @ rnd(w).t() + 2.0 * b) * mul + res)
    res_x = _r(gen, rows, k)
    close(ts.linear_dx(dy, w, exact=exact, res=res_x, route=route),
          rnd(rnd(dy) @ rnd(w)) + res_x)
    if route == "plan":
        dw, db = ts.linear_dw(dy, x, exact=exact, scale=2.0)
        close(dw, rnd(rnd(dy).t() @ rnd(x)))
        ref_db = torch.zeros(n, device="cuda")
        for r in range(rows):  # in row order, as the kernels sum
            ref_db += dy[r]
        assert torch.equal(db, 2.0 * ref_db)


@pytest.mark.parametrize("route", ["plan", "splitk", "wgmma"])
@pytest.mark.parametrize("rows,k,n", [(13, 96, 40)] + [(64, k, n) for k, n in FLAGSHIP_LINEARS])
def test_product_is_bit_equal_on_repeat(gen, route, rows, k, n):
    """Each form twice on the same inputs gives the same bits: no atomics;
    the split-K partials (either kernel) are added in rank order."""
    x, w, b = _r(gen, rows, k), _r(gen, n, k, scale=k ** -0.5), _r(gen, n)
    dy, res = _r(gen, rows, n), _r(gen, rows, k)
    fns = [lambda: ts.linear_forward(x, w, b, exact=False, scale=2.0, route=route),
           lambda: ts.linear_dx(dy, w, exact=False, res=res, route=route)]
    if route == "plan":
        fns += [lambda: ts.linear_dw(dy, x, exact=False)[0],
                lambda: ts.linear_dw(dy, x, exact=False)[1]]
    for fn in fns:
        first = fn()
        torch.cuda.synchronize()
        assert torch.equal(first, fn())


def test_splitk_plan_at_the_flagship(gen):
    """K = 1024: clusters of 8 blocks of two tiles (N = 1024: 256 blocks);
    K = 512: 8 of one; K = 256: 4 of one; K = 64 would be one block; and the
    ragged K of `test_product_three_forms_match_f32_references`."""
    assert {k: ts.splitk_plan(k) for k in SPLITK_PLAN} == SPLITK_PLAN


def test_product_plan_sends_each_form_where_documented(gen):
    """The library's plan at the flagship step's 24 bf16 shapes: dW on the
    wgmma kernel, a block a 64 x 64 tile, no split; Y and dX on the kernel
    `WGMMA_YX` names (the faster of the two in the A/B of PERF.md), else on
    the split-K kernel with `splitk_plan`'s clusters. The f32 lane: the FMA
    kernel."""
    for (form, m, n, k), count in step_products().items():
        plan = ts.product_plan(form, m, n, k)
        if form == "dw":
            assert plan == {"kernel": "wgmma", "tile": (64, 64), "split": 1, "kc": 64,
                            "blocks": m // 64 * (n // 64)}, (form, m, n, k)
        elif (form, m, n, k) in WGMMA_YX:
            s, kt = WGMMA_YX[(form, m, n, k)]
            assert plan == {"kernel": "wgmma", "tile": (64, 64), "split": s, "kc": 64 * kt,
                            "blocks": -(-n // 64) * s}, (form, m, n, k)
        else:
            s, kc = SPLITK_PLAN[k]
            assert plan == {"kernel": "splitk", "tile": (64, 32), "split": s, "kc": kc,
                            "blocks": n // 32 * s}, (form, m, n, k)
        assert ts.product_plan(form, m, n, k, exact=True)["kernel"] == "fma"


@pytest.mark.parametrize("rows,d", [(5, 48), (64, 1024), (3, 1000)])
@pytest.mark.parametrize("block", [False, True])
def test_layernorm_kernels_match_autograd(gen, rows, d, block):
    """LayerNorm forward (mean, rstd saved) and backward with dgamma / dbeta
    reduced over the rows, against torch.nn.functional.layer_norm under
    autograd; `block` adds the dropout mask, the swish and the residual of
    the stage's first half. f32 throughout: 1e-4 of the largest value."""
    x = _r(gen, rows, d, scale=2.0) + 0.5
    g = (1 + _r(gen, d, scale=0.2)).requires_grad_(True)
    b = _r(gen, d, scale=0.5).requires_grad_(True)
    dy, res = _r(gen, rows, d), _r(gen, rows, d)
    mask = (torch.rand((rows, d), generator=gen, device="cuda") >= 0.3).float() / 0.7
    xr = x.clone().requires_grad_(True)
    y_ref = torch.nn.functional.layer_norm(xr, (d,), g, b, ts.LN_EPS)
    if block:
        y_ref = y_ref * mask
        y_ref = y_ref * torch.sigmoid(y_ref) + res
    dx_ref, dg_ref, db_ref = torch.autograd.grad(y_ref, (xr, g, b), dy)
    kw = dict(mask=mask, swish=True) if block else {}
    y, mean, rstd = ts.layernorm_forward(x, g.detach(), b.detach(), res=res if block else None,
                                         **kw)
    dx, dg, db = ts.layernorm_backward(dy, x, mean, rstd, g.detach(), b.detach(), res=res, **kw)
    for got, ref in ((y, y_ref.detach()), (dx, dx_ref + res), (dg, dg_ref), (db, db_ref)):
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _step_case(gen, global_skip, batch=9):
    return _net_case(gen, dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32,
                               num_classes=7, global_skip=global_skip), batch)


@pytest.mark.parametrize("global_skip", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 3e-2)])
def test_train_step_kernel_matches_twin(gen, global_skip, dtype, tol):
    """Loss and every gradient leaf of the kernel sequence against autograd
    on the plain twin, with dropout masks, a condition mask with zeros,
    nonzero biases and perturbed LN affines, at an odd batch. Limits per
    leaf, relative to max|twin grad|: 5e-4 in the f32 lane (summation
    order), 3e-2 in the bf16 lane (the kernel also rounds the incoming
    gradient to bf16, which the twin keeps in f32)."""
    model, data, masks = _step_case(gen, global_skip)
    named = dict(ts.weights_spec(model))
    before = ts.kernel_loss_and_grads.launches
    loss, grads = ts.kernel_loss_and_grads(named, data, masks, dtype=dtype,
                                           global_skip=global_skip)
    assert ts.kernel_loss_and_grads.launches == before + 1
    cpu = {k: v.detach().cpu() for k, v in named.items()}
    ref_loss, ref = ts.kernel_loss_and_grads(
        cpu, {k: v.cpu() for k, v in data.items()}, [m.cpu() for m in masks], dtype=dtype,
        global_skip=global_skip)
    assert abs(float(loss) - float(ref_loss)) <= tol * abs(float(ref_loss))
    for name, g in grads.items():
        r = ref[name].cuda()
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= tol * scale + 1e-9, name
    tree = ts.grads_to_tree(grads, model)
    for name, g in tree.items():
        if ".q." in name or ".k." in name:
            assert not g.any(), name


# Widths whose rows are not whole 16-byte units (latent_dim, time_emb_dim not
# multiples of 4; under the v2 skip hidden[-1] = latent_dim too), where tensor
# maps cannot read a product's operands: (name, model widths, batch).
RAGGED_NETS = [
    ("small_v1", dict(latent_dim=62, hidden_dims=(64, 128, 64), time_emb_dim=30,
                      num_classes=7), 9),
    ("small_v2", dict(latent_dim=62, hidden_dims=(64, 128, 62), time_emb_dim=30,
                      num_classes=7, global_skip=True), 9),
    ("near_flagship_v1", dict(latent_dim=254, hidden_dims=(256, 512, 1024, 512, 256),
                              time_emb_dim=254, num_classes=102), 64),
    ("near_flagship_v2", dict(latent_dim=254, hidden_dims=(256, 512, 1024, 512, 254),
                              time_emb_dim=254, num_classes=102, global_skip=True), 64),
]
_FLAGSHIP_NET = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                     num_classes=102)


def _net_case(gen, kw, batch):
    """A denoiser of widths `kw` with nonzero biases and perturbed LN affines,
    one step's data (a condition mask with zeros) and dropout masks."""
    tree = init_numpy_params("denoiser", seed=2, bias_std=0.3, **kw)
    if len(kw["hidden_dims"]) > 9:  # a residual stream past 8 stages, as _width_sampler's
        residual_stream(tree)
    model = denoiser_from_params(tree, device="cuda", **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_ln_" in name or "final_norm" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=gen, device="cuda"))
    rate, lat, te = 0.3, kw["latent_dim"], kw["time_emb_dim"]
    masks = []
    for d in kw["hidden_dims"][:-1]:
        mb = (torch.rand((batch, d), generator=gen, device="cuda") >= rate).float() / (1 - rate)
        ma = (torch.rand((batch, 8), generator=gen, device="cuda") >= rate).float() / (1 - rate)
        masks += [mb, ma.repeat_interleave(d // 8, dim=1)]
    abar = torch.rand((batch, 1), generator=gen, device="cuda") * 0.9 + 0.05
    data = {"z": _r(gen, batch, lat), "eps": _r(gen, batch, lat),
            "t_f": torch.randint(0, 1000, (batch, 1), generator=gen, device="cuda").float(),
            "sa": abar.sqrt(), "s1a": (1 - abar).sqrt(),
            "labels": (torch.arange(batch, device="cuda") % 5).to(torch.int32),
            "cond_mask": (torch.arange(batch, device="cuda") % 3 != 0).float()[:, None],
            "freqs": ts.sinusoid_freqs(te, "cuda")}
    return model, data, masks


# 40 stages of 128 (~27 MiB of f32 weights and gradients: the JAX step
# holds it in its 120 MiB of VMEM), past the 16 stages the host structs of
# the train kernels once held. The step's net is a residual stream
# (`_net_case`): from the plain seeded tree the bf16 lane, which rounds
# each incoming gradient before its products where the twin rounds after
# them, drifts over 40 stages to ~2e-2 of a leaf's largest gradient.
_DEEP_NET = dict(latent_dim=128, hidden_dims=(128,) * 41, time_emb_dim=64, num_classes=7)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 1.5e-2)])
def test_train_step_kernel_at_40_stages_matches_twin(gen, dtype, tol):
    """The bound step of the deep net at the flagship's batch of 64 in both
    lanes: loss and every gradient leaf against autograd on the plain twin
    on the card; f32 at the limit of `test_train_step_kernel_matches_twin`,
    bf16 at `chip_smoke.py`'s TRAIN_BF16_REL (1.5e-2)."""
    model, data, masks = _net_case(gen, _DEEP_NET, 64)
    named = dict(ts.weights_spec(model))
    run = ts.bind_train_step(named, 64, dtype=dtype)
    before = ts.tensor_map_encodes()
    loss, grads = run(data, masks)
    assert ts.tensor_map_encodes() == before
    assert len(grads) == 11 + 14 * 40 + 9
    ref_loss, ref = ts.twin_loss_and_grads(named, data, masks, dtype=dtype)
    assert torch.isfinite(loss)
    assert abs(float(loss) - float(ref_loss)) <= tol * abs(float(ref_loss))
    for k, r in ref.items():
        g = grads[k].reshape(r.shape)
        assert float((g - r).abs().max()) <= tol * float(r.abs().max()) + 1e-9, k


@pytest.mark.parametrize("name,kw,batch", RAGGED_NETS, ids=[n for n, _, _ in RAGGED_NETS])
def test_train_step_bf16_lane_at_ragged_widths_matches_twin(gen, name, kw, batch):
    """The bf16 lane at widths tensor maps cannot read (their products on
    split-K and mma_dw, the plan's routes): loss and every gradient leaf
    against autograd on the plain twin on the card, at the bf16 limit of
    `test_train_step_kernel_matches_twin` (3e-2 of max|twin grad| a leaf)."""
    tol, skip = 3e-2, kw.get("global_skip", False)
    model, data, masks = _net_case(gen, kw, batch)
    named = dict(ts.weights_spec(model))
    run = ts.bind_train_step(named, batch, dtype=torch.bfloat16, global_skip=skip)
    kernels = {q["kernel"] for q in run.products()}
    assert {"splitk", "mma_dw"} <= kernels, kernels
    loss, grads = run(data, masks)
    ref_loss, ref = ts.twin_loss_and_grads(named, data, masks, dtype=torch.bfloat16,
                                           global_skip=skip)
    assert torch.isfinite(loss)
    assert abs(float(loss) - float(ref_loss)) <= tol * abs(float(ref_loss))
    for k, r in ref.items():
        g = grads[k].reshape(r.shape)
        assert float((g - r).abs().max()) <= tol * float(r.abs().max()) + 1e-9, k
    again, _ = run(data, masks)
    assert torch.equal(again, loss)  # no atomics: the step repeats bit for bit


def _ragged(strides) -> bool:
    return any(4 * s % 16 for s in strides)


@pytest.mark.parametrize("name,kw,batch", RAGGED_NETS + [("flagship", _FLAGSHIP_NET, 64)],
                         ids=[n for n, _, _ in RAGGED_NETS] + ["flagship"])
def test_step_plan_routes_every_product_by_its_strides(gen, name, kw, batch):
    """Every product of a bound bf16 step, read from its plan: none whose
    operand rows are not whole 16-byte units on the tensor-map kernel (dW
    then on mma_dw, Y / dX on split-K), each where `product_plan` with its
    strides sends it; at the flagship the 79 bf16 products of
    `step_products` on the routes of `test_product_plan_sends_each_form_
    where_documented`, the f32 ones on the FMA kernel."""
    model, _, _ = _net_case(gen, kw, batch)
    run = ts.bind_train_step(dict(ts.weights_spec(model)), batch, dtype=torch.bfloat16,
                             global_skip=kw.get("global_skip", False))
    bf16 = {}
    for q in run.products():
        if q["kernel"] == "fma":
            continue
        form, (m, n, k) = q["form"], q["mnk"]
        plan = ts.product_plan(form, m, n, k, strides=q["strides"])
        assert plan["kernel"] == q["kernel"] and plan["split"] == q["split"], q
        assert plan["kc"] == q["kc"] and plan["blocks"] == q["blocks"], q
        if _ragged(q["strides"]):
            assert q["kernel"] == ("mma_dw" if form == "dw" else "splitk"), q
        bf16[(form, m, n, k)] = bf16.get((form, m, n, k), 0) + 1
    # f32: final's Y, dX and dW, and the v2 skip's Y
    assert sum(1 for q in run.products() if q["kernel"] == "fma") == \
        (4 if kw.get("global_skip") else 3)
    if name == "flagship":
        assert bf16 == step_products()
        for (form, m, n, k) in bf16:
            want = "wgmma" if form == "dw" or (form, m, n, k) in WGMMA_YX else "splitk"
            assert ts.product_plan(form, m, n, k)["kernel"] == want
    else:
        assert any(_ragged(q["strides"]) for q in run.products())


def test_forced_wgmma_on_a_ragged_product_raises(gen):
    """A product whose rows tensor maps cannot read is refused on the wgmma
    kernel, when forced (`route=`), in the plan and at the launch; so are the
    routes a form does not run on. The plan's own route takes it."""
    x, w, b = _r(gen, 9, 62), _r(gen, 64, 62), _r(gen, 64)
    dy = _r(gen, 9, 64)
    for call in (lambda: ts.linear_forward(x, w, b, exact=False, route="wgmma"),
                 lambda: ts.linear_dx(dy, w, exact=False, route="wgmma"),
                 lambda: ts.linear_dw(dy, x, exact=False, route="wgmma"),
                 lambda: ts.product_plan("fwd", 9, 64, 62, route="wgmma"),
                 lambda: ts.product_plan("dw", 64, 62, 9, route="wgmma"),
                 lambda: ts.product_plan("dw", 64, 64, 9, route="splitk"),
                 lambda: ts.product_plan("fwd", 9, 64, 64, route="mma_dw")):
        with pytest.raises(RuntimeError):
            call()
    assert ts.product_plan("fwd", 9, 64, 62)["kernel"] == "splitk"
    assert ts.product_plan("dw", 64, 62, 9)["kernel"] == "mma_dw"
    ts.linear_forward(x, w, b, exact=False)
    ts.linear_dw(dy, x, exact=False)
    torch.cuda.synchronize()


# (rows, in, out) of Linears with a width that is not a multiple of 4
RAGGED_STRIDE_LINEARS = [(9, 62, 64), (13, 30, 60), (64, 254, 1024), (64, 1024, 254),
                         (64, 254, 254), (7, 5, 3)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rows,k,n", RAGGED_STRIDE_LINEARS)
def test_product_at_ragged_strides_matches_f32_references(gen, exact, rows, k, n):
    """The three forms where tensor maps cannot read the operands, on the
    plan's kernels (split-K, mma_dw), at the limits of
    `test_product_three_forms_match_f32_references`."""
    _check_three_forms(gen, exact, rows, k, n, "plan")


@pytest.mark.parametrize("rows,k,n", PRODUCT_CASES + RAGGED_STRIDE_LINEARS)
def test_mma_dw_route_matches_f32_references_and_repeats(gen, rows, k, n):
    """dW on the mma_dw kernel, forced at every shape of the other product
    tests: round(bf16(dY)^T bf16(X)) to one bf16 ulp of the largest value,
    db = 2 colsum(dY) in row order exactly, and the same bits twice."""
    dy, x = _r(gen, rows, n), _r(gen, rows, k)
    dw, db = ts.linear_dw(dy, x, exact=False, scale=2.0, route="mma_dw")
    ref = _bf(_bf(dy).t() @ _bf(x))
    assert float((dw - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    ref_db = torch.zeros(n, device="cuda")
    for r in range(rows):
        ref_db += dy[r]
    assert torch.equal(db, 2.0 * ref_db)
    torch.cuda.synchronize()
    again, again_db = ts.linear_dw(dy, x, exact=False, scale=2.0, route="mma_dw")
    assert torch.equal(again, dw) and torch.equal(again_db, db)


def test_bound_steps_encode_no_tensor_map_after_bind(gen):
    """At flagship width, with a bound step and an epoch function alive: the
    binding encodes three maps a wgmma product; three steps after the first
    and one epoch after its first encode none (`tensor_map_encodes`)."""
    from flowerdiff_torch.kernels import train_epoch as te
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
    )

    model, data, masks = _net_case(gen, _FLAGSHIP_NET, 64)
    before = ts.tensor_map_encodes()
    run = ts.bind_train_step(dict(ts.weights_spec(model)), 64, dtype=torch.bfloat16)
    n_wgmma = sum(1 for q in run.products() if q["kernel"] == "wgmma")
    assert n_wgmma == 50 and ts.tensor_map_encodes() - before == 3 * n_wgmma
    cfg = LatentDiffusionConfig(**_FLAGSHIP_NET, n_steps=50, steps_per_epoch=3,
                                dropout_rate=0.3, cond_dropout=0.1)
    state, emodel, sched = create_latent_diffusion_state(3, cfg, device="cuda")
    epoch_fn = te.make_mega_epoch_fn(emodel, cfg, 3, 64)
    z = _r(gen, 3, 64, 256)
    labels = torch.randint(0, 102, (3, 64), generator=gen, device="cuda")
    run(data, masks)
    epoch_fn(state, sched, z, labels, 1)
    torch.cuda.synchronize()
    first = ts.tensor_map_encodes()
    for _ in range(3):
        run(data, masks)
    losses = epoch_fn(state, sched, z, labels, 2)
    torch.cuda.synchronize()
    assert ts.tensor_map_encodes() == first
    assert torch.isfinite(losses).all()


# ---------------------------------------------------------------------------
# The epoch kernels (csrc/train_epoch.cu)

_EPOCH_NET = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=7)


def _epoch_case(net=_EPOCH_NET, **cfg_over):
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
    )

    cfg = LatentDiffusionConfig(**{**net, "n_steps": 50, "steps_per_epoch": 3,
                                   "dropout_rate": 0.3, "cond_dropout": 0.25, **cfg_over})
    state, model, sched = create_latent_diffusion_state(3, cfg, device="cuda")
    return cfg, state, model, sched


def test_draws_kernel_ranges_structure_and_bits(gen):
    """The draws kernel against its PyTorch twin (the same Philox words:
    timesteps, keep-mask and dropout masks equal, eps to 1e-5: libm), the
    masks' values and head structure, and that a step's bits depend on the
    seed and on the step."""
    from flowerdiff_torch.kernels import train_epoch as te

    cfg, state, model, sched = _epoch_case()
    steps, batch, rate = 3, 13, 0.3
    before = te.epoch_draws.launches
    t, eps, keep, masks = te.epoch_draws(model, cfg, sched, steps, batch, 99, 5)
    assert te.epoch_draws.launches == before + steps
    assert t.shape == (steps, batch) and eps.shape == (steps, batch, 64)
    assert float(t.min()) >= 0 and float(t.max()) <= 49 and torch.equal(t, t.floor())
    assert set(keep.unique().tolist()) <= {0.0, 1.0}
    for i in range(steps):
        rt, reps, rkeep, rmasks = te.step_draws_plain(model, 50, cfg.cond_dropout, batch, 99,
                                                      5 + i, "cuda")
        assert torch.equal(t[i], rt) and torch.equal(keep[i], rkeep)
        assert float((eps[i] - reps).abs().max()) <= 1e-5
        assert all(torch.equal(m[i], r) for m, r in zip(masks, rmasks))
    for j, m in enumerate(masks):
        d = _EPOCH_NET["hidden_dims"][j // 2]
        assert m.shape == (steps, batch, d)
        assert bool(((m == 0) | ((m - 1 / (1 - rate)).abs() < 1e-6)).all())
        if j % 2:  # one draw a (sample, head), repeated over the head's columns
            heads = m.reshape(steps, batch, 8, d // 8)
            assert torch.equal(heads, heads[..., :1].expand_as(heads))
        assert not torch.equal(m[0], m[1])
    again = te.epoch_draws(model, cfg, sched, steps, batch, 99, 5)
    assert torch.equal(again[1], eps) and all(torch.equal(a, b) for a, b in zip(again[3], masks))
    other_seed = te.epoch_draws(model, cfg, sched, steps, batch, 100, 5)
    next_step = te.epoch_draws(model, cfg, sched, steps, batch, 99, 6)
    assert not torch.equal(other_seed[1], eps) and not torch.equal(next_step[1], eps)
    assert torch.equal(next_step[1][0], eps[1])  # step 6 is step 6 whichever epoch holds it
    # rate 0 and cond_dropout 0: ones, no draws
    cfg0, _, model0, _ = _epoch_case(dropout_rate=0.0, cond_dropout=0.0)
    _, _, keep0, masks0 = te.epoch_draws(model0, cfg0, sched, 1, batch, 1, 0)
    assert bool((keep0 == 1).all()) and all(bool((m == 1).all()) for m in masks0)


@pytest.mark.parametrize("sizes", [(1,), (4097, 3, 8192), (100003, 1, 77, 4096)])
def test_norm_kernels_match_vector_norm(gen, sizes):
    """Per-chunk partial sums and the ordered final sum at odd leaf sizes,
    against torch.linalg.vector_norm over the concatenation: f32 sums in
    another order, 1e-5 relative; the same input gives the same bits."""
    from flowerdiff_torch.kernels import train_epoch as te

    grads = [_r(gen, n, scale=3.0) for n in sizes]
    got = te.grad_norm(grads)
    ref = torch.linalg.vector_norm(torch.cat(grads))
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)
    assert torch.equal(te.grad_norm(grads), got)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [0.1, 1e9])
def test_adamw_kernel_matches_the_formulas(gen, moments, clip):
    """Clip scale, moments, bias corrections, decoupled decay and the update
    on a few odd-sized leaves, against the formulas in PyTorch ops: f32
    arithmetic in another contraction, rtol 1e-5 / atol 1e-7 on w, 1e-6 of
    the largest value on the moments; stored bf16 moments may land one bf16
    ulp apart."""
    from flowerdiff_torch.kernels import train_epoch as te

    sizes = (5, 4096, 10001)
    w = [_r(gen, n) for n in sizes]
    g = [_r(gen, n, scale=0.3) for n in sizes]
    m = [_r(gen, n, scale=0.01, dtype=moments) for n in sizes]
    v = [(torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-6).to(moments) for n in sizes]
    lr, bc1, bc2, wd = 1e-2, 0.19, 0.002, 0.1
    gnorm = torch.linalg.vector_norm(torch.cat(g))
    cscale = min(1.0, clip / float(gnorm))
    assert (cscale < 1.0) == (clip == 0.1)
    want = []
    for wi, gi, mi, vi in zip(w, g, m, v):
        gs = gi * cscale
        m_new = 0.9 * mi.float() + 0.1 * gs
        v_new = 0.999 * vi.float() + 0.001 * gs * gs
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + 1e-8) + wd * wi
        want.append((wi - lr * upd, m_new, v_new))
    te.adamw_update(w, g, m, v, gnorm, lr, bc1, bc2, grad_clip=clip, weight_decay=wd)
    mtol = 1e-6 if moments == torch.float32 else 2.0 ** -7
    for wi, mi, vi, (rw, rm, rv) in zip(w, m, v, want):
        assert mi.dtype == moments and vi.dtype == moments
        assert float((wi - rw).abs().max()) <= 1e-7 + 1e-5 * float(rw.abs().max())
        for got, ref in ((mi.float(), rm), (vi.float(), rv)):  # 1e-6 of the largest: fma
            assert bool(((got - ref).abs() <= mtol * ref.abs() + 1e-6 * ref.abs().max()).all())


@pytest.mark.parametrize("lane,moments", [(torch.float32, torch.float32),
                                          (torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.bfloat16)])
def test_epoch_kernel_matches_twin_at_small_width(gen, lane, moments):
    """One stochastic epoch of 3 steps at an odd batch against
    `mega_epoch_plain` on the fetched draws, from a state two epochs in
    (nonzero moments, step 6), with an EMA and a decay that shows. f32 lane:
    losses rtol 1e-4, weights and mu rtol 2e-3 / atol 2e-5. bf16 lane: losses
    rtol 1e-2, moments 4e-2 of the leaf's largest, weights within 2 lr a
    step. The same seed twice gives the same bits."""
    _epoch_against_twin(gen, lane, moments, _EPOCH_NET)


_RAGGED_EPOCH_NET = dict(latent_dim=62, hidden_dims=(64, 128, 64), time_emb_dim=30,
                         num_classes=7)


@pytest.mark.parametrize("lane,moments", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_epoch_kernel_matches_twin_at_ragged_widths(gen, lane, moments):
    """The same epoch at widths tensor maps cannot read (latent 62, time
    embedding 30: the bf16 products on split-K and mma_dw), at the limits of
    `test_epoch_kernel_matches_twin_at_small_width`."""
    _epoch_against_twin(gen, lane, moments, _RAGGED_EPOCH_NET)


@pytest.mark.parametrize("lane,moments", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_epoch_kernel_matches_twin_at_40_stages(gen, lane, moments):
    """The same epoch over 40 stages of 128 (its draws in more than one
    launch a step), at the limits of
    `test_epoch_kernel_matches_twin_at_small_width`."""
    _epoch_against_twin(gen, lane, moments, _DEEP_NET)


def _epoch_against_twin(gen, lane, moments, net):
    from flowerdiff_torch.kernels import train_epoch as te

    steps, batch = 3, 9
    z = _r(gen, steps, batch, net["latent_dim"])
    labels = torch.randint(0, 7, (steps, batch), generator=gen, device="cuda")
    runs = []
    for kind in ("kernel", "twin", "kernel"):
        cfg, state, model, sched = _epoch_case(net, weight_decay=0.5, ema_decay=0.9, t0=1)
        fn = te.make_mega_epoch_fn(model, cfg, steps, batch, dtype=lane, moments_dtype=moments)
        for e in range(2):  # the warm-up epochs run through the kernel for all three
            fn(state, sched, z, labels, 7)
        assert state.step == 6 and fn.launches == 2 and fn.steps == 6
        if kind == "kernel":
            losses = fn(state, sched, z, labels, 7)
            assert fn.launches == 3 and float(fn.gnorms.min()) > 0
        else:
            draws = te.epoch_draws(model, cfg, sched, steps, batch, 7, 6)
            losses, _ = te.mega_epoch_plain(state, sched, z, labels, draws, dtype=lane,
                                            moments_dtype=moments)
        torch.cuda.synchronize()
        assert state.step == 9
        runs.append((losses, state))
    (lk, sk), (lt, st), (lk2, sk2) = runs
    assert torch.equal(lk, lk2) and all(torch.equal(a, b) for a, b in zip(sk.params, sk2.params))
    exact = lane == torch.float32
    assert float(((lk - lt).abs() / lt.abs()).max()) <= (1e-4 if exact else 1e-2)
    for name, a, b, ma, mb, ea, eb in zip(sk.names, sk.params, st.params, sk.mu, st.mu, sk.ema,
                                          st.ema):
        if exact:
            mtol = 2e-3 if moments == torch.float32 else 2.0 ** -7
            assert bool(((a - b).abs() <= 2e-5 + 2e-3 * b.abs()).all()), name
            assert bool(((ea - eb).abs() <= 2e-5 + 2e-3 * eb.abs()).all()), name
            assert bool(((ma - mb).abs() <= 2e-5 + mtol * mb.abs()).all()), name
        else:
            assert float((a - b).abs().max()) <= 2 * cfg.lr * steps + 1e-6, name
            assert float((ma - mb).abs().max()) <= 4e-2 * float(mb.abs().max()) + 1e-12, name
    q = sk.names.index("attn_0.q.weight")
    assert torch.equal(sk.params[q], st.params[q])  # the same f32 factor on both sides


# ---------------------------------------------------------------------------
# The reverse process in one launch (kernels/full_sampler.ReverseProcess,
# csrc/reverse_process.cu) against the host loop of the step's kernels

_PROCESS_NET = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                    num_classes=102, shared_cond_proj=True)
_PROCESS_STEPS = 20
# Against the host loop (`fused_sample`'s kernels), relative to max|host
# loop|. Never bit-equal: the host loop's projection and head sum their
# products on other tiles (csrc/latent_proj.cu, latent_head.cu) and its
# stages split the columns by their own plans, so a value near a bf16
# rounding boundary lands one ulp away and carries on. Guided, the scale
# (7.0) multiplies the two branches' difference, and over 1000 steps the
# differences carry further; 20 steps at flagship width read 1.4e-2 to
# 1.8e-2 guided, 1.5e-3 to 1.8e-3 unguided, 1000 guided steps at the 8
# bucket 3.6e-2. By (steps, guided).
PROCESS_TOL = {(20, True): 3e-2, (20, False): 5e-3, (1000, True): 1e-1, (1000, False): 3e-2}
_PROCESS_MODELS = {}


def _process_sampler(global_skip, guided, steps=_PROCESS_STEPS):
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import FusedDiffusionSampler

    kw = dict(_PROCESS_NET, global_skip=global_skip)
    if global_skip not in _PROCESS_MODELS:
        _PROCESS_MODELS[global_skip] = denoiser_from_params(
            init_numpy_params("denoiser", seed=3, bias_std=0.3, **kw), device="cuda", **kw)
    return FusedDiffusionSampler(_PROCESS_MODELS[global_skip], linear_schedule(steps), (256,),
                                 clip_x0=3.0, guidance_scale=7.0 if guided else None,
                                 device="cuda")


def _inputs(sampler, batch, cls, seed, x_init=None):
    from flowerdiff_torch.kernels.full_sampler import draw_request

    return draw_request(sampler._prep, batch, cls, None,
                        torch.Generator(device="cuda").manual_seed(seed), x_init,
                        guided=sampler.guidance_scale is not None)


def _host_loop(sampler, inputs, stochastic=True, prep=None, **over):
    from flowerdiff_torch.kernels.full_sampler import run_steps

    kw = dict(stochastic=stochastic, clip_x0=sampler.clip_x0,
              guidance_scale=sampler.guidance_scale)
    kw.update(over)
    return run_steps(prep or sampler._prep, inputs, **kw)


def _process(sampler, inputs, stochastic=True, **kw):
    return sampler.process(inputs, stochastic=stochastic, clip_x0=sampler.clip_x0,
                           guidance_scale=sampler.guidance_scale, **kw)


def _held(got, ref, guided, steps=_PROCESS_STEPS):
    assert got.shape == ref.shape and torch.isfinite(got).all()
    tol = PROCESS_TOL[(steps, guided)] * float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= tol, f"err {err} > {tol}"
    return tol


# (stage rows, guided, v2 global skip, step noise): every row count the
# services launch, 8 to 256, guided and not
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("global_skip", [False, True])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("rows", [8, 16, 32, 64, 128, 256])
def test_reverse_process_holds_the_host_loop(gen, rows, guided, global_skip, stochastic):
    """20 steps in one launch against `fused_sample`'s host loop of the
    step's kernels from the same x_init and key, within PROCESS_TOL; a
    repeat bit-equal; the counters: one launch of the reverse-process kernel
    and no stage, head, projection or reverse-step launch."""
    from flowerdiff_torch.kernels.full_sampler import launch_counts

    sampler = _process_sampler(global_skip, guided)
    batch = rows // 2 if guided else rows
    cls = torch.arange(batch, device="cuda") % 102
    x0 = None if stochastic else _r(gen, batch, 256)
    inputs = _inputs(sampler, batch, cls, 11, x0)
    before = launch_counts()
    got = _process(sampler, inputs, stochastic)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), reverse_process=1)
    _held(got, _host_loop(sampler, inputs, stochastic), guided)
    assert torch.equal(_process(sampler, inputs, stochastic), got)
    assert list(sampler.process.bound) == [(batch, guided)]


def _left_out(sampler, inputs):
    """The host loop with one term of the process left out at a time."""
    from flowerdiff_torch.kernels.full_sampler import bind_latent_proj

    out = {"CFG": _host_loop(sampler, inputs, guidance_scale=1.0),
           "clip": _host_loop(sampler, inputs, clip_x0=None),
           "noise": _host_loop(sampler, inputs, stochastic=False)}
    adds = list(inputs.stage_adds)
    adds[2] = torch.zeros_like(adds[2])
    out["stage 2's condition add"] = _host_loop(sampler, inputs._replace(stage_adds=tuple(adds)))
    if sampler.model.global_skip:
        wl, bl = sampler._prep["proj"].weights[:2]
        out["skip"] = _host_loop(sampler, inputs,
                                 prep=dict(sampler._prep, proj=bind_latent_proj(wl, bl)))
    return out


@pytest.mark.parametrize("batch,steps", [(8, _PROCESS_STEPS), (64, _PROCESS_STEPS), (8, 1000),
                                         (64, 1000)])
def test_reverse_process_left_out_terms_sit_far_outside_its_limit(gen, batch, steps):
    """The guided v2 process with noise, 20 and 1000 steps at the 8 and 64
    buckets: within its limit of the host loop, and the host loop without
    any one of CFG, the skip, the clip, the noise or one stage's condition
    add more than twice the limit away."""
    sampler = _process_sampler(True, True, steps)
    cls = torch.arange(batch, device="cuda") % 102
    inputs = _inputs(sampler, batch, cls, 17)
    ref = _host_loop(sampler, inputs)
    tol = _held(_process(sampler, inputs), ref, True, steps)
    for term, other in _left_out(sampler, inputs).items():
        assert float((other - ref).abs().max()) > 2 * tol, term


@pytest.mark.parametrize("guided", [True, False])
def test_reverse_process_1000_steps_at_both_buckets(gen, guided):
    """The flagship's 1000 stochastic steps at the 8 and 64 buckets, v1,
    within the limit of the host loop, repeats bit-equal."""
    sampler = _process_sampler(False, guided, 1000)
    for batch in (8, 64):
        cls = torch.arange(batch, device="cuda") % 102
        inputs = _inputs(sampler, batch, cls, 5)
        got = _process(sampler, inputs)
        _held(got, _host_loop(sampler, inputs), guided, 1000)
        assert torch.equal(_process(sampler, inputs), got)


def test_reverse_process_carries_each_request(gen):
    """Three requests through one bound plan (other classes, x_init and
    key): each holds its own host-loop result, and they differ."""
    sampler = _process_sampler(False, True)
    cls_a = torch.arange(8, device="cuda") % 102
    cls_b = (torch.arange(8, device="cuda") * 13 + 5) % 102
    runs = [_inputs(sampler, 8, cls_a, 21), _inputs(sampler, 8, cls_b, 22),
            _inputs(sampler, 8, cls_b, 23, _r(gen, 8, 256))]
    got = [_process(sampler, i) for i in runs]
    for g, i in zip(got, runs):
        _held(g, _host_loop(sampler, i), True)
    assert len(sampler.process.bound) == 1
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])


def test_reverse_process_every_plan_forced(gen):
    """Every plan the kernel takes at the 64 bucket, guided, each with one
    operand buffer too (the mbarrier that counts the blocks' releases), and
    the unguided 8 bucket's: each within the limit of the host loop; a
    bound plan's launches encode no tensor map; a plan claimed one wave fits
    the card's cudaOccupancyMaxActiveClusters."""
    from flowerdiff_torch.kernels.full_sampler import (
        process_map_encodes,
        process_max_clusters,
        process_plans,
        process_smem,
    )

    for guided, batch in ((True, 64), (False, 8)):
        sampler = _process_sampler(True, guided)
        inputs = _inputs(sampler, batch, torch.arange(batch, device="cuda") % 102, 41)
        ref = _host_loop(sampler, inputs)
        plans = process_plans(256, _PROCESS_NET["hidden_dims"], True, batch, guided)
        for p in list(plans):
            if p.qbufs == 2:
                smem = process_smem(256, _PROCESS_NET["hidden_dims"], True, p.cols, p.rows, 1,
                                    p.slots)
                plans.append(p._replace(qbufs=1, smem=smem))
        assert any(p.qbufs == 1 for p in plans)
        for p in plans:
            _held(_process(sampler, inputs, plan=p), ref, guided)
            encodes = process_map_encodes()
            _process(sampler, inputs, plan=p)
            assert process_map_encodes() == encodes, p
            if p.waves == 1:
                assert p.clusters <= process_max_clusters(p), p


# Denoisers the JAX package samples with its kernel (whole arrays in VMEM,
# no condition on width or depth), by (latent, hidden): the --tiny preset,
# ragged widths, six stages, latent 254 with the flagship's hidden widths and
# with a last width of 254 (a stage's input width is a multiple of its 8
# attention heads), a 2048-wide stage; each v1 and, where hidden[-1] ==
# latent, v2.
WIDTH_NETS = [(32, (32, 64, 32)), (96, (96, 200, 96)), (64, (64, 128, 128, 128, 128, 128, 64)),
              (254, (256, 512, 1024, 512, 256)), (254, (256, 512, 1024, 512, 254)),
              (256, (256, 2048, 256))]
# Nets past the resident layout's 8 stages and 2048 wide, at the JAX
# kernel's edge (its 100 MiB at the 64 bucket): 63 stages of 256, 340 of 64,
# 23 of 512, the flagship's shape with a 3456-wide middle, latent 2560, and
# a 12-stage v2 net; (latent, hidden, skip). The deep ones are residual
# streams (`residual_stream`): from the plain seeded tree a bf16 rounding
# that lands the other way in one of their thousands of products moves the
# guided sample past PROCESS_TOL (the host loop's own sums in f64 do, on the
# CPU), and 340 stages overflow.
DEEP_CASES = [(256, (256,) * 64, False), (64, (64,) * 341, False), (512, (512,) * 24, False),
              (256, (256, 512, 3456, 512, 256), False), (2560, (2560, 2560), False),
              (64, (64,) * 13, True)]
WIDTH_CASES = [(lat, hid, skip) for lat, hid in WIDTH_NETS
               for skip in ((False, True) if hid[-1] == lat else (False,))] + DEEP_CASES
_WIDTH_MODELS = {}


def _width_sampler(latent, hidden, skip, guided, steps):
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import FusedDiffusionSampler

    kw = dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=32 if latent == 32 else 64,
              num_classes=11, shared_cond_proj=True, global_skip=skip)
    key = (latent, hidden, skip)
    if key not in _WIDTH_MODELS:
        tree = init_numpy_params("denoiser", seed=3, bias_std=0.3, **kw)
        if len(hidden) > 9:  # past 8 stages a residual stream: the plain tree is chaotic
            residual_stream(tree)
        _WIDTH_MODELS[key] = denoiser_from_params(tree, device="cuda", **kw)
    return FusedDiffusionSampler(_WIDTH_MODELS[key], linear_schedule(steps), (latent,),
                                 clip_x0=3.0, guidance_scale=7.0 if guided else None,
                                 device="cuda")


def _plain_steps(sampler, inputs):
    """The process on the kernels' plain twins on the card, step for step
    as the host loop issues the kernels."""
    from flowerdiff_torch.kernels.full_sampler import reverse_step_plain

    prep, guided = sampler._prep, sampler.guidance_scale is not None
    wl, bl, wf, bf, rw = prep["proj"].weights
    _, _, _, _, g, b, hwf, hbf = prep["head"].weights
    x = inputs.x
    for t in range(prep["n_steps"] - 1, -1, -1):
        h, skip = latent_proj_plain(x, wl, bl, copies=2 if guided else 1, wf=wf, bf=bf, rw=rw)
        for i, stage in enumerate(prep["stages"]):
            h = fused_stage_plain(h, inputs.stage_adds[i], *stage.weights,
                                  row_add=prep["tadds"][i][t])
        eps = fused_head_plain(h, None, None, None, None, None, None, g, b, hwf, hbf,
                               row_add=prep["tadd_final"][t], rows_add=inputs.final_add)
        x = reverse_step_plain(eps, x, t, prep["coefs"][t], guidance_scale=sampler.guidance_scale,
                               clip_x0=sampler.clip_x0, key=inputs.key, skip=skip)
    return x


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("latent,hidden,skip", WIDTH_CASES)
def test_reverse_process_takes_every_width_and_depth(gen, latent, hidden, skip, guided, batch):
    """At each denoiser of WIDTH_CASES (DEEP_CASES among them), both
    buckets, guided and not, with noise: 20 steps in one launch against the
    host loop within PROCESS_TOL,
    every left-out term (CFG and the clip when guided, the noise, the last
    stage's condition add, the skip) more than twice the limit away, a
    repeat bit-equal, one launch; 5 steps against the plain twins on the
    card within the same limits."""
    from flowerdiff_torch.kernels.full_sampler import bind_latent_proj, launch_counts

    sampler = _width_sampler(latent, hidden, skip, guided, _PROCESS_STEPS)
    cls = torch.arange(batch, device="cuda") % 11
    inputs = _inputs(sampler, batch, cls, 31)
    # past 8 stages the streamed layout (maps and tables in device memory)
    assert sampler.process.plan_for(batch, guided).streamed == (len(hidden) > 9)
    before = launch_counts()
    got = _process(sampler, inputs)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), reverse_process=1)
    ref = _host_loop(sampler, inputs)
    tol = _held(got, ref, guided)
    assert torch.equal(_process(sampler, inputs), got)
    adds = list(inputs.stage_adds)
    adds[-1] = torch.zeros_like(adds[-1])
    dropped = {"noise": _host_loop(sampler, inputs, stochastic=False),
               "the last stage's condition add": _host_loop(
                   sampler, inputs._replace(stage_adds=tuple(adds)))}
    if guided:
        dropped["CFG"] = _host_loop(sampler, inputs, guidance_scale=1.0)
        dropped["clip"] = _host_loop(sampler, inputs, clip_x0=None)
    if skip:
        wl, bl = sampler._prep["proj"].weights[:2]
        dropped["skip"] = _host_loop(sampler, inputs,
                                     prep=dict(sampler._prep, proj=bind_latent_proj(wl, bl)))
    for term, other in dropped.items():
        assert float((other - ref).abs().max()) > 2 * tol, term
    short = _width_sampler(latent, hidden, skip, guided, 5)
    inputs = _inputs(short, batch, cls, 32)
    _held(_process(short, inputs), _plain_steps(short, inputs), guided)


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("latent,hidden,skip", [(256, (256, 512, 1024, 512, 256), False),
                                                (64, (64, 128, 128, 128, 128, 128, 64), True),
                                                (96, (96, 200, 96), False)])
def test_streamed_layout_is_bit_equal_to_the_resident_one(gen, latent, hidden, skip, batch):
    """The streamed layout (maps, widths and time tables in device memory,
    vectors and condition rows read from L2) on a net that fits the
    resident one, at the bound plan's geometry: the same arithmetic in the
    same order, so the same bits, guided with noise and the clip."""
    from flowerdiff_torch.kernels.full_sampler import launch_counts, process_smem, process_widths

    sampler = _width_sampler(latent, hidden, skip, True, _PROCESS_STEPS)
    inputs = _inputs(sampler, batch, torch.arange(batch, device="cuda") % 11, 33)
    plan = sampler.process.plan_for(batch, True)
    assert not plan.streamed
    lat_p, hid_p = process_widths(latent, hidden, plan.cols)
    streamed = plan._replace(streamed=True, smem=process_smem(
        lat_p, hid_p, skip, plan.cols, plan.rows, plan.qbufs, plan.slots, True))
    resident = _process(sampler, inputs)
    before = launch_counts()["reverse_process"]
    got = _process(sampler, inputs, plan=streamed)
    assert launch_counts()["reverse_process"] == before + 1
    assert torch.equal(got, resident)


def test_streamed_launches_on_two_streams_keep_their_own_condition_rows(gen):
    """Two requests of the 12-stage v2 net (the streamed layout, which
    reads each stage's condition adds through a pointer table) launched
    together on two streams, three times: each x_0 bit-equal to its launch
    alone, which holds its own host loop within PROCESS_TOL. A table shared
    by the binding would let the second launch's pointers reach the first
    while it still runs."""
    sampler = _width_sampler(64, (64,) * 13, True, True, _PROCESS_STEPS)
    batch = 8
    assert sampler.process.plan_for(batch, True).streamed
    reqs = [_inputs(sampler, batch, (torch.arange(batch, device="cuda") + 5 * k) % 11, 40 + k)
            for k in range(2)]
    alone = [_process(sampler, r) for r in reqs]
    for r, x in zip(reqs, alone):
        _held(x, _host_loop(sampler, r), True)
    assert not torch.equal(*alone)
    streams = [torch.cuda.Stream() for _ in reqs]
    for _ in range(3):
        torch.cuda.synchronize()
        outs = []
        for s, r in zip(streams, reqs):
            with torch.cuda.stream(s):
                outs.append(_process(sampler, r))
        torch.cuda.synchronize()
        for got, x in zip(outs, alone):
            assert torch.equal(got, x)


def test_reverse_step_takes_the_key_from_device_memory(gen):
    x, eps = _r(gen, 64, 256), _r(gen, 128, 256)
    kw = dict(guidance_scale=7.0, clip_x0=3.0)
    for key in ((12345, 678), (2**31 + 3, 2**32 - 1)):
        ref = reverse_step(eps, x, 500, (0.99, 0.5, 0.01), key=key, **kw)
        words = [k - 2**32 if k >= 2**31 else k for k in key]
        dev_key = torch.tensor(words, dtype=torch.int32, device="cuda")
        assert torch.equal(reverse_step(eps, x, 500, (0.99, 0.5, 0.01), key=dev_key, **kw), ref)
        assert float((ref - reverse_step_plain(eps, x, 500, (0.99, 0.5, 0.01), key=dev_key,
                                               **kw)).abs().max()) <= 1e-4


_SVC_DEN = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=64, num_classes=11)
_SVC_VAE = dict(latent_dim=64, channels=(8, 16, 32, 64), head_width=64)


def _service(**kw):
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.serving import SamplingService
    from flowerdiff_torch.utils.weights import vae_from_params

    return SamplingService(
        denoiser_from_params(init_numpy_params("denoiser", seed=4, **_SVC_DEN), device="cuda",
                             **_SVC_DEN),
        vae_from_params(init_numpy_params("vae", seed=5, **_SVC_VAE), device="cuda", **_SVC_VAE),
        sched=linear_schedule(10), buckets=(4, 8), clip_x0=3.0, guidance_scale=3.0,
        device="cuda", **kw)


@pytest.mark.parametrize("decode", [False, True])
def test_sample_async_equals_sample_on_the_card(gen, decode):
    """A request of three chunks: `sample_async`'s fetch equals `sample` bit
    for bit (each chunk one launch of the reverse-process kernel), the decoded
    images included: the service decodes under cuDNN's deterministic
    algorithms itself."""
    import numpy as np

    from flowerdiff_torch.kernels.full_sampler import reverse_process

    svc = _service(quantize_uint8=True)
    assert svc.use_fused
    classes = np.arange(19) * 5 % 11
    assert svc.request_plan(19) == [8, 8, 4]
    launches = reverse_process.launches
    svc.warmup()
    assert sorted(k[0] for k in svc.sampler.process.bound) == [4, 8]
    got = svc.sample_async(classes, seed=3, decode=decode)()
    ref = svc.sample(classes, seed=3, decode=decode)
    assert got.shape == ((19, 64, 64, 3) if decode else (19, 64))
    np.testing.assert_array_equal(got, ref)
    assert reverse_process.launches - launches == 2 + 2 * 3
    assert not torch.backends.cudnn.deterministic  # the service set no global flag


def test_each_kernel_launch_falls_inside_its_launch_span(gen, tmp_path):
    """A request of three chunks under `profiling.trace`: the runtime call
    that launched each reverse-process kernel starts inside a
    `sampler.launch` span of the chrome trace (spans and device work on one
    clock), one span a launch, each a child of its chunk's span."""
    import json

    import numpy as np

    from flowerdiff_torch.utils import profiling

    svc = _service(quantize_uint8=True)
    svc.warmup()
    with profiling.trace(str(tmp_path)):
        svc.sample(np.arange(19) * 5 % 11, seed=3)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "process_kernel" in e.get("name", "")]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == "flowerdiff" and e["name"] == "sampler.launch"]
    chunks = {e["args"]["span"] for e in events
              if e.get("cat") == "flowerdiff" and e["name"] == "service.chunk"}
    assert len(kernels) == len(spans) == len(chunks) == 3
    assert {s["args"]["parent"] for s in spans} == chunks
    for k in kernels:
        ts = calls[k["args"]["correlation"]]["ts"]
        assert sum(s["ts"] <= ts <= s["ts"] + s["dur"] for s in spans) == 1


@pytest.mark.parametrize("kind", ["ancestral", "ddim"])
@pytest.mark.parametrize("quantize", [True, False])
def test_identical_requests_are_bit_equal_on_the_card(gen, kind, quantize):
    """Two identical 19-image requests (three chunks): equal bit for bit as
    uint8 and as f32 images, with no flag set by the caller."""
    import numpy as np

    svc = _service(quantize_uint8=quantize, sampler_kind=kind, ddim_steps=5)
    classes = np.arange(19) * 3 % 11
    a = svc.sample(classes, seed=8)
    b = svc.sample(classes, seed=8)
    assert a.dtype == (np.uint8 if quantize else np.float32) and a.shape == (19, 64, 64, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, svc.sample(classes, seed=9))


def test_augment_on_the_card_matches_the_cpu_with_injected_draws(gen):
    """64 images of 64 x 64: the card's rotation and jitter against the
    CPU's on the same draws, within 1e-5 (f32, values in [0, 1])."""
    from flowerdiff_torch.data import make_augment_fn

    augment = make_augment_fn(10.0, 0.2)
    x = torch.rand((64, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    draws = augment.draw(64, torch.Generator().manual_seed(2))
    ref = augment(x, draws=draws)
    got = augment(x.cuda(), draws=draws._replace(**{k: v.cuda()
                                                   for k, v in draws._asdict().items()}))
    assert got.is_cuda
    assert float((got.cpu() - ref).abs().max()) <= 1e-5
    own = augment(x.cuda(), torch.Generator(device="cuda").manual_seed(3))
    assert own.is_cuda and 0.0 <= float(own.min()) and float(own.max()) <= 1.0


def test_ddim_on_the_card_matches_the_cpu(gen):
    """The plain f32 model's DDIM (20 steps, CFG 3, clip 3) on the card
    against the CPU from one x_init, TF32 off: within 1e-3 x max|CPU|."""
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import DiffusionSampler

    tree = init_numpy_params("denoiser", seed=6, bias_std=0.2, **_SVC_DEN)
    x = torch.randn((8, 64), generator=torch.Generator().manual_seed(4))
    cls = torch.arange(8) % 11
    out = {}
    for dev in ("cpu", "cuda"):
        s = DiffusionSampler(denoiser_from_params(tree, device=dev, **_SVC_DEN),
                             linear_schedule(200), (64,), clip_x0=3.0, guidance_scale=3.0,
                             device=dev)
        out[dev] = s.ddim(8, cls, num_steps=20, x_init=x).cpu()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-3 * scale


def test_uncached_epochs_on_the_card_launch_the_train_kernel(gen):
    """make_fused_latent_epochs with epoch_encode and the bf16 train
    kernel, augmenting, at small width: one kernel launch a step, finite
    losses, and the f32 lane against the per-step form from one generator
    within 1e-4 x max|loss|."""
    from flowerdiff_torch.data import synthetic_flowers
    from flowerdiff_torch.train.fused import epoch_rows, make_fused_latent_epochs
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
    )
    from flowerdiff_torch.utils.weights import vae_from_params

    vae = vae_from_params(init_numpy_params("vae", seed=5, **_SVC_VAE), device="cuda",
                          **_SVC_VAE)
    imgs, labels = synthetic_flowers(64, 11, 64, seed=1)
    images = torch.from_numpy(imgs).cuda()
    labels = torch.from_numpy(labels).long().cuda()
    idx = torch.from_numpy(epoch_rows(2, 64, 16, 2)[0]).cuda()
    losses = {}
    for name, over in (("bf16", dict(train_kernel=True, epoch_encode=True,
                                     encode_dtype="bfloat16")),
                       ("f32", dict(train_kernel=True, epoch_encode=True,
                                    train_kernel_dtype="float32")),
                       ("per step", dict())):
        cfg = LatentDiffusionConfig(cond_dropout=0.1, n_steps=100, **_SVC_DEN, **over)
        state, model, sched = create_latent_diffusion_state(0, cfg, device="cuda")
        fn = make_fused_latent_epochs(model, vae, sched, cfg, steps_per_epoch=4)
        before = ts.kernel_loss_and_grads.launches
        losses[name] = fn(state, images, labels, None, idx,
                          torch.Generator(device="cuda").manual_seed(7)).cpu()
        launched = ts.kernel_loss_and_grads.launches - before
        assert launched == (8 if cfg.train_kernel else 0), (name, launched)
        assert torch.isfinite(losses[name]).all() and state.step == 8
    scale = float(losses["per step"].abs().max())
    assert float((losses["f32"] - losses["per step"]).abs().max()) <= 1e-4 * scale


# The VAE-GAN step: no kernel of its own (cuDNN and cuBLAS through PyTorch),
# held against itself on the CPU, for bit-reproducibility and for its bf16
# lane, at a small width (the discriminator and VGG are full width always).
_GAN = dict(channels=(16, 32, 48, 64), latent_dim=32, head_width=64, num_classes=10,
            total_steps=100)


def _gan_batches(n, b=8, seed=3, noise_seed=None):
    """Synthetic flower images, as the trainer sees them, or, with
    `noise_seed`, uniform-noise images with the same labels (where the
    centers are held relative to their size:
    test_vae_gan_centers_on_noise_are_rounding_on_the_card)."""
    from flowerdiff_torch.data import synthetic_flowers

    imgs, labels = synthetic_flowers(n * b, 10, 64, seed=seed)
    x = torch.from_numpy(imgs).float() / 255.0
    if noise_seed is not None:
        x = torch.rand(x.shape, generator=torch.Generator().manual_seed(noise_seed))
    y = torch.from_numpy(labels).long()
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


def _gan_run(device, cfg, batches, draws=None, seed=0):
    """Three steps on `device` from one seeded init; the draws given, or from
    make_vae_gan_step's generator of (seed, step)."""
    from flowerdiff_torch.models import VGGPerceptual
    from flowerdiff_torch.train import vae_gan as vg
    from flowerdiff_torch.train.schedules import vae_gan_loss_gates

    state, vae, disc = vg.create_vae_gan_state(5, cfg, device=device)
    vgg = VGGPerceptual(device=device)
    gates = vg.gates_array(vae_gan_loss_gates(200, 1200), device)
    step, body = vg.make_vae_gan_step(vae, disc, cfg, vgg), vg.make_vae_gan_step_body(
        vae, disc, cfg, vgg)
    ms = []
    for i, (x, y) in enumerate(batches):
        x, y = x.to(device), y.to(device)
        if draws is None:
            m = step(state, x, y, gates, seed)
        else:
            eps, masks = draws[i]
            masks = tuple(k.to(device) for k in masks)
            m = body(state, x, y, gates, draws=(eps.to(device), masks))
        ms.append(torch.stack([m[k] for k in vg.METRICS]))
    return torch.stack(ms).cpu(), state


# Leaves whose gradient is rounding noise in the first steps (the bias of a
# convolution that feeds a LayerNorm2d; the channel gates' kernels, whose
# input is a LayerNorm2d's bias): held to Adam's bound of 2 lr a step and a
# first moment below 1e-6; every other leaf on its own, weights rtol 5e-2 of
# the leaf's move and Adam first moments rtol 2e-2 (rms), as
# tests/test_torch_port_vae_gan.py holds the CPU against the reference.
_GAN_NOISE = re.compile(r"((stem_conv|down\d+_conv|res\d+\.conv[12])\.bias"
                        r"|\.ca\.(squeeze|excite)\.weight)$")


def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def test_vae_gan_step_on_the_card_matches_the_cpu(gen, monkeypatch):
    """Three f32 steps (TF32 off), VGG on, every gate on, the CPU's draws:
    losses rtol 1e-3, the centers within 1e-5, and each leaf of G and D,
    weights and Adam first moments, on its own (the limits of the CPU tests
    against the reference and of chip_smoke.py)."""
    from flowerdiff_torch.train import vae_gan as vg

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = vg.VAEGANConfig(**_GAN)
    batches = _gan_batches(3)
    init, cpu_vae, _ = vg.create_vae_gan_state(5, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    draws = [vg.draw_step_inputs(cpu_vae, 8, g, "cpu") for _ in range(3)]
    ref, ref_state = _gan_run("cpu", cfg, batches, draws)
    got, state = _gan_run("cuda", cfg, batches, draws)
    assert torch.allclose(got, ref, rtol=1e-3, atol=0), (got, ref)
    assert float((state.centers.cpu() - ref_state.centers).abs().max()) <= 1e-5
    bound = 2 * max(cfg.lr, cfg.d_lr) * 3
    for part in ("gen", "disc"):
        a, b, a0 = getattr(state, part), getattr(ref_state, part), getattr(init, part)
        for name, p, q, p0, m, n in zip(b.names, a.params, b.params, a0.params, a.mu, b.mu):
            p, m = p.cpu(), m.cpu()
            if _GAN_NOISE.search(name):
                assert float((p - q).abs().max()) <= bound, (part, name)
                assert max(float(m.abs().max()), float(n.abs().max())) < 1e-6, (part, name)
            else:
                assert _rms(p - q) <= 5e-2 * _rms(q - p0), (part, name)
                assert _rms(m - n) <= 2e-2 * _rms(n), (part, name)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_vae_gan_steps_are_bit_reproducible_on_the_card(gen, lane):
    """Two identical 3-step runs from one seed (draws from the derived
    generators, cuDNN's deterministic algorithms, fixed-order center sums)
    leave every state tensor and loss bit-equal."""
    from flowerdiff_torch.train import vae_gan as vg

    cfg = vg.VAEGANConfig(compute_dtype=lane, **_GAN)
    batches = _gan_batches(3)
    (m0, s0), (m1, s1) = (_gan_run("cuda", cfg, batches, seed=9) for _ in range(2))
    assert torch.equal(m0, m1)
    assert all(torch.equal(a, b) for a, b in zip(s0.tensors(), s1.tensors()))


def test_vae_gan_bf16_lane_is_finite_and_within_its_band(gen):
    """bf16 against f32 from one seed: every loss finite and within 1e-2 of
    the f32 run's (chip_smoke.py's band); parameters and moments f32."""
    from flowerdiff_torch.train import vae_gan as vg

    batches = _gan_batches(3)
    runs = {lane: _gan_run("cuda", vg.VAEGANConfig(compute_dtype=lane, **_GAN), batches, seed=9)
            for lane in ("float32", "bfloat16")}
    (f32, _), (b16, state) = runs["float32"], runs["bfloat16"]
    assert torch.isfinite(b16).all()
    assert float(((b16 - f32).abs() / f32.abs()).max()) <= 1e-2
    assert all(t.dtype == torch.float32 for t in state.tensors())


# On uniform noise the centers part from the CPU's by the encoder's rounding
# carried through Adam (src/flowerdiff_torch/tools/centers_probe.py on the
# H100, PERF.md section 7): at the first step, with equal weights, z differs
# by ~1e-6 of max|z|; Adam's first update is lr sign(g), so weights whose
# gradient lies within rounding of zero step lr either way, and from the
# second step z differs by up to 1.5e-5 of max|z|. The centers are an EMA
# (momentum 0.9, from zero) of per-class batch means of z, so |dc| / max|c|
# follows |dz| / max|z|: the worst reading was 1.3e-5 (4 noise seeds, 3
# steps each). The limit is 4e-5 of max|c|, and the flowers case keeps its
# absolute 1e-5.
_NOISE_CENTER_REL = 4e-5


@pytest.mark.parametrize("noise_seed", [0, 1, 2, 3])
def test_vae_gan_centers_on_noise_are_rounding_on_the_card(gen, monkeypatch, noise_seed):
    """Three f32 steps on uniform-noise images with the flowers' labels, the
    CPU's draws: losses rtol 1e-3 and the centers within
    _NOISE_CENTER_REL of their largest value."""
    from flowerdiff_torch.train import vae_gan as vg

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = vg.VAEGANConfig(**_GAN)
    batches = _gan_batches(3, noise_seed=noise_seed)
    _, cpu_vae, _ = vg.create_vae_gan_state(5, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    draws = [vg.draw_step_inputs(cpu_vae, 8, g, "cpu") for _ in range(3)]
    ref, ref_state = _gan_run("cpu", cfg, batches, draws)
    got, state = _gan_run("cuda", cfg, batches, draws)
    assert torch.allclose(got, ref, rtol=1e-3, atol=0), (got, ref)
    c_err = float((state.centers.cpu() - ref_state.centers).abs().max())
    assert c_err <= _NOISE_CENTER_REL * float(ref_state.centers.abs().max()), c_err


# The pixel family (no kernel of its own: cuDNN and cuBLAS through
# PyTorch), held against itself on the CPU at base 16, 32x32 images.
_PIXEL = dict(base_channels=16, time_emb_dim=32, learnable_residual=True, img_size=32,
              n_steps=100)


def test_pixel_step_on_the_card_matches_the_cpu(gen, monkeypatch):
    """Three f32 Adam steps (TF32 off) from one seeded tree with the CPU's
    draws: losses rtol 1e-5; per leaf, Adam first moments within 2e-2 of
    their rms, every weight within Adam's bound of 2 lr a step, and the
    weights of the elements whose gradient is at least 2e-2 of the leaf's
    rms within 5e-2 of the leaf's move (rms). Below that floor an element's
    rounding takes Adam's normalised step either way (chip_smoke.py's
    PIXEL_GRAD_FLOOR)."""
    from flowerdiff_torch.train import pixel_ddpm as px

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = px.PixelDiffusionConfig(**_PIXEL)
    arch = dict(base_channels=16, time_emb_dim=32, learnable_residual=True)
    tree = init_numpy_params("pixel", seed=2, **arch)
    g = torch.Generator().manual_seed(5)
    xs = [torch.rand((8, 32, 32, 3), generator=g) for _ in range(3)]
    draws = [(torch.randint(0, 100, (8,), generator=g), torch.randn((8, 32, 32, 3), generator=g))
             for _ in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        state, model, sched = px.create_pixel_diffusion_state(0, cfg, device=dev, params=tree)
        body = px.make_pixel_diffusion_step_body(model)
        losses = [body(state, sched, x.to(dev), draws=(t.to(dev), e.to(dev))).cpu()
                  for x, (t, e) in zip(xs, draws)]
        runs[dev] = (torch.stack(losses), state)
    assert torch.allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5, atol=0)
    init, _, _ = px.create_pixel_diffusion_state(0, cfg, device="cpu", params=tree)
    a, b = runs["cuda"][1], runs["cpu"][1]
    for name, p, q, p0, m, n in zip(b.names, a.params, b.params, init.params, a.mu, b.mu):
        d = p.cpu() - q
        g = n.abs() / (1 - 0.9**3)
        strong = g >= 2e-2 * _rms(g)
        assert float(d.abs().max()) <= 2 * cfg.lr * 3, name
        assert _rms(d[strong]) <= 5e-2 * _rms(q - p0), name
        assert _rms(m.cpu() - n) <= 2e-2 * _rms(n), name


@pytest.mark.parametrize("quantize", [False, True])
def test_identical_pixel_requests_are_bit_equal_on_the_card(gen, quantize):
    """PixelSamplingService (T = 100, buckets (2, 4)): two identical 5-image
    requests (chunks [4, 2]) equal bit for bit; another seed differs."""
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.serving import PixelSamplingService
    from flowerdiff_torch.utils.weights import pixel_unet_from_params

    arch = dict(base_channels=16, time_emb_dim=32, learnable_residual=True)
    model = pixel_unet_from_params(init_numpy_params("pixel", seed=3, **arch), **arch)
    svc = PixelSamplingService(model, linear_schedule(100), buckets=(2, 4), img_size=32,
                               quantize_uint8=quantize)
    a, b = svc.sample_images(5, seed=8), svc.sample_images(5, seed=8)
    assert a.dtype == (np.uint8 if quantize else np.float32) and a.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, svc.sample_images(5, seed=9))


def test_checkpoint_resume_is_bit_equal_on_the_card(gen, tmp_path):
    """The pixel state on the card: 2 steps, save, one more; a fresh state
    restored onto the card takes the same step bit for bit."""
    from flowerdiff_torch.train import pixel_ddpm as px
    from flowerdiff_torch.train.checkpoints import (
        CheckpointManager,
        state_to_tree,
        tree_into_state,
    )

    cfg = px.PixelDiffusionConfig(**_PIXEL)
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(6)).cuda()

    def fresh(seed):
        state, model, sched = px.create_pixel_diffusion_state(seed, cfg)
        return state, px.make_pixel_diffusion_step(model, sched)

    state, step = fresh(0)
    for _ in range(2):
        step(state, x, 4)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(2, state_to_tree(state))
    step(state, x, 4)
    state2, step2 = fresh(1)
    tree_into_state(state2, mgr.restore(like=state_to_tree(state2)))
    assert all(t.is_cuda for t in state2.tensors()) and state2.step == 2
    step2(state2, x, 4)
    assert state.step == state2.step == 3
    assert all(torch.equal(a, b) for a, b in zip(state.tensors(), state2.tensors()))


def test_cli_run_and_its_service_launch_the_kernels(gen, tmp_path, monkeypatch):
    """cli.main on the card with --train_kernel at the --tiny preset's
    widths (latent 32, hidden (32, 64, 32), time 32): the train-step kernel
    launches once a step; service_from_run over the run directory samples
    through the sampler's kernels, and two identical requests are
    bit-equal."""
    from flowerdiff_torch import cli
    from flowerdiff_torch.kernels.full_sampler import launch_counts
    from flowerdiff_torch.serving import service_from_run

    monkeypatch.delenv("FLOWERDIFF_PLATFORM", raising=False)
    before = ts.kernel_loss_and_grads.launches
    runner = cli.main(["--version", "flagship", "--tiny", "--dataset", "synthetic",
                       "--synthetic_size", "64", "--train_kernel", "--vae_epochs", "1",
                       "--total_epochs", "2", "--batch_size", "16", "--results_dir",
                       str(tmp_path), "--no-cadence-viz", "--no-final-sweep"])
    assert runner.device.type == "cuda"
    assert ts.kernel_loss_and_grads.launches - before == 2 * (64 // 16)

    svc = service_from_run(str(tmp_path), version="flagship", tiny=True, synthetic_size=64,
                           buckets=(8,), quantize_uint8=True)
    assert svc.use_fused and svc.sampler._inner.guidance_scale == 7.0
    svc.warmup()  # the bucket's first call binds its plan of the reverse-process kernel
    counts = launch_counts()
    a = svc.sample(np.arange(6) % 5, seed=3)
    moved = {k: launch_counts()[k] - counts[k] for k in counts}
    assert moved == dict(dict.fromkeys(moved, 0), reverse_process=1), moved
    b = svc.sample(np.arange(6) % 5, seed=3)
    assert a.dtype == np.uint8 and a.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_http_server_under_concurrent_clients_equals_serial_calls(gen):
    """8 concurrent clients (3 requests of 2 rows each, npy) and one
    concurrent /v1/animate against a tiny service on the card: every reply
    equals rows of a dispatch, each dispatch equals the service called
    directly, one call at a time, at that dispatch's seed, and the GIF equals
    `animate` called directly, bit for bit; no kernel plan is bound under
    the traffic. Before `warmup` the server refuses the service."""
    import http.client
    import io
    import json
    import threading

    from flowerdiff_torch.serving_http import serve

    svc = _service()
    assert svc.unwarmed() == [4, 8]
    with pytest.raises(RuntimeError, match="no kernel plan bound"):
        serve(svc, 31, host="127.0.0.1", port=0)  # a binding under traffic
    svc.warmup()
    assert svc.unwarmed() == []
    bound = dict(svc.sampler.process.bound)
    dispatches = []
    orig = svc.sample_async

    def spy(classes, seed=0, colors=None, decode=True, *rest, **kw):
        fetch = orig(classes, seed, colors, decode, *rest, **kw)
        entry = {"classes": np.array(classes), "seed": seed, "decode": decode}
        dispatches.append(entry)

        def recorded():
            entry["out"] = fetch()
            return entry["out"]

        return recorded

    svc.sample_async = spy
    server = serve(svc, 31, host="127.0.0.1", port=0, max_wait_ms=5.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    replies, errors = {}, []

    def client(i):
        try:
            for j in range(3):
                classes = [(3 * i + j) % 11, (5 * i + 2 * j + 1) % 11]
                replies[(i, j)] = (classes, post("/v1/sample",
                                                 {"classes": classes, "format": "npy"}))
        except Exception as exc:
            errors.append(exc)

    anim = {}
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    threads.append(threading.Thread(target=lambda: anim.update(
        reply=post("/v1/animate", {"class": 4, "seed": 9, "num_frames": 6}))))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    assert not errors and len(replies) == 24
    assert dict(svc.sampler.process.bound) == bound, "a plan was bound under traffic"
    assert not torch.backends.cudnn.deterministic, "two threads restored each other's flags"
    svc.sample_async = orig
    for entry in dispatches:  # each dispatch against the direct call
        want = svc.sample(entry["classes"], entry["seed"], decode=entry["decode"])
        np.testing.assert_array_equal(entry["out"], want)
    for classes, (status, data) in replies.values():
        assert status == 200
        got = np.load(io.BytesIO(data))
        assert any(np.array_equal(got, d["out"][o:o + 2])
                   for d in dispatches if d["decode"]
                   for o in range(len(d["classes"]) - 1)
                   if list(d["classes"][o:o + 2]) == classes), classes
    status, gif = anim["reply"]
    assert status == 200 and gif == svc.animate(4, 9, num_frames=6, label="4")
    assert server.batcher.stats["dispatches"] == sum(d["decode"] for d in dispatches)


def _small_chunks(mesh):
    """phase_parallel's three chunks at small widths on the card, from fixed
    seeds on `mesh` (None: no process group): (losses, state tensors)."""
    from flowerdiff_torch.data import DeviceDataset, synthetic_flowers
    from flowerdiff_torch.train import pixel_ddpm as px
    from flowerdiff_torch.train import vae_gan as vg
    from flowerdiff_torch.train.latent_ddpm import LatentDiffusionConfig, LatentDiffusionTrainer

    imgs, labels = synthetic_flowers(32, 10, 64, seed=3)
    dataset = DeviceDataset(imgs, labels, mesh=mesh)
    gan = vg.VAEGANTrainer(vg.VAEGANConfig(use_perceptual=False, **_GAN), seed=0)
    out = {"vae_gan": ([m["total"] for m in gan.run_epochs_fused(
        dataset, 200, 1200, 1, seed=1, batch_size=16, mesh=mesh)], gan.state.tensors())}
    arch = dict(latent_dim=32, channels=(16, 32, 48, 64), head_width=64, base_size=8)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **arch), device="cuda", **arch)
    cfg = LatentDiffusionConfig(latent_dim=32, hidden_dims=(64, 128, 64), time_emb_dim=32,
                                num_classes=10, cond_dropout=0.1, steps_per_epoch=2)
    lat = LatentDiffusionTrainer(cfg, vae, seed=4)
    out["latent"] = (lat.run_epochs_fused(dataset, 1, None,
                                          torch.Generator(device="cuda").manual_seed(5),
                                          batch_size=16, mesh=mesh), lat.state.tensors())
    pix = px.PixelDiffusionTrainer(px.PixelDiffusionConfig(base_channels=16, time_emb_dim=32,
                                                           learnable_residual=True), seed=0)
    out["pixel"] = (pix.run_epochs_fused(dataset, 1, seed=1, batch_size=16, mesh=mesh),
                    pix.state.tensors())
    return out


def test_nccl_world_size_one_is_bit_equal_to_no_group(gen, monkeypatch):
    """phase_parallel (a) at small widths: torchrun's environment for one
    rank, NCCL, the 1x1 mesh; the VAE-GAN, latent and pixel chunks leave
    every loss and state tensor bit-equal to the run with no group."""
    import socket

    import torch.distributed as dist

    from flowerdiff_torch.parallel import create_mesh, init_distributed

    torch.backends.cudnn.allow_tf32 = False
    alone = _small_chunks(None)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    try:
        assert init_distributed() == 1 and dist.get_backend() == "nccl"
        mesh = create_mesh()
        assert tuple(mesh.shape) == (1, 1)
        one = _small_chunks(mesh)
    finally:
        dist.destroy_process_group()
    for name, (losses, tensors) in alone.items():
        assert one[name][0] == losses, name
        assert all(torch.equal(a, b) for a, b in zip(one[name][1], tensors, strict=True)), name


def test_tensor_parallel_forward_on_the_card_over_gloo(gen, tmp_path):
    """phase_parallel (c) at a small width: two spawned ranks on the one
    card over gloo, the denoiser sharded at model=2, within 2e-5 of
    max|replicated|."""
    from torch_port_dist_common import card_tensor_parallel, start_ranks

    for out in start_ranks(card_tensor_parallel, 2, tmp_path).join():
        assert out["rel_err"] <= 2e-5, out
        assert out["local_block_fc_0"] == (32, 64), out


def test_native_jpeg_decoder_builds_on_this_machine(gen, tmp_path):
    """The port's ingest builds native/jpeg_loader.cpp here and decodes
    through it: every good file ok, a file that is no JPEG zero and not
    ok, within a few levels of PIL (another resampler)."""
    import shutil
    import subprocess

    from PIL import Image

    from flowerdiff_torch import native

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    probe = subprocess.run(["g++", "-x", "c++", "-E", "-"], input="#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if probe.returncode:
        pytest.skip("no libjpeg headers (jpeglib.h) on this machine: the ingest decodes "
                    "with PIL")
    assert native.native_available(), native.build_error()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        path = tmp_path / f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (90 + 10 * i, 120, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    imgs, ok = native.decode_jpeg_batch(paths + [str(tmp_path / "bad.jpg")], 32)
    assert ok.tolist() == [True] * 4 + [False] and not imgs[4].any()
    native_ok = imgs[:4].astype(np.float32)
    saved, native._load = native._load, lambda: None
    try:
        pil, _ = native.decode_jpeg_batch(paths, 32)
    finally:
        native._load = saved
    assert np.abs(native_ok - pil).mean() < 8.0


# Lopsided nets past 4096 (the wide layout of the reverse-process kernel):
# a last hidden width of 4200 under narrow stages, a v2 net whose latent and
# last width are 5120, a latent of 6000 under stages of 64; (latent, hidden,
# skip).
WIDE_CASES = [(40, (48, 48, 4200), False), (5120, (256, 512, 5120), True),
              (6000, (64, 64), False)]


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("latent,hidden,skip", WIDE_CASES)
def test_reverse_process_takes_the_wide_nets(gen, latent, hidden, skip, guided, batch):
    """At each net of WIDE_CASES, both buckets, guided and not, with noise:
    the wide layout's plan, 20 steps in one launch against the host loop
    (whose stage, head and projection kernels run their passes past 4096)
    within PROCESS_TOL, every left-out term more than twice the limit away,
    a repeat bit-equal, one launch; 5 steps against the plain twins on the
    card within the same limits."""
    from flowerdiff_torch.kernels.full_sampler import bind_latent_proj, launch_counts

    sampler = _width_sampler(latent, hidden, skip, guided, _PROCESS_STEPS)
    cls = torch.arange(batch, device="cuda") % 11
    inputs = _inputs(sampler, batch, cls, 51)
    assert sampler.process.plan_for(batch, guided).wide
    before = launch_counts()
    got = _process(sampler, inputs)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), reverse_process=1)
    ref = _host_loop(sampler, inputs)
    tol = _held(got, ref, guided)
    assert torch.equal(_process(sampler, inputs), got)
    adds = list(inputs.stage_adds)
    adds[-1] = torch.zeros_like(adds[-1])
    dropped = {"noise": _host_loop(sampler, inputs, stochastic=False),
               "the last stage's condition add": _host_loop(
                   sampler, inputs._replace(stage_adds=tuple(adds))),
               "the head's condition add": _host_loop(
                   sampler, inputs._replace(final_add=torch.zeros_like(inputs.final_add)))}
    if guided:
        dropped["CFG"] = _host_loop(sampler, inputs, guidance_scale=1.0)
        dropped["clip"] = _host_loop(sampler, inputs, clip_x0=None)
    if skip:
        wl, bl = sampler._prep["proj"].weights[:2]
        dropped["skip"] = _host_loop(sampler, inputs,
                                     prep=dict(sampler._prep, proj=bind_latent_proj(wl, bl)))
    for term, other in dropped.items():
        assert float((other - ref).abs().max()) > 2 * tol, term
    short = _width_sampler(latent, hidden, skip, guided, 5)
    inputs = _inputs(short, batch, cls, 52)
    _held(_process(short, inputs), _plain_steps(short, inputs), guided)
