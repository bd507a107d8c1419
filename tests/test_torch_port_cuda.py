"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. Run them on
a machine with an H100 with `python -m pytest tests/test_torch_port_cuda.py`.
Widths are small multiples of 8; chip_smoke.py covers the flagship shapes.
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
from flowerdiff_torch.kernels.latent_stage import (
    bind_head,
    bind_stage,
    fused_head,
    fused_head_plain,
    fused_stage,
    fused_stage_plain,
    stage_max_clusters,
)
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

pytestmark = pytest.mark.cuda

# (s, kc) of the bf16 lane's split-K product over K: clusters of s blocks,
# block r summing k in [r kc, r kc + kc). The library's plan
# (`test_splitk_plan_at_the_flagship`); test_torch_port_faults.py models the
# order of the sum with it on the CPU.
SPLITK_PLAN = {1024: (8, 128), 512: (8, 64), 256: (4, 64), 1000: (8, 128), 200: (4, 64),
               96: (2, 64), 64: (1, 64), 36: (1, 64)}


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


# Products with idle warps: (1024, 768) on clusters of 16 (16 rows; the
# whole-row kernel at 128), (512, 1536) on clusters of 8 with chunks of 128
# k's and more chunks than ring slots.
IDLE_WARP_STAGES = [(16, 1024, 768), (128, 1024, 768), (128, 512, 1536)]


@pytest.mark.parametrize("b,d,d_out", [(1, 64, 64), (13, 128, 256), (32, 256, 64)]
                         + [(b, d, o) for d, o in FLAGSHIP_STAGES for b in (1, 16, 100, 128)]
                         + IDLE_WARP_STAGES)
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


@pytest.mark.parametrize("b", [16, 100])
def test_stage_kernel_is_deterministic(gen, b):
    """No atomics: the same call twice gives the same bits."""
    args = _stage_args(gen, b, 1024, 512)
    row = _r(gen, 1024)
    run = bind_stage(*args[2:])
    assert torch.equal(run(args[0], args[1], row), run(args[0], args[1], row))


def test_stage_plan_follows_the_cards_occupancy(gen):
    """The wide stage runs on the ring's clusters of 16 up to the rows that
    one wave of them takes on this card, and on the whole-row kernel above."""
    run = bind_stage(*_stage_args(gen, 1, 1024, 512)[2:])
    ring = run.plan_for(16)
    wave = stage_max_clusters(16, ring.smem)
    assert ring.cluster == 16 and ring.slots >= 2 and wave >= 1
    assert run.plan_for(16 * wave) == ring
    assert run.plan_for(16 * wave + 1).slots == 0


@pytest.mark.parametrize("b,dl,de,lat", [(9, 64, 32, 128), (128, 256, 256, 256)])
def test_head_kernel_matches_twin(gen, b, dl, de, lat):
    """Every form of the head: with both base products, one of them, or
    none (the sampler's table form), with and without the adds. A call with
    either product runs the whole-row kernel and counts in
    fused_head.product_launches; a call with neither runs the column-tile
    kernel; both count in fused_head.launches."""
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
                         + [(3, 24, 40), (5, 200, 100), (64, 520, 256), (8, 1024, 72)])
def test_latent_proj_tiles_match_twin_and_repeat(gen, b, lat, hid, guided, with_skip):
    """The projection's 16 x 16 tiles at every batch of the step (ragged row
    tiles), and at widths with ragged column tiles (H not a multiple of 16),
    ragged k chunks (L not a multiple of 32) and two or four k chunks a warp
    (L above 256 or 512); limits as test_latent_proj_kernel_matches_twin.
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


def _head_case(gen, rows, dl, lat, de=32):
    w = dict(scale=dl ** -0.5, dtype=torch.bfloat16)
    weights = dict(wt=_r(gen, dl, de, **w), bt=_r(gen, dl, scale=0.5),
                   wc=_r(gen, dl, de, **w), bc=_r(gen, dl, scale=0.5),
                   g=1 + _r(gen, dl, scale=0.2), b=_r(gen, dl, scale=0.5),
                   wf=_r(gen, lat, dl, **w), bf=_r(gen, lat, scale=0.5))
    return _r(gen, rows, dl), _r(gen, dl), _r(gen, rows, dl, scale=0.5), weights


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("b,dl,lat", [(b, 256, 256) for b in STEP_BATCHES]
                         + [(3, 96, 40), (8, 512, 264), (64, 32, 8)])
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
    # the projection's widths: L a multiple of 8, at most 1024
    for lat in (12, 1032):
        with pytest.raises(ValueError, match="latent width"):
            bind_latent_proj(_r(gen, 16, lat, dtype=bf), _r(gen, 16))
    # the head's: d_last a multiple of 32 and at most 512, latent a multiple of 8
    for dl, lat in ((48, 64), (544, 64), (64, 12)):
        hw = _head_case(gen, 4, dl, lat)[3]
        with pytest.raises(ValueError, match="width"):
            bind_head(**{**hw, "wt": None, "bt": None, "wc": None, "bc": None})


# ---------------------------------------------------------------------------
# The train-step kernels (csrc/train_step.cuh, bound by csrc/train_step.cu)

def _bf(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rows,k,n", [(1, 32, 32), (13, 96, 40), (64, 256, 512), (67, 100, 36),
                                      (64, 1024, 1024), (64, 1024, 512), (64, 1000, 36),
                                      (64, 200, 1000)])
def test_product_three_forms_match_f32_references(gen, exact, rows, k, n):
    """Y = X W^T + b, dX = dY W, dW = dY^T X with db = colsum(dY), at odd row
    counts and ragged tiles, the flagship's widest shapes, and K that is not
    a multiple of the split or of the 64-deep tile (Y at K = 1000 or 200, dX
    at K = 36 or 40). Exact lane: f32 sums in another order, rtol 1e-5 of
    the largest value. bf16 lane: the references round the same operands to
    bf16, and the dX / dW outputs are rounded to bf16 after the whole sum
    (one bf16 ulp = 2^-8 relative, plus the summation order)."""
    x, w, b = _r(gen, rows, k), _r(gen, n, k, scale=k ** -0.5), _r(gen, n)
    dy, mul, res = _r(gen, rows, n), _r(gen, rows, n), _r(gen, rows, n)
    rnd = (lambda t: t) if exact else _bf
    tol = 1e-5 if exact else 2.0 ** -7

    def close(got, ref):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())

    close(ts.linear_forward(x, w, b, exact=exact, scale=2.0, mul=mul, res=res),
          (rnd(x) @ rnd(w).t() + 2.0 * b) * mul + res)
    res_x = _r(gen, rows, k)
    close(ts.linear_dx(dy, w, exact=exact, res=res_x), rnd(rnd(dy) @ rnd(w)) + res_x)
    dw, db = ts.linear_dw(dy, x, exact=exact, scale=2.0)
    close(dw, rnd(rnd(dy).t() @ rnd(x)))
    close(db, 2.0 * dy.sum(dim=0))


@pytest.mark.parametrize("rows,k,n", [(64, 1024, 1024), (64, 1024, 512), (64, 256, 512),
                                      (64, 256, 256), (13, 96, 40)])
def test_product_is_bit_equal_on_repeat(gen, rows, k, n):
    """Each form twice on the same inputs gives the same bits: the bf16
    lane's split-K partials are added in rank order, with no atomics."""
    x, w, b = _r(gen, rows, k), _r(gen, n, k, scale=k ** -0.5), _r(gen, n)
    dy, res = _r(gen, rows, n), _r(gen, rows, k)
    for fn in (lambda: ts.linear_forward(x, w, b, exact=False, scale=2.0),
               lambda: ts.linear_dx(dy, w, exact=False, res=res),
               lambda: ts.linear_dw(dy, x, exact=False)[0]):
        first = fn()
        torch.cuda.synchronize()
        assert torch.equal(first, fn())


def test_splitk_plan_at_the_flagship(gen):
    """K = 1024: clusters of 8 blocks of two tiles (N = 1024: 256 blocks);
    K = 512: 8 of one; K = 256: 4 of one; K = 64 would be one block; and the
    ragged K of `test_product_three_forms_match_f32_references`."""
    assert {k: ts.splitk_plan(k) for k in SPLITK_PLAN} == SPLITK_PLAN


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
    kw = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=7,
              global_skip=global_skip)
    model = denoiser_from_params(init_numpy_params("denoiser", seed=2, bias_std=0.3, **kw),
                                 device="cuda", **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_ln_" in name or "final_norm" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=gen, device="cuda"))
    rate = 0.3
    masks = []
    for d in kw["hidden_dims"][:-1]:
        mb = (torch.rand((batch, d), generator=gen, device="cuda") >= rate).float() / (1 - rate)
        ma = (torch.rand((batch, 8), generator=gen, device="cuda") >= rate).float() / (1 - rate)
        masks += [mb, ma.repeat_interleave(d // 8, dim=1)]
    abar = torch.rand((batch, 1), generator=gen, device="cuda") * 0.9 + 0.05
    data = {"z": _r(gen, batch, 64), "eps": _r(gen, batch, 64),
            "t_f": torch.randint(0, 1000, (batch, 1), generator=gen, device="cuda").float(),
            "sa": abar.sqrt(), "s1a": (1 - abar).sqrt(),
            "labels": (torch.arange(batch, device="cuda") % 5).to(torch.int32),
            "cond_mask": (torch.arange(batch, device="cuda") % 3 != 0).float()[:, None],
            "freqs": ts.sinusoid_freqs(32, "cuda")}
    return model, data, masks


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


# ---------------------------------------------------------------------------
# The epoch kernels (csrc/train_epoch.cu)

_EPOCH_NET = dict(latent_dim=64, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=7)


def _epoch_case(**cfg_over):
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
    )

    cfg = LatentDiffusionConfig(**{**_EPOCH_NET, "n_steps": 50, "steps_per_epoch": 3,
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
    from flowerdiff_torch.kernels import train_epoch as te

    steps, batch = 3, 9
    z = _r(gen, steps, batch, 64)
    labels = torch.randint(0, 7, (steps, batch), generator=gen, device="cuda")
    runs = []
    for kind in ("kernel", "twin", "kernel"):
        cfg, state, model, sched = _epoch_case(weight_decay=0.5, ema_decay=0.9, t0=1)
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
# The reverse process as one CUDA graph (kernels/full_sampler.SamplerGraph)

_GRAPH_NET = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                  num_classes=102, shared_cond_proj=True)
_GRAPH_STEPS = 20


def _graph_sampler(global_skip, guided, steps=_GRAPH_STEPS):
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import FusedDiffusionSampler

    kw = dict(_GRAPH_NET, global_skip=global_skip)
    model = denoiser_from_params(init_numpy_params("denoiser", seed=3, bias_std=0.3, **kw),
                                 device="cuda", **kw)
    return FusedDiffusionSampler(model, linear_schedule(steps), (256,), clip_x0=3.0,
                                 guidance_scale=7.0 if guided else None, device="cuda")


def _host_loop(sampler, batch, cls, seed, x_init=None, stochastic=True):
    from flowerdiff_torch.kernels.full_sampler import fused_sample

    return fused_sample(sampler._prep, batch, cls,
                        generator=torch.Generator(device="cuda").manual_seed(seed),
                        x_init=x_init, stochastic=stochastic, clip_x0=sampler.clip_x0,
                        guidance_scale=sampler.guidance_scale)


def _replay(sampler, batch, cls, seed, x_init=None, stochastic=True):
    return sampler.sample(batch, cls, generator=torch.Generator(device="cuda").manual_seed(seed),
                          x_init=x_init, stochastic=stochastic)


# (stage rows, guided, v2 global skip, step noise)
@pytest.mark.parametrize("rows,guided,global_skip,stochastic",
                         [(16, True, False, True), (128, True, True, False),
                          (16, False, True, True), (128, False, False, False)])
def test_graph_replay_is_bit_equal_to_the_host_loop(gen, rows, guided, global_skip,
                                                    stochastic):
    """20 steps through the captured graph and through `fused_sample`'s host
    loop, the same x_init and key: the same kernels in the same order give
    the same bits. The counters: the first call counts its eager run and its
    replay, the capture nothing; a replay adds what its graph captured."""
    from flowerdiff_torch.kernels.full_sampler import launch_counts

    sampler = _graph_sampler(global_skip, guided)
    batch = rows // 2 if guided else rows
    cls = torch.arange(batch, device="cuda") % 102
    x0 = None if stochastic else _r(gen, batch, 256)
    before = launch_counts()
    got = _replay(sampler, batch, cls, 11, x0, stochastic)
    (graph,) = sampler.graphs.values()
    step = {"latent_proj": 1, "fused_stage": 4, "fused_head": 1, "fused_head_products": 0,
            "reverse_step": 1}
    assert graph.captured == {k: _GRAPH_STEPS * v for k, v in step.items()}
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * _GRAPH_STEPS * v for k, v in step.items()}
    ref = _host_loop(sampler, batch, cls, 11, x0, stochastic)
    assert got.shape == (batch, 256) and torch.isfinite(got).all()
    assert torch.equal(got, ref)
    before = launch_counts()
    again = _replay(sampler, batch, cls, 11, x0, stochastic)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == graph.captured
    assert torch.equal(again, ref) and graph.replays == 2 and len(sampler.graphs) == 1


def test_graph_carries_each_request(gen):
    """Two requests through one captured graph (other classes, x_init and
    key): each equals its own host-loop result."""
    sampler = _graph_sampler(False, True)
    cls_a = torch.arange(8, device="cuda") % 102
    cls_b = (torch.arange(8, device="cuda") * 13 + 5) % 102
    x_c = _r(gen, 8, 256)
    a = _replay(sampler, 8, cls_a, 21)
    b = _replay(sampler, 8, cls_b, 22)
    c = _replay(sampler, 8, cls_b, 23, x_init=x_c)
    assert len(sampler.graphs) == 1
    assert torch.equal(a, _host_loop(sampler, 8, cls_a, 21))
    assert torch.equal(b, _host_loop(sampler, 8, cls_b, 22))
    assert torch.equal(c, _host_loop(sampler, 8, cls_b, 23, x_init=x_c))
    assert not torch.equal(a, b) and not torch.equal(b, c)


def test_graph_buckets_replay_independently(gen):
    """Bucket A, then B, then A: A's second result equals its first, and the
    tensor A's first call returned is not rewritten by later replays."""
    sampler = _graph_sampler(False, True)
    cls_a = torch.arange(8, device="cuda") % 102
    cls_b = torch.arange(64, device="cuda") % 102
    a1 = _replay(sampler, 8, cls_a, 31)
    kept = a1.clone()
    b = _replay(sampler, 64, cls_b, 32)
    a2 = _replay(sampler, 8, cls_a, 31)
    assert len(sampler.graphs) == 2
    assert torch.equal(a1, kept) and torch.equal(a2, kept)
    assert torch.equal(b, _host_loop(sampler, 64, cls_b, 32))


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
    for bit (each chunk one replay of its bucket's graph), the decoded
    images included: the service decodes under cuDNN's deterministic
    algorithms itself."""
    import numpy as np

    svc = _service(quantize_uint8=True)
    assert svc.use_fused
    classes = np.arange(19) * 5 % 11
    assert svc.request_plan(19) == [8, 8, 4]
    svc.warmup()
    assert sorted(k[0] for k in svc.sampler.graphs) == [4, 8]
    got = svc.sample_async(classes, seed=3, decode=decode)()
    ref = svc.sample(classes, seed=3, decode=decode)
    assert got.shape == ((19, 64, 64, 3) if decode else (19, 64))
    np.testing.assert_array_equal(got, ref)
    assert sum(g.replays for g in svc.sampler.graphs.values()) == 2 + 2 * 3
    assert not torch.backends.cudnn.deterministic  # the service set no global flag


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


def _small_preset(tiny_preset):
    """configs.tiny_preset at widths the kernels take: latent 64, hidden
    (64, 128, 64), time 64 (the stage kernel needs multiples of 64)."""
    import dataclasses

    def small(preset):
        preset = tiny_preset(preset)
        if preset.latent is None:
            return preset
        return dataclasses.replace(
            preset, vae=dataclasses.replace(preset.vae, latent_dim=64),
            latent=dataclasses.replace(preset.latent, latent_dim=64, hidden_dims=(64, 128, 64),
                                       time_emb_dim=64))

    return small


def test_cli_run_and_its_service_launch_the_kernels(gen, tmp_path, monkeypatch):
    """cli.main on the card with --train_kernel at a small width: the
    train-step kernel launches once a step; service_from_run over the run
    directory samples through the sampler's kernels, and two identical
    requests are bit-equal."""
    from flowerdiff_torch import cli, configs
    from flowerdiff_torch.kernels.full_sampler import launch_counts
    from flowerdiff_torch.serving import service_from_run

    monkeypatch.delenv("FLOWERDIFF_PLATFORM", raising=False)
    monkeypatch.setattr(configs, "tiny_preset", _small_preset(configs.tiny_preset))
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
    svc.warmup()  # the bucket's first call runs eagerly, then captures its graph
    counts = launch_counts()
    a = svc.sample(np.arange(6) % 5, seed=3)
    moved = {k: launch_counts()[k] - counts[k] for k in counts}
    steps = svc.sched.n_steps
    assert moved["fused_stage"] == 2 * steps and moved["reverse_step"] == steps, moved
    assert moved["latent_proj"] == steps and moved["fused_head"] == steps, moved
    b = svc.sample(np.arange(6) % 5, seed=3)
    assert a.dtype == np.uint8 and a.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_http_server_under_concurrent_clients_equals_serial_calls(gen):
    """8 concurrent clients (3 requests of 2 rows each, npy) and one
    concurrent /v1/animate against a tiny service on the card: every reply
    equals rows of a dispatch, each dispatch equals the service called
    directly, one call at a time, at that dispatch's seed, and the GIF equals
    `animate` called directly, bit for bit; no graph is captured under the
    traffic. This holds only if the service's lock keeps the threads from
    interleaving a graph's input copies and its replay. Before `warmup` the
    server refuses the service."""
    import http.client
    import io
    import json
    import threading

    from flowerdiff_torch.serving_http import serve

    svc = _service()
    assert svc.unwarmed() == [4, 8]
    with pytest.raises(RuntimeError, match="no CUDA graph captured"):
        serve(svc, 31, host="127.0.0.1", port=0)  # a capture under traffic
    svc.warmup()
    assert svc.unwarmed() == []
    graphs = dict(svc.sampler.graphs)
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
    assert dict(svc.sampler.graphs) == graphs, "a graph was captured under traffic"
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
