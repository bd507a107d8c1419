"""Fused latent-denoiser stage and head: CUDA kernels with plain twins.

Replaces the Pallas kernels `_stage_kernel` and `_head_kernel` of
flowerdiff/kernels/latent_stage.py (csrc/latent_stage.cu, and for the
sampler's form of the head csrc/latent_head.cu). One stage at
inference, where attention over one key is out(v(x)):

    h   = h + row_add + tc
    h   = h + swish(LN1(h @ Wb + bb))
    h   = h + (LN2(h) @ Wv + bv) @ Wo + bo
    out = h @ Wd + bd

and the head: out = LN(h + row_add + rows_add + t_base @ Wt + bt
+ c_base @ Wc + bc) @ Wf + bf. Matmul operands are bf16, accumulation f32;
weights are bf16 in PyTorch's Linear layout (out, in), everything else f32.

Bound on the card: weight bytes (see the note in csrc/latent_stage.cu).
LayerNorm needs whole rows: a stage launch is clusters of blocks that each
hold some rows (`stage_plan`: clusters along the rows, column slices a
cluster), each block owning a column slice of its cluster's rows and of
every product's output. The products run on `wgmma` with the weight as the
A operand, fed by TMA through 3-D tensor maps that `bind_stage` encodes once
(Linear's (out, in) layout is K-major as it is) into a ring of
shared-memory slots, one box of up to 32 KB a chunk. The blocks of a
cluster exchange LayerNorm statistics and operand slices through
distributed shared memory, stores that complete on the receiver's
mbarrier. The head has
two kernels, chosen by form at each call: with no t_base or c_base (the
sampler's step, whose time and condition adds come from tables) a block
owns 16 rows and 16 output columns and computes its rows' LayerNorm itself
(csrc/latent_head.cu); with either product, which must be added to whole
rows before the LayerNorm, a block owns 16 whole rows and all the columns
(csrc/latent_stage.cu::head_kernel, the rows in device memory).
`stage_plan` makes a stage launch's plan on the host: `bind_stage` makes
those of the row counts up to 128 once.

`bind_stage` / `bind_head` fix a kernel's weights (checked once, and padded
with zeros to the widths the kernels tile: `padded`, `stage_widths`) and
return the per-call launcher, which reads the activations at their own
widths. A stage's input width d runs up to MAX_D = 4096 (past the ~3852 the
JAX kernel's 100 MiB of VMEM holds at T = 1000: three d x d weights), its
output width and every width of the head up to MAX_WIDTH = 2**22 (Wd's
rows in column passes past a block's slice; the head's K in passes). For
CPU weights they return the plain twin
(`fused_stage_plain` / `fused_head_plain`, same arithmetic in PyTorch ops).
`fused_stage` / `fused_head` are one-off calls through them. Each kernel
launch adds one to `fused_stage.launches` / `fused_head.launches`; a launch
of the head's product form also adds one to `fused_head.product_launches`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from flowerdiff_torch.kernels import _build

LN_EPS = 1e-6  # the model's (flax) LayerNorm epsilon


def _mm(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: bf16(a) @ w.T + b, w (out, in)."""
    return a.to(torch.bfloat16).float() @ w.float().t() + b


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def fused_stage_plain(h, tc, wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd,
                      *, row_add=None, eps: float = LN_EPS):
    if row_add is not None:
        h = h + row_add
    if tc is not None:
        h = h + tc
    u = _ln(_mm(h, wb, bb), g1, b1, eps)
    h = h + u * torch.sigmoid(u)
    v = _mm(_ln(h, g2, b2, eps), wv, bv)
    h = h + _mm(v, wo, bo)
    return _mm(h, wd, bd)


def fused_head_plain(h, t_base, c_base, wt, bt, wc, bc, g, b, wf, bf,
                     *, row_add=None, rows_add=None, eps: float = LN_EPS):
    if row_add is not None:
        h = h + row_add
    if rows_add is not None:
        h = h + rows_add
    if t_base is not None:
        h = h + _mm(t_base, wt, bt)
    if c_base is not None:
        h = h + _mm(c_base, wc, bc)
    return _mm(_ln(h, g, b, eps), wf, bf)


# ---------------------------------------------------------------------------
# CUDA launch

def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(name: str, x: Optional[torch.Tensor], shape, dtype, device,
           aligned: bool = True) -> None:
    """Raise unless x is None or matches: device, dtype, shape, contiguous,
    16-byte aligned (with `aligned`; else 4-byte)."""
    if x is None:
        return
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % (16 if aligned else 4):  # float4 / 16-byte vectors where aligned
        raise ValueError(f"{name} must start on a {16 if aligned else 4}-byte boundary")


def _check_max(name: str, n: int, most: int) -> None:
    if n > most:
        raise ValueError(f"{name} width {n} is above the kernel's {most}")


_F32, _BF16 = torch.float32, torch.bfloat16


# The stage kernel's launch plan (csrc/latent_stage.cu::stage_kernel). A
# block's shared memory holds the weight ring (slots of one chunk: a TMA box
# of kb k64 tiles of its slice's rows, up to 32 KB), the operand buffers
# (its rows x d bf16), both LayerNorms' statistics (cols x rows float2), the
# row sums, (mean, rstd) a row, the slices of the biases and LayerNorm
# affines, both warpgroups' partial sums and the mbarriers, after up to 1 KB
# that aligns the ring to 1024 bytes for the 128-byte swizzle.
SMEM_LIMIT = 232_448   # bytes of shared memory a block may have on the H100
MAX_CLUSTER = 16       # non-portable cluster size
MAX_SLOTS = 32
MAX_D = 4096           # the widest d (padded): 16 column slices of MAX_SLICE
MAX_WIDTH = 1 << 22    # a stage's d_out, the head's widths
MAX_SLICE = 256        # columns a block computes of one product: a TMA box's lines
ROW_CHOICES = (8, 16, 32, 64, 128)  # rows a block: N of its warpgroups' products
TILE_BYTES, CHUNK_BYTES, BARRIERS = 8192, 32768, 8
# At most this many blocks a launch up to 128 rows: one wave on the H100,
# whose 132 SMs run 7 clusters of 16 such blocks at once (PERF_ARCHIVE.md).
WAVE_BLOCKS = 64
# The cost model's rates, measured on the H100 (PERF.md section 6): a block's
# TMA requests run one after another at REQUEST_US each plus their bytes at
# REQUEST_BYTES_PER_S (tools/ingress_probe.py); a column slice's operand
# comes in over distributed shared memory at DSMEM_BYTES_PER_S, each
# exchange after EXCHANGE_US (tools/stage_phases.py); a wgmma of a block's
# few rows costs WGMMA_US, whatever its N (tools/stage_ab.py --sweep). The
# model only ranks plans: it leaves out the launch's fixed phases.
REQUEST_US, REQUEST_BYTES_PER_S = 0.37, 330e9
DSMEM_BYTES_PER_S, EXCHANGE_US = 20e9, 1.0
WGMMA_US = 0.065


class StagePlan(NamedTuple):
    tiles: int    # clusters along the rows
    cols: int     # blocks of a cluster: each computes 1 / cols of each product's columns
    rows: int     # rows a block, one of ROW_CHOICES
    qbufs: int    # operand buffers: 2, or 1 rewritten after every reader's release
    slots: int    # slots of the weight ring
    smem: int     # dynamic shared memory of a block, bytes


def _units(rows: int) -> int:
    """m64 tiles a block's slice may have at `rows` rows (64 accumulators a
    thread, rows / 2 a tile)."""
    return 1 if rows == 128 else 2 if rows == 64 else 4


def chunk_tiles(slice_: int, d: int) -> int:
    """k64 tiles of a weight chunk (one TMA box) for a column slice of
    `slice_` rows: the most, a power of two dividing d / 64, within
    CHUNK_BYTES. Mirrors csrc/latent_stage.cu::chunk_tiles."""
    kb = 1
    while 2 * kb * slice_ * 128 <= CHUNK_BYTES and (d // 64) % (2 * kb) == 0:
        kb *= 2
    return kb


def stage_pass(so: int, rows: int) -> int:
    """Wd's rows a pass of a block whose slice of Wd is `so` rows at `rows`
    rows: the slice, or the m64 tiles its accumulators hold where the slice
    is wider (the wide instances, csrc/latent_stage.cu::StageLayout)."""
    return min(so, 64 * _units(rows))


def _stage_smem(d: int, dout: int, cols: int, rows: int, qbufs: int, slots: int) -> int:
    """Mirrors csrc/latent_stage.cu::StageLayout, plus the alignment."""
    sd, pw = d // cols, stage_pass(dout // cols, rows)
    kbd, kbo = chunk_tiles(sd, d), chunk_tiles(pw, d)
    slot = max(kbd * sd, kbo * pw) * 128
    ring = slots * slot
    vec = -(-(7 * sd + pw) * 4 // 16) * 16  # the slices of the biases and LN affines
    part = 2 * 128 * -(-max(sd, pw) // 64) * rows // 2 * 4  # both warpgroups' partial sums
    red = 2 * 2 * 4 * rows * 4  # row sums: [pass][warpgroup][warp][row]
    total = ring + qbufs * rows * d * 2 + 2 * cols * rows * 8 + red + rows * 8 + vec \
        + part + (2 * slots + BARRIERS) * 8
    reach = max((kb - 1) * n * 128 + -(-n // 64) * TILE_BYTES for n, kb in ((sd, kbd), (pw, kbo)))
    return 1024 + total + max(0, reach - slot - (total - ring))


def stage_cost_us(d: int, dout: int, plan: StagePlan) -> float:
    """The plan's cost model, us a launch: a block's weight requests
    (REQUEST_US each plus their bytes) or its wgmmas, whichever is longer,
    plus its exchanges: four operands from the other blocks of its
    cluster over distributed shared memory, two LayerNorms' statistics, and
    with one operand buffer two releases. Wd's passes each cost a product."""
    sd, so = d // plan.cols, dout // plan.cols
    pw = stage_pass(so, plan.rows)
    weights = mma = 0.0
    for n, products in ((sd, 3), (pw, -(-so // pw))):
        kb = chunk_tiles(n, d)
        chunks = products * d // 64 // kb
        weights += chunks * (REQUEST_US + kb * n * 128 / REQUEST_BYTES_PER_S * 1e6)
        # each warpgroup issues half of the slice's m64 tiles x d / 16 wgmmas
        mma += products * -(-n // 64) * d // 32 * WGMMA_US
    operand = plan.rows * d * 2 * (plan.cols - 1) / plan.cols
    exchanges = (4 * (EXCHANGE_US + operand / DSMEM_BYTES_PER_S * 1e6)
                 + (2 + 2 * (plan.qbufs == 1)) * EXCHANGE_US)
    return max(weights, mma) + exchanges


def padded(x: torch.Tensor, shape) -> torch.Tensor:
    """x (1-D or 2-D) with zeros appended up to `shape`, contiguous: x
    itself where it has that shape. The kernels tile with padded widths;
    padded weights, biases and LayerNorm affines keep the padded columns
    of every activation exactly 0."""
    if tuple(x.shape) == tuple(shape):
        return x
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def stage_widths(d: int, dout: int):
    """The widths (d, d_out) the stage kernel tiles a stage of widths d ->
    dout with: d up to a multiple of 64 (its k64 tiles), d_out up to a
    multiple of 8 where every row count has a plan, else of 64, else of
    128 (and d too, where a width above 2048 needs 16 slices of whole
    8-column units). The flagship's widths are their own. ValueError past
    MAX_D (d) or MAX_WIDTH (d_out)."""
    if not 1 <= d <= MAX_D or not 1 <= dout <= MAX_WIDTH:
        raise ValueError(f"stage {d} -> {dout}: the kernel takes d 1 to {MAX_D} and d_out 1 "
                         f"to {MAX_WIDTH}")
    for unit in (64, 128):  # above 2048, whole 8-column units a slice of 16 need 128
        dk = _up(d, unit)
        for dok in (_up(dout, 8), _up(dout, 64), _up(dout, 128)):
            if all(stage_plans(dk, dok, rows) for rows in ROW_CHOICES):
                return dk, dok
    raise ValueError(f"stage {d} -> {dout}: no plan of the kernel takes it")


def stage_plan(d: int, dout: int, rows: int = 16) -> StagePlan:
    """The stage kernel's launch plan for the kernel's widths d -> dout
    (`stage_widths` of the stage's own) at `rows` rows, or ValueError.

    Geometry: `tiles` clusters along the rows, each of `cols` blocks (at most
    16) that share `rows` rows (one of ROW_CHOICES). Column slice c computes
    columns [c sd, (c + 1) sd) of the d-wide products (sd = d / cols) and
    [c so, (c + 1) so) of the last (so = dout / cols): multiples of 8 (an
    exchange moves 16-byte units), at most 256 (a TMA box's lines), and at
    most _units(rows) m64 tiles; where no split keeps Wd's slice to that,
    Wd runs in passes of `stage_pass` rows. Up to 128 rows a launch takes at most
    WAVE_BLOCKS blocks where any plan fits them (a stage wider than 2048
    fits none at 128 rows); above, the 128-row plan repeats over more
    clusters.

    Shared memory (bytes, csrc/latent_stage.cu::StageLayout): slots x a
    chunk (kb x slice x 128, kb = chunk_tiles: up to 32 KB) of ring +
    qbufs x rows x d x 2 of operands + fixed parts; two operand buffers
    where two slots still fit beside them, else one. The flagship's widest
    stage shows the limits: 128 rows of a 1024-wide bf16 operand (256 KB)
    do not fit a block's 227 KB, 64 rows (128 KB) fit beside at most three
    32 KB slots.

    Among the geometries that fit, the least `stage_cost_us`, then the most
    column slices. Each cluster reads every weight byte once; one cluster
    holding all the rows, or row groups of one cluster sharing each chunk
    by TMA multicast, measured slower than more clusters of fewer rows at
    every row count the sampler launches: a block's TMA requests run one
    after another, its operand exchanges grow with its rows, and its wgmma
    count with its slice (PERF.md section 6)."""
    if d <= 0 or d % 64:
        raise ValueError(f"d width {d} must be a positive multiple of 64")
    if dout <= 0 or dout % 8:
        raise ValueError(f"d_out width {dout} must be a positive multiple of 8")
    _check_max("d", d, MAX_D)
    _check_max("d_out", dout, MAX_WIDTH)
    if rows < 1:
        raise ValueError(f"rows {rows} must be positive")
    if rows > ROW_CHOICES[-1]:
        plan = stage_plan(d, dout, ROW_CHOICES[-1])
        return plan._replace(tiles=-(-rows // plan.rows))
    plans = stage_plans(d, dout, rows)
    if not plans:
        raise ValueError(f"stage {d} -> {dout}: no cluster of at most {MAX_CLUSTER} blocks "
                         f"splits it into column slices the kernel takes")
    return min(plans, key=lambda plan: (stage_cost_us(d, dout, plan), -plan.cols))


def stage_plans(d: int, dout: int, rows: int):
    """Every plan the kernel takes for widths d -> dout at `rows` (at most
    128) rows: each column split with each row count a block (at most as
    many as the rows need), the most ring slots that fit, two operand
    buffers where two slots still fit beside them; within WAVE_BLOCKS blocks
    where any plan is. Where no split keeps Wd's slice within a block's m64
    tiles, the plans whose Wd runs in passes (`stage_pass`)."""
    return _stage_plans(d, dout, rows, False) or _stage_plans(d, dout, rows, True)


def _stage_plans(d: int, dout: int, rows: int, passes: bool):
    plans, waves = [], []
    most = next((r for r in ROW_CHOICES if r >= rows), ROW_CHOICES[-1])
    for cols in range(1, MAX_CLUSTER + 1):
        if d % cols or dout % cols:
            continue
        sd, so = d // cols, dout // cols
        if sd % 8 or so % 8 or sd > MAX_SLICE or (so > MAX_SLICE and not passes):
            continue
        for rb in ROW_CHOICES:
            tiles = -(-rows // rb)
            if rb > most or -(-sd // 64) > _units(rb):
                continue
            pw = stage_pass(so, rb)
            if (pw < so) != passes:  # Wd in passes only where the slice needs them
                continue
            kbd, kbo = chunk_tiles(sd, d), chunk_tiles(pw, d)
            slot = max(kbd * sd, kbo * pw) * 128
            for qbufs in (2, 1):
                fixed = _stage_smem(d, dout, cols, rb, qbufs, 0)
                slots = min(MAX_SLOTS, 3 * d // 64 // kbd + -(-so // pw) * d // 64 // kbo,
                            (SMEM_LIMIT - fixed) // slot)
                while slots >= 2 and _stage_smem(d, dout, cols, rb, qbufs, slots) > SMEM_LIMIT:
                    slots -= 1
                if slots >= 2:
                    plan = StagePlan(tiles, cols, rb, qbufs, slots,
                                     _stage_smem(d, dout, cols, rb, qbufs, slots))
                    (waves if tiles > 1 and tiles * cols > WAVE_BLOCKS else plans).append(plan)
                    break
    # more than a wave of blocks only where no plan keeps to one (a stage
    # wider than 2048 at 128 rows)
    return plans or waves


MAP_BYTES = 128  # a CUtensorMap


def stage_map_encodes() -> int:
    """Calls of cuTensorMapEncodeTiled by the loaded stage library so far:
    `bind_stage` encodes a stage's maps, a launch none."""
    fn = _build.load("latent_stage").fd_stage_map_encodes
    fn.restype = ctypes.c_longlong
    return fn()


def _fn(symbol: str, n_ptr: int, n_int: int, lib: str = "latent_stage"):
    fn = getattr(_build.load(lib), symbol)
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pad_stage(d: int, dout: int, weights):
    """A stage's twelve operands (`bind_stage`'s order) padded with zeros
    to the kernel's widths (dk, dok) = `stage_widths(d, dout)`: each tensor
    itself where it needs no padding."""
    dk, dok = stage_widths(d, dout)
    shapes = [(dk, dk), (dk,), (dk,), (dk,), (dk,), (dk,), (dk, dk), (dk,), (dk, dk), (dk,),
              (dok, dk), (dok,)]
    return [padded(w, shape) for w, shape in zip(weights, shapes)]


def bind_stage(wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd, *,
               eps: float = LN_EPS):
    """`fused_stage` with its weights fixed: returns run(h, tc=None,
    row_add=None). CUDA weights are checked here, once, padded to the
    kernel's widths (`pad_stage`: any d up to MAX_D, d_out up to
    MAX_WIDTH), the plans of the row counts up to 128 made and the tensor
    maps of their column slices (and Wd's passes) encoded (`run.maps`, held
    by `run`), so a call checks only its
    activations and encodes nothing (a CUDA graph's capture stays valid).
    For CPU weights `run` is the plain twin."""
    weights = (wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd)
    if not wb.is_cuda:
        def plain(h, tc=None, row_add=None):
            return fused_stage_plain(h, tc, *weights, row_add=row_add, eps=eps)
        plain.weights = weights
        return plain
    dev = wb.device
    width, width_out = wb.shape[1], wd.shape[0]
    for name, w in (("wb", wb), ("wv", wv), ("wo", wo)):
        _check(name, w, (width, width), _BF16, dev)
    _check("wd", wd, (width_out, width), _BF16, dev)
    for name, v in (("bb", bb), ("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2),
                    ("bv", bv), ("bo", bo)):
        _check(name, v, (width,), _F32, dev)
    _check("bd", bd, (width_out,), _F32, dev)
    wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd = pad_stage(width, width_out, weights)
    d, dout = wb.shape[1], wd.shape[0]
    plans = {rows: stage_plan(d, dout, rows) for rows in ROW_CHOICES}
    encode = _build.load("latent_stage").fd_stage_maps
    encode.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    encode.restype = ctypes.c_int
    maps, buffers = {}, []

    def map_key(plan: StagePlan):  # a plan's column split, and Wd's rows a box
        return plan.cols, stage_pass(dout // plan.cols, plan.rows)

    def encode_maps(key) -> None:
        buf = ctypes.create_string_buffer(4 * MAP_BYTES + 64)
        at = -(-ctypes.addressof(buf) // 64) * 64  # a CUtensorMap is 64-byte aligned
        _build.check(encode(wb.data_ptr(), wv.data_ptr(), wo.data_ptr(), wd.data_ptr(),
                            d, dout, *key, at), "the stage's tensor maps")
        maps[key] = at
        buffers.append(buf)
    for key in sorted({map_key(plan) for plan in plans.values()}):
        encode_maps(key)
    vecs = [v.data_ptr() for v in (bb, g1, b1, g2, b2, bv, bo, bd)]
    chosen = {}

    def plan_for(rows: int) -> StagePlan:
        plan = chosen.get(rows)
        if plan is None:
            base = plans[next((r for r in ROW_CHOICES if r >= rows), ROW_CHOICES[-1])]
            plan = chosen[rows] = (base if rows <= ROW_CHOICES[-1] else stage_plan(d, dout, rows))
        return plan
    fn = _fn("fd_stage_launch", 13, 11)

    def run(h, tc=None, row_add=None, plan=None):
        """`plan`: one of `stage_plans(*run.widths, rows)` in place of
        the bound one (a comparison's; its maps are encoded at its first
        call where its column slices are new)."""
        bsz = h.shape[0]
        # 4-byte aligned only where the width is ragged (the kernel reads it a float at a time)
        _check("h", h, (bsz, width), _F32, dev, width == d)
        _check("tc", tc, (bsz, width), _F32, dev, width == d)
        _check("row_add", row_add, (width,), _F32, dev, width == d)
        out = torch.empty((bsz, width_out), dtype=_F32, device=dev)
        if plan is None:
            plan = plan_for(bsz)
        elif map_key(plan) not in maps:
            encode_maps(map_key(plan))
        code = fn(maps[map_key(plan)], h.data_ptr(), _ptr(row_add), _ptr(tc), *vecs, out.data_ptr(),
                  bsz, d, dout, width, width_out, *plan, float(eps), _stream(dev))
        _build.check(code, "fused_stage")
        fused_stage.launches += 1
        return out

    run.weights = weights  # the stage's own, unpadded
    run.padded = (wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd)  # behind the maps and pointers
    run.widths = (d, dout)
    run.maps = buffers
    run.plan_for = plan_for
    return run


def fused_stage(h, tc, wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd,
                *, row_add=None, eps: float = LN_EPS):
    """One denoiser stage. h, tc: (B, d) f32 (tc may be None); row_add: an
    optional (d,) f32 row added to every row (the sampler's time add);
    W*: (d, d) bf16, Wd: (d_out, d) bf16, all (out, in); biases and LN
    affines f32. A one-off `bind_stage(...)(h, tc, row_add)`."""
    return bind_stage(wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd,
                      eps=eps)(h, tc, row_add)


fused_stage.launches = 0


def bind_head(wt, bt, wc, bc, g, b, wf, bf, *, eps: float = LN_EPS):
    """`fused_head` with its weights fixed: returns run(h, t_base=None,
    c_base=None, row_add=None, rows_add=None); wt/bt and wc/bc may be None
    when the calls pass no t_base or c_base. Weights are checked once, as in
    `bind_stage`, and padded with zeros (d_last and d_emb to multiples of
    32, the latent to one of 8): any width up to MAX_WIDTH. A call with
    neither base runs the column-tile kernel (csrc/latent_head.cu), a call
    with either the whole-row kernel (csrc/latent_stage.cu::head_kernel, its
    rows in device memory of the call's own). For CPU weights `run` is the
    plain twin."""
    if not wf.is_cuda:
        def plain(h, t_base=None, c_base=None, row_add=None, rows_add=None):
            return fused_head_plain(h, t_base, c_base, wt, bt, wc, bc, g, b, wf, bf,
                                    row_add=row_add, rows_add=rows_add, eps=eps)
        plain.weights = (wt, bt, wc, bc, g, b, wf, bf)
        return plain
    dev = wf.device
    latent, dl = wf.shape
    de = next((w.shape[1] for w in (wt, wc) if w is not None), dl)
    for name, n in (("d_last", dl), ("d_emb", de), ("latent", latent)):
        _check_max(name, n, MAX_WIDTH)
    for w, bias, tag in ((wt, bt, "t"), (wc, bc, "c")):
        if w is not None:
            _check(f"w{tag}", w, (dl, de), _BF16, dev)
            _check(f"b{tag}", bias, (dl,), _F32, dev)
    _check("g", g, (dl,), _F32, dev)
    _check("b", b, (dl,), _F32, dev)
    _check("wf", wf, (latent, dl), _BF16, dev)
    _check("bf", bf, (latent,), _F32, dev)
    weights = (wt, bt, wc, bc, g, b, wf, bf)
    # padded with zeros: d_last and d_emb to whole 32-wide k chunks, the
    # latent to whole n8 tiles of the products
    dlp, dep, latp = _up(dl, 32), _up(de, 32), _up(latent, 8)
    shapes = [(dlp, dep), (dlp,), (dlp, dep), (dlp,), (dlp,), (dlp,), (latp, dlp), (latp,)]
    pads = [None if w is None else padded(w, shape) for w, shape in zip(weights, shapes)]
    ptrs = [_ptr(w) for w in pads]
    aligned = dl % 32 == 0  # else the kernels read the rows a float at a time
    fn_rows = _fn("fd_head_launch", 15, 4)
    fn_cols = _fn("fd_head_cols_launch", 8, 4, lib="latent_head")

    def run(h, t_base=None, c_base=None, row_add=None, rows_add=None):
        bsz = h.shape[0]
        _check("h", h, (bsz, dl), _F32, dev, aligned)
        _check("row_add", row_add, (dl,), _F32, dev, aligned)
        _check("rows_add", rows_add, (bsz, dl), _F32, dev, aligned)
        for base, w, tag in ((t_base, wt, "t"), (c_base, wc, "c")):
            if base is not None and w is None:
                raise ValueError(f"{tag}_base given but no w{tag} bound")
            _check(f"{tag}_base", base, (bsz, de), _F32, dev, False)
        use_t, use_c = t_base is not None, c_base is not None
        out = torch.empty((bsz, latent), dtype=_F32, device=dev)
        if use_t or use_c:
            rows = torch.empty((_up(bsz, 16), dlp), dtype=_F32, device=dev)  # pre-LN, 16 a block
            code = fn_rows(h.data_ptr(), _ptr(row_add), _ptr(rows_add),
                           _ptr(t_base), ptrs[0] if use_t else None, ptrs[1] if use_t else None,
                           _ptr(c_base), ptrs[2] if use_c else None, ptrs[3] if use_c else None,
                           *ptrs[4:], out.data_ptr(), rows.data_ptr(), bsz, dl, de, latent,
                           float(eps), _stream(dev))
            _build.check(code, "fused_head (products)")
            fused_head.product_launches += 1
        else:
            code = fn_cols(h.data_ptr(), _ptr(row_add), _ptr(rows_add), *ptrs[4:],
                           out.data_ptr(), bsz, dl, dlp, latent, float(eps), _stream(dev))
            _build.check(code, "fused_head")
        fused_head.launches += 1
        return out

    run.weights = weights  # the head's own, unpadded
    run.padded = pads  # the tensors behind `ptrs` live as long as run
    return run


def fused_head(h, t_base, c_base, wt, bt, wc, bc, g, b, wf, bf,
               *, row_add=None, rows_add=None, eps: float = LN_EPS):
    """The denoiser head. h: (B, d_last) f32; t_base, c_base: (B, d_emb) f32
    or None (their projections are then skipped); row_add (d_last,) and
    rows_add (B, d_last): optional precomputed adds; Wt, Wc: (d_last, d_emb)
    bf16; Wf: (latent, d_last) bf16. A one-off `bind_head(...)(...)` that
    binds only the products it is given an input for."""
    use_t, use_c = t_base is not None, c_base is not None
    return bind_head(wt if use_t else None, bt if use_t else None,
                     wc if use_c else None, bc if use_c else None,
                     g, b, wf, bf, eps=eps)(h, t_base, c_base, row_add, rows_add)


fused_head.launches = 0
fused_head.product_launches = 0
