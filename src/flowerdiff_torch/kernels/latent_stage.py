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
LayerNorm needs whole rows: a stage runs on clusters of blocks (16 for the
1024-wide stage, else 8) that share 16 rows, each block owning a column
slice of the rows and of every product's output, computed on the tensor
cores from weights streamed through a ring of shared-memory slots; the
blocks exchange LayerNorm statistics and operand slices through distributed
shared memory. Where the card cannot run the wide stage's clusters of 16
for all the row tiles at once (`stage_max_clusters`), the stage runs on the
whole-row kernel instead: clusters of 8 in which every block holds the 16
whole rows and reads its weight columns from global memory. The head has
two kernels, chosen by form at each call: with no t_base or c_base (the
sampler's step, whose time and condition adds come from tables) a block
owns 16 rows and 16 output columns and computes its rows' LayerNorm itself
(csrc/latent_head.cu); with either product, which must be added to whole
rows before the LayerNorm, a block owns 16 whole rows and all the columns
(csrc/latent_stage.cu::head_kernel). `stage_plan` makes a stage launch's
plan (cluster size, ring slots, chunk depth, shared memory) on the host:
`bind_stage` makes the one or two it can need once.

`bind_stage` also packs the stage's four weights once into the kernel's
layout (`pack_stage_weight`: whole-row pieces cut into k-chunks with padded
rows), so that each chunk the kernel streams is one bulk copy a piece.

`bind_stage` / `bind_head` fix a kernel's weights (checked once) and return
the per-call launcher; for CPU weights they return the plain twin
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


def _check(name: str, x: Optional[torch.Tensor], shape, dtype, device) -> None:
    """Raise unless x is None or matches: device, dtype, shape, contiguous,
    16-byte aligned."""
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
    if x.data_ptr() % 16:  # the kernels read rows as float4 / 16-byte vectors
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_width(name: str, n: int, multiple: int = 8) -> None:
    if n % multiple:
        raise ValueError(f"{name} width {n} must be a multiple of {multiple}")


def _check_max(name: str, n: int, most: int) -> None:
    if n > most:
        raise ValueError(f"{name} width {n} is above the kernel's {most}")


_F32, _BF16 = torch.float32, torch.bfloat16


# The stage kernel's launch plan. Its shared memory holds, besides the ring:
# the block's column slices of h and of a product's output (16 rows, f32),
# two bf16 operands of 16 full rows (padded by 8 elements), two sets of row
# statistics, the split-K partials and the ring's mbarriers.
SMEM_LIMIT = 232_448   # bytes of shared memory a block may have on the H100
MAX_CLUSTER = 16       # non-portable cluster size
PIECES = 16            # row pieces of a packed weight: one bulk copy each a chunk
MAX_SLOTS = 8
MAX_D = 1024           # a thread holds at most 16 float4s of the 16 rows
MAX_SLICE = 256        # columns a block computes: four n8 tiles a warp
ROWS, WARPS = 16, 8
SLOT_PAD, OPERAND_PAD, BARRIER_BYTES = 16, 8, 128
MAX_CLUSTER_STATS = 16  # the statistics' room: (mean, m2) of 16 rows a block
# Clusters of 16 pay only where a block of a cluster of 8 would stream more
# than this many weight bytes (the 1024-wide stage: PERF.md, PR 5).
_WIDE_STAGE_BYTES = 1 << 19
# Chunk depths, deepest first: a chunk carries a fixed cost, so the deepest
# whose two slots fit.
_CHUNKS = (256, 128, 64)
# The whole-row kernel (csrc/latent_stage.cu::stage_rows_kernel): clusters of
# 8, split-K partials of 16 x 64 floats, operand rows padded by 32 elements.
_ROWS_CLUSTER, _ROWS_RED_FLOATS, _ROWS_PAD = 8, ROWS * 64, 32


class StagePlan(NamedTuple):
    cluster: int   # blocks sharing 16 rows, each computing 1/cluster of the columns
    slots: int     # shared-memory slots of the weight ring; 0: the whole-row kernel
    chunk: int     # k's of a chunk: one bulk copy of 2 * chunk bytes a weight row (0: none)
    smem: int      # dynamic shared memory of a block, bytes

    def slot_row_bytes(self) -> int:
        return 2 * self.chunk + SLOT_PAD


def _stage_smem(d: int, dout: int, cluster: int, slots: int, chunk: int) -> int:
    """Mirrors csrc/latent_stage.cu::stage_smem_bytes."""
    sd, sm = d // cluster, max(d, dout) // cluster
    return (BARRIER_BYTES + slots * sm * (2 * chunk + SLOT_PAD) + 4 * 2 * ROWS * sd
            + 2 * 2 * ROWS * (d + OPERAND_PAD) + 8 * 2 * MAX_CLUSTER_STATS * ROWS
            + 4 * WARPS * ROWS * 8)


def _rows_plan(d: int, dout: int) -> StagePlan:
    """The whole-row kernel's plan, or ValueError."""
    _check_width("d_out", dout, 8 * _ROWS_CLUSTER)
    sm = max(d, dout) // _ROWS_CLUSTER
    smem = 4 * (ROWS * (2 * d + 2 * sm) + _ROWS_RED_FLOATS) + 2 * ROWS * (d + _ROWS_PAD)
    if smem > SMEM_LIMIT:
        raise ValueError(f"stage {d} -> {dout}: the whole-row kernel's {smem} bytes "
                         f"of shared memory are above {SMEM_LIMIT}")
    return StagePlan(_ROWS_CLUSTER, 0, 0, smem)


def stage_plan(d: int, dout: int, rows: int = ROWS,
               wave16: Optional[int] = None) -> StagePlan:
    """The stage kernel's launch plan for widths d -> dout at `rows` rows,
    or ValueError. `wave16`: how many clusters of 16 stage blocks the card
    runs at once (`stage_max_clusters`); None: as many as the rows need.

    Cluster size min(16, d / 8, dout / 8) rounded down to a power of two,
    then 8 instead of 16 unless the stage is wide (_WIDE_STAGE_BYTES). A
    wide stage whose row tiles do not all fit in one wave of clusters of 16
    runs on the whole-row kernel (its plan has no slots): there the ring on
    clusters of 8, or on clusters of 16 of 32 rows, was slower (PERF.md, PR
    5). Chunks of 256 k's (fewer where d is not a multiple of 256, or where
    two slots of 256 do not fit); as many ring slots (at most 8, at most the
    stage's 4 d / chunk chunks) as fit beside the fixed buffers."""
    if d <= 0 or dout <= 0 or d % 64:
        raise ValueError(f"d width {d} must be a positive multiple of 64")
    if dout % PIECES:
        raise ValueError(f"d_out width {dout} must be a multiple of {PIECES}")
    _check_max("d", d, MAX_D)
    cluster = 1 << (min(MAX_CLUSTER, d // 8, max(dout // 8, 1)).bit_length() - 1)
    if cluster == 16 and (3 * d + dout) * d * 2 // 8 <= _WIDE_STAGE_BYTES:
        cluster = 8
    if cluster == 16 and wave16 is not None and -(-rows // ROWS) > wave16:
        return _rows_plan(d, dout)
    for name, n in (("d", d), ("d_out", dout)):
        if n % (8 * cluster):
            raise ValueError(f"{name} width {n} must be a multiple of 8 x the "
                             f"cluster size {cluster}")
        _check_max(f"{name} / cluster", n // cluster, MAX_SLICE)
    for chunk in _CHUNKS:
        if d % chunk:
            continue
        fixed = _stage_smem(d, dout, cluster, 0, chunk)
        slot = max(d, dout) // cluster * (2 * chunk + SLOT_PAD)
        slots = min(MAX_SLOTS, 4 * d // chunk, (SMEM_LIMIT - fixed) // slot)
        if slots >= 2:
            return StagePlan(cluster, slots, chunk,
                             _stage_smem(d, dout, cluster, slots, chunk))
    raise ValueError(f"stage {d} -> {dout}: two ring slots do not fit in "
                     f"{SMEM_LIMIT} bytes of shared memory")


def pack_stage_weight(w: torch.Tensor, chunk: int) -> torch.Tensor:
    """An (N, K) bf16 weight in the stage kernel's packed layout: (PIECES,
    K / chunk, N / PIECES, chunk + 8). Piece j holds rows [j N / PIECES,
    (j + 1) N / PIECES); [j, kc] is their k's [kc chunk, (kc + 1) chunk), each
    row padded with 8 zeros (16 bytes, the ring slot's row padding), so that
    a block's chunk of a product is one contiguous run of bytes a piece and
    one bulk copy fills its part of a slot."""
    n, k = w.shape
    packed = w.reshape(PIECES, n // PIECES, k // chunk, chunk).permute(0, 2, 1, 3)
    return torch.nn.functional.pad(packed, (0, SLOT_PAD // 2)).contiguous()


def stage_max_clusters(cluster: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters for stage blocks of `smem` bytes on
    clusters of `cluster`: how many such clusters the card runs at once."""
    fn = _build.load("latent_stage").fd_stage_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    _build.check(fn(cluster, smem, ctypes.byref(count)), "cudaOccupancyMaxActiveClusters")
    return count.value


def _fn(symbol: str, n_ptr: int, n_int: int, lib: str = "latent_stage"):
    fn = getattr(_build.load(lib), symbol)
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def bind_stage(wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd, *,
               eps: float = LN_EPS):
    """`fused_stage` with its weights fixed: returns run(h, tc=None,
    row_add=None). CUDA weights are checked here, once, and each call checks
    only its activations, so a sampler's step pays for three checks a stage
    and not fifteen. For CPU weights `run` is the plain twin."""
    weights = (wb, bb, g1, b1, g2, b2, wv, bv, wo, bo, wd, bd)
    if not wb.is_cuda:
        return lambda h, tc=None, row_add=None: fused_stage_plain(
            h, tc, *weights, row_add=row_add, eps=eps)
    dev = wb.device
    d, dout = wb.shape[1], wd.shape[0]
    plans, edge = [stage_plan(d, dout)], None
    if plans[0].cluster == 16:  # one plan for the rows one wave takes, one for more
        wave = stage_max_clusters(16, plans[0].smem)
        edge = ROWS * wave
        plans.append(stage_plan(d, dout, edge + 1, wave))
    for name, w in (("wb", wb), ("wv", wv), ("wo", wo)):
        _check(name, w, (d, d), _BF16, dev)
    _check("wd", wd, (dout, d), _BF16, dev)
    for name, v in (("bb", bb), ("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2),
                    ("bv", bv), ("bo", bo)):
        _check(name, v, (d,), _F32, dev)
    _check("bd", bd, (dout,), _F32, dev)
    launch_weights, ptrs = {}, {}
    for chunk in {plan.chunk for plan in plans}:  # chunk 0: the weights as they are
        pw = {name: pack_stage_weight(w, chunk) if chunk else w
              for name, w in (("wb", wb), ("wv", wv), ("wo", wo), ("wd", wd))}
        launch_weights[chunk] = (pw["wb"], bb, g1, b1, g2, b2, pw["wv"], bv,
                                 pw["wo"], bo, pw["wd"], bd)
        ptrs[chunk] = [w.data_ptr() for w in launch_weights[chunk]]

    def plan_for(rows: int) -> StagePlan:
        return plans[0] if edge is None or rows <= edge else plans[1]
    fn = _fn("fd_stage_launch", 16, 7)

    def run(h, tc=None, row_add=None):
        bsz = h.shape[0]
        _check("h", h, (bsz, d), _F32, dev)
        _check("tc", tc, (bsz, d), _F32, dev)
        _check("row_add", row_add, (d,), _F32, dev)
        out = torch.empty((bsz, dout), dtype=_F32, device=dev)
        plan = plan_for(bsz)
        code = fn(h.data_ptr(), _ptr(row_add), _ptr(tc), *ptrs[plan.chunk], out.data_ptr(),
                  bsz, d, dout, *plan, float(eps), _stream(dev))
        _build.check(code, "fused_stage")
        fused_stage.launches += 1
        return out

    run.weights = launch_weights  # the tensors behind `ptrs` live as long as run
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
    `bind_stage`. A call with neither base runs the column-tile kernel
    (csrc/latent_head.cu), a call with either the whole-row kernel
    (csrc/latent_stage.cu::head_kernel). For CPU weights `run` is the plain
    twin."""
    if not wf.is_cuda:
        def plain(h, t_base=None, c_base=None, row_add=None, rows_add=None):
            return fused_head_plain(h, t_base, c_base, wt, bt, wc, bc, g, b, wf, bf,
                                    row_add=row_add, rows_add=rows_add, eps=eps)
        return plain
    dev = wf.device
    latent, dl = wf.shape
    de = next((w.shape[1] for w in (wt, wc) if w is not None), dl)
    _check_width("d_last", dl, 32)  # 32-wide k chunks of the products
    _check_width("d_emb", de, 32)
    _check_width("latent", latent)
    for name, n in (("d_last", dl), ("d_emb", de), ("latent", latent)):
        # the whole-row kernel: one block all columns; the column kernel: a
        # warp holds two rows of d_last in registers
        _check_max(name, n, 512)
    for w, bias, tag in ((wt, bt, "t"), (wc, bc, "c")):
        if w is not None:
            _check(f"w{tag}", w, (dl, de), _BF16, dev)
            _check(f"b{tag}", bias, (dl,), _F32, dev)
    _check("g", g, (dl,), _F32, dev)
    _check("b", b, (dl,), _F32, dev)
    _check("wf", wf, (latent, dl), _BF16, dev)
    _check("bf", bf, (latent,), _F32, dev)
    weights = (wt, bt, wc, bc, g, b, wf, bf)
    ptrs = [_ptr(w) for w in weights]
    fn_rows = _fn("fd_head_launch", 14, 4)
    fn_cols = _fn("fd_head_cols_launch", 8, 3, lib="latent_head")

    def run(h, t_base=None, c_base=None, row_add=None, rows_add=None):
        bsz = h.shape[0]
        _check("h", h, (bsz, dl), _F32, dev)
        _check("row_add", row_add, (dl,), _F32, dev)
        _check("rows_add", rows_add, (bsz, dl), _F32, dev)
        for base, w, tag in ((t_base, wt, "t"), (c_base, wc, "c")):
            if base is not None and w is None:
                raise ValueError(f"{tag}_base given but no w{tag} bound")
            _check(f"{tag}_base", base, (bsz, de), _F32, dev)
        use_t, use_c = t_base is not None, c_base is not None
        out = torch.empty((bsz, latent), dtype=_F32, device=dev)
        if use_t or use_c:
            code = fn_rows(h.data_ptr(), _ptr(row_add), _ptr(rows_add),
                           _ptr(t_base), ptrs[0] if use_t else None, ptrs[1] if use_t else None,
                           _ptr(c_base), ptrs[2] if use_c else None, ptrs[3] if use_c else None,
                           *ptrs[4:], out.data_ptr(), bsz, dl, de, latent, float(eps),
                           _stream(dev))
            _build.check(code, "fused_head (products)")
            fused_head.product_launches += 1
        else:
            code = fn_cols(h.data_ptr(), _ptr(row_add), _ptr(rows_add), *ptrs[4:],
                           out.data_ptr(), bsz, dl, latent, float(eps), _stream(dev))
            _build.check(code, "fused_head")
        fused_head.launches += 1
        return out

    run.weights = weights  # the tensors behind `ptrs` live as long as run
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
