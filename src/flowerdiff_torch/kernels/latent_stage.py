"""Fused latent-denoiser stage and head: CUDA kernels with plain twins.

Replaces the Pallas kernels `_stage_kernel` and `_head_kernel` of
flowerdiff/kernels/latent_stage.py (csrc/latent_stage.cu). One stage at
inference, where attention over one key is out(v(x)):

    h   = h + row_add + tc
    h   = h + swish(LN1(h @ Wb + bb))
    h   = h + (LN2(h) @ Wv + bv) @ Wo + bo
    out = h @ Wd + bd

and the head: out = LN(h + row_add + rows_add + t_base @ Wt + bt
+ c_base @ Wc + bc) @ Wf + bf. Matmul operands are bf16, accumulation f32;
weights are bf16 in PyTorch's Linear layout (out, in), everything else f32.

Bound on the card: weight bytes (see the note in csrc/latent_stage.cu).
LayerNorm needs whole rows: a stage runs on clusters of 8 blocks that share
16 rows, each block computing 1/8 of every product's columns on the tensor
cores and the blocks exchanging slices through distributed shared memory;
the head gives each block 16 whole rows.

`bind_stage` / `bind_head` fix a kernel's weights (checked once) and return
the per-call launcher; for CPU weights they return the plain twin
(`fused_stage_plain` / `fused_head_plain`, same arithmetic in PyTorch ops).
`fused_stage` / `fused_head` are one-off calls through them. Each kernel
launch adds one to `fused_stage.launches` / `fused_head.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


def _fn(symbol: str, n_ptr: int, n_int: int):
    lib = _build.load("latent_stage")
    fn = getattr(lib, symbol)
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
    _check_width("d", d, 64)  # 8-column tiles over a cluster of 8 blocks
    _check_width("d_out", dout, 64)
    _check_max("d", d, 1024)  # the block's shared memory holds 16 rows of 2 x d f32
    _check_max("d_out", dout, 4096)
    for name, w in (("wb", wb), ("wv", wv), ("wo", wo)):
        _check(name, w, (d, d), _BF16, dev)
    _check("wd", wd, (dout, d), _BF16, dev)
    for name, v in (("bb", bb), ("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2),
                    ("bv", bv), ("bo", bo)):
        _check(name, v, (d,), _F32, dev)
    _check("bd", bd, (dout,), _F32, dev)
    ptrs = [w.data_ptr() for w in weights]
    fn = _fn("fd_stage_launch", 16, 3)

    def run(h, tc=None, row_add=None):
        bsz = h.shape[0]
        _check("h", h, (bsz, d), _F32, dev)
        _check("tc", tc, (bsz, d), _F32, dev)
        _check("row_add", row_add, (d,), _F32, dev)
        out = torch.empty((bsz, dout), dtype=_F32, device=dev)
        code = fn(h.data_ptr(), _ptr(row_add), _ptr(tc), *ptrs, out.data_ptr(),
                  bsz, d, dout, float(eps), _stream(dev))
        _build.check(code, "fused_stage")
        fused_stage.launches += 1
        return out

    run.weights = weights  # the tensors behind `ptrs` live as long as run
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
    `bind_stage`. For CPU weights `run` is the plain twin."""
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
        _check_max(name, n, 512)  # one block computes all columns
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
    fn = _fn("fd_head_launch", 14, 4)

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
        code = fn(h.data_ptr(), _ptr(row_add), _ptr(rows_add),
                  _ptr(t_base), ptrs[0] if use_t else None, ptrs[1] if use_t else None,
                  _ptr(c_base), ptrs[2] if use_c else None, ptrs[3] if use_c else None,
                  *ptrs[4:], out.data_ptr(), bsz, dl, de, latent, float(eps),
                  _stream(dev))
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
