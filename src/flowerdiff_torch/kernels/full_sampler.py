"""The ancestral reverse process on the kernels (port of
flowerdiff/kernels/full_sampler.py).

The Pallas kernel `_make_kernel` runs all T steps in one TPU kernel with
every weight resident in VMEM, the latent projection `h = x Wl + bl`
(`full_sampler.py:118`) included. On Hopper each step launches the port's
own kernels and nothing else:

  1. the `latent_proj` kernel (csrc/latent_proj.cu): h = bf16(x) Wl^T + bl,
     written to both halves of the stage input when guided (the CFG copy),
     and for a v2 model the global skip sigmoid(rw) (bf16(x) Wf^T + bf);
  2. the stage kernels (`fused_stage`), time adds read as one row of a
     precomputed (T, d) table, condition adds as precomputed (rows, d);
  3. the head kernel (`fused_head`);
  4. the `reverse_step` kernel: the skip added to eps, CFG from the doubled
     batch, x0 clipping, the posterior mean and the step noise, drawn in
     the kernel by Philox4x32-10 + Box-Muller from a key in device memory.

and the T steps' launches run as one launch structure: `SamplerGraph`
captures `run_steps` once per (batch, guidance, clip, stochastic) as a CUDA
graph and replays it for every request, as the TPU kernel runs its
`fori_loop` in one launch. `fused_sample` is the same loop issued from the
host (7 launches a step): the graph's oracle and the CPU's path.

The time path (sinusoid -> time MLP -> per-stage projections) is computed
once per sampler as (T, d) tables, and the condition path once per request
(`draw_request`, with x_init and the Philox key), as
`full_sampler.py:200-226,280-291` do outside their kernel. Semantics follow
the model (not the TPU kernel's shortcuts): the CFG null rows keep the
projection biases, the v2 global skip is applied, LayerNorm eps is 1e-6.

A persistent kernel (one grid-synchronised launch with the ~12.7 MB of
bf16 weights L2-resident) is later performance work.

`reverse_step` and `bind_latent_proj` launch their kernels for CUDA tensors
and run their plain twins, `reverse_step_plain` (the same Philox stream in
PyTorch integer ops) and `latent_proj_plain`, for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flowerdiff_torch.diffusion.schedule import DiffusionSchedule
from flowerdiff_torch.kernels import _build
from flowerdiff_torch.kernels.denoiser_apply import _b, _w, head_weights, stage_weights
from flowerdiff_torch.kernels.latent_stage import bind_head, bind_stage, fused_head, fused_stage
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser

_M32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))  # the kernel's f32 constant


# ---------------------------------------------------------------------------
# Philox4x32-10 in PyTorch integer ops (the twin of the kernel's generator)

def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant and a tensor of
    32-bit values held in int64, without overflowing int64."""
    p_lo = a * (b & 0xFFFF)          # < 2**48
    p_hi = a * (b >> 16)             # < 2**48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _M32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox4x32_10(c0: torch.Tensor, c1: int, c2: int, c3: int,
                  key0: int, key1: int):
    """Philox4x32-10 on counters (c0[i], c1, c2, c3) under key (key0, key1);
    returns four int64 tensors of 32-bit outputs."""
    c = [c0.to(torch.int64), torch.full_like(c0, c1, dtype=torch.int64),
         torch.full_like(c0, c2, dtype=torch.int64),
         torch.full_like(c0, c3, dtype=torch.int64)]
    k0, k1 = key0 & _M32, key1 & _M32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c[0])
        hi1, lo1 = _mulhilo(0xCD9E8D57, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_normal(n: int, step: int, key: Tuple[int, int], device=None) -> torch.Tensor:
    """The n standard normals the kernel draws at `step`: group g gives
    elements 4g..4g+3 by Box-Muller on its four Philox outputs."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    r = philox4x32_10(g, step, 0, 0, key[0], key[1])
    zs = []
    for a, b in ((r[0], r[1]), (r[2], r[3])):
        u1 = ((a >> 8) + 1).to(torch.float32) * 2.0**-24
        u2 = (b >> 8).to(torch.float32) * 2.0**-24
        rad = torch.sqrt(-2.0 * torch.log(u1))
        th = u2 * _TWO_PI_F32
        zs.append((rad * torch.cos(th), rad * torch.sin(th)))
    z = torch.stack([zs[0][0], zs[0][1], zs[1][0], zs[1][1]], dim=1)
    return z.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# The reverse-step kernel and its twin

def _key_ints(key) -> Tuple[int, int]:
    """The Philox key as two 32-bit ints, from a pair of ints or a (2,)
    integer tensor (whose words the kernel reads as uint32)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    return int(key[0]) & _M32, int(key[1]) & _M32


def key_tensor(key, device) -> torch.Tensor:
    """A Philox key (two ints, or a (2,) integer tensor) as the (2,) int32
    tensor on `device` that the kernel reads: each word's 32 bits."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int32)
    words = [k - (1 << 32) if k >= 1 << 31 else k for k in _key_ints(key)]
    return torch.tensor(words, dtype=torch.int32, device=device)


def reverse_step_plain(eps, x, t: int, coefs: Tuple[float, float, float], *,
                       guidance_scale: Optional[float] = None,
                       clip_x0: Optional[float] = None, stochastic: bool = True,
                       key=(0, 0), skip=None):
    # Scalar coefficients in f32, as the kernel forms them; a Python float
    # holding an f32 value multiplies an f32 tensor in f32.
    a, ab, beta = (np.float32(v) for v in coefs)
    one = np.float32(1.0)
    sq1mab, sqab = np.sqrt(one - ab), np.sqrt(ab)
    if skip is not None:
        eps = eps + (torch.cat([skip, skip]) if guidance_scale is not None else skip)
    e = eps
    if guidance_scale is not None:
        e_c, e_u = eps[: x.shape[0]], eps[x.shape[0]:]
        e = e_u + float(np.float32(guidance_scale)) * (e_c - e_u)
    if clip_x0 is not None:
        x0 = (x - float(sq1mab) * e) / float(sqab)
        x0 = torch.clamp(x0, -clip_x0, clip_x0)
        e = (x - float(sqab) * x0) / float(sq1mab)
    mean = (x - float((one - a) / sq1mab) * e) / float(np.sqrt(a))
    if stochastic and t > 0:
        z = philox_normal(x.numel(), t, _key_ints(key), device=x.device).reshape(x.shape)
        mean = mean + float(np.sqrt(beta)) * z
    return mean


def _reverse_fn():
    fn = _build.load("reverse_step").fd_reverse_step_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_int, ctypes.c_float] + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def reverse_step(eps, x, t: int, coefs: Tuple[float, float, float], *,
                 guidance_scale: Optional[float] = None,
                 clip_x0: Optional[float] = None, stochastic: bool = True,
                 key=(0, 0), skip=None, out=None):
    """x_{t-1} from x_t (B, L) f32 and eps: (B, L) f32, or (2B, L) with the
    conditional rows first when guidance_scale is set. coefs: the schedule's
    (alpha_t, alpha_bar_t, beta_t); key: the Philox key of the request, a
    (2,) int32 tensor on x's device (the kernel reads it there, so a
    captured launch reads whatever key was copied in last), or two ints or
    another integer tensor, converted here; skip: None or (B, L) f32, the
    v2 global skip, added to eps (to both halves when guided) before the
    guidance; out: None or a (B, L) f32 tensor to write x_{t-1} into."""
    if not x.is_cuda:
        mean = reverse_step_plain(eps, x, t, coefs, guidance_scale=guidance_scale,
                                  clip_x0=clip_x0, stochastic=stochastic, key=key, skip=skip)
        return mean if out is None else out.copy_(mean)
    guided = guidance_scale is not None
    rows = x.shape[0] * (2 if guided else 1)
    if x.dtype != torch.float32 or eps.dtype != torch.float32:
        raise ValueError("reverse_step takes float32 eps and x")
    if x.ndim != 2 or tuple(eps.shape) != (rows, x.shape[1]):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {(rows, x.shape[1])}")
    if eps.device != x.device or not (x.is_contiguous() and eps.is_contiguous()):
        raise ValueError("eps and x must be contiguous and on one device")
    for name, v in (("skip", skip), ("out", out)):
        if v is not None and (v.dtype != torch.float32 or v.shape != x.shape
                              or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor shaped and "
                             "placed like x")
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int32:
        key = key_tensor(key, x.device)
    if tuple(key.shape) != (2,) or key.device != x.device or not key.is_contiguous():
        raise ValueError(f"key must be a contiguous (2,) tensor on {x.device}, got "
                         f"{tuple(key.shape)} on {key.device}")
    out = torch.empty_like(x) if out is None else out
    a, ab, beta = coefs
    code = _reverse_fn()(
        eps.data_ptr(), None if skip is None else skip.data_ptr(), x.data_ptr(),
        out.data_ptr(), x.numel(), int(guided), float(guidance_scale or 0.0),
        int(clip_x0 is not None), float(clip_x0 or 0.0), float(a), float(ab), float(beta),
        int(t), int(stochastic), key.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "reverse_step")
    reverse_step.launches += 1
    return out


reverse_step.launches = 0


# ---------------------------------------------------------------------------
# The latent-projection kernel and its twin

def latent_proj_plain(x, wl, bl, *, copies: int = 1, wf=None, bf=None, rw=None):
    """(h, skip) of one step: h = bf16(x) Wl^T + bl, repeated `copies` times
    along the rows (2 when guided: the CFG copy); skip = sigmoid(rw)
    (bf16(x) Wf^T + bf) with Wf given (the v2 model), else None. x (B, L)
    f32; Wl (H, L) and Wf (L, L) bf16; f32 sums, as the reference's `_mm`."""
    xb = x.to(torch.bfloat16).float()
    h = xb @ wl.float().t() + bl
    if copies > 1:
        h = h.repeat(copies, 1)
    skip = None
    if wf is not None:
        skip = torch.sigmoid(rw.reshape(())) * (xb @ wf.float().t() + bf)
    return h, skip


def bind_latent_proj(wl, bl, wf=None, bf=None, rw=None):
    """The `latent_proj` kernel with its weights fixed: returns run(x, copies)
    -> (h, skip) as `latent_proj_plain` computes them (wf, bf and rw: the v2
    skip, all given or none). Weights are checked once; for CPU weights
    `run` is the plain twin. Each launch adds one to `latent_proj.launches`."""
    if (wf is None) != (bf is None) or (wf is None) != (rw is None):
        raise ValueError("wf, bf and rw go together (the v2 skip)")
    if not wl.is_cuda:
        def plain(x, copies=1):
            return latent_proj_plain(x, wl, bl, copies=copies, wf=wf, bf=bf, rw=rw)
        return plain
    dev = wl.device
    hid, lat = wl.shape
    if lat % 8 or lat > 1024:
        raise ValueError(f"latent width {lat}: the kernel takes multiples of 8 up to 1024")
    want = [("wl", wl, (hid, lat), torch.bfloat16), ("bl", bl, (hid,), torch.float32)]
    if wf is not None:
        want += [("wf", wf, (lat, lat), torch.bfloat16), ("bf", bf, (lat,), torch.float32),
                 ("rw", rw, (), torch.float32)]
    for name, w, shape, dtype in want:
        if (tuple(w.shape) != shape or w.dtype != dtype or w.device != dev
                or not w.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
                             f"on {dev}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    weights = (wl, bl, wf, bf, rw)
    ptrs = [None if w is None else w.data_ptr() for w in weights]
    fn = _build.load("latent_proj").fd_latent_proj_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def run(x, copies=1):
        b = x.shape[0]
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, lat) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"x: expected a contiguous float32 (B, {lat}) tensor on {dev}")
        h = torch.empty((copies * b, hid), dtype=torch.float32, device=dev)
        skip = None if wf is None else torch.empty((b, lat), dtype=torch.float32, device=dev)
        code = fn(x.data_ptr(), *ptrs, h.data_ptr(), None if skip is None else skip.data_ptr(),
                  b, lat, hid, copies, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, "latent_proj")
        latent_proj.launches += 1
        return h, skip

    run.weights = weights  # the tensors behind `ptrs` live as long as run
    return run


def latent_proj(x, wl, bl, *, copies: int = 1, wf=None, bf=None, rw=None):
    """A one-off `bind_latent_proj(wl, bl, wf, bf, rw)(x, copies)`."""
    return bind_latent_proj(wl, bl, wf, bf, rw)(x, copies)


latent_proj.launches = 0


# ---------------------------------------------------------------------------
# The sampler

@torch.no_grad()
def prepare_fused_sampler(model: ConditionalLatentDenoiser,
                          sched: DiffusionSchedule) -> Dict:
    """One-time prep on the model's device: the projection, stage and head
    kernels bound to their weights (bf16 (out, in), checked once), the (T, d)
    time-add tables of every stage and of the head, and the schedule
    coefficients as Python floats."""
    model = model.eval()
    dev = model.latent_proj.weight.device
    n_steps = sched.n_steps
    t_base_all = model.time_emb(torch.arange(n_steps, device=dev))
    skip = {}
    if model.global_skip:
        skip = dict(wf=_w(model.final), bf=_b(model.final),
                    rw=model.residual_weight.detach().float().contiguous())
    return {
        "model": model,
        "proj": bind_latent_proj(_w(model.latent_proj), _b(model.latent_proj), **skip),
        "stages": [bind_stage(**stage_weights(model, i)) for i in range(model.n_stages)],
        "head": bind_head(**head_weights(model)),
        "tadds": [model.stage("time_proj", i)(t_base_all).contiguous()
                  for i in range(model.n_stages)],
        "tadd_final": model.final_time_proj(t_base_all).contiguous(),
        "coefs": list(zip(sched.alpha.tolist(), sched.alpha_bar.tolist(),
                          sched.beta.tolist())),
        "n_steps": n_steps,
    }


def _cond_adds(prep: Dict, cond, color, guided: bool):
    """Per-request condition adds: rows (B, d) per stage and for the head;
    with guidance, the null-condition rows (the projection biases) follow."""
    model = prep["model"]
    c_base = model.embed_condition(cond, color)
    projs = [model.cond_proj(i) for i in range(model.n_stages)] + [model.final_cond_proj]
    adds = []
    for proj in projs:
        rows = proj(c_base)
        if guided:
            rows = torch.cat([rows, proj.bias.expand_as(rows)])
        adds.append(rows.contiguous())
    return adds[:-1], adds[-1]


class SamplerInputs(NamedTuple):
    """What a request gives the step loop: the starting state x (B, L) f32,
    the Philox key (2,) int32, the condition rows of each stage and of the
    head (rows, d) f32 (rows = 2B when guided)."""
    x: torch.Tensor
    key: torch.Tensor
    stage_adds: Tuple[torch.Tensor, ...]
    final_add: torch.Tensor

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.x, self.key, *self.stage_adds, self.final_add)

    def clone(self) -> "SamplerInputs":
        return SamplerInputs(self.x.clone(), self.key.clone(),
                             tuple(a.clone() for a in self.stage_adds), self.final_add.clone())


@torch.no_grad()
def draw_request(prep: Dict, batch: int, cond: torch.Tensor,
                 color: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None,
                 guided: bool = False) -> SamplerInputs:
    """The per-request work before the step loop, on the model's device:
    x_init (drawn from the generator unless given), then the request's
    Philox key from the same generator, then the condition adds (as
    `full_sampler.py:200-226` do outside their kernel). No host sync."""
    model = prep["model"]
    dev = model.latent_proj.weight.device
    cond = cond.to(dev)
    color = None if color is None else color.to(dev)
    if x_init is None:
        x = torch.randn((batch, model.latent_dim), generator=generator, device=dev)
    else:
        x = x_init.to(device=dev, dtype=torch.float32).contiguous()
    key = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                        device=generator.device if generator is not None else "cpu")
    stage_adds, final_add = _cond_adds(prep, cond, color, guided)
    return SamplerInputs(x, key_tensor(key, dev), tuple(stage_adds), final_add)


@torch.no_grad()
def run_steps(prep: Dict, inputs: SamplerInputs, *, stochastic: bool = True,
              clip_x0: Optional[float] = None, guidance_scale: Optional[float] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The T reverse steps from `inputs`, each the projection, the stage,
    head and reverse-step kernels and nothing else (plain twins for CPU
    weights). Reads its inputs only from `inputs` and writes the final x
    into `out` (a new tensor when None), so that a CUDA graph of it
    (`SamplerGraph`) serves any request copied into the same tensors."""
    proj, head = prep["proj"], prep["head"]
    copies = 2 if guidance_scale is not None else 1
    x = inputs.x
    for t in range(prep["n_steps"] - 1, -1, -1):
        h, skip = proj(x, copies)
        for i, stage in enumerate(prep["stages"]):
            h = stage(h, inputs.stage_adds[i], row_add=prep["tadds"][i][t])
        eps = head(h, row_add=prep["tadd_final"][t], rows_add=inputs.final_add)
        x = reverse_step(eps, x, t, prep["coefs"][t], guidance_scale=guidance_scale,
                         clip_x0=clip_x0, stochastic=stochastic, key=inputs.key, skip=skip,
                         out=out if t == 0 else None)
    return x


@torch.no_grad()
def fused_sample(prep: Dict, batch: int, cond: torch.Tensor,
                 color: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None, stochastic: bool = True,
                 clip_x0: Optional[float] = None,
                 guidance_scale: Optional[float] = None) -> torch.Tensor:
    """Full ancestral sampling on the kernels as a host loop of launches
    (7 a step). The generator draws x_init (unless given) and the request's
    Philox key. `SamplerGraph` replays the same launches; this loop is its
    oracle and the CPU's path."""
    inputs = draw_request(prep, batch, cond, color, generator, x_init,
                          guided=guidance_scale is not None)
    return run_steps(prep, inputs, stochastic=stochastic, clip_x0=clip_x0,
                     guidance_scale=guidance_scale)


# ---------------------------------------------------------------------------
# The step loop as one CUDA graph

def launch_counts() -> Dict[str, int]:
    """The launch counters of the sampler step's kernels."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def _add_launches(delta: Dict[str, int], times: int = 1) -> None:
    for name, (fn, attr) in _COUNTERS.items():
        setattr(fn, attr, getattr(fn, attr) + times * delta[name])


class SamplerGraph:
    """`run_steps` for one (batch, guidance_scale, clip_x0, stochastic)
    captured once as a CUDA graph and replayed for every request: the T
    steps' 7 T launches in one `replay()`, as the TPU kernel runs them in
    one launch. The request's x_init, key and condition rows are copied
    into the graph's own input tensors before each replay; guidance, clip,
    T and the schedule are baked in, as the TPU kernel bakes them per
    compile.

    Built from a first request's inputs: one eager `run_steps` on a side
    stream (it builds the kernels and sets their attributes, so that the
    capture makes no such call), then the capture. A failed capture raises.

    Launch counts: the eager run counts as launched; the capture launches
    nothing, so what it added to the counters is taken back and kept as
    `captured` (the launches of one replay), and each replay adds it.
    `replays` counts the replays; `warm_s` (the eager run), `capture_s`
    (capture and instantiation) and `pool_bytes` (the memory the capture
    reserved for the graph's pool) describe the build."""

    def __init__(self, prep: Dict, inputs: SamplerInputs, *, stochastic: bool = True,
                 clip_x0: Optional[float] = None, guidance_scale: Optional[float] = None):
        dev = inputs.x.device
        kw = dict(stochastic=stochastic, clip_x0=clip_x0, guidance_scale=guidance_scale)
        self.inputs = inputs.clone()
        self.out = torch.empty_like(inputs.x)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run_steps(prep, self.inputs, out=self.out, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warm_s = time.perf_counter() - t0
        before = launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            reserved = torch.cuda.memory_reserved(dev)
            run_steps(prep, self.inputs, out=self.out, **kw)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = launch_counts()
        self.captured = {name: after[name] - before[name] for name in after}
        _add_launches(self.captured, -1)
        self.replays = 0

    def __call__(self, inputs: SamplerInputs) -> torch.Tensor:
        """The request's final x: a new tensor, since the next replay
        rewrites the graph's own output."""
        for dst, src in zip(self.inputs.tensors(), inputs.tensors()):
            dst.copy_(src)
        self.graph.replay()
        _add_launches(self.captured)
        self.replays += 1
        return self.out.clone()


_COUNTERS = {"latent_proj": (latent_proj, "launches"), "fused_stage": (fused_stage, "launches"),
             "fused_head": (fused_head, "launches"),
             "fused_head_products": (fused_head, "product_launches"),
             "reverse_step": (reverse_step, "launches")}
