"""The ancestral reverse process on the kernels (port of
flowerdiff/kernels/full_sampler.py).

The Pallas kernel `_make_kernel` runs all T steps in one TPU kernel with x
and every weight resident in VMEM. Its counterpart here is one launch too:
the reverse-process kernel (csrc/reverse_process.cu, `ReverseProcess`) runs
every step of a bucket call, each cluster of blocks keeping its rows, its
column slice of x and of the condition adds on chip for the whole launch.
A step is the latent projection `h = bf16(x) Wl^T + bl` (with the CFG copy,
and for a v2 model the global skip sigmoid(rw) (bf16(x) Wf^T + bf)), the
stages as the stage kernel computes them, the head in its table form,
and the reverse step (the skip added to eps, CFG from the doubled batch, x0
clipping, the posterior mean and the step noise, Philox4x32-10 +
Box-Muller from a key in device memory). Its plan (`process_plan`: clusters,
blocks a cluster, rows a cluster, ring, shared memory) is bound once per
(batch, guided), its tensor maps encoded then. Any depth up to MAX_STAGES,
any stage input width up to MAX_STAGE_WIDTH = 4096 and any latent and last
hidden width up to MAX_WIDTH = 2**22 runs, which holds every denoiser the
JAX kernel holds in its 100 MiB of VMEM: the weights, vectors and time
tables are padded with zeros to the widths the plan's column split tiles
(`pad_process`), the request's tensors read at their own widths. A denoiser
of up to 8 stages whose slices fit keeps its vectors and condition adds
resident on chip; any other runs the streamed layout
(`ProcessPlan.streamed`: tensor maps and tables in device memory, vectors
and adds read from L2 where they are used); one whose latent or last width
a block's slice or shared memory cannot hold (past 4096 beside narrow
stages) runs the wide layout (`ProcessPlan.wide`: those two widths split
by m64 units and taken in column passes, their rows in a scratch in device
memory, the wide products' operands read through the ring).

`fused_sample` is the same process as a host loop of the step's own kernels
(7 launches a step): the projection (`latent_proj`, csrc/latent_proj.cu),
the stage kernels (`fused_stage`), the head (`fused_head`) and
`reverse_step` (csrc/reverse_step.cu). It is the reverse-process kernel's
oracle on the card; on the CPU, where each wrapper runs its plain twin
(`reverse_step_plain`: the same Philox stream in PyTorch integer ops,
`latent_proj_plain`), it is the kernel's plain version.

The time path (sinusoid -> time MLP -> per-stage projections) is computed
once per sampler as (T, d) tables, and the condition path once per request
(`draw_request`, with x_init and the Philox key), as
`full_sampler.py:200-226,280-291` do outside their kernel. Semantics follow
the model (not the TPU kernel's shortcuts): the CFG null rows keep the
projection biases, the v2 global skip is applied, LayerNorm eps is 1e-6.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flowerdiff_torch.diffusion.schedule import DiffusionSchedule
from flowerdiff_torch.kernels import _build
from flowerdiff_torch.kernels.denoiser_apply import _b, _w, head_weights, stage_weights
from flowerdiff_torch.kernels.latent_stage import (
    DSMEM_BYTES_PER_S,
    EXCHANGE_US,
    LN_EPS,
    MAP_BYTES,
    MAX_SLOTS,
    REQUEST_BYTES_PER_S,
    REQUEST_US,
    SMEM_LIMIT,
    TILE_BYTES,
    WGMMA_US,
    bind_head,
    bind_stage,
    chunk_tiles,
    fused_head,
    fused_stage,
    padded,
)
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.utils import profiling

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
    weights = (wl, bl, wf, bf, rw)
    if not wl.is_cuda:
        def plain(x, copies=1):
            return latent_proj_plain(x, wl, bl, copies=copies, wf=wf, bf=bf, rw=rw)
        plain.weights = weights
        return plain
    dev = wl.device
    hid, lat = wl.shape
    want = [("wl", wl, (hid, lat), torch.bfloat16), ("bl", bl, (hid,), torch.float32)]
    if wf is not None:
        want += [("wf", wf, (lat, lat), torch.bfloat16), ("bf", bf, (lat,), torch.float32),
                 ("rw", rw, (), torch.float32)]
    for name, w, shape, dtype in want:
        if (tuple(w.shape) != shape or w.dtype != dtype or w.device != dev
                or not w.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
                             f"on {dev}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    # the weights' rows padded with zeros to whole 16-byte loads
    ldw = -(-lat // 8) * 8
    pads = (padded(wl, (hid, ldw)), bl, None if wf is None else padded(wf, (lat, ldw)), bf, rw)
    ptrs = [None if w is None else w.data_ptr() for w in pads]
    fn = _build.load("latent_proj").fd_latent_proj_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def run(x, copies=1):
        b = x.shape[0]
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, lat) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"x: expected a contiguous float32 (B, {lat}) tensor on {dev}")
        h = torch.empty((copies * b, hid), dtype=torch.float32, device=dev)
        skip = None if wf is None else torch.empty((b, lat), dtype=torch.float32, device=dev)
        code = fn(x.data_ptr(), *ptrs, h.data_ptr(), None if skip is None else skip.data_ptr(),
                  b, lat, ldw, hid, copies, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, "latent_proj")
        latent_proj.launches += 1
        return h, skip

    run.weights = weights  # the projection's own, unpadded
    run.padded = pads  # the tensors behind `ptrs` live as long as run
    return run


def latent_proj(x, wl, bl, *, copies: int = 1, wf=None, bf=None, rw=None):
    """A one-off `bind_latent_proj(wl, bl, wf, bf, rw)(x, copies)`."""
    return bind_latent_proj(wl, bl, wf, bf, rw)(x, copies)


latent_proj.launches = 0


# ---------------------------------------------------------------------------
# The sampler

@torch.no_grad()
@profiling.spanned("sampler.prepare")
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
    `full_sampler.py:200-226` do outside their kernel). No host sync.
    Spans: `sampler.draw` (x and the key), `sampler.cond_rows`."""
    model = prep["model"]
    dev = model.latent_proj.weight.device
    with profiling.annotate("sampler.draw"):
        if x_init is None:
            x = torch.randn((batch, model.latent_dim), generator=generator, device=dev)
        else:
            x = x_init.to(device=dev, dtype=torch.float32).contiguous()
        key = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                            device=generator.device if generator is not None else "cpu")
        key = key_tensor(key, dev)
    with profiling.annotate("sampler.cond_rows", rows=batch * (2 if guided else 1)):
        cond = cond.to(dev)
        color = None if color is None else color.to(dev)
        stage_adds, final_add = _cond_adds(prep, cond, color, guided)
    return SamplerInputs(x, key, tuple(stage_adds), final_add)


@torch.no_grad()
def run_steps(prep: Dict, inputs: SamplerInputs, *, stochastic: bool = True,
              clip_x0: Optional[float] = None, guidance_scale: Optional[float] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The T reverse steps from `inputs`, each the projection, the stage,
    head and reverse-step kernels and nothing else (plain twins for CPU
    weights). Reads its inputs only from `inputs` and writes the final x
    into `out` (a new tensor when None)."""
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
    Philox key. The reverse-process kernel runs the same process in one
    launch; this loop is its oracle and, on the CPU, its plain version."""
    inputs = draw_request(prep, batch, cond, color, generator, x_init,
                          guided=guidance_scale is not None)
    return run_steps(prep, inputs, stochastic=stochastic, clip_x0=clip_x0,
                     guidance_scale=guidance_scale)


# ---------------------------------------------------------------------------
# The whole reverse process in one launch (csrc/reverse_process.cu)

# The kernel's limits (csrc/reverse_process.cu): stages (resident: tensor
# maps and per-stage pointers in the launch's parameters; streamed: in device
# memory), a stage's input width (16 blocks of at most 4 m64 tiles), the
# latent and the last hidden width (the wide layout: m64 units in passes,
# rows in device memory), rows a cluster (the wgmma's N). Past every width
# the JAX kernel holds in 100 MiB at any batch: its time table alone (T x d
# f32) bounds a last width near 26,000 at T = 1000, its Wl, Wf and the rows
# of x a latent near 3.5 M at one sample, and three d x d weights a stage's
# input near 4180 (~3852 at T = 1000).
MAX_RESIDENT_STAGES = 8
MAX_STAGES = 32768
MAX_STAGE_WIDTH = 4096
MAX_WIDTH = 1 << 22
# Rows a cluster of the resident layout, and of the streamed and wide ones:
# csrc/reverse_process.cu's kResidentRows and kStreamedRows
PROCESS_ROWS = (8, 16, 24, 32)
STREAMED_ROWS = (8, 16, 32)
# A wide chunk's slot (weights and operand rows), bytes; the scratch's own
# rate a block reads and writes at, for the cost model only (not measured:
# the rows of x, the skip and the pre-LN head rows go through L1 and L2)
WIDE_CHUNK = 36864
SCRATCH_BYTES_PER_S = 200e9


def process_units(rows: int, widest: int) -> int:
    """The m64 tiles a block's widest column slice may have at `rows` rows
    a cluster for a denoiser whose widest width is `widest`: 2, the
    instances the flagship's plans were measured on; `max_units` (4 at 8
    and 16 rows) for one wider than 1024, which at 2 would need 16 blocks a
    cluster, of which the card runs 7 at once."""
    return max_units(rows) if widest > 1024 else 2
PROCESS_COLS = (1, 2, 4, 8, 16)
PROCESS_BARRIERS = 5
MAX_MAPS = 2 + 4 * MAX_RESIDENT_STAGES  # the resident launch's parameter holds this many maps
# Clusters of `cols` blocks of one block an SM that the H100 runs at once
# (cudaOccupancyMaxActiveClusters on the card: 7 of 16, 15 of 8; PERF.md);
# a launch of more clusters runs them in waves.
WAVE_CLUSTERS = {16: 7, 8: 15, 4: 32, 2: 66, 1: 132}


class ProcessPlan(NamedTuple):
    clusters: int  # clusters of the launch; each owns `rows` rows for all T steps
    cols: int      # blocks of a cluster: each computes 1 / cols of each product's columns
    rows: int      # rows a cluster (guided: its samples' conditional rows, then their null rows)
    qbufs: int     # operand buffers: 2, or 1 rewritten after every reader's release
    slots: int     # slots of the weight ring
    smem: int      # dynamic shared memory of a block, bytes
    waves: int     # ceil(clusters / WAVE_CLUSTERS[cols])
    streamed: bool = False  # vectors and condition adds read from L2, maps in device memory
    wide: bool = False  # the latent and the last width in passes, their rows in device memory


def process_width(width: int, cols: int) -> int:
    """The padded width the kernel tiles `width` with at `cols` blocks a
    cluster: a multiple of 64 (whole k64 tiles) and of 8 cols (every
    block's slice whole 8-column units). A width that is one already is
    its own (the flagship's are). Mirrors csrc/reverse_process.cu::padded_ok."""
    unit = max(64, 8 * cols)
    return -(-width // unit) * unit


def process_widths(latent: int, hidden, cols: int, wide: bool = False):
    """(latent, hidden) padded for `cols` blocks a cluster (`process_width`);
    `wide`: the latent and the last hidden width to multiples of 64 (the
    wide layout's m64 units). Mirrors csrc/reverse_process.cu::padded_ok."""
    if wide:
        return (-(-latent // 64) * 64, tuple(process_width(w, cols) for w in hidden[:-1])
                + (-(-hidden[-1] // 64) * 64,))
    return process_width(latent, cols), tuple(process_width(w, cols) for w in hidden)


def wide_passes(width: int, cols: int, units: int) -> int:
    """The column passes of a wide output `width` (a multiple of 64) on the
    wide layout: its m64 units split among `cols` blocks, `units` a pass,
    every block running the most any block needs. Mirrors
    csrc/reverse_process.cu::wide_passes."""
    most = -(-(width // 64) // cols)  # a block's units
    return -(-most // units)


def wide_tiles(lines: int, rows: int, k: int) -> int:
    """k64 tiles of a wide chunk of `lines` weight rows and `rows` operand
    rows: the most, a power of two dividing k / 64, within WIDE_CHUNK bytes
    (one tile where one is larger). Mirrors csrc/reverse_process.cu."""
    kb = 1
    while (k // 64) % (2 * kb) == 0 and 2 * kb * (lines + rows) * 128 <= WIDE_CHUNK:
        kb *= 2
    return kb


def _wide_products(latent: int, hidden, skip: bool, cols: int, rows: int):
    """(weight rows a chunk, K, k64 tiles a chunk, passes, operand rows a
    chunk) of each product of a step on the wide layout, in stream order, at
    the kernel's (padded) widths: the projection and the head read their
    operand through the ring (the skip too), the stages from their buffers;
    the skip, the last Wd and the head run the wide output's passes. Mirrors
    csrc/reverse_process.cu::wide_shape."""
    n, units = len(hidden) - 1, max_units(rows)
    tw = 64 * units
    lines = hidden[0] // cols
    out = [(lines, latent, wide_tiles(lines, rows, latent), 1, rows)]
    wf_lines = min(tw, latent)
    if skip:
        out.append((wf_lines, latent, wide_tiles(wf_lines, rows, latent),
                    wide_passes(latent, cols, units), rows))
    for i in range(n):
        d = hidden[i]
        out += [(d // cols, d, chunk_tiles(d // cols, d), 1, 0)] * 3
        if i < n - 1:
            out.append((hidden[i + 1] // cols, d, chunk_tiles(hidden[i + 1] // cols, d), 1, 0))
        else:
            wl = min(tw, hidden[n])
            out.append((wl, d, chunk_tiles(wl, d), wide_passes(hidden[n], cols, units), 0))
    out.append((wf_lines, hidden[n], wide_tiles(wf_lines, rows, hidden[n]),
                wide_passes(latent, cols, units), rows))
    return out


def max_units(rows: int) -> int:
    """m64 tiles a block's slice or pass may have at `rows` rows a cluster
    (at most 64 accumulators a thread). Mirrors csrc/reverse_process.cu."""
    return 4 if rows <= 16 else 2


def process_scratch(latent: int, hidden, skip: bool, plan: ProcessPlan, guided: bool) -> int:
    """Bytes of a wide launch's scratch in device memory at the kernel's
    (padded) widths: per cluster bf16(x) and the head's operand (rows x L and
    rows x hidden[-1] bf16), the head's pre-LN rows (f32) and the skip (its
    samples x L f32). Mirrors csrc/reverse_process.cu::WideScratch."""
    c, r = plan.clusters, plan.rows
    s = r // 2 if guided else r
    return c * r * (latent + hidden[-1]) * 2 + c * r * hidden[-1] * 4 + (c * s * latent * 4
                                                                         if skip else 0)


def _products(latent: int, hidden, skip: bool, cols: int):
    """(column slice, K) of each product of a step, in stream order: the
    projection, the skip, each stage's Wb Wv Wo Wd, the head; the kernel's
    (padded) widths. Mirrors csrc/reverse_process.cu::product_shape."""
    n = len(hidden) - 1
    out = [(hidden[0] // cols, latent)]
    if skip:
        out.append((latent // cols, latent))
    for i in range(n):
        out += [(hidden[i] // cols, hidden[i])] * 3 + [(hidden[i + 1] // cols, hidden[i])]
    out.append((latent // cols, hidden[n]))
    return out


def process_vec_floats(latent: int, hidden, cols: int) -> int:
    """Floats of a block's slices of every vector (bl; each stage's bb g1 b1
    g2 b2 bv bo and bd; the head's g, b and bf) at the kernel's widths: its
    resident room, or its row of the streamed layout's vector table."""
    n = len(hidden) - 1
    return (hidden[0] + sum(7 * hidden[i] + hidden[i + 1] for i in range(n))
            + 2 * hidden[n] + latent) // cols


def process_smem(latent: int, hidden, skip: bool, cols: int, rows: int, qbufs: int,
                 slots: int, streamed: bool = False, wide: bool = False) -> int:
    """A block's shared memory in bytes, the alignment included, at the
    kernel's (padded) widths; streamed, without the resident vectors and
    condition adds; wide, without x, eps and the skip too (a pass's eps
    instead), the operand buffers as wide as the stages' inputs, a wide
    chunk's slot holding its operand rows. Mirrors
    csrc/reverse_process.cu::ProcessLayout."""
    n = len(hidden) - 1
    if wide:
        prods = _wide_products(latent, hidden, skip, cols, rows)
        slot = max(kb * (ln + op) * 128 for ln, _, kb, _, op in prods)
        reach = max((kb - 1) * ln * 128 + -(-ln // 64) * TILE_BYTES for ln, _, kb, _, _ in prods)
        dmax = max([64] + list(hidden[:n]))
        units = max_units(rows)
        ring = slots * slot
        total = (ring + qbufs * rows * dmax * 2 + 2 * cols * rows * 8 + 16 * rows * 4 + rows * 8
                 + 2 * 128 * units * (rows // 2) * 4 + rows * 64 * units * 4
                 + (2 * slots + PROCESS_BARRIERS + 2) * 8)
        return 1024 + total + max(0, reach - slot - (total - ring))
    prods = _products(latent, hidden, skip, cols)
    kbs = [chunk_tiles(sl, k) for sl, k in prods]
    slot = max(kb * sl * 128 for (sl, _), kb in zip(prods, kbs))
    reach = max((kb - 1) * sl * 128 + -(-sl // 64) * TILE_BYTES for (sl, _), kb in zip(prods, kbs))
    units = -(-max(sl for sl, _ in prods) // 64)
    dmax = max([latent] + [k for _, k in prods])
    nvec = 0 if streamed else process_vec_floats(latent, hidden, cols)
    nadds = 0 if streamed else sum(hidden) // cols
    ring = slots * slot
    total = (ring + qbufs * rows * dmax * 2 + 2 * cols * rows * 8 + 16 * rows * 4 + rows * 8
             + 2 * 128 * units * (rows // 2) * 4 + -(-nvec * 4 // 16) * 16 + rows * nadds * 4
             + 3 * rows * (latent // cols) * 4 + (2 * slots + PROCESS_BARRIERS) * 8)
    return 1024 + total + max(0, reach - slot - (total - ring))


def process_step_us(latent: int, hidden, skip: bool, plan: ProcessPlan) -> float:
    """The plan's cost model, us a step of one cluster: the block's weight
    requests (REQUEST_US each plus their bytes), which its producer issues
    ahead of the consumers, against its wgmmas plus its exchanges: each
    operand from the other blocks over distributed shared memory, the
    LayerNorms' statistics and, with one operand buffer, the releases. The
    rates are the stage kernel's (kernels/latent_stage.py). Widths are
    padded for the plan's column split first. On the wide layout a wide
    chunk is two requests (its weights, its operand rows from L2), a block
    reads the rows of x, the skip and the head's pre-LN rows of its columns
    from the scratch and writes them back (SCRATCH_BYTES_PER_S), and the
    projection's operand and the head's are published instead of exchanged."""
    latent, hidden = process_widths(latent, hidden, plan.cols, plan.wide)
    n = len(hidden) - 1
    if plan.wide:
        weights = mma = 0.0
        for ln, k, kb, passes, op in _wide_products(latent, hidden, skip, plan.cols, plan.rows):
            chunks = passes * (k // 64 // kb)
            weights += chunks * ((1 + (op > 0)) * REQUEST_US
                                 + kb * (ln + op) * 128 / REQUEST_BYTES_PER_S * 1e6)
            mma += passes * -(-ln // 64) * k // 32 * WGMMA_US
        operands = [d for d in hidden[:-1] for _ in range(4)]
        share = (plan.cols - 1) / plan.cols * 2 * plan.rows / DSMEM_BYTES_PER_S * 1e6
        exchanges = sum(EXCHANGE_US + w * share for w in operands) + (2 * n + 3) * EXCHANGE_US
        if plan.qbufs == 1:
            exchanges += 3 * n * EXCHANGE_US
        scratch = plan.rows * (latent * (2 + 3 * 4) + hidden[n] * (2 + 3 * 4)) / plan.cols
        return max(weights, mma + exchanges) + scratch / SCRATCH_BYTES_PER_S * 1e6
    weights = mma = 0.0
    for sl, k in _products(latent, hidden, skip, plan.cols):
        kb = chunk_tiles(sl, k)
        weights += k // 64 // kb * (REQUEST_US + kb * sl * 128 / REQUEST_BYTES_PER_S * 1e6)
        mma += -(-sl // 64) * k // 32 * WGMMA_US
    operands = [latent] + [d for d in hidden[:-1] for _ in range(4)] + [hidden[n]]
    share = (plan.cols - 1) / plan.cols * 2 * plan.rows / DSMEM_BYTES_PER_S * 1e6
    exchanges = sum(EXCHANGE_US + w * share for w in operands) + (2 * n + 1) * EXCHANGE_US
    if plan.qbufs == 1:
        exchanges += (3 * n + 1) * EXCHANGE_US
    return max(weights, mma + exchanges)


def process_plans(latent: int, hidden, skip: bool, batch: int, guided: bool):
    """Every plan the kernel takes for a bucket call of `batch` samples: each
    column split with each row count a cluster at which the padded slices
    are at most 64 `process_units` columns, the most ring slots that fit,
    two operand buffers where two slots still fit beside them. Resident
    plans where the denoiser has up to MAX_RESIDENT_STAGES stages and any
    fits (the layout does not depend on the batch), else streamed ones,
    else (a latent or last width past a block's slices or shared memory)
    wide ones."""
    resident = len(hidden) - 1 <= MAX_RESIDENT_STAGES
    plans = _plans(latent, hidden, skip, batch, guided, False) if resident else []
    return (plans or _plans(latent, hidden, skip, batch, guided, True)
            or _plans(latent, hidden, skip, batch, guided, True, True))


def _plans(latent: int, hidden, skip: bool, batch: int, guided: bool, streamed: bool,
           wide: bool = False):
    plans = []
    for cols in PROCESS_COLS:
        lat_p, hid_p = process_widths(latent, hidden, cols, wide)
        for rows in STREAMED_ROWS if streamed else PROCESS_ROWS:
            if wide:
                if max(hid_p[:-1]) // cols > 64 * max_units(rows):
                    continue
                slot = max(kb * (ln + op) * 128
                           for ln, _, kb, _, op in _wide_products(lat_p, hid_p, skip, cols, rows))
            elif max(lat_p, *hid_p) // cols > 64 * process_units(rows, max(latent, *hidden)):
                continue
            else:
                slot = max(chunk_tiles(sl, k) * sl * 128
                           for sl, k in _products(lat_p, hid_p, skip, cols))
            clusters = -(-batch // (rows // 2 if guided else rows))

            def smem(qbufs, slots):
                return process_smem(lat_p, hid_p, skip, cols, rows, qbufs, slots, streamed, wide)
            for qbufs in (2, 1):
                slots = min(MAX_SLOTS, (SMEM_LIMIT - smem(qbufs, 0)) // slot)
                while slots >= 2 and smem(qbufs, slots) > SMEM_LIMIT:
                    slots -= 1
                if slots >= 2:
                    plans.append(ProcessPlan(clusters, cols, rows, qbufs, slots,
                                             smem(qbufs, slots),
                                             -(-clusters // WAVE_CLUSTERS[cols]), streamed,
                                             wide))
                    break
    return plans


def process_plan(latent: int, hidden, skip: bool, batch: int, guided: bool) -> ProcessPlan:
    """The reverse-process kernel's plan for a bucket call of `batch`
    samples, or ValueError: among `process_plans`, the least waves x
    `process_step_us`, then the most column slices. A cluster's rows cost
    exchange bytes every step; more clusters than fit in one wave run in
    waves, each T steps long; each cluster reads every weight every step.
    The kernel takes 1 to MAX_STAGES stages, stage input widths (hidden[:-1])
    1 to MAX_STAGE_WIDTH and a latent and last hidden width 1 to MAX_WIDTH,
    padded (`process_widths`): every denoiser the JAX kernel holds in its
    100 MiB of VMEM, at any batch. A v2 skip needs hidden[-1] == latent."""
    if not 1 <= len(hidden) - 1 <= MAX_STAGES:
        raise ValueError(f"{len(hidden) - 1} stages: the kernel takes 1 to {MAX_STAGES}")
    if not all(1 <= w <= MAX_STAGE_WIDTH for w in hidden[:-1]):
        raise ValueError(f"hidden {tuple(hidden)}: the kernel takes stage input widths 1 to "
                         f"{MAX_STAGE_WIDTH}")
    if not all(1 <= w <= MAX_WIDTH for w in (latent, hidden[-1])):
        raise ValueError(f"latent {latent}, last width {hidden[-1]}: the kernel takes 1 to "
                         f"{MAX_WIDTH}")
    if skip and hidden[-1] != latent:
        raise ValueError(f"a v2 skip needs hidden[-1] == latent, got {hidden[-1]} and {latent}")
    if batch < 1:
        raise ValueError(f"batch {batch} must be positive")
    plans = process_plans(latent, hidden, skip, batch, guided)
    if not plans:
        raise ValueError(f"latent {latent}, hidden {tuple(hidden)}: no plan fits a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return min(plans, key=lambda p: (p.waves * process_step_us(latent, hidden, skip, p),
                                     -p.cols))


class ProcessOperands(NamedTuple):
    """The reverse-process kernel's operands for one column split, padded
    with zeros to its widths (`process_widths`): each tensor the prep's own
    where it needs no padding."""
    latent: int
    hidden: Tuple[int, ...]
    weights: Tuple[torch.Tensor, ...]  # bf16, in map order: Wl, each stage's Wb Wv Wo Wd, Wf
    fixed: Tuple[Optional[torch.Tensor], ...]  # bl, rw (None: no skip), tadd_f, g, b, bf
    # each stage's (tadd, (bb, g1, b1, g2, b2, bv, bo, bd))
    stages: Tuple[Tuple[torch.Tensor, Tuple[torch.Tensor, ...]], ...]


def pad_process(prep: Dict, cols: int, wide: bool = False) -> ProcessOperands:
    """The prep's weights, vectors and time tables padded for `cols` blocks a
    cluster (`wide`: the wide layout's widths). Zeros in every padded column
    keep the padded columns of h at exactly 0 through each step, so the
    kernel's true columns compute what the unpadded model does."""
    model = prep["model"]
    hidden = tuple(model.hidden_dims)
    lat, dims = process_widths(model.latent_dim, hidden, cols, wide)
    n, steps = len(hidden) - 1, prep["n_steps"]
    wl, bl, _, _, rw = prep["proj"].weights
    stages = [st.weights for st in prep["stages"]]
    _, _, _, _, g, b, wf, bf = prep["head"].weights
    weights = [padded(wl, (dims[0], lat))]
    vecs = []
    for i, st in enumerate(stages):
        d, do = dims[i], dims[i + 1]
        weights += [padded(st[j], (d, d)) for j in (0, 6, 8)] + [padded(st[10], (do, d))]
        vecs.append((padded(prep["tadds"][i], (steps, d)),
                     tuple(padded(st[j], (d,)) for j in (1, 2, 3, 4, 5, 7, 9))
                     + (padded(st[11], (do,)),)))
    weights.append(padded(wf, (lat, dims[n])))
    fixed = (padded(bl, (dims[0],)), rw, padded(prep["tadd_final"], (steps, dims[n])),
             padded(g, (dims[n],)), padded(b, (dims[n],)), padded(bf, (lat,)))
    return ProcessOperands(lat, dims, tuple(weights), fixed, tuple(vecs))


def process_vec_table(ops: ProcessOperands, cols: int) -> torch.Tensor:
    """The streamed layout's vector table, (cols, `process_vec_floats`) f32:
    row c holds block c's slices of every vector in the order the resident
    layout keeps them (bl; each stage's bb g1 b1 g2 b2 bv bo, then bd; the
    head's g, b and bf), so the kernel reads them at the same offsets."""
    bl, _, _, g, b, bf = ops.fixed
    vecs = [bl] + [v for _, stage in ops.stages for v in stage] + [g, b, bf]
    return torch.cat([v.reshape(cols, -1) for v in vecs], dim=1).contiguous()


def process_rows(plan: ProcessPlan, batch: int, guided: bool):
    """The rows of the condition adds ((2 batch, d) when guided, else
    (batch, d)) that each cluster of the plan holds, by cluster row, -1
    past the batch. Guided, a cluster's first rows / 2 rows are its
    samples' conditional rows and the rest their null rows, so the CFG
    combine of sample b stays in its cluster. Mirrors the kernel's
    `add_row`; sample s0 + r of cluster row r owns x's row s0 + r."""
    samples = plan.rows // 2 if guided else plan.rows
    out = []
    for cl in range(plan.clusters):
        rows = []
        for r in range(plan.rows):
            b = cl * samples + (r - samples if guided and r >= samples else r)
            rows.append(-1 if b >= batch else batch + b if guided and r >= samples else b)
        out.append(rows)
    return out


def process_map_encodes() -> int:
    """Calls of cuTensorMapEncodeTiled by the loaded reverse-process library
    so far: a plan's binding encodes its maps (once a column split), a launch
    none."""
    fn = _build.load("reverse_process").fd_process_map_encodes
    fn.restype = ctypes.c_longlong
    return fn()


def process_max_clusters(plan: ProcessPlan) -> int:
    """Clusters of the plan's shape the card runs at once
    (cudaOccupancyMaxActiveClusters)."""
    fn = _build.load("reverse_process").fd_process_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    _build.check(fn(plan.rows, plan.cols, plan.smem, ctypes.addressof(out)),
                 "cudaOccupancyMaxActiveClusters")
    return out.value


class ReverseProcess:
    """All T reverse steps of a bucket call in one launch of the
    reverse-process kernel (csrc/reverse_process.cu), the weights of
    `prep` fixed: any stage input width up to MAX_STAGE_WIDTH, any latent
    and last hidden width up to MAX_WIDTH and 1 to MAX_STAGES stages
    (`process_plan`), every denoiser the JAX kernel holds in its 100 MiB of
    VMEM. For a CPU model a call is `run_steps` on the plain twins: the
    kernel's plain version.

    A plan is bound once per (batch, guided): its geometry chosen
    (`process_plan`) and, where its column split is new, the weights padded
    for it (`pad_process`) and their tensor maps encoded; a streamed plan's
    maps, widths, time-table pointers and vector table (`process_vec_table`)
    are copied to device memory then. `bound` lists the bound plans. A call
    reads the request's `SamplerInputs` in place, launches once (adding one
    to `reverse_process.launches`; a streamed launch first copies the
    pointers of the request's condition adds into a device table of its
    own on the same stream; a wide launch allocates its scratch there too)
    and returns x_0, a new (B, L) tensor."""

    def __init__(self, prep: Dict):
        self.prep = prep
        model = prep["model"]
        self.device = model.latent_proj.weight.device
        self.latent, self.hidden = model.latent_dim, tuple(model.hidden_dims)
        self.skip = bool(model.global_skip)
        self.bound: Dict[Tuple[int, bool], ProcessPlan] = {}
        if self.device.type != "cuda":
            return
        self._coefs = torch.tensor(prep["coefs"], dtype=torch.float32, device=self.device)
        # by `_split_key`: (the maps' address, the padded operands, what the
        # launch's pointers point into)
        self._split: Dict[Tuple[int, bool, int], Tuple[int, ProcessOperands, tuple]] = {}
        self._launch = _build.load("reverse_process").fd_process_launch
        self._launch.argtypes = [ctypes.c_void_p] * 5
        self._launch.restype = ctypes.c_int

    @staticmethod
    def _split_key(plan: ProcessPlan) -> Tuple[int, bool, int]:
        """What a plan's operands and maps depend on: its column split, its
        layout and, wide, its rows (a wide chunk's box holds them)."""
        return plan.cols, plan.streamed, plan.rows if plan.wide else 0

    def _encode(self, key: Tuple[int, bool, int]):
        cols, streamed, wide_rows = key
        ops = pad_process(self.prep, cols, bool(wide_rows))
        n = len(self.hidden) - 1
        fn = _build.load("reverse_process").fd_process_maps
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # the resident launch copies MAX_MAPS maps into its parameters
        buf = ctypes.create_string_buffer(max(2 + 4 * n, MAX_MAPS) * MAP_BYTES + 64)
        at = -(-ctypes.addressof(buf) // 64) * 64  # a CUtensorMap is 64-byte aligned
        ptrs = (ctypes.c_void_p * len(ops.weights))(*[w.data_ptr() for w in ops.weights])
        dims = (ctypes.c_int * (n + 1))(*ops.hidden)
        _build.check(fn(ptrs, dims, n, ops.latent, cols, wide_rows, at),
                     "the sampler's tensor maps")
        keep: tuple = (buf,)
        if streamed:
            # the maps, widths, time tables' pointers and vector slices in
            # device memory (a tensor is at least 256-byte aligned)
            raw = ctypes.string_at(at, (2 + 4 * n) * MAP_BYTES)
            smaps = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(self.device)
            sdims = torch.tensor(ops.hidden + self.hidden, dtype=torch.int32,
                                 device=self.device)
            stadd = torch.tensor([tadd.data_ptr() for tadd, _ in ops.stages], dtype=torch.int64,
                                 device=self.device)
            svec = process_vec_table(ops, cols)
            keep = (smaps, sdims, stadd, svec)
            at = smaps.data_ptr()
        self._split[key] = (at, ops, keep)
        return self._split[key]

    def plan_for(self, batch: int, guided: bool) -> ProcessPlan:
        """The bound plan of a bucket call, bound at its first use (a span
        `sampler.bind`: bucket, guided, whether maps were encoded)."""
        key = (batch, guided)
        plan = self.bound.get(key)
        if plan is None:
            with profiling.annotate("sampler.bind", bucket=batch, guided=guided) as span:
                plan = process_plan(self.latent, self.hidden, self.skip, batch, guided)
                encoded = self.device.type == "cuda" and self._split_key(plan) not in self._split
                if encoded:
                    self._encode(self._split_key(plan))
                span.set(encoded=encoded)
            self.bound[key] = plan
        return plan

    def __call__(self, inputs: SamplerInputs, *, stochastic: bool = True,
                 clip_x0: Optional[float] = None, guidance_scale: Optional[float] = None,
                 plan: Optional[ProcessPlan] = None) -> torch.Tensor:
        """x_0 of the request. `plan`: one of `process_plans(...)` in place
        of the bound one (a comparison's; its operands are padded and its
        maps encoded at its first call where its column split is new). The
        whole call is a span `sampler.launch` (rows; on the card, whether
        the plan is streamed or wide, its waves and its rows a cluster)."""
        kw = dict(stochastic=stochastic, clip_x0=clip_x0, guidance_scale=guidance_scale)
        guided = guidance_scale is not None
        x = inputs.x
        batch, n = x.shape[0], len(self.hidden) - 1
        rows = batch * (2 if guided else 1)
        with profiling.annotate("sampler.launch", rows=rows) as span:
            if self.device.type != "cuda":
                return run_steps(self.prep, inputs, **kw)
            want = ([("x", x, (batch, self.latent), torch.float32),
                     ("key", inputs.key, (2,), torch.int32)]
                    + [(f"stage_adds[{i}]", a, (rows, self.hidden[i]), torch.float32)
                       for i, a in enumerate(inputs.stage_adds)]
                    + [("final_add", inputs.final_add, (rows, self.hidden[n]), torch.float32)])
            if len(inputs.stage_adds) != n:
                raise ValueError(f"{len(inputs.stage_adds)} stage adds for {n} stages")
            for name, v, shape, dtype in want:
                if (tuple(v.shape) != shape or v.dtype != dtype or v.device != self.device
                        or not v.is_contiguous() or v.data_ptr() % 16):
                    raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {dtype} "
                                     f"tensor of shape {shape} on {self.device}, got {v.dtype} "
                                     f"{tuple(v.shape)} on {v.device}")
            if plan is None:
                plan = self.plan_for(batch, guided)
            span.set(streamed=plan.streamed, wide=plan.wide, waves=plan.waves,
                     cluster_rows=plan.rows)
            maps, ops, keep = (self._split.get(self._split_key(plan))
                               or self._encode(self._split_key(plan)))
            out = torch.empty_like(x)
            bl, rw, tadd_f, g, b, bf = (None if v is None else v.data_ptr() for v in ops.fixed)
            ptrs = [x.data_ptr(), out.data_ptr(), inputs.key.data_ptr(), self._coefs.data_ptr(),
                    bl, rw, tadd_f, inputs.final_add.data_ptr(), g, b, bf]
            if plan.streamed:
                # the condition adds' pointers in a table of this launch's own,
                # copied on the launch's stream from pinned memory: a table
                # shared by the binding could be overwritten by a launch on
                # another stream while this one still reads it
                sadds = torch.tensor([a.data_ptr() for a in inputs.stage_adds],
                                     dtype=torch.int64).pin_memory()
                sadds = sadds.to(self.device, non_blocking=True)
                ptrs += [t.data_ptr() for t in keep] + [sadds.data_ptr()]
                if plan.wide:
                    # the last stage's bd, and the launch's own scratch (rows of
                    # x, the skip, the head's, and the wide operands), allocated
                    # on its stream
                    scratch = torch.empty(process_scratch(ops.latent, ops.hidden, self.skip,
                                                          plan, guided), dtype=torch.uint8,
                                          device=self.device)
                    ptrs += [ops.stages[-1][1][7].data_ptr(), scratch.data_ptr()]
            else:
                for (tadd, vec), adds in zip(ops.stages, inputs.stage_adds):
                    ptrs += [tadd.data_ptr(), adds.data_ptr()] + [v.data_ptr() for v in vec]
            ints = [n, batch, ops.latent, self.prep["n_steps"], int(guided),
                    int(clip_x0 is not None), int(stochastic), plan.clusters, plan.cols,
                    plan.rows, plan.qbufs, plan.slots, plan.smem, *ops.hidden, self.latent,
                    *self.hidden, int(plan.streamed), int(plan.wide)]
            floats = [float(guidance_scale or 0.0), float(clip_x0 or 0.0), LN_EPS]
            code = self._launch(None if plan.streamed else maps,
                                (ctypes.c_void_p * len(ptrs))(*ptrs),
                                (ctypes.c_int * len(ints))(*ints),
                                (ctypes.c_float * len(floats))(*floats),
                                torch.cuda.current_stream(self.device).cuda_stream)
            _build.check(code, "reverse_process")
            reverse_process.launches += 1
            return out


def reverse_process(prep: Dict, inputs: SamplerInputs, **kw) -> torch.Tensor:
    """A one-off `ReverseProcess(prep)(inputs, **kw)`."""
    return ReverseProcess(prep)(inputs, **kw)


reverse_process.launches = 0


def launch_counts() -> Dict[str, int]:
    """The launch counters of the sampler's kernels."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


_COUNTERS = {"reverse_process": (reverse_process, "launches"),
             "latent_proj": (latent_proj, "launches"), "fused_stage": (fused_stage, "launches"),
             "fused_head": (fused_head, "launches"),
             "fused_head_products": (fused_head, "product_launches"),
             "reverse_step": (reverse_step, "launches")}
