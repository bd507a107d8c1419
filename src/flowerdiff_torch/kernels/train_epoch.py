"""A whole epoch of latent-DDPM train steps in one call (port of
flowerdiff/kernels/train_epoch.py).

Replaces the Pallas kernel `_make_epoch_kernel`, reached through
`make_mega_epoch_fn`: S train steps, each drawing its own timesteps, noise,
condition keep-mask and dropout masks, reading abar[t], running the forward
and backward of the eps-loss (the train step of kernels/train_step.py),
clipping the gradient by its global norm and taking the AdamW update from
per-step tables of the learning rate and the bias corrections. As in the
JAX package this is an entry point of its own: no trainer calls it and no
config field selects it.

    epoch_fn = make_mega_epoch_fn(model, cfg, steps_per_epoch, batch)
    losses = epoch_fn(state, sched, z_rows (S, B, L), labels (S, B), seed)

updates `state` (a `LatentTrainState` over `model`) in place and returns the
S losses as a tensor on the device. Per epoch:

  1. Outside, once: the tables lr_i = schedule(step + i),
     bc1_i = 1 - 0.9^(step + i + 1), bc2_i = 1 - 0.999^(step + i + 1), in
     f32 as the reference computes them (`train_epoch.py:342-346`;
     `LatentTrainState.apply_gradients` uses Python doubles for the bias
     corrections, a difference of one f32 rounding).
  2. For step i: the draws; `sa = sqrt(abar[t])`, `s1a = sqrt(1 - abar[t])`;
     loss and gradients of the 76 weight leaves; gnorm = sqrt(sum g^2) in
     f32; g *= min(1, clip / max(gnorm, 1e-16)); m = b1 m + (1 - b1) g;
     v = b2 v + (1 - b2) g^2; w -= lr_i ((m / bc1_i) / (sqrt(v / bc2_i) +
     1e-8) + wd w); m and v stored in `moments_dtype` (bf16 when `dtype` is
     bf16 unless given), the arithmetic in f32.
  3. Outside, once: q and k of every stage (zero gradient, so no kernel sees
     them, but AdamW decays them) times prod_i (1 - lr_i wd); `state.step`
     advances by S; the EMA copy, if any, takes ONE blend with decay^S toward
     the epoch-end weights (epoch-granular, unlike the per-step EMA of
     `LatentTrainState.apply_gradients`).

On CUDA weights all of 2 and 3 is `fd_train_epoch_launch`
(csrc/train_epoch.cu): one call into the library enqueues every kernel of
the epoch on the current stream, with no Python, no PyTorch op and no host
synchronisation between the steps. Each step launches from the plan of the
step that `bind_train_step` bound (its products' routes and tensor maps),
so an epoch encodes no tensor map. A build or launch failure raises. On CPU
weights the same arithmetic runs as `mega_epoch_plain`, the plain twin,
which also serves the comparisons on the card. With bf16 moments the kernel
keeps bf16 buffers for the epoch and writes f32 values (bf16-representable)
back into `state.mu` / `state.nu`, so `apply_gradients` goes on working.

Randomness. `stochastic=True`: the kernel draws (Philox4x32-10 keyed by the
seed; counter = (element group, global step, tensor id)). `epoch_draws`
fetches the draws of any steps through the same kernel, so that an epoch
can be repeated by the twin on the same bits; `step_draws_plain` is the
draws' own twin in PyTorch integer ops. `stochastic=False`: the draws are an
argument, `(t (S, B), eps (S, B, L), keep (S, B), masks [(S, B, d_i)] * 2
a stage)`.

Not carried over from the TPU kernel: `grad_scratch` (parks gradients in
VMEM to shorten register live ranges, a Mosaic allocator matter),
`interpret` and `vmem_limit_bytes` (Pallas arguments), the one-hot products
that stand in for gathers there (the kernel here indexes abar[t] and repeats
a head's draw over its columns directly), and the one-hot labels (the train
step takes int32 labels).
"""
from __future__ import annotations

import ctypes
import types
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flowerdiff_torch.kernels import _build
from flowerdiff_torch.kernels.full_sampler import _TWO_PI_F32, philox4x32_10
from flowerdiff_torch.kernels.train_step import (
    HEADS,
    _lane,
    _ptr_array,
    _stream,
    bind_train_step,
    kernel_supported,
    sinusoid_freqs,
    step_data,
    twin_loss_and_grads,
    weights_spec,
)
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.train.latent_ddpm import ADAM_B1, ADAM_B2, ADAM_EPS

_F32 = torch.float32
_M32 = 0xFFFFFFFF
_CHUNK = 4096  # elements of a leaf one block of the optimizer kernels handles (kChunk)

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]


def _grad_is_bf16(k: str) -> bool:
    """Leaves whose product operand, and hence gradient, is bf16 in the bf16
    lane: every `w*` but `wf` (the epsilon head computes in f32), and the
    class table."""
    leaf = k.split(".")[-1]
    return (leaf.startswith("w") and leaf != "wf") or k == "table"


def _moments_dtype(dtype: torch.dtype, moments_dtype: Optional[torch.dtype]) -> torch.dtype:
    if moments_dtype is None:
        return torch.bfloat16 if dtype == torch.bfloat16 else _F32
    if moments_dtype not in (torch.bfloat16, _F32):
        raise ValueError(f"moments are kept in bfloat16 or float32, not {moments_dtype}")
    return moments_dtype


def epoch_tables(schedule, step0: int, steps: int) -> np.ndarray:
    """(3, steps) f32: the learning rate and Adam's two bias corrections
    for optimizer steps step0 .. step0 + steps - 1, computed in f32."""
    ix = step0 + np.arange(steps)
    lr = np.array([schedule(int(i)) for i in ix], np.float32)
    k = (ix + 1).astype(np.float32)
    one = np.float32(1.0)
    return np.stack([lr, one - np.power(np.float32(ADAM_B1), k),
                     one - np.power(np.float32(ADAM_B2), k)]).astype(np.float32)


def qk_decay_factor(lr: np.ndarray, weight_decay: float) -> float:
    """prod_i (1 - lr_i wd) in f32: what an epoch of AdamW does to a weight
    whose gradient and moments are exactly zero."""
    return float(np.prod(np.float32(1.0) - lr * np.float32(weight_decay), dtype=np.float32))


def _state_slots(state, model: ConditionalLatentDenoiser) -> Dict[str, int]:
    """kernel leaf name -> index into the state's params / mu / nu lists."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    index = {name: j for j, name in enumerate(state.names)}
    return {key: index[by_id[id(p)]] for key, p in weights_spec(model)}


def _qk_slots(state) -> List[int]:
    return [j for j, name in enumerate(state.names) if ".q." in name or ".k." in name]


# ---------------------------------------------------------------------------
# The draws and their twin

def _uniforms(n: int, stream: int, gstep: int, key: Tuple[int, int], device) -> torch.Tensor:
    """n 24-bit uniforms in [0, 1) of tensor `stream` at global step `gstep`:
    draw q is word q % 4 of the Philox call with counter (q // 4, gstep,
    stream, 0)."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10(g, gstep & _M32, stream, 0, *key), dim=1).reshape(-1)[:n]
    return (words >> 8).to(_F32) * 2.0**-24


def step_draws_plain(model: ConditionalLatentDenoiser, n_steps: int, cond_dropout: float,
                     batch: int, seed: int, gstep: int, device=None):
    """One step's draws as the kernel makes them, in PyTorch ops: (t (B,)
    float indices, eps (B, L), keep (B,), masks). t = min(floor(u n_steps),
    n_steps - 1); eps by Box-Muller's cosine branch with u1 >= 1e-7 (normal
    q from words 2 (q % 2), 2 (q % 2) + 1 of call q // 2); keep and the
    masks are u >= rate, the attention mask one draw a (sample, head)."""
    key = (seed & _M32, (seed >> 32) & _M32)
    lat = model.latent_dim
    t = torch.clamp(torch.floor(_uniforms(batch, 0, gstep, key, device) * float(n_steps)),
                    max=float(n_steps - 1))
    keep = torch.ones(batch, dtype=_F32, device=device)
    if cond_dropout > 0.0:
        keep = (_uniforms(batch, 1, gstep, key, device) >= cond_dropout).float()
    n = batch * lat
    g = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    r = philox4x32_10(g, gstep & _M32, 2, 0, *key)

    def normal(a, b):
        u1 = torch.clamp((a >> 8).to(_F32) * 2.0**-24, min=1e-7)
        u2 = (b >> 8).to(_F32) * 2.0**-24
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * _TWO_PI_F32)

    eps = torch.stack([normal(r[0], r[1]), normal(r[2], r[3])], dim=1).reshape(-1)[:n]
    rate = model.dropout_rate
    masks = []
    for i in range(model.n_stages):
        d = model.hidden_dims[i]
        if rate > 0.0:
            scale = 1.0 / (1.0 - rate)
            mb = (_uniforms(batch * d, 3 + 2 * i, gstep, key, device) >= rate).float() * scale
            ma = (_uniforms(batch * HEADS, 4 + 2 * i, gstep, key, device) >= rate).float() * scale
            masks += [mb.reshape(batch, d),
                      ma.reshape(batch, HEADS).repeat_interleave(d // HEADS, dim=1)]
        else:
            masks += [torch.ones((batch, d), dtype=_F32, device=device) for _ in range(2)]
    return t, eps.reshape(batch, lat), keep, masks


class _EpochArgs(ctypes.Structure):
    """`EpochArgs` of csrc/train_epoch.cu, field for field."""
    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "plan", "z_rows", "labels", "freqs", "abar", "injected", "draw_bufs", "losses",
            "gnorms", "tables", "leaves", "leaf_chunks", "partials", "blends", "qk_chunks",
            "ema_chunks")]
        + [("seed", ctypes.c_ulonglong), ("count0", ctypes.c_longlong)]
        + [(k, ctypes.c_int) for k in (
            "steps", "n_sched", "n_leaf_chunks", "n_qk_chunks", "n_ema_chunks", "bf16_moments",
            "stochastic")]
        + [(k, ctypes.c_float) for k in (
            "grad_clip", "weight_decay", "b1", "b2", "omb1", "omb2", "eps_adam", "dropout",
            "mask_scale", "cond_dropout", "qk_factor", "ema_keep", "ema_take")])


def _lib():
    lib = _build.load("train_epoch")
    if lib.fd_train_epoch_launch.argtypes is None:  # first use: declare the C signatures
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fd_train_epoch_launch.argtypes = [ctypes.POINTER(_EpochArgs), vp]
        lib.fd_train_epoch_launch.restype = ci
        lib.fd_epoch_draws_launch.argtypes = [vp, vp, vp, ci, cf, cf, cf, ctypes.c_ulonglong,
                                              ctypes.c_longlong, vp]
        lib.fd_epoch_draws_launch.restype = ci
        lib.fd_grad_norm_launch.argtypes = [vp, vp, ci, vp, vp, vp]
        lib.fd_grad_norm_launch.restype = ci
        lib.fd_adamw_launch.argtypes = [vp, vp, ci, vp, vp, ctypes.POINTER(cf), ci, vp]
        lib.fd_adamw_launch.restype = ci
        lib.fd_tensor_map_encodes.argtypes = []
        lib.fd_tensor_map_encodes.restype = ctypes.c_longlong
    return lib


def _model_dims(model: ConditionalLatentDenoiser, batch: int):
    if any(d % HEADS for d in model.hidden_dims[:-1]):
        raise ValueError(f"every stage width must be a multiple of {HEADS} heads")
    return (ctypes.c_int * (6 + model.n_stages))(
        batch, model.latent_dim, model.time_emb_dim, model.num_classes, model.n_stages,
        *model.hidden_dims)


def _mask_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _draw_buffers(model: ConditionalLatentDenoiser, lead: Tuple[int, ...], device):
    """t_f, sa, s1a, eps, cond_mask, then block and attention mask a stage,
    each with the leading shape `lead` ((B,) for one step)."""
    def new(*tail):
        return torch.empty(lead + tail, dtype=_F32, device=device)

    return ([new(), new(), new(), new(model.latent_dim), new()]
            + [new(d) for d in model.hidden_dims[:-1] for _ in range(2)])


def epoch_draws(model: ConditionalLatentDenoiser, cfg, sched, steps: int, batch: int,
                seed: int, step0: int, device=None) -> Draws:
    """The draws of optimizer steps step0 .. step0 + steps - 1 under `seed`,
    as a stochastic epoch starting at `state.step == step0` makes them: on a
    CUDA device through the draws kernel (one launch a step), on the CPU by
    `step_draws_plain`."""
    dev = torch.device(sched.alpha_bar.device if device is None else device)
    if dev.type != "cuda":
        per = [step_draws_plain(model, sched.n_steps, cfg.cond_dropout, batch, seed, step0 + i,
                                dev) for i in range(steps)]
        return (torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per]),
                torch.stack([p[2] for p in per]),
                [torch.stack([p[3][j] for p in per]) for j in range(2 * model.n_stages)])
    abar = sched.alpha_bar.to(dev, _F32).contiguous()
    bufs = _draw_buffers(model, (steps, batch), dev)
    dims = _model_dims(model, batch)
    lib = _lib()
    for i in range(steps):
        code = lib.fd_epoch_draws_launch(
            _ptr_array([b[i] for b in bufs]), abar.data_ptr(), dims, sched.n_steps,
            model.dropout_rate, _mask_scale(model.dropout_rate), cfg.cond_dropout,
            seed & (2**64 - 1), step0 + i, _stream(dev))
        _build.check(code, "epoch draws")
        epoch_draws.launches += 1
    return bufs[0], bufs[3], bufs[4], bufs[5:]


epoch_draws.launches = 0


# ---------------------------------------------------------------------------
# The plain twin

def mega_epoch_plain(state, sched, z_rows: torch.Tensor, labels: torch.Tensor, draws: Draws, *,
                     dtype: torch.dtype = torch.bfloat16,
                     moments_dtype: Optional[torch.dtype] = None, cfg=None,
                     tables: Optional[np.ndarray] = None):
    """One epoch in plain PyTorch ops on whatever device the state lies:
    S steps of autograd on the train step's twin, the clip and AdamW written
    out, then the q/k decay, the step count and the epoch-granular EMA.
    Updates `state` in place; returns (losses (S,), gradient norms (S,)).
    `cfg` (default: the state's) carries grad_clip and weight_decay; `tables`
    (default: `epoch_tables` at the state's step) the lr / bc1 / bc2 rows."""
    model = state.model
    cfg = state.cfg if cfg is None else cfg
    steps = z_rows.shape[0]
    mdt = _moments_dtype(dtype, moments_dtype)
    if tables is None:
        tables = epoch_tables(state.schedule, state.step, steps)
    named = dict(weights_spec(model))
    slots = _state_slots(state, model)
    m = {k: state.mu[j].to(mdt) for k, j in slots.items()}
    v = {k: state.nu[j].to(mdt) for k, j in slots.items()}
    t, eps, keep, masks = draws
    freqs = sinusoid_freqs(model.time_emb_dim, z_rows.device)
    losses, gnorms = [], []
    for i in range(steps):
        data = step_data(sched, z_rows[i], labels[i], t[i].long(), eps[i], keep[i], freqs)
        loss, grads = twin_loss_and_grads(named, data, [mk[i] for mk in masks], dtype=dtype,
                                          global_skip=model.global_skip)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        cscale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-16), max=1.0)
        lr, bc1, bc2 = (float(x) for x in tables[:, i])
        for k, p in named.items():
            g = grads[k] * cscale
            m_new = ADAM_B1 * m[k].float() + (1.0 - ADAM_B1) * g
            v_new = ADAM_B2 * v[k].float() + (1.0 - ADAM_B2) * g * g
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + ADAM_EPS) + cfg.weight_decay * p.data
            p.data.sub_(lr * upd)
            m[k], v[k] = m_new.to(mdt), v_new.to(mdt)
        losses.append(loss)
        gnorms.append(gnorm)
    for k, j in slots.items():
        state.mu[j].copy_(m[k])
        state.nu[j].copy_(v[k])
    factor = qk_decay_factor(tables[0], cfg.weight_decay)
    for j in _qk_slots(state):
        state.params[j].mul_(factor)
    state.step += steps
    if state.ema is not None:
        keep_e = state.ema_decay ** steps
        for e, p in zip(state.ema, state.params):
            e.mul_(keep_e).add_(p, alpha=1.0 - keep_e)
    return torch.stack(losses), torch.stack(gnorms)


# ---------------------------------------------------------------------------
# The kernel's tables and the launch

def _chunks(sizes: Sequence[int], first_item: int = 0) -> np.ndarray:
    """(n_chunks, 2) int32 rows (item, piece): one block of an optimizer
    kernel a row."""
    rows = [(first_item + j, c) for j, n in enumerate(sizes)
            for c in range(-(-n // _CHUNK))]
    return np.asarray(rows, np.int32).reshape(-1, 2)


def leaf_table(w: Sequence[torch.Tensor], g: Sequence[torch.Tensor],
               m32: Sequence[torch.Tensor], v32: Sequence[torch.Tensor],
               m16: Optional[Sequence[torch.Tensor]] = None,
               v16: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """(n, 7) int64 rows of csrc/train_epoch.cu's `Leaf`: the addresses of a
    leaf's weight, gradient, f32 moments and bf16 moments (0 without), and
    its element count. Every tensor must be contiguous and on one device."""
    n = len(w)
    cols = [w, g, m32, v32, m16 or [None] * n, v16 or [None] * n]
    want = [_F32] * 4 + [torch.bfloat16] * 2
    rows = np.zeros((n, 7), np.int64)
    for c, (col, dt) in enumerate(zip(cols, want)):
        for j, x in enumerate(col):
            if x is None:
                continue
            if x.dtype != dt or not x.is_contiguous() or x.numel() != w[j].numel() \
                    or x.device != w[0].device:
                raise ValueError(f"leaf {j}, column {c}: expected a contiguous {dt} tensor of "
                                 f"{w[j].numel()} elements on {w[0].device}")
            rows[j, c] = x.data_ptr()
    rows[:, 6] = [x.numel() for x in w]
    return rows


def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum over the tensors of sum g^2) by the norm kernels (CUDA, f32):
    per-chunk partial sums, then one ordered sum. The twin is
    `torch.linalg.vector_norm` over the concatenation."""
    dev = grads[0].device
    table = torch.from_numpy(leaf_table(grads, grads, grads, grads)).to(dev)
    chunks = torch.from_numpy(_chunks([g.numel() for g in grads])).to(dev)
    partials = torch.empty(len(chunks), dtype=_F32, device=dev)
    out = torch.empty((), dtype=_F32, device=dev)
    code = _lib().fd_grad_norm_launch(table.data_ptr(), chunks.data_ptr(), len(chunks),
                                      partials.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check(code, "gradient norm")
    return out


def adamw_update(w, g, m, v, gnorm: torch.Tensor, lr: float, bc1: float, bc2: float, *,
                 grad_clip: float, weight_decay: float) -> None:
    """One clipped AdamW step by the kernel (CUDA), in place on the f32
    weights `w` and on the moments `m`, `v` (all f32 or all bf16 lists), from
    the f32 gradients `g` and their norm."""
    dev = w[0].device
    bf16 = m[0].dtype == torch.bfloat16
    # with bf16 moments the kernel never touches the f32 columns: w stands in
    table = leaf_table(w, g, w, w, m, v) if bf16 else leaf_table(w, g, m, v)
    table = torch.from_numpy(table).to(dev)
    chunks = torch.from_numpy(_chunks([x.numel() for x in w])).to(dev)
    tables = torch.tensor([lr, bc1, bc2], dtype=_F32, device=dev)
    hyper = (ctypes.c_float * 7)(grad_clip, weight_decay, ADAM_B1, ADAM_B2, 1.0 - ADAM_B1,
                                 1.0 - ADAM_B2, ADAM_EPS)
    code = _lib().fd_adamw_launch(table.data_ptr(), chunks.data_ptr(), len(chunks),
                                  gnorm.data_ptr(), tables.data_ptr(), hyper, int(bf16),
                                  _stream(dev))
    _build.check(code, "AdamW")


def make_mega_epoch_fn(model: ConditionalLatentDenoiser, cfg, steps_per_epoch: int, batch: int,
                       dtype: torch.dtype = torch.bfloat16, stochastic: bool = True,
                       moments_dtype: Optional[torch.dtype] = None):
    """epoch_fn(state, sched, z_rows (S, B, L), labels (S, B), seed=0,
    draws=None) -> losses (S,) on the device; `state` is updated in place.
    See the module docstring. `seed`: an integer or a `torch.Generator`
    (its initial seed is taken); the same seed at the same `state.step`
    gives the same draws. stochastic=False takes `draws` instead.
    `epoch_fn.launches` counts epoch launches of the kernel, `epoch_fn.steps`
    the train steps they enqueued; `epoch_fn.gnorms` holds the last epoch's
    gradient norms (S,), before the clip."""
    if not kernel_supported(model):
        raise ValueError("the epoch kernel supports shared_cond_proj single-condition "
                         "variants (v1/v2) only")
    _lane(dtype)
    mdt = _moments_dtype(dtype, moments_dtype)
    steps = steps_per_epoch
    bound: Dict[torch.device, types.SimpleNamespace] = {}

    def bind(state, dev):
        named = dict(weights_spec(model))
        b = types.SimpleNamespace()
        b.run = bind_train_step(named, batch, dtype=dtype, global_skip=model.global_skip)
        b.slots = list(_state_slots(state, model).values())
        sizes = [w.numel() for w in b.run.weights]
        b.m16 = b.v16 = None
        if mdt == torch.bfloat16:
            b.m16 = [torch.zeros(n, dtype=mdt, device=dev) for n in sizes]
            b.v16 = [torch.zeros(n, dtype=mdt, device=dev) for n in sizes]
        b.leaf_chunks = torch.from_numpy(_chunks(sizes)).to(dev)
        b.partials = torch.empty(len(b.leaf_chunks), dtype=_F32, device=dev)
        b.bufs = _draw_buffers(model, (batch,), dev)
        b.buf_ptrs = _ptr_array(b.bufs)
        b.freqs = sinusoid_freqs(model.time_emb_dim, dev).contiguous()
        b.tables = torch.empty((3, steps), dtype=_F32, device=dev)
        b.qk = _qk_slots(state)
        b.n_params = len(state.params)
        b.qk_chunks = torch.from_numpy(_chunks([state.params[j].numel() for j in b.qk])).to(dev)
        b.ema_chunks = torch.from_numpy(
            _chunks([p.numel() for p in state.params], first_item=len(b.qk))).to(dev)
        b.leaves_host = b.blends_host = None
        return b

    def refresh_tables(b, state, dev):
        """The leaf and blend tables hold addresses of the state's tensors:
        written once, and again only if the state's tensors were replaced."""
        leaves = leaf_table(b.run.weights, b.run.grads, [state.mu[j] for j in b.slots],
                            [state.nu[j] for j in b.slots], b.m16, b.v16)
        if b.leaves_host is None or not np.array_equal(leaves, b.leaves_host):
            b.leaves_host, b.leaves = leaves, torch.from_numpy(leaves).to(dev)
        rows = [(state.params[j].data_ptr(),) * 2 + (state.params[j].numel(),) for j in b.qk]
        if state.ema is not None:
            rows += [(e.data_ptr(), p.data_ptr(), p.numel())
                     for e, p in zip(state.ema, state.params)]
        blends = np.asarray(rows, np.int64).reshape(-1, 3)
        if b.blends_host is None or not np.array_equal(blends, b.blends_host):
            b.blends_host, b.blends = blends, torch.from_numpy(blends).to(dev)

    def epoch_fn(state, sched, z_rows, labels, seed: Union[int, torch.Generator] = 0,
                 draws: Optional[Draws] = None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than the epoch function")
        if tuple(z_rows.shape) != (steps, batch, model.latent_dim):
            raise ValueError(f"z_rows has shape {tuple(z_rows.shape)}, expected "
                             f"{(steps, batch, model.latent_dim)}")
        if tuple(labels.shape) != (steps, batch):
            raise ValueError(f"labels has shape {tuple(labels.shape)}, expected {(steps, batch)}")
        if stochastic == (draws is not None):
            raise ValueError("stochastic=False takes the epoch's draws as `draws`, "
                             "stochastic=True draws its own and takes none")
        seed = seed.initial_seed() if isinstance(seed, torch.Generator) else int(seed)
        dev = state.params[0].device
        if z_rows.device != dev or labels.device != dev or sched.alpha_bar.device != dev:
            raise ValueError(f"z_rows, labels and the schedule must lie on the weights' {dev}")
        if dev.type != "cuda":
            if draws is None:
                draws = epoch_draws(model, cfg, sched, steps, batch, seed, state.step, dev)
            losses, epoch_fn.gnorms = mega_epoch_plain(
                state, sched, z_rows, labels, draws, dtype=dtype, moments_dtype=mdt, cfg=cfg)
            return losses

        if dev not in bound:
            bound[dev] = bind(state, dev)
        b = bound[dev]
        refresh_tables(b, state, dev)
        tables = epoch_tables(state.schedule, state.step, steps)
        b.tables.copy_(torch.from_numpy(tables))
        z = z_rows.to(_F32).contiguous()
        lab = labels.to(torch.int32).contiguous()
        abar = sched.alpha_bar.to(_F32).contiguous()
        losses = torch.empty(steps, dtype=_F32, device=dev)
        gnorms = torch.empty(steps, dtype=_F32, device=dev)
        injected = inj_ptrs = None
        if draws is not None:
            t, eps, keep, masks = draws
            injected = [t.to(_F32).contiguous(), eps.to(_F32).contiguous(),
                        keep.to(_F32).contiguous()] + [mk.to(_F32).contiguous() for mk in masks]
            shapes = ([(steps, batch), (steps, batch, model.latent_dim), (steps, batch)]
                      + [(steps, batch, d) for d in model.hidden_dims[:-1] for _ in range(2)])
            if [tuple(x.shape) for x in injected] != shapes or any(x.device != dev
                                                                   for x in injected):
                raise ValueError(f"draws must have shapes {shapes} on {dev}")
            inj_ptrs = _ptr_array(injected)
        ema_keep = 1.0 if state.ema is None else state.ema_decay ** steps
        args = _EpochArgs(
            plan=b.run.plan, z_rows=z.data_ptr(), labels=lab.data_ptr(),
            freqs=b.freqs.data_ptr(), abar=abar.data_ptr(),
            injected=None if injected is None else ctypes.cast(inj_ptrs, ctypes.c_void_p),
            draw_bufs=ctypes.cast(b.buf_ptrs, ctypes.c_void_p),
            losses=losses.data_ptr(), gnorms=gnorms.data_ptr(), tables=b.tables.data_ptr(),
            leaves=b.leaves.data_ptr(), leaf_chunks=b.leaf_chunks.data_ptr(),
            partials=b.partials.data_ptr(), blends=b.blends.data_ptr(),
            qk_chunks=b.qk_chunks.data_ptr(), ema_chunks=b.ema_chunks.data_ptr(),
            seed=seed & (2**64 - 1), count0=state.step,
            steps=steps, n_sched=sched.n_steps, n_leaf_chunks=len(b.leaf_chunks),
            n_qk_chunks=len(b.qk_chunks),
            n_ema_chunks=0 if state.ema is None else len(b.ema_chunks),
            bf16_moments=int(mdt == torch.bfloat16), stochastic=int(stochastic),
            grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay, b1=ADAM_B1, b2=ADAM_B2,
            omb1=1.0 - ADAM_B1, omb2=1.0 - ADAM_B2, eps_adam=ADAM_EPS,
            dropout=model.dropout_rate, mask_scale=_mask_scale(model.dropout_rate),
            cond_dropout=cfg.cond_dropout,
            qk_factor=qk_decay_factor(tables[0], cfg.weight_decay),
            ema_keep=ema_keep, ema_take=1.0 - ema_keep)
        code = _lib().fd_train_epoch_launch(ctypes.byref(args), _stream(dev))
        _build.check(code, "train_epoch")
        epoch_fn.launches += 1
        epoch_fn.steps += steps
        state.step += steps
        epoch_fn.gnorms = gnorms
        return losses

    epoch_fn.launches = 0
    epoch_fn.steps = 0
    epoch_fn.gnorms = None
    return epoch_fn
