"""Forward + backward of the latent-DDPM train step: a CUDA kernel sequence
with a plain twin (port of flowerdiff/kernels/train_step.py).

Replaces the Pallas kernel `_make_kernel` (reached through
`_kernel_loss_and_grads`), which runs `forward_loss` and its whole vjp in one
TPU program. On the card `csrc/train_step.cuh` computes the same loss and one
f32 gradient per weight leaf with hand-written forward and backward kernels
(see the note at the top of that file: bound by weight and gradient bytes;
one tiled product in three forms plus row and column kernels, enqueued on
the caller's stream by `fd_train_step_launch` of `csrc/train_step.cu`, and
step after step by the epoch kernel, kernels/train_epoch.py).

The objective (`forward_loss_plain`, the twin, same names as the
reference's `_weights_spec`):

    x_t = sa z + s1a eps
    t_base = lin2(swish(lin1([sin(t f), cos(t f)])))
    c_base = lin2(swish(lin1(table[label]))) * cond_mask
    h = latent_proj(x_t)
    per stage:  h += (t_base + c_base) Wt^T + 2 bt   (shared projection quirk)
                h += swish(m_blk * LN(h Wb^T + bb))  (mask, then swish)
                h += (m_attn * (LN(h) Wv^T + bv)) Wo^T + bo   (one key)
                h  = h Wd^T + bd
    h = LN(h + t_base Wtf^T + btf + c_base Wcf^T + bcf)
    out = h Wf^T + bf2 [+ sigmoid(rw) (x_t Wf^T + bf2)]      (always f32)
    loss = mean_rows sqrt(sum (eps - out)^2 + 1e-8)

Product operands are rounded to `dtype` (bf16, or f32 for the exact lane)
with f32 accumulation; under autograd the twin therefore rounds dX and dW of
each cast operand to bf16, as the reference's vjp does. Weights are the
module's own f32 parameters in PyTorch's (out, in) layout; LayerNorm eps is
1e-6.

All randomness (t, eps, the condition keep-mask, the dropout masks) is drawn
outside and passed in: `draw_step_inputs` draws it from one
`torch.Generator`, for the kernel body and for the eager autograd body
alike, so the two can be given identical draws.

`kernel_loss_and_grads` launches the kernels for CUDA weights (a build or
launch failure raises) and runs autograd on the twin for CPU weights. Each
launch of the kernel sequence adds one to `kernel_loss_and_grads.launches`.

`bind_train_step` plans the step once on CUDA weights (`fd_step_plan_create`):
each product's kernel, chosen from its form, shape and operand strides (a
row that is not a whole number of 16-byte units, as at a `latent_dim` or
`time_emb_dim` that is not a multiple of 4, keeps its product off the
tensor-map kernel), and the tensor maps of the products that take it,
encoded then. A launch encodes nothing: `tensor_map_encodes()` reads the
process's count of encodes.
"""
from __future__ import annotations

import ctypes
import math
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flowerdiff_torch.kernels import _build
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser

LN_EPS = 1e-6  # the model's (flax) LayerNorm epsilon
HEADS = 8      # attention heads of every denoiser stage

_STAGE_LEAVES = ("wt", "bt", "wb", "bb", "g1", "b1", "g2", "b2", "wv", "bv",
                 "wo", "bo", "wd", "bd")


def _ln(x, gamma, beta):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * gamma + beta


def _swish(x):
    return x * torch.sigmoid(x)


def forward_loss_plain(weights: Dict, data: Dict, *, n_stages: int,
                       dtype: torch.dtype = torch.bfloat16,
                       global_skip: bool = False) -> torch.Tensor:
    """The training objective in PyTorch ops on a weight dict (`_nest` of
    `weights_spec`). data: z, eps (B, L); t_f, sa, s1a, cond_mask (B, 1);
    labels (B,) integers; freqs (1, half); m_blk, m_attn: per stage (B, d_i)
    masks already scaled by 1 / (1 - rate). Differentiable in the weights."""
    w = {k: v for k, v in weights.items() if k != "stages"}
    stages = weights["stages"]
    assert len(stages) == n_stages

    def cast(a):
        return a if dtype == torch.float32 else a.to(dtype).float()

    def mm(a, kernel, bias):
        return cast(a) @ cast(kernel).t() + bias

    z, eps = data["z"], data["eps"]
    x_t = data["sa"] * z + data["s1a"] * eps
    args = data["t_f"] * data["freqs"]
    sin_emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    t_base = mm(_swish(mm(sin_emb, w["wt1"], w["bt1"])), w["wt2"], w["bt2"])

    e_c = cast(w["table"])[data["labels"].long()]
    c_base = mm(_swish(mm(e_c, w["wc1"], w["bc1"])), w["wc2"], w["bc2"])
    c_base = c_base * data["cond_mask"]

    h = mm(x_t, w["wl"], w["bl"])
    for i, s in enumerate(stages):
        h = h + mm(t_base + c_base, s["wt"], 2.0 * s["bt"])
        blk = _ln(mm(h, s["wb"], s["bb"]), s["g1"], s["b1"]) * data["m_blk"][i]
        h = h + _swish(blk)
        v = mm(_ln(h, s["g2"], s["b2"]), s["wv"], s["bv"]) * data["m_attn"][i]
        h = h + mm(v, s["wo"], s["bo"])
        h = mm(h, s["wd"], s["bd"])

    h = h + mm(t_base, w["wtf"], w["btf"]) + mm(c_base, w["wcf"], w["bcf"])
    h = _ln(h, w["gf"], w["bf"])
    out = h @ w["wf"].t() + w["bf2"]
    if global_skip:
        out = out + torch.sigmoid(w["rw"].reshape(())) * (x_t @ w["wf"].t() + w["bf2"])
    diff = eps - out
    return torch.sqrt((diff * diff).sum(dim=1) + 1e-8).mean()


def weights_spec(model: ConditionalLatentDenoiser) -> List[Tuple[str, torch.Tensor]]:
    """(name, parameter) pairs in the kernel's order: the module's own f32
    parameters (no copies; matrices (out, in), vectors 1-D, `rw` 0-D)."""
    te, ce = model.time_emb, model.cond_emb
    flat = [
        ("wt1", te.lin1.weight), ("bt1", te.lin1.bias),
        ("wt2", te.lin2.weight), ("bt2", te.lin2.bias),
        ("table", ce.embedding.weight),
        ("wc1", ce.lin1.weight), ("bc1", ce.lin1.bias),
        ("wc2", ce.lin2.weight), ("bc2", ce.lin2.bias),
        ("wl", model.latent_proj.weight), ("bl", model.latent_proj.bias),
    ]
    for i in range(model.n_stages):
        attn = model.stage("attn", i)
        mods = (model.stage("time_proj", i), model.stage("block_fc", i),
                model.stage("block_ln", i), model.stage("stage_ln", i),
                attn.v, attn.out, model.stage("downsample", i))
        leaves = [p for m in mods for p in (m.weight, m.bias)]
        flat += [(f"s{i}.{k}", p) for k, p in zip(_STAGE_LEAVES, leaves)]
    flat += [
        ("wtf", model.final_time_proj.weight), ("btf", model.final_time_proj.bias),
        ("wcf", model.final_cond_proj.weight), ("bcf", model.final_cond_proj.bias),
        ("gf", model.final_norm.weight), ("bf", model.final_norm.bias),
        ("wf", model.final.weight), ("bf2", model.final.bias),
        ("rw", model.residual_weight),
    ]
    return flat


def _nest(named: Dict[str, torch.Tensor], n_stages: int) -> Dict:
    """(name -> tensor) mapping into the `forward_loss_plain` weights dict."""
    d: Dict = {k: v for k, v in named.items() if "." not in k}
    d["stages"] = [
        {k.split(".", 1)[1]: v for k, v in named.items() if k.startswith(f"s{i}.")}
        for i in range(n_stages)
    ]
    return d


def grads_to_tree(named_grads: Dict[str, torch.Tensor],
                  model: ConditionalLatentDenoiser) -> Dict[str, torch.Tensor]:
    """A gradient for EVERY parameter of `model`, keyed by parameter name:
    the kernel's leaves, and zero tensors for what it has none for: q and k
    of each stage (attention over one key gives them exactly zero gradient)
    and `residual_weight` without the global skip. Zeros, not None: the
    optimizer decays every leaf, as optax does."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    out = {name: None for name, _ in model.named_parameters()}
    for key, p in weights_spec(model):
        out[by_id[id(p)]] = named_grads[key].reshape(p.shape)
    if not model.global_skip:
        out["residual_weight"] = torch.zeros_like(model.residual_weight)
    for name, p in model.named_parameters():
        if out[name] is None:
            assert ".q." in name or ".k." in name, name
            out[name] = torch.zeros_like(p)
    return out


def kernel_supported(model: ConditionalLatentDenoiser) -> bool:
    return model.num_colors is None and model.shared_cond_proj


# ---------------------------------------------------------------------------
# CUDA launch

_DATA_NAMES = ("z", "t_f", "sa", "s1a", "eps", "labels", "cond_mask", "freqs")
_F32 = torch.float32


def _lib():
    lib = _build.load("train_step")
    if lib.fd_train_step_launch.argtypes is None:  # first use: declare the C signatures
        vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.fd_train_step_workspace_floats.argtypes = [vp]
        lib.fd_train_step_workspace_floats.restype = ll
        lib.fd_step_plan_create.argtypes = [vp] * 4 + [ci, ci, cf, ctypes.POINTER(ci)]
        lib.fd_step_plan_create.restype = vp
        lib.fd_step_plan_free.argtypes = [vp]
        lib.fd_step_plan_free.restype = None
        lib.fd_step_plan_products.argtypes = [vp, ctypes.POINTER(ci), ci]
        lib.fd_step_plan_products.restype = ci
        lib.fd_train_step_launch.argtypes = [vp] * 5
        lib.fd_train_step_launch.restype = ci
        lib.fd_tensor_map_encodes.argtypes = []
        lib.fd_tensor_map_encodes.restype = ll
        lib.fd_gemm_launch.argtypes = ([ci, vp, ll, ll, vp, ll, ll, vp, ci, ci, ci, vp, cf, ci,
                                        vp, vp, vp, cf, ci, ci, vp])
        lib.fd_gemm_launch.restype = ci
        lib.fd_gemm_empty_launch.argtypes = [ci] * 6 + [vp]
        lib.fd_gemm_empty_launch.restype = ci
        lib.fd_product_plan.argtypes = [ci] * 5 + [ll] * 3 + [ci, ctypes.POINTER(ci)]
        lib.fd_product_plan.restype = ci
        lib.fd_splitk_plan.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.fd_splitk_plan.restype = ci
        lib.fd_ln_fwd_launch.argtypes = [vp] * 4 + [ci, vp, vp, vp, vp, ci, ci, cf, vp]
        lib.fd_ln_fwd_launch.restype = ci
        lib.fd_ln_bwd_launch.argtypes = [vp] * 7 + [ci] + [vp] * 5 + [ci, ci, vp]
        lib.fd_ln_bwd_launch.restype = ci
    return lib


def tensor_map_encodes() -> int:
    """Calls of cuTensorMapEncodeTiled in this process so far: the count of
    each kernel library that encodes (train_step, train_epoch) that is loaded.
    A bound step encodes its maps when it is bound and none at a launch."""
    libs = (_build.loaded(name) for name in ("train_step", "train_epoch"))
    return sum(lib.fd_tensor_map_encodes() for lib in libs if lib is not None)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _optr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _lane(dtype: torch.dtype) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the train-step kernel has a bfloat16 and a float32 lane, not {dtype}")
    return int(dtype == torch.float32)


def _expected_shapes(dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """Shapes of the weight leaves in `weights_spec` order, from
    (latent, time_emb, classes, hidden...)."""
    lat, te, classes, hidden = dims[0], dims[1], dims[2], dims[3:]
    shapes = [(2 * te, te), (2 * te,), (te, 2 * te), (te,), (classes, te),
              (te, te), (te,), (te, te), (te,), (hidden[0], lat), (hidden[0],)]
    for d, dn in zip(hidden[:-1], hidden[1:]):
        shapes += [(d, te), (d,), (d, d), (d,), (d,), (d,), (d,), (d,),
                   (d, d), (d,), (d, d), (d,), (dn, d), (dn,)]
    dl = hidden[-1]
    shapes += [(dl, te), (dl,), (dl, te), (dl,), (dl,), (dl,), (lat, dl), (lat,), ()]
    return shapes


def twin_loss_and_grads(w_named: Dict[str, torch.Tensor], data: Dict,
                        masks: Sequence[torch.Tensor], *,
                        dtype: torch.dtype = torch.bfloat16, global_skip: bool = False):
    """(loss, {name: gradient}) by torch autograd on the plain twin, on
    whatever device the tensors lie; a leaf the loss does not reach (`rw`
    without the global skip) gets zeros."""
    names = list(w_named)
    n_stages = len(masks) // 2
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w_named.items()}
    d = dict(data, m_blk=list(masks[0::2]), m_attn=list(masks[1::2]))
    loss = forward_loss_plain(_nest(leaves, n_stages), d, n_stages=n_stages, dtype=dtype,
                              global_skip=global_skip)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(names, grads)}


def bind_train_step(w_named: Dict[str, torch.Tensor], batch: int, *,
                    dtype: torch.dtype = torch.bfloat16, global_skip: bool = False):
    """The train step with its weights fixed: returns run(data, masks) ->
    (loss, named_grads). `w_named` is dict(weights_spec(model)): the live
    parameters, whose storage the optimizer updates in place.

    CUDA weights: they are checked here, once; the workspace of saved
    activations and the gradient tensors are allocated here, once per
    (batch, widths), and every call writes the SAME loss and gradient
    tensors. CPU weights: `run` is autograd on the plain twin."""
    names = list(w_named)
    n_stages = sum(1 for k in names if k.endswith(".wt"))
    lane = _lane(dtype)
    first = w_named[names[0]]
    if not first.is_cuda:
        return lambda data, masks: twin_loss_and_grads(
            w_named, data, masks, dtype=dtype, global_skip=global_skip)

    dev = first.device
    te = w_named["wt2"].shape[0]
    classes = w_named["table"].shape[0]
    hidden = ([w_named["wl"].shape[0]]
              + [w_named[f"s{i}.wd"].shape[0] for i in range(n_stages)])
    lat = w_named["wl"].shape[1]
    if te % 2:
        raise ValueError(f"time_emb_dim {te} must be even")
    if global_skip and hidden[-1] != lat:
        raise ValueError("global_skip needs hidden_dims[-1] == latent_dim")
    expected = _expected_shapes([lat, te, classes] + hidden)
    if len(expected) != len(names):
        raise ValueError(f"expected {len(expected)} weight leaves, got {len(names)}")
    for name, shape in zip(names, expected):
        _check(name, w_named[name], shape, _F32, dev)
    weights = [w_named[k] for k in names]
    grads = [torch.zeros_like(w) for w in weights]
    dims = (ctypes.c_int * (6 + n_stages))(batch, lat, te, classes, n_stages, *hidden)
    lib = _lib()
    n_floats = lib.fd_train_step_workspace_floats(dims)
    if n_floats <= 0:
        raise ValueError(f"the train-step kernel takes a batch of at least 1, an even "
                         f"time_emb_dim and 1 to 65536 stages, got dims {list(dims)}")
    workspace = torch.empty(n_floats, dtype=_F32, device=dev)
    loss = torch.zeros((), dtype=_F32, device=dev)
    err = ctypes.c_int()
    plan = lib.fd_step_plan_create(_ptr_array(weights), _ptr_array(grads), workspace.data_ptr(),
                                   dims, lane, int(global_skip), LN_EPS, ctypes.byref(err))
    if not plan:
        _build.check(err.value or 1, "train_step plan")
    shapes = {"z": (batch, lat), "eps": (batch, lat), "labels": (batch,),
              "freqs": (1, te // 2)}
    named_grads = dict(zip(names, grads))

    def run(data, masks):
        if len(masks) != 2 * n_stages:
            raise ValueError(f"expected {2 * n_stages} masks, got {len(masks)}")
        tensors = []
        for k in _DATA_NAMES:
            want = torch.int32 if k == "labels" else _F32
            _check(k, data[k], shapes.get(k, (batch, 1)), want, dev)
            tensors.append(data[k])
        for i, m in enumerate(masks):
            _check(f"mask {i}", m, (batch, hidden[i // 2]), _F32, dev)
        code = lib.fd_train_step_launch(plan, _ptr_array(tensors), _ptr_array(masks),
                                        loss.data_ptr(), _stream(dev))
        _build.check(code, "train_step")
        kernel_loss_and_grads.launches += 1
        return loss, named_grads

    def products() -> List[Dict[str, object]]:
        """The plan's products in launch order: form, (m, n, k), the line
        strides of A, B and C, and the kernel, split, kc and blocks."""
        n = lib.fd_step_plan_products(plan, None, 0)
        rows = (ctypes.c_int * (n * 11))()
        lib.fd_step_plan_products(plan, rows, n)
        return [{"form": _FORM_NAMES[r[0]], "mnk": tuple(r[1:4]), "strides": tuple(r[4:7]),
                 "kernel": PRODUCT_KERNELS[r[7]], "split": r[8], "kc": r[9], "blocks": r[10]}
                for r in (rows[i * 11:(i + 1) * 11] for i in range(n))]

    # what the plan points at, alive as long as run; the plan (routes and
    # tensor maps) is freed with run. The epoch kernel (kernels/train_epoch.py)
    # enqueues the same step from the same plan.
    weakref.finalize(run, lib.fd_step_plan_free, plan)
    run.weights, run.grads, run.workspace = weights, grads, workspace
    run.plan, run.products = plan, products
    return run


def kernel_loss_and_grads(w_named: Dict[str, torch.Tensor], data: Dict,
                          masks: Sequence[torch.Tensor], *,
                          dtype: torch.dtype = torch.bfloat16, global_skip: bool = False):
    """(loss, {name: f32 gradient}) of `forward_loss_plain` for the named
    weights. A one-off `bind_train_step(...)(data, masks)`: the kernels for
    CUDA weights, autograd on the twin for CPU weights."""
    run = bind_train_step(w_named, data["z"].shape[0], dtype=dtype, global_skip=global_skip)
    return run(data, masks)


kernel_loss_and_grads.launches = 0


def splitk_plan(k: int) -> Tuple[int, int]:
    """(s, kc) of the bf16 lane's Y and dX products over K = k, as the
    library plans them (`splitk_plan` in csrc/train_step.cuh): clusters of s
    blocks, block r summing k in [r kc, r kc + kc) and finishing rows
    [r 64 / s, (r + 1) 64 / s) of the 64-row output tile."""
    s, kc = ctypes.c_int(), ctypes.c_int()
    _build.check(_lib().fd_splitk_plan(k, ctypes.byref(s), ctypes.byref(kc)), "splitk plan")
    return s.value, kc.value


# The three forms of the product and the LayerNorm kernels, alone (tests).

# kernels of `product_plan` in csrc/train_step.cuh, by their number there
PRODUCT_KERNELS = ("fma", "splitk", "wgmma", "mma_dw")
_FORMS = {"fwd": 0, "dx": 1, "dw": 2}
_FORM_NAMES = ("fwd", "dx", "dw")
_ROUTES = {"plan": 0, "splitk": 1, "wgmma": 2, "mma_dw": 3}


def contiguous_strides(form: str, m: int, n: int, k: int) -> Tuple[int, int, int]:
    """Line strides (elements) of A, B and C of a product of this form on
    contiguous tensors: fwd reads X (m, k) and W (n, k); dx dY (m, k) and
    W (k, n); dw dY (k, m) and X (k, n); C is (m, n)."""
    return (m if form == "dw" else k), (k if form == "fwd" else n), n


def product_plan(form: str, m: int, n: int, k: int, *, exact: bool = False,
                 route: str = "plan",
                 strides: Optional[Tuple[int, int, int]] = None) -> Dict[str, object]:
    """Where the library sends a product of form "fwd" (Y = X W^T + b), "dx"
    (dY W) or "dw" (dY^T X) with C (m, n) and depth k: {"kernel": "fma" (the
    f32 lane), "splitk", "wgmma" or "mma_dw", "tile": (tile_m, tile_n),
    "split": blocks a cluster, "kc": k's a block sums, "blocks": blocks
    launched} (`fd_product_plan`). `strides`: the line strides of A, B and C
    (default: contiguous tensors); a stride that is not a whole number of
    16-byte units keeps the product off "wgmma". `route` forces a kernel, as
    `linear_forward(..., route=)` does; a route the product cannot take
    (wgmma on such a stride, splitk for dw, mma_dw for fwd or dx) raises."""
    a_ld, b_ld, c_ld = strides or contiguous_strides(form, m, n, k)
    out = (ctypes.c_int * 6)()
    _build.check(_lib().fd_product_plan(int(exact), _FORMS[form], m, n, k, a_ld, b_ld, c_ld,
                                        _ROUTES[route], out), "product plan")
    return {"kernel": PRODUCT_KERNELS[out[0]], "tile": (out[1], out[2]), "split": out[3],
            "kc": out[4], "blocks": out[5]}


def product_empty_launcher(form: str, m: int, n: int, k: int, *, exact: bool = False,
                           route: str = "plan"):
    """A call that launches an empty kernel on the product's grid, block,
    shared memory and cluster (`fd_gemm_empty_launch`; contiguous tensors):
    its launch floor."""
    lib = _lib()

    def launch():
        code = lib.fd_gemm_empty_launch(_FORMS[form], m, n, k, int(exact), _ROUTES[route],
                                        _stream(torch.cuda.current_device()))
        _build.check(code, "empty product launch")
    return launch


def _gemm(form, a, a_sm, a_sk, b, b_sn, b_sk, m, n, k, *, exact, bias=None, bias_scale=1.0,
          round_bf16=False, mul=None, res=None, colsum=None, colsum_scale=1.0, route="plan"):
    c = torch.empty((m, n), dtype=_F32, device=a.device)
    p = _optr
    code = _lib().fd_gemm_launch(_FORMS[form], a.data_ptr(), a_sm, a_sk, b.data_ptr(), b_sn,
                                 b_sk, c.data_ptr(), m, n, k, p(bias), bias_scale,
                                 int(round_bf16), p(mul), p(res), p(colsum), colsum_scale,
                                 int(exact), _ROUTES[route], _stream(a.device))
    _build.check(code, "train_step product")
    return c


def linear_forward(x, w, bias, *, exact: bool, scale: float = 1.0, mul=None, res=None,
                   route: str = "plan"):
    """(x w^T + scale * bias) [* mul] [+ res] by the kernel; w (out, in)."""
    rows, k = x.shape
    return _gemm("fwd", x, k, 1, w, k, 1, rows, w.shape[0], k, exact=exact, bias=bias,
                 bias_scale=scale, mul=mul, res=res, route=route)


def linear_dx(dy, w, *, exact: bool, mul=None, res=None, route: str = "plan"):
    """dy w, rounded to bf16 unless exact, [* mul] [+ res]; w (out, in)."""
    rows, out = dy.shape
    return _gemm("dx", dy, out, 1, w, 1, w.shape[1], rows, w.shape[1], out, exact=exact,
                 round_bf16=not exact, mul=mul, res=res, route=route)


def linear_dw(dy, x, *, exact: bool, scale: float = 1.0, route: str = "plan"):
    """(dy^T x rounded to bf16 unless exact, scale * colsum(dy))."""
    rows, out = dy.shape
    db = torch.empty(out, dtype=_F32, device=dy.device)
    dw = _gemm("dw", dy, 1, out, x, 1, x.shape[1], out, x.shape[1], rows, exact=exact,
               round_bf16=not exact, colsum=db, colsum_scale=scale, route=route)
    return dw, db


def layernorm_forward(x, g, b, *, mask=None, swish: bool = False, res=None,
                      eps: float = LN_EPS):
    """(y, mean, rstd), y = [swish]([mask *] LN(x)) [+ res], by the kernel."""
    rows, d = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=_F32, device=x.device)
    rstd = torch.empty_like(mean)
    p = _optr
    code = _lib().fd_ln_fwd_launch(x.data_ptr(), g.data_ptr(), b.data_ptr(), p(mask),
                                   int(swish), p(res), y.data_ptr(), mean.data_ptr(),
                                   rstd.data_ptr(), rows, d, eps, _stream(x.device))
    _build.check(code, "train_step LayerNorm forward")
    return y, mean, rstd


def layernorm_backward(dy, x, mean, rstd, g, b, *, mask=None, swish: bool = False, res=None):
    """(dx [+ res], dgamma, dbeta) of `layernorm_forward`, by the kernels."""
    rows, d = x.shape
    dx, scratch = torch.empty_like(x), torch.empty_like(x)
    dg = torch.empty(d, dtype=_F32, device=x.device)
    db = torch.empty_like(dg)
    p = _optr
    code = _lib().fd_ln_bwd_launch(dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                                   rstd.data_ptr(), g.data_ptr(), b.data_ptr(), p(mask),
                                   int(swish), p(res), scratch.data_ptr(), dx.data_ptr(),
                                   dg.data_ptr(), db.data_ptr(), rows, d, _stream(x.device))
    _build.check(code, "train_step LayerNorm backward")
    return dx, dg, db


# ---------------------------------------------------------------------------
# The draws and the denoise body

def sinusoid_freqs(time_emb_dim: int, device=None) -> torch.Tensor:
    half = time_emb_dim // 2
    k = torch.arange(half, dtype=_F32, device=device)
    return torch.exp(k * (-math.log(10000.0) / (half - 1))).reshape(1, half)


def draw_step_inputs(model: ConditionalLatentDenoiser, n_steps: int, cond_dropout: float,
                     z: torch.Tensor, generator: Optional[torch.Generator] = None):
    """One step's randomness, in a fixed order from one generator on z's
    device: t (B,) integers in [0, n_steps), eps like z, the condition
    keep-mask (B,) of 0/1 floats (ones when cond_dropout is 0), and the
    dropout masks [m_blk_0, m_attn_0, m_blk_1, ...]: the block mask (B, d_i),
    the attention mask one draw a (sample, head) repeated over d_i / 8
    columns, both scaled by 1 / (1 - rate); ones at rate 0."""
    b, dev = z.shape[0], z.device
    t = torch.randint(0, n_steps, (b,), generator=generator, device=dev)
    eps = torch.randn(z.shape, generator=generator, device=dev, dtype=z.dtype)
    keep = torch.ones(b, dtype=_F32, device=dev)
    if cond_dropout > 0.0:
        keep = (torch.rand(b, generator=generator, device=dev) >= cond_dropout).float()
    rate = model.dropout_rate
    masks = []
    for i in range(model.n_stages):
        d = model.hidden_dims[i]
        if rate > 0.0:
            scale = 1.0 / (1.0 - rate)
            mb = (torch.rand((b, d), generator=generator, device=dev) >= rate).float() * scale
            ma = (torch.rand((b, HEADS), generator=generator, device=dev) >= rate).float() * scale
            masks += [mb, ma.repeat_interleave(d // HEADS, dim=1)]
        else:
            masks += [torch.ones((b, d), dtype=_F32, device=dev) for _ in range(2)]
    return t, eps, keep, masks


def step_data(sched, z, labels, t, eps, keep, freqs) -> Dict[str, torch.Tensor]:
    """The kernel's data dict from one step's draws; sa and s1a are read from
    the schedule's alpha_bar here, outside the kernel."""
    abar = sched.alpha_bar[t][:, None].float()
    return {"z": z.float().contiguous(), "t_f": t.float()[:, None], "sa": torch.sqrt(abar),
            "s1a": torch.sqrt(1.0 - abar), "eps": eps.float().contiguous(),
            "labels": labels.to(torch.int32).contiguous(), "cond_mask": keep[:, None].float(),
            "freqs": freqs}


def make_kernel_denoise_body(model: ConditionalLatentDenoiser, cfg,
                             dtype: torch.dtype = torch.bfloat16):
    """The train step on pre-encoded latents, backed by the kernel:
    denoise(state, sched, z, labels, colors, generator, draws=None) -> loss
    (a 0-d tensor on the device; the state is updated in place). The
    optimizer is the state's own chain (clip, AdamW, EMA). `draws` injects
    (t, eps, keep, masks) in place of `draw_step_inputs`."""
    if not kernel_supported(model):
        raise ValueError("the fused train kernel supports shared_cond_proj "
                         "single-condition variants (v1/v2) only")
    _lane(dtype)
    bound = {}  # (batch, device) -> (launcher, freqs, the full gradient tree)

    def denoise(state, sched, z, labels, colors, generator=None, draws=None):
        if colors is not None:
            raise ValueError("the fused train kernel takes no color labels")
        if draws is None:
            draws = draw_step_inputs(model, sched.n_steps, cfg.cond_dropout, z, generator)
        t, eps, keep, masks = draws
        key = (z.shape[0], z.device)
        if key not in bound:
            bound[key] = (bind_train_step(dict(weights_spec(model)), z.shape[0], dtype=dtype,
                                          global_skip=model.global_skip),
                          sinusoid_freqs(model.time_emb_dim, z.device), None)
        run, freqs, tree = bound[key]
        loss, named_grads = run(step_data(sched, z, labels, t, eps, keep, freqs), masks)
        if tree is None or not z.is_cuda:
            # on the card every launch writes the same gradient tensors, so
            # the tree (with its zero leaves) is built once
            tree = grads_to_tree(named_grads, model)
            bound[key] = (run, freqs, tree)
        loss = loss.clone()  # the kernel's loss tensor is rewritten by the next step
        state.apply_gradients(tree)
        return loss

    return denoise
