"""Weight bridge: flax-named numpy parameter trees -> the port's modules.

Takes a NUMPY tree in the reference's flax naming (`{"params": {...}}` or
bare) — from a checkpoint restored elsewhere, from the reference's tests, or
from `init_numpy_params` — and loads it into the port's modules by name.
Layout rules (the port's own copy of the reference's conversion rules):

  Dense kernel (in, out)             -> Linear weight (out, in)
  Conv kernel HWIO                   -> Conv2d weight OIHW
  ConvTranspose kernel (kh,kw,in,out)-> ConvTranspose2d weight (in,out,kh,kw),
                                        spatially flipped
  packed qkv kernel (d, 3d)          -> three Linears q, k, v
  Embed / LayerNorm / GroupNorm      -> weight (scale) and bias
  decoder fc2 output rows + fc2_ln   -> permuted HWC-major -> CHW-major, since
                                        the port reshapes fc2's output NCHW
  encoder mu_fc1 / logvar_fc1 input  -> permuted the same way, since the port
                                        flattens the conv features NCHW

`state_dict_to_flax` is the inverse map: a module (the denoiser, a
FlowerVAE, a Discriminator64), or a dict keyed like its state dict
(gradients, EMA weights, Adam moments) with that module, back to a
flax-named numpy tree in flax layouts, so that it can be held against the
reference's trees leaf by leaf and loaded into the reference's modules.

`init_numpy_params` builds a full flax-named tree from a seed, without JAX:
kaiming-normal kernels (std sqrt(2 / 1.04 / fan_in)), LayerNorm scales of 1,
and small NONZERO biases by default, so that checks of classifier-free
guidance see the bias terms a null condition still adds (bias_std=0 gives
the reference's initial distribution, zero biases).
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from flowerdiff_torch.core.attention import MultiHeadSelfAttention
from flowerdiff_torch.core.layers import LayerNorm2d, kaiming_std
from flowerdiff_torch.models.discriminator import WIDTHS as DISC_WIDTHS
from flowerdiff_torch.models.discriminator import Discriminator64
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.utils.device import resolve_device

_CONV_TRANSPOSE = re.compile(r"up\d+_conv$")


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def _leaf_params(path: str, name: str, leaf: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One flax module's parameter dict -> torch state-dict entries."""
    prefix = f"{path}{name}"
    out: Dict[str, np.ndarray] = {}
    if "kernel" in leaf:
        k = np.asarray(leaf["kernel"], np.float32)
        if k.ndim == 2 and name == "qkv":
            d = k.shape[0]
            b = np.asarray(leaf["bias"], np.float32)
            for j, part in enumerate("qkv"):
                out[f"{path}{part}.weight"] = k[:, j * d:(j + 1) * d].T
                out[f"{path}{part}.bias"] = b[j * d:(j + 1) * d]
            return out
        if k.ndim == 2:
            out[f"{prefix}.weight"] = k.T
        elif _CONV_TRANSPOSE.search(name):
            out[f"{prefix}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            out[f"{prefix}.weight"] = k.transpose(3, 2, 0, 1)
        if "bias" in leaf:
            out[f"{prefix}.bias"] = leaf["bias"]
    elif "embedding" in leaf:
        out[f"{prefix}.weight"] = leaf["embedding"]
    elif "scale" in leaf:  # flax LayerNorm / GroupNorm
        out[f"{prefix}.weight"] = leaf["scale"]
        out[f"{prefix}.bias"] = leaf["bias"]
    else:  # LayerNorm2d keeps torch's names
        out.update({f"{prefix}.{k}": v for k, v in leaf.items()})
    return out


def flax_to_state_dict(tree: Dict[str, Any], path: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax-named numpy tree into a torch state dict (no layout
    permutations beyond the per-layer rules above)."""
    out: Dict[str, Any] = {}
    for name, value in _unwrap(tree).items():
        if isinstance(value, dict):
            if all(not isinstance(v, dict) for v in value.values()):
                out.update(_leaf_params(path, name, value))
            else:
                out.update(flax_to_state_dict(value, f"{path}{name}."))
        else:  # a bare parameter, e.g. residual_weight
            out[f"{path}{name}"] = value
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32)))
            for k, v in out.items()}


def hwc_to_chw_index(c: int, h: int, w: int) -> np.ndarray:
    """idx[chw_position] = hwc_position for a flattened (H, W, C) vector."""
    return np.arange(h * w * c).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)


def load_denoiser(model: ConditionalLatentDenoiser, tree: Dict[str, Any]) -> ConditionalLatentDenoiser:
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    return model


# The FlowerVAE entries whose rows (or columns) the port orders CHW-major
# where the reference orders them HWC-major.
_VAE_ROWS = ("decoder.fc2.weight", "decoder.fc2.bias", "decoder.fc2_ln.weight",
             "decoder.fc2_ln.bias")
_VAE_COLS = ("encoder.mu_fc1.weight", "encoder.logvar_fc1.weight")


def _vae_index(vae: FlowerVAE) -> torch.Tensor:
    dec = vae.decoder
    return torch.from_numpy(hwc_to_chw_index(dec.channels[-1], dec.base_size, dec.base_size))


def load_vae(vae: FlowerVAE, tree: Dict[str, Any]) -> FlowerVAE:
    """Load the decoder of a FlowerVAE tree and, where the tree and the
    module hold them, the encoder and the classifier head. A part the tree
    lacks keeps the module's weights; a classifier the module lacks is
    ignored."""
    params = _unwrap(tree)
    sd = flax_to_state_dict(params["decoder"], "decoder.")
    idx = _vae_index(vae)
    for key in _VAE_ROWS:
        sd[key] = sd[key][idx].contiguous()
    for part in ("encoder", "classifier"):
        if part == "classifier" and vae.classifier is None:
            continue
        if part in params:
            sd.update(flax_to_state_dict(params[part], f"{part}."))
        else:
            sd.update({k: v for k, v in vae.state_dict().items() if k.startswith(f"{part}.")})
    if "encoder" in params:
        for key in _VAE_COLS:
            sd[key] = sd[key][:, idx].contiguous()
    vae.load_state_dict(sd, strict=True)
    return vae


def load_discriminator(disc: Discriminator64, tree: Dict[str, Any]) -> Discriminator64:
    """A Discriminator64 tree (conv0-3, norm1-3, head) into the module."""
    disc.load_state_dict(flax_to_state_dict(tree), strict=True)
    return disc


def _put(tree: Dict[str, Any], path, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def state_dict_to_flax(source, module: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """A module, or a dict keyed like its state dict (gradients, EMA
    weights, Adam moments: give the module as `module`), as a flax-named
    numpy tree in flax layouts, the inverse of the loaders, by the type of
    the module that owns each entry: Linear weights transposed to (in, out)
    kernels, conv weights to HWIO (transposed convs flipped back),
    LayerNorm / GroupNorm weight -> scale, Embedding weight -> embedding,
    an attention's q/k/v packed into one `qkv` Dense; for a FlowerVAE the
    reference's HWC-major rows and columns restored."""
    if isinstance(source, torch.nn.Module):
        module, sd = source, source.state_dict()
    elif module is None:
        raise ValueError("state_dict_to_flax: give the module a dict is keyed like")
    else:
        sd = source
    flat = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)
            for k, v in sd.items()}
    if isinstance(module, FlowerVAE):
        inv = np.argsort(_vae_index(module).numpy())
        for key in _VAE_ROWS:
            flat[key] = flat[key][inv]
        for key in _VAE_COLS:
            flat[key] = flat[key][:, inv]
    owners = dict(module.named_modules())
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        if "." not in key:  # a bare parameter, e.g. residual_weight
            _put(tree, [key], value)
            continue
        path, leaf = key.rsplit(".", 1)
        owner, parts = owners[path], path.split(".")
        parent = owners.get(path.rpartition(".")[0])
        if isinstance(parent, MultiHeadSelfAttention) and parts[-1] in ("q", "k", "v"):
            if parts[-1] == "q":  # k and v are packed with it
                qkv = [flat[f"{path[:-1]}{p}.{leaf}"] for p in "qkv"]
                _put(tree, parts[:-1] + ["qkv", "kernel" if leaf == "weight" else "bias"],
                     np.concatenate([w.T for w in qkv], axis=1) if leaf == "weight"
                     else np.concatenate(qkv))
        elif isinstance(owner, torch.nn.ConvTranspose2d) and leaf == "weight":
            _put(tree, parts + ["kernel"], value.transpose(2, 3, 0, 1)[::-1, ::-1].copy())
        elif isinstance(owner, torch.nn.Conv2d) and leaf == "weight":
            _put(tree, parts + ["kernel"], value.transpose(2, 3, 1, 0).copy())
        elif isinstance(owner, torch.nn.Linear) and leaf == "weight":
            _put(tree, parts + ["kernel"], value.T.copy())
        elif isinstance(owner, torch.nn.Embedding):
            _put(tree, parts + ["embedding"], value)
        elif isinstance(owner, (torch.nn.LayerNorm, torch.nn.GroupNorm)) and leaf == "weight":
            _put(tree, parts + ["scale"], value)
        elif leaf == "bias" or isinstance(owner, LayerNorm2d):
            _put(tree, parts + [leaf], value)
        else:
            raise ValueError(f"state_dict_to_flax: no rule for {key} {value.shape}")
    return tree


def load_adam_moments(state, mu: Dict[str, Any], nu: Dict[str, Any], count: int) -> None:
    """Adam's moments and step count into a train state (an `AdamState`,
    as `LatentTrainState`), in place, from
    flax-named numpy trees laid out like the weights (optax's `mu` / `nu`,
    the packed `qkv` included)."""
    for dst, tree in ((state.mu, mu), (state.nu, nu)):
        flat = flax_to_state_dict(tree)
        if set(flat) != set(state.names):
            raise ValueError("the moment tree's leaves are not the state's parameters")
        for name, t in zip(state.names, dst):
            t.copy_(flat[name].reshape(t.shape))
    state.step = int(count)


def adam_moments_to_flax(state):
    """(mu, nu, count) of an `AdamState` as flax-named numpy trees: the
    inverse of `load_adam_moments`."""
    return (state_dict_to_flax(dict(zip(state.names, state.mu)), state.module),
            state_dict_to_flax(dict(zip(state.names, state.nu)), state.module), int(state.step))


def denoiser_from_params(tree: Dict[str, Any], device=None, **config) -> ConditionalLatentDenoiser:
    """ConditionalLatentDenoiser(**config) holding `tree`'s weights, in eval
    mode on `device` (default cuda)."""
    dev = resolve_device(device)
    model = load_denoiser(ConditionalLatentDenoiser(**config), tree)
    return model.to(dev).eval()


def vae_from_params(tree: Dict[str, Any], device=None, **config) -> FlowerVAE:
    dev = resolve_device(device)
    return load_vae(FlowerVAE(**config), tree).to(dev).eval()


# --------------------------------------------------------------------------
# Seeded full-width parameter trees, without JAX.

class _Init:
    def __init__(self, seed: int, bias_std: float = 0.05):
        self.rng = np.random.default_rng(seed)
        self.bias_std = bias_std

    def _normal(self, shape, std):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def bias(self, n):
        return self._normal((n,), self.bias_std)

    def dense(self, fan_in, fan_out, bias=True):
        p = {"kernel": self._normal((fan_in, fan_out), kaiming_std(fan_in))}
        if bias:
            p["bias"] = self.bias(fan_out)
        return p

    def conv(self, k, cin, cout, bias=True):
        p = {"kernel": self._normal((k, k, cin, cout), kaiming_std(k * k * cin))}
        if bias:
            p["bias"] = self.bias(cout)
        return p

    def norm(self, n):  # flax LayerNorm / GroupNorm
        return {"scale": np.ones((n,), np.float32), "bias": self.bias(n)}

    def ln2d(self, n):
        return {"weight": np.ones((n,), np.float32), "bias": self.bias(n)}

    def embed(self, num, features):
        return {"embedding": self._normal((num, features), 1.0 / math.sqrt(features))}

    def res_block(self, ch):
        return {
            "conv1": self.conv(3, ch, ch), "ln1": self.ln2d(ch),
            "conv2": self.conv(3, ch, ch), "ln2": self.ln2d(ch),
            "ca": {"squeeze": self.dense(ch, ch // 8, bias=False),
                   "excite": self.dense(ch // 8, ch, bias=False)},
            "sa": {"conv": self.conv(7, 2, 1, bias=False)},
        }


def _denoiser_tree(ini: _Init, latent_dim: int = 256,
                   hidden_dims: Sequence[int] = (256, 512, 1024, 512, 256),
                   time_emb_dim: int = 256, num_classes: int = 102,
                   num_colors: Optional[int] = None,
                   shared_cond_proj: bool = True, global_skip: bool = False):
    e, hidden = time_emb_dim, tuple(hidden_dims)
    p: Dict[str, Any] = {
        "time_emb": {"lin1": ini.dense(e, 2 * e), "lin2": ini.dense(2 * e, e)},
    }
    if num_colors is not None:
        p["cond_emb"] = {"flower_embedding": ini.embed(num_classes, e),
                         "color_embedding": ini.embed(num_colors, e),
                         "proj": ini.dense(2 * e, e)}
    else:
        p["cond_emb"] = {"embedding": ini.embed(num_classes, e),
                         "lin1": ini.dense(e, e), "lin2": ini.dense(e, e)}
    p["latent_proj"] = ini.dense(latent_dim, hidden[0])
    for i in range(len(hidden) - 1):
        d = hidden[i]
        p[f"time_proj_{i}"] = ini.dense(e, d)
        if not shared_cond_proj:
            p[f"cond_proj_{i}"] = ini.dense(e, d)
        p[f"block_fc_{i}"] = ini.dense(d, d)
        p[f"block_ln_{i}"] = ini.norm(d)
        p[f"stage_ln_{i}"] = ini.norm(d)
        p[f"attn_{i}"] = {"qkv": ini.dense(d, 3 * d), "out": ini.dense(d, d)}
        p[f"downsample_{i}"] = ini.dense(d, hidden[i + 1])
    p["final_time_proj"] = ini.dense(e, hidden[-1])
    p["final_cond_proj"] = ini.dense(e, hidden[-1])
    p["final_norm"] = ini.norm(hidden[-1])
    p["final"] = ini.dense(hidden[-1], latent_dim)
    p["residual_weight"] = np.asarray(0.1, np.float32)
    return p


def _decoder_tree(ini: _Init, latent_dim: int = 256, in_channels: int = 3,
                  channels: Sequence[int] = (64, 128, 256, 512),
                  head_width: int = 512, base_size: int = 8):
    ch = tuple(channels)
    deep, n_ups = ch[-1], len(ch) - 1
    p: Dict[str, Any] = {
        "fc1": ini.dense(latent_dim, head_width), "fc1_ln": ini.norm(head_width),
        "fc2": ini.dense(head_width, deep * base_size**2),
        "fc2_ln": ini.norm(deep * base_size**2),
        f"res{n_ups}": ini.res_block(deep),
    }
    prev = deep
    for i in range(n_ups, 0, -1):
        c = ch[i - 1]
        p[f"up{i}_conv"] = ini.conv(4, prev, c)
        p[f"up{i}_gn"] = ini.norm(c)
        if i > 1:
            p[f"res{i - 1}"] = ini.res_block(c)
        prev = c
    mid = max(4, ch[0] // 2)
    p["final_conv1"] = ini.conv(3, prev, mid)
    p["final_gn"] = ini.norm(mid)
    p["final_conv2"] = ini.conv(3, mid, in_channels)
    return {"decoder": p}


def _encoder_tree(ini: _Init, latent_dim: int = 256, in_channels: int = 3,
                  channels: Sequence[int] = (64, 128, 256, 512),
                  head_width: int = 512, base_size: int = 8):
    ch = tuple(channels)
    p: Dict[str, Any] = {"stem_conv": ini.conv(3, in_channels, ch[0]),
                         "stem_ln": ini.ln2d(ch[0])}
    for i in range(1, len(ch)):
        p[f"down{i}_conv"] = ini.conv(4, ch[i - 1], ch[i])
        p[f"down{i}_ln"] = ini.ln2d(ch[i])
        p[f"res{i}"] = ini.res_block(ch[i])
    flat = ch[-1] * base_size**2
    for name in ("mu", "logvar"):
        p[f"{name}_fc1"] = ini.dense(flat, head_width)
        p[f"{name}_ln"] = ini.norm(head_width)
        p[f"{name}_fc2"] = ini.dense(head_width, latent_dim)
    return {"encoder": p}


def _classifier_tree(ini: _Init, latent_dim: int = 256, num_classes: int = 102):
    return {"classifier": {"fc1": ini.dense(latent_dim, 512), "ln1": ini.norm(512),
                           "fc2": ini.dense(512, 256), "ln2": ini.norm(256),
                           "out": ini.dense(256, num_classes)}}


def _discriminator_tree(ini: _Init, in_channels: int = 3):
    p: Dict[str, Any] = {}
    prev = in_channels
    for i, ch in enumerate(DISC_WIDTHS):
        p[f"conv{i}"] = ini.conv(4, prev, ch)
        if i > 0:
            p[f"norm{i}"] = ini.norm(ch)
        prev = ch
    p["head"] = ini.conv(4, prev, 1)
    return p


def init_numpy_params(kind: str, seed: int = 0, bias_std: float = 0.05,
                      **config) -> Dict[str, Any]:
    """A seeded flax-named numpy tree, `{"params": {...}}`.

    kind: "denoiser" (ConditionalLatentDenoiser config keywords); "vae"
    (FlowerVAE config keywords; the tree holds the decoder and, drawn after
    it, the encoder); "generator" (the same, plus `num_classes`, and the
    classifier head drawn after the encoder: the reference's `init_all`
    tree); "discriminator" (Discriminator64, `in_channels`)."""
    ini = _Init(seed, bias_std)
    if kind == "denoiser":
        return {"params": _denoiser_tree(ini, **config)}
    if kind in ("vae", "generator"):
        config = dict(config)
        num_classes = config.pop("num_classes", 102)
        tree = {**_decoder_tree(ini, **config), **_encoder_tree(ini, **config)}
        if kind == "generator":
            tree.update(_classifier_tree(ini, config.get("latent_dim", 256), num_classes))
        return {"params": tree}
    if kind == "discriminator":
        return {"params": _discriminator_tree(ini, **config)}
    raise ValueError(f"unknown kind {kind!r}; choose 'denoiser', 'vae', 'generator' "
                     "or 'discriminator'")
