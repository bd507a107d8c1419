"""Seeded weights and latent statistics, made on the device from the seed.

The names and shapes follow the configuration file alone (the published
module names: `latent_proj`, `time_proj_i`, `block_fc_i`, `attn_i.{q,k,v,out}`,
`downsample_i`, `final_*` for the denoiser; `fc1`, `res3.conv1`, `up3_conv`,
... for the decoder). Every tensor is cut out of one `torch.randn` call of
a generator on the device and scaled: matrices and kernels by
1/sqrt(fan-in), biases by 0.02, LayerNorm and GroupNorm gains 1 + 0.1 z and
their shifts 0.1 z, embeddings unit normals; the z-score statistics are a
mean of 0.5 z and a std of exp(0.3 z). The port and the reference are each
given weights made here from the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, kind): kind is "w" (fan-in scaled, fan-in given), "b", "g", "s"
# (a norm's shift), "e" (embedding), "r" (a scalar weight)
Layout = List[Tuple[str, tuple, str, int]]


def _linear(name: str, out: int, inp: int, bias: bool = True) -> Layout:
    rows = [(f"{name}.weight", (out, inp), "w", inp)]
    return rows + ([(f"{name}.bias", (out,), "b", 0)] if bias else [])


def _norm(name: str, width: int) -> Layout:
    return [(f"{name}.weight", (width,), "g", 0), (f"{name}.bias", (width,), "s", 0)]


def denoiser_layout(cfg: dict) -> Layout:
    lat, hid, temb = cfg["latent_dim"], cfg["hidden_dims"], cfg["time_emb_dim"]
    out: Layout = []
    out += _linear("time_emb.lin1", 2 * temb, temb) + _linear("time_emb.lin2", temb, 2 * temb)
    out += [("cond_emb.embedding.weight", (cfg["num_classes"], temb), "e", 0)]
    out += _linear("cond_emb.lin1", temb, temb) + _linear("cond_emb.lin2", temb, temb)
    out += _linear("latent_proj", hid[0], lat)
    for i, (d, dout) in enumerate(zip(hid[:-1], hid[1:])):
        out += _linear(f"time_proj_{i}", d, temb)
        if not cfg["shared_cond_proj"]:
            out += _linear(f"cond_proj_{i}", d, temb)
        out += _linear(f"block_fc_{i}", d, d)
        out += _norm(f"block_ln_{i}", d) + _norm(f"stage_ln_{i}", d)
        for part in ("q", "k", "v", "out"):
            out += _linear(f"attn_{i}.{part}", d, d)
        out += _linear(f"downsample_{i}", dout, d)
    out += _linear("final_time_proj", hid[-1], temb) + _linear("final_cond_proj", hid[-1], temb)
    out += _norm("final_norm", hid[-1]) + _linear("final", lat, hid[-1])
    out += [("residual_weight", (), "r", 0)]
    return out


def _conv(name: str, out: int, inp: int, k: int, bias: bool = True) -> Layout:
    rows = [(f"{name}.weight", (out, inp, k, k), "w", inp * k * k)]
    return rows + ([(f"{name}.bias", (out,), "b", 0)] if bias else [])


def _residual(name: str, c: int) -> Layout:
    return (_conv(f"{name}.conv1", c, c, 3) + _norm(f"{name}.ln1", c)
            + _conv(f"{name}.conv2", c, c, 3) + _norm(f"{name}.ln2", c)
            + _linear(f"{name}.ca.squeeze", c // 8, c, bias=False)
            + _linear(f"{name}.ca.excite", c, c // 8, bias=False)
            + _conv(f"{name}.sa.conv", 1, 2, 7, bias=False))


def decoder_layout(cfg: dict) -> Layout:
    ch, base, head = cfg["channels"], cfg["base_size"], cfg["head_width"]
    flat = ch[-1] * base * base
    out: Layout = _linear("fc1", head, cfg["latent_dim"]) + _norm("fc1_ln", head)
    out += _linear("fc2", flat, head) + _norm("fc2_ln", flat)
    n = len(ch) - 1
    out += _residual(f"res{n}", ch[-1])
    prev = ch[-1]
    for i in range(n, 0, -1):
        c = ch[i - 1]
        # a stride-2 4x4 transposed convolution feeds each output from
        # prev x 2 x 2 inputs; its weight is (in, out, k, k)
        out += [(f"up{i}_conv.weight", (prev, c, 4, 4), "w", prev * 4),
                (f"up{i}_conv.bias", (c,), "b", 0)] + _norm(f"up{i}_gn", c)
        if i > 1:
            out += _residual(f"res{i - 1}", c)
        prev = c
    mid = max(4, ch[0] // 2)
    out += _conv("final_conv1", mid, prev, 3) + _norm("final_gn", mid)
    out += _conv("final_conv2", cfg["out_channels"], mid, 3)
    return out


def _seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1, np.uint64)[0]) >> 1


def _fill(layout: Layout, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape, kind, fan in layout:
        n = int(np.prod(shape, dtype=np.int64))
        v = z[at:at + n].view(shape)
        at += n
        if kind == "w":
            v = v * fan**-0.5
        elif kind == "b":
            v = v * 0.02
        elif kind == "g":
            v = v * 0.1 + 1.0
        elif kind == "s":
            v = v * 0.1
        elif kind == "r":
            v = v * 0.5
        out[name] = v.contiguous()
    return out


def make(cfg: dict, seed: int, device) -> Tuple[Dict[str, Dict[str, torch.Tensor]], tuple]:
    """({'denoiser': ..., 'decoder': ...}, (mean, std)) for configuration
    `cfg` and `seed`, f32 on `device`, from one generator there."""
    layouts = {"denoiser": denoiser_layout(cfg["denoiser"]),
               "decoder": decoder_layout(cfg["decoder"])}
    lat = cfg["denoiser"]["latent_dim"]
    total = sum(int(np.prod(s, dtype=np.int64)) for rows in layouts.values()
                for _, s, _, _ in rows) + 2 * lat
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 0x5EED))
    z = torch.randn((total,), generator=gen, device=device)
    params, at = {}, 0
    for part, rows in layouts.items():
        n = sum(int(np.prod(s, dtype=np.int64)) for _, s, _, _ in rows)
        params[part] = _fill(rows, z[at:at + n])
        at += n
    stats = (z[at:at + lat] * 0.5, torch.exp(z[at + lat:at + 2 * lat] * 0.3))
    return params, stats
