"""The conditional latent denoiser (ConditionalUNet, v1:501-561; v2's global
skip, v2:561), as the reverse process evaluates it.

    t_emb = lin2(swish(lin1(sinusoid(t))))            (TimeEmbedding, v1:401-418)
    c_emb = lin2(swish(lin1(embedding[c])))           (ClassEmbedding, v1:421-431)
    h = latent_proj(x)
    stage i:  h += time_proj_i(t_emb) + cond_i(c_emb)   (cond_i is time_proj_i in v1/v2, v1:544)
              h += swish(LN(block_fc_i(h)))
              h += attn_i(LN(h))                        (one key: out(v(.)), softmax over it is 1)
              h = downsample_i(h)
    out = final(LN(h + final_time_proj(t_emb) + final_cond_proj(c_emb)))
          [+ sigmoid(residual_weight) final(x)]        (v2)

The null condition of classifier-free guidance is c_emb = 0, so a null row
keeps each condition projection's bias. LayerNorm's epsilon is the
configuration's. The products inside the step (latent_proj, block_fc, v, out,
downsample, final) round both operands to the configured type and
accumulate in f32; the time and condition paths are f32. Parameters are a
dict by the names in `portbench/harness/weights.py`.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
_FP8_MAX = 448.0  # largest finite float8_e4m3fn


def rounder(kind: str):
    """x -> x with its values rounded to `kind` and back to f32: 'float32'
    (unchanged), 'bfloat16', or 'float8_e4m3fn' with one scale a tensor
    (its largest magnitude onto the type's largest finite value)."""
    if kind == "float32":
        return lambda x: x
    if kind == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if kind == "float8_e4m3fn":
        def fp8(x):
            scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return fp8
    raise ValueError(f"unknown product type {kind!r}")


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(k * (-math.log(10000.0) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, dim - emb.shape[-1]))


def _lin(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Denoiser:
    """eps(x, t) of one request's rows, the time and condition paths worked
    out once. cfg: the configuration's `denoiser` block."""

    def __init__(self, p: Params, cfg: dict, n_steps: int, products: str):
        self.p, self.cfg = p, cfg
        self.q = rounder(products)
        self.n_stages = len(cfg["hidden_dims"]) - 1
        self.eps = float(cfg["ln_eps"])
        t = torch.arange(n_steps, device=p["latent_proj.weight"].device)
        t_emb = _lin(p, "time_emb.lin2", _swish(_lin(p, "time_emb.lin1",
                                                     sinusoid(t, cfg["time_emb_dim"]))))
        self.t_adds = [_lin(p, f"time_proj_{i}", t_emb) for i in range(self.n_stages)]
        self.t_add_final = _lin(p, "final_time_proj", t_emb)

    def _cond_name(self, i: int) -> str:
        return f"time_proj_{i}" if self.cfg["shared_cond_proj"] else f"cond_proj_{i}"

    def condition(self, classes: torch.Tensor, guided: bool):
        """The condition adds of each stage and of the head for rows
        `classes`, followed by the null rows when guided."""
        p = self.p
        c_emb = p["cond_emb.embedding.weight"][classes]
        c_emb = _lin(p, "cond_emb.lin2", _swish(_lin(p, "cond_emb.lin1", c_emb)))
        adds = []
        for name in [self._cond_name(i) for i in range(self.n_stages)] + ["final_cond_proj"]:
            rows = _lin(p, name, c_emb)
            if guided:
                rows = torch.cat([rows, p[f"{name}.bias"].expand_as(rows)])
            adds.append(rows)
        return adds

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            self.eps)

    def __call__(self, x: torch.Tensor, t: int, adds, copies: int) -> torch.Tensor:
        """eps (copies * B, L) at step t for x (B, L); `adds` from `condition`."""
        h = self._mm(x, "latent_proj").repeat(copies, 1)
        for i in range(self.n_stages):
            h = h + self.t_adds[i][t] + adds[i]
            h = h + _swish(self._ln(self._mm(h, f"block_fc_{i}"), f"block_ln_{i}"))
            v = self._mm(self._ln(h, f"stage_ln_{i}"), f"attn_{i}.v")
            h = h + self._mm(v, f"attn_{i}.out")
            h = self._mm(h, f"downsample_{i}")
        h = h + self.t_add_final[t] + adds[-1]
        out = self._mm(self._ln(h, "final_norm"), "final")
        if self.cfg["global_skip"]:
            skip = torch.sigmoid(self.p["residual_weight"]) * self._mm(x, "final")
            out = out + skip.repeat(copies, 1)
        return out
