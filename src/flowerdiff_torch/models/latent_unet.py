"""Conditional latent-space denoiser (port of flowerdiff/models/latent_unet.py).

An MLP hourglass over flat latents:

  latent_proj: latent -> hidden[0]
  per stage i:
     h += time_proj_i(t_emb) + cond_proj_i(c_emb)   (time_proj_i under shared_cond_proj)
     h += swish(Dropout(LayerNorm(block_fc_i(h))))
     h += attn_i(LayerNorm(h))                     # length-1 sequence, weight dropout
     h  = downsample_i(h)
  final: LayerNorm(h + final_time_proj(t) + final_cond_proj(c)) -> final

Quirks kept from the reference, config-gated:
  - `shared_cond_proj` (v1/v2): the class embedding goes through the TIME
    projection, bias included, so a null condition (cond_mask=0) still adds
    that bias.
  - `global_skip` (v2): out += sigmoid(residual_weight) * final(x).
  - flax LayerNorm epsilon, 1e-6.

Dropout (rate `dropout_rate`, on the block's LayerNorm output before the
swish and on the attention weights) acts in train mode only. `forward` also
takes injected masks in its place, so that one set of masks can go through
this module, the train-step twin and the train-step kernel. This f32 module
is the oracle the kernel paths are held to.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from flowerdiff_torch.core.attention import MultiHeadSelfAttention
from flowerdiff_torch.core.embeddings import (
    ClassEmbedding,
    MultiConditionEmbedding,
    TimeEmbedding,
)
from flowerdiff_torch.core.layers import swish

LN_EPS = 1e-6  # flax nn.LayerNorm default


class ConditionalLatentDenoiser(nn.Module):
    def __init__(
        self,
        latent_dim: int = 256,
        hidden_dims: Sequence[int] = (256, 512, 1024, 512, 256),
        time_emb_dim: int = 256,
        num_classes: int = 102,
        num_colors: Optional[int] = None,
        shared_cond_proj: bool = True,
        global_skip: bool = False,
        dropout_rate: float = 0.3,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.hidden_dims = tuple(hidden_dims)
        self.time_emb_dim = time_emb_dim
        self.num_classes = num_classes
        self.num_colors = num_colors
        self.shared_cond_proj = shared_cond_proj
        self.global_skip = global_skip
        self.dropout_rate = dropout_rate
        hidden = self.hidden_dims
        self.n_stages = len(hidden) - 1

        self.time_emb = TimeEmbedding(time_emb_dim)
        if num_colors is not None:
            self.cond_emb = MultiConditionEmbedding(num_classes, num_colors,
                                                    time_emb_dim)
        else:
            self.cond_emb = ClassEmbedding(num_classes, time_emb_dim)
        self.latent_proj = nn.Linear(latent_dim, hidden[0])
        for i in range(self.n_stages):
            d = hidden[i]
            self.add_module(f"time_proj_{i}", nn.Linear(time_emb_dim, d))
            if not shared_cond_proj:
                self.add_module(f"cond_proj_{i}", nn.Linear(time_emb_dim, d))
            self.add_module(f"block_fc_{i}", nn.Linear(d, d))
            self.add_module(f"block_ln_{i}", nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(f"stage_ln_{i}", nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(f"block_drop_{i}", nn.Dropout(dropout_rate))
            self.add_module(f"attn_{i}", MultiHeadSelfAttention(
                d, num_heads=8, dropout_rate=dropout_rate))
            self.add_module(f"downsample_{i}", nn.Linear(d, hidden[i + 1]))
        self.final_time_proj = nn.Linear(time_emb_dim, hidden[-1])
        self.final_cond_proj = nn.Linear(time_emb_dim, hidden[-1])
        self.final_norm = nn.LayerNorm(hidden[-1], eps=LN_EPS)
        self.final = nn.Linear(hidden[-1], latent_dim)
        self.residual_weight = nn.Parameter(torch.tensor(0.1))

    def stage(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def cond_proj(self, i: int) -> nn.Linear:
        """The Linear that projects the condition embedding at stage i."""
        return self.stage("time_proj" if self.shared_cond_proj else "cond_proj", i)

    def embed_condition(self, cond: torch.Tensor,
                        color: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.num_colors is not None:
            if color is None:
                raise ValueError("the v3 variant needs a color label")
            return self.cond_emb(cond, color)
        return self.cond_emb(cond)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: torch.Tensor,
        color: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
        masks: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """cond_mask: optional (B,) 0/1 floats; 0 zeroes that row's condition
        embedding (the null condition of classifier-free guidance).
        masks: optional injected dropout masks, one (m_blk, m_attn) pair a
        stage, both (B, d_i) and already scaled by 1 / (1 - rate); m_attn
        holds one value a (sample, head), repeated over the head's d_i / 8
        columns. They take the place of the module's own dropout draws."""
        t_base = self.time_emb(t)
        c_base = self.embed_condition(cond, color)
        if cond_mask is not None:
            c_base = c_base * cond_mask[:, None].to(c_base.dtype)

        h = self.latent_proj(x)
        for i in range(self.n_stages):
            h = h + self.stage("time_proj", i)(t_base) + self.cond_proj(i)(c_base)
            blk = self.stage("block_ln", i)(self.stage("block_fc", i)(h))
            if masks is not None:
                m_blk, m_attn = masks[i]
                blk = blk * m_blk
                head_mask = m_attn[:, ::m_attn.shape[1] // self.stage("attn", i).num_heads]
            else:
                blk = self.stage("block_drop", i)(blk)
                head_mask = None
            h = h + swish(blk)
            h_norm = self.stage("stage_ln", i)(h)
            h = h + self.stage("attn", i)(h_norm[:, None, :], head_mask)[:, 0, :]
            h = self.stage("downsample", i)(h)

        h = h + self.final_time_proj(t_base) + self.final_cond_proj(c_base)
        out = self.final(self.final_norm(h))
        if self.global_skip:
            out = out + torch.sigmoid(self.residual_weight) * self.final(x)
        return out
