"""Multi-head self-attention (port of flowerdiff/core/attention.py).

The reference packs q, k, v into one Dense; here they are three Linears (the
weight bridge splits the packed kernel). The denoiser runs this on a
length-1 sequence, where softmax over one key is 1 and the module reduces to
out(v(x)) — the identity the stage kernel exploits. Dropout acts on the
attention weights in train mode (`nn.Dropout`), or through an injected
per-(sample, head) mask, which for one key is a mask on `v`.

The head dim is fixed at construction and the head count read from the
width q gives: under tensor parallelism (parallel/sharding.py) q, k and v
are column-parallel and a rank holds only its own heads.

`SpatialSelfAttention2D` is the reference's module of that name, NCHW like
the port's other conv blocks, with the same three q, k, v Linears.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (B, S, D) with `num_heads` heads, q=k=v=x."""

    def __init__(self, dim: int, num_heads: int = 8, dropout_rate: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """head_mask: optional (B, heads) multiplier of the attention weights
        (a dropout mask already scaled by 1 / (1 - rate)); it takes the place
        of the module's own dropout draw."""
        batch, seq, _ = x.shape
        hd = self.head_dim

        def heads(t):
            return t.reshape(batch, seq, t.shape[-1] // hd, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.einsum("bhsd,bhtd->bhst", q, k) * hd**-0.5
        weights = torch.softmax(logits, dim=-1)
        if head_mask is not None:
            weights = weights * head_mask[:, :, None, None].to(weights.dtype)
        else:
            weights = self.attn_drop(weights)
        out = torch.einsum("bhst,bhtd->bhsd", weights, v)
        return self.out(out.transpose(1, 2).reshape(batch, seq, -1))


class SpatialSelfAttention2D(nn.Module):
    """Self-attention over the H*W positions of an NCHW feature map:
    GroupNorm(1) -> q, k, v (1x1 convs, as channel matmuls) ->
    `num_heads`-head scaled dot-product attention -> 1x1 `proj` ->
    +residual. Positions are taken in the reference's row-major (H, W)
    order."""

    def __init__(self, channels: int, num_heads: int = 4):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} is not a multiple of {num_heads} heads")
        self.channels = channels
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(1, channels, eps=1e-6)  # flax GroupNorm's epsilon
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # (B, H*W, C)
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(b, h * w, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q(tokens)), heads(self.k(tokens)), heads(self.v(tokens))
        logits = torch.einsum("bhsd,bhtd->bhst", q, k) * hd**-0.5
        out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, dim=-1), v)
        out = self.proj(out.transpose(1, 2).reshape(b, h * w, c))
        return out.transpose(1, 2).reshape(b, c, h, w) + x
