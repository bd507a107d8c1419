"""Multi-head self-attention (port of flowerdiff/core/attention.py).

The reference packs q, k, v into one Dense; here they are three Linears (the
weight bridge splits the packed kernel). The denoiser runs this on a
length-1 sequence, where softmax over one key is 1 and the module reduces to
out(v(x)) — the identity the stage kernel exploits. Attention dropout is
train-time only and waits for the training slice.
`SpatialSelfAttention2D` is not on the sampling path and is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (B, S, D) with `num_heads` heads, q=k=v=x."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, dim = x.shape
        hd = dim // self.num_heads

        def heads(t):
            return t.reshape(batch, seq, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.einsum("bhsd,bhtd->bhst", q, k) * hd**-0.5
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhst,bhtd->bhsd", weights, v)
        return self.out(out.transpose(1, 2).reshape(batch, seq, dim))
