"""Parameter sharding rules (port of flowerdiff/parallel/sharding.py).

Megatron-style tensor parallelism for the latent denoiser's wide stages,
over the mesh's "model" dim. The reference's rules (regex over the flax
path -> PartitionSpec; XLA inserts the collectives) become rules over the
port's module names -> a parallel Linear that holds its rank's shard and
runs its collective itself:

  block_fc_i, downsample_i   column-parallel (the reference's kernel
                             P(None, 'model'); torch's weight is (out, in),
                             so its rows), the output gathered, since a
                             LayerNorm or the next stage reads all of it
  attn_i.q / .k / .v         column-parallel, the output kept sharded: each
                             rank holds whole heads (the reference's packed
                             qkv split is only a layout; the attention takes
                             its head count from the width it is given)
  attn_i.out                 row-parallel (P('model', None)), the output
                             summed over the ranks, then the bias

Everything else (embeddings, LayerNorms, the convolutional models) stays
replicated; data parallelism over "data" is the scaling story there.

The two layers are written out on the process group's plain collectives
(parallel/mesh.py, which stages gloo's through the host) rather than
through `parallelize_module`: DTensor's functional all-gather crashes the
process on a gloo group over CUDA tensors (torch 2.11), which is how two
ranks share the one card where NCCL refuses them. The layers run the
forward (inference), as the reference's sharded forward is held.
"""
from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from flowerdiff_torch.parallel.mesh import MODEL_AXIS, _staged

# (module-name regex, style): 'colwise_gather', 'colwise' or 'rowwise'
LatentRules = Sequence[Tuple[str, str]]


def latent_denoiser_rules() -> LatentRules:
    return [
        (r"^(block_fc|downsample)_\d+$", "colwise_gather"),
        (r"^attn_\d+\.(q|k|v)$", "colwise"),
        (r"^attn_\d+\.out$", "rowwise"),
    ]


class _ParallelLinear(nn.Module):
    """A Linear's shard on one rank of the mesh's "model" dim: the rows
    (column-parallel) or the columns (row-parallel) of its (out, in)
    weight."""

    def __init__(self, linear: nn.Linear, mesh, style: str):
        super().__init__()
        if style not in ("colwise_gather", "colwise", "rowwise"):
            raise ValueError(f"unknown parallel style {style!r}")
        n, r = mesh.size(1), mesh.get_local_rank(MODEL_AXIS)
        dim = 1 if style == "rowwise" else 0
        if linear.weight.shape[dim] % n:
            raise ValueError(f"a width of {linear.weight.shape[dim]} does not split over "
                             f"{n} model ranks")
        k = linear.weight.shape[dim] // n
        weight = linear.weight.detach().narrow(dim, r * k, k)
        bias = linear.bias.detach()
        self.weight = nn.Parameter(weight.clone(), requires_grad=False)
        self.bias = nn.Parameter((bias if dim else bias[r * k:(r + 1) * k]).clone(),
                                 requires_grad=False)
        self.style, self.ranks = style, n
        self.group = mesh.get_group(MODEL_AXIS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.style == "rowwise":  # x: this rank's columns of the input
            y = F.linear(x, self.weight)
            buf = _staged(self.group, y)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
            return buf.to(y.device) + self.bias
        y = F.linear(x, self.weight, self.bias)
        if self.style == "colwise":
            return y
        buf = _staged(self.group, y.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.ranks)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=-1).to(y.device)


def shard_params(model: nn.Module, mesh, rules: LatentRules = ()) -> nn.Module:
    """Shard `model`'s Linears in place over the mesh's "model" dim, each by
    the first rule whose regex matches its name (default: replicated).
    Returns the model, whose forward then runs the collectives (None or a
    mesh with one model rank: nothing to shard)."""
    if mesh is None or mesh.size(1) == 1:
        return model
    for name, module in list(model.named_modules()):
        for pattern, style in rules:
            if name and re.search(pattern, name):
                if not isinstance(module, nn.Linear):
                    raise ValueError(f"{name} is no Linear: {type(module).__name__}")
                parent, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(parent), leaf, _ParallelLinear(module, mesh, style))
                break
    return model
