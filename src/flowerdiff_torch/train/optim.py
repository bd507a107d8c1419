"""The optimizers of the port's trainers, written out to optax's formulas.

`clip_by_global_norm` scales every gradient by clip / max(norm, clip) (no
epsilon in the denominator, where torch's `clip_grad_norm_` divides by
norm + 1e-6). `adam_` is optax's `scale_by_adam` with bias corrections,
plus `add_decayed_weights` when weight_decay > 0 (optax's adamw: every leaf
decays, whether its gradient is zero or not), then the step by -lr. The
learning rate is the schedule's value at the count BEFORE the update, as
optax's `scale_by_schedule` evaluates it. All updates are in place and take
no host synchronisation.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def clip_by_global_norm(grads: Sequence[torch.Tensor], clip: float) -> List[torch.Tensor]:
    """The gradients scaled by clip / max(global norm, clip) (new tensors)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    return torch._foreach_mul(list(grads), clip / torch.clamp(norm, min=clip))


def adam_(params: List[torch.Tensor], grads: Sequence[torch.Tensor], mu: List[torch.Tensor],
          nu: List[torch.Tensor], count: int, lr: float, b1: float, b2: float,
          eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One Adam(W) update in place; `count` is the step count after it
    (1 for the first update)."""
    grads = list(grads)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(nu, 1.0 - b2**count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, 1.0 - b1**count)
    torch._foreach_div_(update, denom)
    if weight_decay:
        torch._foreach_add_(update, params, alpha=weight_decay)
    torch._foreach_add_(params, update, alpha=-lr)


class AdamState:
    """A module's parameters (detached aliases, updated in place), Adam's
    moments and the step count, with an optional global-norm clip and
    decoupled weight decay: optax's chain(clip_by_global_norm(clip),
    adamw(schedule, b1, b2, eps, weight_decay)), or plain adam with no clip
    and no decay."""

    def __init__(self, module: torch.nn.Module, schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip=None):
        self.module = module
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p.detach() for p in module.parameters()]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """grads: one tensor per parameter, in `names` order; left as they are."""
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip)
        lr = self.schedule(self.step)
        self.step += 1
        adam_(self.params, grads, self.mu, self.nu, self.step, lr, self.b1, self.b2, self.eps,
              self.weight_decay)

    def tensors(self) -> List[torch.Tensor]:
        return self.params + self.mu + self.nu
