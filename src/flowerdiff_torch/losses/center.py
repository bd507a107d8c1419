"""EMA class-center losses (port of flowerdiff/losses/center.py).

`center_loss`: the mean euclidean distance of each latent to its class's
center. `update_centers`: the EMA (momentum 0.9) of the per-class batch
means, for the classes present in the batch only. `standalone_center_loss`:
the reference's standalone CenterLoss semantics (attraction, a repulsion
hinge between centers, minus 0.1 x the mean intra-class variance); the
training step does not use it, in the reference either.

The reference's segment sums are one-hot sums here, (C, B, ...) products
reduced over the batch: on the card `index_add_` adds with atomics in no
fixed order, and the training step must be bit-reproducible. They are not
matrix products, so no TF32 or autocast setting rounds the latents.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _segment_sums(values: torch.Tensor, labels: torch.Tensor, num_classes: int):
    """(per-class sums of `values` (B, ...), per-class counts), each
    reduced over the batch in a fixed order."""
    onehot = F.one_hot(labels.long(), num_classes).to(values.dtype).T  # (C, B)
    flat = values.reshape(1, values.shape[0], -1)
    sums = (onehot[:, :, None] * flat).sum(dim=1).reshape((num_classes,) + values.shape[1:])
    return sums, onehot.sum(dim=1)


def center_loss(z: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of sqrt(|z_i - centers[labels_i]|^2 + 1e-8)."""
    delta = z - centers[labels]
    return torch.mean(torch.sqrt(torch.sum(delta * delta, dim=1) + 1e-8))


def standalone_center_loss(z: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
                           min_distance: float = 1.0,
                           repulsion_strength: float = 1.0) -> torch.Tensor:
    num_classes, batch = centers.shape[0], z.shape[0]
    d2 = ((z**2).sum(dim=1)[:, None] + (centers**2).sum(dim=1)[None, :]
          - 2.0 * z @ centers.T)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    attraction = dist[torch.arange(batch, device=z.device), labels].sum() / batch

    sq = (centers**2).sum(dim=1)
    cd2 = sq[:, None] + sq[None, :] - 2.0 * centers @ centers.T
    center_dist = torch.sqrt(torch.clamp(cd2, min=1e-12))
    off_diag = 1.0 - torch.eye(num_classes, device=z.device, dtype=z.dtype)
    repulsion = (torch.clamp(min_distance - center_dist, min=0.0) * off_diag).sum() / (
        num_classes * (num_classes - 1) + 1e-6)

    sums, counts = _segment_sums(z, labels, num_classes)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    sq_dev = ((z - means[labels]) ** 2).sum(dim=1)
    var_sums, _ = _segment_sums(sq_dev, labels, num_classes)
    cls_var = torch.where(counts > 1, var_sums / torch.clamp(counts, min=1.0),
                          torch.zeros_like(var_sums))
    intra_variance = cls_var.sum() / num_classes
    return attraction + repulsion_strength * repulsion - 0.1 * intra_variance


def update_centers(centers: torch.Tensor, z: torch.Tensor, labels: torch.Tensor,
                   momentum: float = 0.9) -> torch.Tensor:
    """The new centers; classes absent from the batch keep their old ones."""
    sums, counts = _segment_sums(z, labels, centers.shape[0])
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    updated = momentum * centers + (1.0 - momentum) * means
    return torch.where((counts > 0)[:, None], updated, centers)
