"""Device-side input pipeline (port of flowerdiff/data/pipeline.py).

The dataset stays on the device as uint8 (N, H, W, 3), as the reference
holds it; a batch is one gather, a cast to float [0, 1] and the augmentation
stack of the reference (v1:24-30 in its source):

    flip along W (probability 1/2)
    -> bilinear rotation by a uniform angle in +-max_rotation_deg about the
       image centre ((H-1)/2, (W-1)/2), zero fill
    -> brightness x fb -> contrast around the per-image mean of the
       grayscale (taken after brightness) x fc -> saturation around the
       per-pixel grayscale x fs, with fb, fc, fs ~ U[1 - jitter, 1 + jitter]
    -> one clip to [0, 1]

The rotation is a 4-tap gather (`rotate_bilinear`), which is what the GPU
does well; the reference's TPU form, two einsums over a (B, H, W, H, C)
intermediate, would hold ~0.8 GB at a chunk of 255 images. Draws come from
an explicit `torch.Generator` in the order flip, angle, fb, fc, fs, and a
branch that is switched off (flip=False, max_rotation_deg=0, jitter=0) takes
no draw, as in the reference; the five draws may also be injected
(`AugmentDraws`), which is how the port is held against the reference.

`DeviceDataset.batches` takes its order from the same numpy
`Generator.permutation` as the reference, so the order is bit-equal; batch
`start` augments from a generator derived from (seed, start), the
counterpart of `fold_in(key, start)`. There is no mesh argument: multi-GPU
comes with the orchestration slice.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flowerdiff_torch.parallel.mesh import local_rows
from flowerdiff_torch.utils.device import derived_generator, resolve_device

GRAY_WEIGHTS = (0.299, 0.587, 0.114)


class AugmentDraws(NamedTuple):
    """One batch's augmentation draws, each (B,): the flip mask (bool), the
    angle in radians and the brightness, contrast and saturation factors.
    A branch that is off leaves its draws None."""
    flip: Optional[torch.Tensor]
    angle: Optional[torch.Tensor]
    fb: Optional[torch.Tensor]
    fc: Optional[torch.Tensor]
    fs: Optional[torch.Tensor]


def unit_float(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1], times the f32 reciprocal of 255: what
    the reference's compiled gather computes for its `/ 255.0` (XLA turns
    the division by a constant into that product), so the values are
    bit-equal."""
    return images_u8.float() * (1.0 / 255.0)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1): 0.299 R + 0.587 G + 0.114 B."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=images.dtype, device=images.device)
    return (images * w).sum(dim=-1, keepdim=True)


def rotate_bilinear(images: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W, C) image of a (B, H, W, C) batch by its angle in
    radians about ((H-1)/2, (W-1)/2), bilinear, zero outside the image (the
    reference's `_rotate_bilinear` and `_rotate_bilinear_batch`). Output
    pixel (y, x) samples the input at the inverse-rotated point
    sx = cos (x - cx) + sin (y - cy) + cx, sy = -sin (x - cx) + cos (y - cy) + cy
    from its four neighbours; a neighbour outside the image adds zero."""
    b, h, w, c = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
    angles = angles.to(device=dev, dtype=torch.float32).reshape(b, 1, 1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    sx = cos * (xx - cx) + sin * (yy - cy) + cx  # (B, H, W)
    sy = -sin * (xx - cx) + cos * (yy - cy) + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dx, dy = sx - x0, sy - y0
    flat = images.reshape(b * h * w, c)
    base = (torch.arange(b, device=dev) * (h * w)).reshape(b, 1, 1)
    out = torch.zeros_like(images)
    for ox, oy, wt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                       (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
        xi, yi = x0 + ox, y0 + oy
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        tap = flat[idx.reshape(-1)].reshape(b, h, w, c)
        out = out + tap * (wt * inside)[..., None]
    return out


def make_augment_fn(max_rotation_deg: float = 10.0, jitter: float = 0.2, flip: bool = True):
    """augment(images (B, H, W, 3) float [0, 1], generator=None, draws=None)
    -> augmented images, the reference's `make_augment_fn`. `draws`
    (`AugmentDraws`) replaces the generator's draws; `draw(b, generator,
    device)` makes them."""
    max_rad = max_rotation_deg * math.pi / 180.0

    def draw(b: int, generator: Optional[torch.Generator] = None, device=None) -> AugmentDraws:
        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(b, generator=generator, device=device)

        do_flip = (torch.rand(b, generator=generator, device=device) < 0.5) if flip else None
        angle = uniform(-max_rad, max_rad) if max_rotation_deg > 0 else None
        factors = ([uniform(1 - jitter, 1 + jitter) for _ in range(3)] if jitter > 0
                   else [None] * 3)
        return AugmentDraws(do_flip, angle, *factors)

    def augment(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[AugmentDraws] = None) -> torch.Tensor:
        if draws is None:
            draws = draw(images.shape[0], generator, images.device)
        if flip:
            mask = draws.flip.to(images.device, torch.bool).reshape(-1, 1, 1, 1)
            images = torch.where(mask, images.flip(2), images)
        if max_rotation_deg > 0:
            images = rotate_bilinear(images, draws.angle)
        if jitter > 0:
            fb, fc, fs = (f.to(images.device, torch.float32).reshape(-1, 1, 1, 1)
                          for f in (draws.fb, draws.fc, draws.fs))
            images = images * fb  # brightness
            gray_mean = grayscale(images).mean(dim=(1, 2), keepdim=True)
            images = (images - gray_mean) * fc + gray_mean  # contrast
            gray = grayscale(images)
            images = (images - gray) * fs + gray  # saturation
            images = images.clamp(0.0, 1.0)
        return images

    augment.draw = draw
    return augment


class DeviceDataset:
    """Device-resident dataset: images uint8 (N, H, W, 3), labels (and the
    optional v3 color labels) int64, and the augmentation policy, which the
    training paths read.

    mesh: a data-parallel mesh (parallel/mesh.py). Every rank holds the
    whole source arrays (the reference's replicated source); a batch is
    the global batch's index row and augmentation draws, of which the rank
    assembles its rows."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 colors: Optional[np.ndarray] = None, augment: bool = True,
                 max_rotation_deg: float = 10.0, jitter: float = 0.2, device=None,
                 mesh=None):
        dev = resolve_device(device)
        self.mesh = mesh
        images = np.asarray(images)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 (N, H, W, C)")
        self.device = dev
        self.n = images.shape[0]
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        self.labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(dev)
        self.colors = (None if colors is None else
                       torch.as_tensor(np.asarray(colors), dtype=torch.int64).to(dev))
        self.augment_enabled = augment
        self.max_rotation_deg = max_rotation_deg
        self.jitter = jitter
        self._augment = make_augment_fn(max_rotation_deg, jitter) if augment else None

    def assemble(self, idx: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[AugmentDraws] = None) -> Tuple[torch.Tensor, ...]:
        """(images float [0, 1], labels[, colors]) of the rows `idx`,
        augmented when the dataset augments; under the mesh, this rank's
        rows of them (`idx` and `draws` are the global batch's)."""
        if self._augment is not None and draws is None:
            draws = self._augment.draw(idx.shape[0], generator, self.images.device)
        idx = local_rows(self.mesh, idx)
        imgs = unit_float(self.images[idx])
        if self._augment is not None:
            imgs = self._augment(imgs, None, local_rows(self.mesh, draws))
        if self.colors is not None:
            return imgs, self.labels[idx], self.colors[idx]
        return imgs, self.labels[idx]

    def batches(self, rng, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Tuple[torch.Tensor, ...]]:
        """One epoch of batches. `rng`: a numpy Generator or an int seed."""
        if isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(int(rng))
        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        seed = int(rng.integers(0, 2**31))
        end = self.n - (self.n % batch_size) if drop_remainder else self.n
        if end == 0:  # the dataset is smaller than one batch
            end = self.n
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_remainder:
                break
            yield self.assemble(torch.from_numpy(idx).to(self.device),
                                derived_generator(self.device, seed, start))

    def full(self):
        """The whole split, un-augmented float [0, 1] images and labels."""
        imgs = self.images.float() / 255.0
        if self.colors is not None:
            return imgs, self.labels, self.colors
        return imgs, self.labels
