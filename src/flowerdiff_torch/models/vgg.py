"""VGG16 features[:16] for the perceptual loss (port of flowerdiff/models/vgg.py).

conv3-64, conv3-64, maxpool2, conv3-128, conv3-128, maxpool2, conv3-256,
conv3-256, conv3-256, a ReLU after every conv (through relu3_3). The inputs
are normalised with the ImageNet mean and std; the loss is the euclidean
distance between the two feature maps, accumulated in f32.

Weights: the reference's asset `flowerdiff/assets/vgg16_features16.npz`
({name}_kernel HWIO, {name}_bias; `__source__` names its provenance), read
in place as a data file, or the file that FLOWERDIFF_VGG_WEIGHTS names.
Without an asset the filters are seeded random (normal, variance 1 / fan_in,
zero biases), a random-projection perceptual loss, reported as
`pretrained=False` and "random-filters", never silently. The backbone is
frozen: its parameters take no gradient, and the loss differentiates through
its input only. Under bf16 autocast (the training step's compute dtype) its
convolutions run in bf16.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flowerdiff_torch.losses.distances import euclidean_distance_loss
from flowerdiff_torch.utils.device import resolve_device

# (channels, name) per conv of features[:16]; "P" is a 2x2 max pool
VGG16_PREFIX = [(64, "conv1_1"), (64, "conv1_2"), "P", (128, "conv2_1"), (128, "conv2_2"),
                "P", (256, "conv3_1"), (256, "conv3_2"), (256, "conv3_3")]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

ASSET = Path(__file__).resolve().parents[2] / "flowerdiff" / "assets" / "vgg16_features16.npz"


def default_weights_path() -> str:
    return os.environ.get("FLOWERDIFF_VGG_WEIGHTS", str(ASSET))


class VGGFeatures(nn.Module):
    """NHWC images (already normalised) -> NCHW features after relu3_3."""

    def __init__(self):
        super().__init__()
        prev = 3
        for item in VGG16_PREFIX:
            if item != "P":
                ch, name = item
                self.add_module(name, nn.Conv2d(prev, ch, 3, padding=1))
                prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for item in VGG16_PREFIX:
            h = F.max_pool2d(h, 2) if item == "P" else F.relu(getattr(self, item[1])(h))
        return h


def load_vgg_params(path: Optional[str] = None,
                    seed: int = 0) -> Tuple[Dict[str, Dict[str, np.ndarray]], bool]:
    """(flax-named numpy params {name: {kernel (3, 3, in, out), bias}},
    pretrained). Without a file at `path` (default: the asset), seeded
    random filters and pretrained=False."""
    path = path or default_weights_path()
    params = {}
    if os.path.exists(path):
        with np.load(path) as data:
            for item in VGG16_PREFIX:
                if item != "P":
                    name = item[1]
                    params[name] = {"kernel": np.asarray(data[f"{name}_kernel"], np.float32),
                                    "bias": np.asarray(data[f"{name}_bias"], np.float32)}
        return params, True
    rng = np.random.default_rng(seed)
    prev = 3
    for item in VGG16_PREFIX:
        if item != "P":
            ch, name = item
            std = np.sqrt(1.0 / (9 * prev))
            params[name] = {"kernel": (rng.standard_normal((3, 3, prev, ch)) * std
                                       ).astype(np.float32),
                            "bias": np.zeros(ch, np.float32)}
            prev = ch
    return params, False


def describe_vgg_weights(path: Optional[str] = None) -> str:
    """Provenance of the perceptual weights: the asset's `__source__`, or
    "random-filters" when there is no asset."""
    path = path or default_weights_path()
    if os.path.exists(path):
        with np.load(path) as data:
            if "__source__" in data:
                return str(data["__source__"])
        return f"converted asset at {path}"
    return "random-filters"


class VGGPerceptual(nn.Module):
    """The frozen perceptual criterion: euclidean distance of the VGG
    features of two NHWC image batches in [0, 1]."""

    def __init__(self, params: Optional[dict] = None, pretrained: Optional[bool] = None,
                 device=None):
        """params: a flax-named numpy tree as `load_vgg_params` returns
        (default: the asset, or seeded random filters without one)."""
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params, pretrained = load_vgg_params()
        self.pretrained = bool(pretrained)
        self.features_net = VGGFeatures()
        with torch.no_grad():
            for name, leaf in params.items():
                conv = getattr(self.features_net, name)
                conv.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(np.asarray(leaf["bias"])))
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN))
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD))
        self.requires_grad_(False)
        self.to(dev).eval()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.features_net((x - self.mean) / self.std)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """distance(features(x), features(y)); y's features are taken
        without gradient (y is the real image in the training step)."""
        with torch.no_grad():
            fy = self.features(y)
        return euclidean_distance_loss(self.features(x), fy)
