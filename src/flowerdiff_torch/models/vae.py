"""The VAE: encoder, decoder, classifier head (port of flowerdiff/models/vae.py).

Encoder: image -> 3x3 conv stem (LayerNorm2d, swish) -> three 4x4 stride-2
downs (LayerNorm2d, swish, ResidualBlock) -> flatten -> twin MLP heads
(fc1, LN, swish, fc2) for mu and logvar.

Decoder: z -> fc1 (LN, swish) -> fc2 (LN, swish) -> (deep, base, base) -> ResidualBlock
and 4x4 stride-2 transposed-conv ups (GroupNorm ch/8 groups, swish) -> 3x3
convs (GroupNorm) -> sigmoid. The convolutions run NCHW through PyTorch's
own operators (they are XLA convolutions in the reference, not Pallas).

LatentClassifier: z -> 512 -> 256 -> classes (LayerNorm, swish, dropout 0.3
and 0.2), the head the VAE-GAN objective trains beside the autoencoder.

Layout: images are NHWC (B, H, W, 3) at the public functions, like the
reference, and NCHW inside. The reference flattens HWC-major; here the
encoder flattens, and the decoder's fc2 output is reshaped, CHW-major, so
the weight bridge permutes the heads' fc1 input columns, fc2's output rows
and fc2_ln's affine.

Precision: under bf16 autocast (the reference's compute dtype) the conv and
dense stacks run in bf16; the encoder's fc2 heads, the decoder's sigmoid and
the classifier stay f32, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from flowerdiff_torch.core.layers import LayerNorm2d, ResidualBlock, full_precision, swish

NORM_EPS = 1e-6  # flax LayerNorm / GroupNorm default
LOGVAR_MIN, LOGVAR_MAX = -2.0, 10.0


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, latent_dim: int = 256,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8, remat: bool = False):
        """remat: recompute each residual block in the backward pass instead
        of keeping its activations (the reference's `Encoder.remat`)."""
        super().__init__()
        self.channels = tuple(channels)
        self.remat = remat
        ch = self.channels
        self.stem_conv = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.stem_ln = LayerNorm2d(ch[0])
        for i in range(1, len(ch)):
            self.add_module(f"down{i}_conv", nn.Conv2d(ch[i - 1], ch[i], 4, stride=2, padding=1))
            self.add_module(f"down{i}_ln", LayerNorm2d(ch[i]))
            self.add_module(f"res{i}", ResidualBlock(ch[i]))
        flat = ch[-1] * base_size**2
        for name in ("mu", "logvar"):
            self.add_module(f"{name}_fc1", nn.Linear(flat, head_width))
            self.add_module(f"{name}_ln", nn.LayerNorm(head_width, eps=NORM_EPS))
            self.add_module(f"{name}_fc2", nn.Linear(head_width, latent_dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) in [0, 1] -> (mu, logvar), each (B, latent), f32."""
        h = swish(self.stem_ln(self.stem_conv(x.permute(0, 3, 1, 2))))
        for i in range(1, len(self.channels)):
            h = getattr(self, f"down{i}_conv")(h)
            h = swish(getattr(self, f"down{i}_ln")(h))
            res = getattr(self, f"res{i}")
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(res, h, use_reentrant=False)
            else:
                h = res(h)
        flat = h.flatten(1)

        def head(name: str) -> torch.Tensor:
            y = swish(getattr(self, f"{name}_ln")(getattr(self, f"{name}_fc1")(flat)))
            with full_precision(y):
                return getattr(self, f"{name}_fc2")(y.float())

        return head("mu"), head("logvar")


class Decoder(nn.Module):
    def __init__(self, latent_dim: int = 256, out_channels: int = 3,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8):
        super().__init__()
        self.channels = tuple(channels)
        self.base_size = base_size
        deep = self.channels[-1]
        self.fc1 = nn.Linear(latent_dim, head_width)
        self.fc1_ln = nn.LayerNorm(head_width, eps=NORM_EPS)
        self.fc2 = nn.Linear(head_width, deep * base_size**2)
        self.fc2_ln = nn.LayerNorm(deep * base_size**2, eps=NORM_EPS)
        n_ups = len(self.channels) - 1
        self.add_module(f"res{n_ups}", ResidualBlock(deep))
        prev = deep
        for i in range(n_ups, 0, -1):
            ch = self.channels[i - 1]
            self.add_module(f"up{i}_conv",
                            nn.ConvTranspose2d(prev, ch, 4, stride=2, padding=1))
            self.add_module(f"up{i}_gn",
                            nn.GroupNorm(max(1, ch // 8), ch, eps=NORM_EPS))
            if i > 1:
                self.add_module(f"res{i - 1}", ResidualBlock(ch))
            prev = ch
        mid = max(4, self.channels[0] // 2)
        self.final_conv1 = nn.Conv2d(prev, mid, 3, padding=1)
        self.final_gn = nn.GroupNorm(max(1, mid // 4), mid, eps=NORM_EPS)
        self.final_conv2 = nn.Conv2d(mid, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = swish(self.fc1_ln(self.fc1(z)))
        h = swish(self.fc2_ln(self.fc2(h)))
        h = h.reshape(-1, self.channels[-1], self.base_size, self.base_size)
        n_ups = len(self.channels) - 1
        h = getattr(self, f"res{n_ups}")(h)
        for i in range(n_ups, 0, -1):
            h = getattr(self, f"up{i}_conv")(h)
            h = swish(getattr(self, f"up{i}_gn")(h))
            if i > 1:
                h = getattr(self, f"res{i - 1}")(h)
        h = swish(self.final_gn(self.final_conv1(h)))
        img = torch.sigmoid(self.final_conv2(h).float())
        return img.permute(0, 2, 3, 1)  # NHWC, as the reference returns it


class LatentClassifier(nn.Module):
    """z -> fc1 (512) -> LN -> swish -> dropout 0.3 -> fc2 (256) -> LN ->
    swish -> dropout 0.2 -> out (classes), f32 whatever the autocast around
    it."""

    dropout = (0.3, 0.2)

    def __init__(self, latent_dim: int = 256, num_classes: int = 102):
        super().__init__()
        self.fc1 = nn.Linear(latent_dim, 512)
        self.ln1 = nn.LayerNorm(512, eps=NORM_EPS)
        self.fc2 = nn.Linear(512, 256)
        self.ln2 = nn.LayerNorm(256, eps=NORM_EPS)
        self.out = nn.Linear(256, num_classes)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, ...]:
        """The two dropout keep masks (bool, (B, 512) and (B, 256)) drawn
        from `generator`."""
        return tuple(torch.rand((batch, width), generator=generator, device=device) >= rate
                     for rate, width in zip(self.dropout, (512, 256)))

    def forward(self, z: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
        """deterministic=False applies dropout with keep masks `masks` (as
        `draw_masks` makes them) or, without them, masks drawn from
        `generator`; a kept value is divided by 1 - rate."""
        with full_precision(z):
            if not deterministic and masks is None:
                masks = self.draw_masks(z.shape[0], generator, z.device)

            def drop(h, i):
                if deterministic or masks[i] is None:
                    return h
                return torch.where(masks[i], h / (1.0 - self.dropout[i]), torch.zeros_like(h))

            h = drop(swish(self.ln1(self.fc1(z.float()))), 0)
            h = drop(swish(self.ln2(self.fc2(h))), 1)
            return self.out(h)


class FlowerVAE(nn.Module):
    """The reference `FlowerVAE`: encoder, reparameterisation, `decode(z)`
    -> images in [0, 1] (NHWC), and, with `num_classes`, the classifier head
    (`classify`). `forward` is `decode`, which the service and the latent
    trainers call; the reference's full pass is `autoencode`."""

    def __init__(self, latent_dim: int = 256, in_channels: int = 3,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8, num_classes: Optional[int] = None, remat: bool = False):
        """num_classes: build the classifier head (None: a VAE without one,
        enough for the latent paths). remat: see `Encoder`."""
        super().__init__()
        self.encoder = Encoder(in_channels, latent_dim, channels, head_width,
                               base_size, remat)
        self.decoder = Decoder(latent_dim, in_channels, channels, head_width,
                               base_size)
        self.classifier = (None if num_classes is None else
                           LatentClassifier(latent_dim, num_classes))

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mu + noise * exp(0.5 * clamp(logvar, -2, 10)); the standard-normal
        noise is drawn from `generator` unless given."""
        std = torch.exp(0.5 * torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX))
        if noise is None:
            noise = torch.randn(std.shape, generator=generator, device=std.device,
                                dtype=std.dtype)
        return mu + noise * std

    def encode_with_params(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, clamped logvar) of NHWC images."""
        mu, logvar = self.encoder(x)
        return mu, torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    forward = decode

    def autoencode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
        """The reference's full pass -> (recon, mu, logvar, z): logvar as the
        encoder gives it (the reparameterisation clamps its own copy)."""
        mu, logvar = self.encoder(x)
        z = self.reparameterize(mu, logvar, generator, noise)
        return self.decoder(z), mu, logvar, z

    def classify(self, z: torch.Tensor, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None, masks=None) -> torch.Tensor:
        if self.classifier is None:
            raise ValueError("this FlowerVAE has no classifier head (num_classes=None)")
        return self.classifier(z, deterministic, generator, masks)
