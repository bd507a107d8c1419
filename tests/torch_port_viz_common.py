"""What the viz tests share (tests/test_torch_port_viz*.py): a stub sampler
for each side, a deterministic function of the classes and start steps that
records every call; the same decoder for both sides (a sigmoid of three
latent dims broadcast over a 16x16 image), recording its inputs; seeded
images and labels; PNG shapes read from the file's header."""
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff_torch.diffusion import linear_schedule

ROOT = Path(__file__).resolve().parents[1]
T, LATENT = 10, 8
NAMES = [str(i) for i in range(12)]
EPS = np.random.default_rng(11).standard_normal((1, LATENT)).astype(np.float32)


def _latents(classes: np.ndarray, t_start=None) -> np.ndarray:
    """The stub's deterministic output for rows of `classes`."""
    c = np.asarray(classes, np.float32).reshape(-1, 1)
    z = 0.8 * np.sin(0.37 * (c + 1) * np.arange(1, LATENT + 1, dtype=np.float32))
    if t_start is not None:
        z = z + 0.01 * np.asarray(t_start, np.float32).reshape(-1, 1)
    return z.astype(np.float32)


class _Stub:
    """Records (method, batch or shape, conditions, start steps)."""

    def __init__(self, event_shape=(LATENT,)):
        self.event_shape = tuple(event_shape)
        self.calls = []

    @property
    def latent_dim(self):
        return self.event_shape[0]

    def _record(self, name, n, cond, t_start=None):
        self.calls.append((name, n, [np.asarray(c).tolist() for c in cond],
                           None if t_start is None else np.asarray(t_start).tolist()))

    def _draw(self, batch, cond):
        if len(self.event_shape) == 1:
            return _latents(np.asarray(cond[0]) if cond else np.zeros(batch))
        base = _latents(np.zeros(batch))[:, :3]
        return np.broadcast_to((base + 1) / 2, (batch,) + self.event_shape[:2] + (3,)).copy()

    def _traj(self, batch):
        x = self._draw(batch, ())
        return x, np.stack([x * (i + 1) / T for i in range(T)])


class JaxStub(_Stub):
    def __init__(self, event_shape=(LATENT,)):
        super().__init__(event_shape)
        self.sched = jax_schedule(T)

    def sample(self, rng, batch, *cond):
        self._record("sample", batch, cond)
        return jnp.asarray(self._draw(batch, cond))

    def masked_denoise(self, rng, x_init, t_start, *cond):
        self._record("masked_denoise", list(x_init.shape), cond, t_start)
        return jnp.asarray(_latents(cond[0], t_start))

    def sample_with_trajectory(self, rng, batch, *cond):
        self._record("trajectory", batch, cond)
        return tuple(jnp.asarray(a) for a in self._traj(batch))


class TorchStub(_Stub):
    device = torch.device("cpu")

    def __init__(self, event_shape=(LATENT,)):
        super().__init__(event_shape)
        self.sched = linear_schedule(T)

    def sample(self, batch, *cond, generator=None):
        self._record("sample", batch, cond)
        return torch.from_numpy(self._draw(batch, cond))

    def masked_denoise(self, x_init, t_start, *cond, generator=None):
        self._record("masked_denoise", list(x_init.shape), cond, t_start)
        return torch.from_numpy(_latents(cond[0], t_start))

    def sample_with_trajectory(self, batch, *cond, generator=None):
        self._record("trajectory", batch, cond)
        return tuple(torch.from_numpy(a) for a in self._traj(batch))


def _decode_np(z):
    img = 1.0 / (1.0 + np.exp(-np.asarray(z, np.float32)[:, :3]))
    return np.broadcast_to(img[:, None, None, :], (img.shape[0], 16, 16, 3))


class Decoders:
    """The same decoder for both sides, recording its inputs."""

    def __init__(self):
        self.jax_in, self.port_in = [], []

    def jax(self, z):
        self.jax_in.append(np.asarray(z))
        return jnp.asarray(_decode_np(z))

    def port(self, z):
        self.port_in.append(z.detach().cpu().numpy())
        return torch.from_numpy(_decode_np(z.detach().cpu().numpy()).copy())


def _images(n=40):
    x = np.random.default_rng(2).random((n, 16, 16, 3), dtype=np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


def _labels(n=40):
    return np.arange(n) % 12


def _encode_mu(x):
    return x.reshape(x.shape[0], -1)[:, :LATENT]


def _png_shape(path):
    """(height, width, bands) from the PNG's header."""
    with Image.open(path) as im:
        assert im.format == "PNG"
        return im.size[1], im.size[0], len(im.getbands())


def _same_png(got, want):
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.exists(got) and _png_shape(got) == _png_shape(want)
