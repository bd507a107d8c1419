"""flowerdiff_torch.viz against the JAX package's viz, function by function.

Both sides get the same stub sampler (a deterministic function of the
classes and start steps that records every call) and the same decoder (a
sigmoid of three latent dims broadcast over a 16x16 image), so the figures'
device work is equal where the draws are not: the calls each function makes
must be equal (batch, classes, `masked_denoise`'s tiled start steps,
trajectories), the animation's frames equal once the one draw it makes (the
fixed eps) is injected on both sides, `encode_gif` byte-equal on equal
frames, `pca_projection` equal, and each function must write the file the
reference writes, a PNG of the reference's shape (the figure functions:
tests/test_torch_port_viz_figures.py; stubs and helpers:
tests/torch_port_viz_common.py)."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff import viz as jviz
from flowerdiff.viz import animation as janim
from flowerdiff.viz import grids as jgrids
from flowerdiff.viz import latent_plots as jplots
from flowerdiff_torch import viz
from flowerdiff_torch.viz import animation as anim
from flowerdiff_torch.viz import grids
from flowerdiff_torch.viz import latent_plots as plots
from torch_port_viz_common import (
    EPS,
    LATENT,
    NAMES,
    ROOT,
    T,
    Decoders,
    JaxStub,
    TorchStub,
    _images,
    _png_shape,
    _same_png,
)
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


def test_viz_imports_without_matplotlib_pil_or_sklearn():
    code = ("import sys\n"
            "for m in ('matplotlib', 'PIL', 'sklearn'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "import flowerdiff_torch.viz, flowerdiff_torch.runner, flowerdiff_torch.cli\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_exports_are_the_reference_s():
    assert sorted(viz.__all__) == sorted(jviz.__all__)


@pytest.mark.parametrize("n,frames", [(1000, 50), (10, 50), (10, 3), (7, 7), (100, 6)])
def test_pingpong_timesteps_equal_the_reference(n, frames):
    assert anim._pingpong_timesteps(n, frames) == janim._pingpong_timesteps(n, frames)


def test_samples_grid_equals_the_reference(tmp_path):
    js, ts_, dec = JaxStub(), TorchStub(), Decoders()
    want = jviz.generate_samples_grid(js, dec.jax, NAMES, save_dir=str(tmp_path / "jax"))
    got = viz.generate_samples_grid(ts_, dec.port, NAMES, save_dir=str(tmp_path / "port"))
    assert ts_.calls == js.calls and ts_.calls[0][:2] == ("sample", 50)
    np.testing.assert_allclose(dec.port_in[0], dec.jax_in[0], atol=1e-6)
    _same_png(got, want)


@pytest.mark.parametrize("target", [3, "7"])
def test_class_samples_equal_the_reference(tmp_path, target):
    js, ts_, dec = JaxStub(), TorchStub(), Decoders()
    want = jviz.generate_class_samples(js, dec.jax, target, NAMES,
                                       save_path=str(tmp_path / "j.png"),
                                       extra_cond=jnp.full((5,), 2, jnp.int32))
    got = viz.generate_class_samples(ts_, dec.port, target, NAMES,
                                     save_path=str(tmp_path / "p.png"),
                                     extra_cond=torch.full((5,), 2))
    assert ts_.calls == js.calls
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert _png_shape(tmp_path / "p.png") == _png_shape(tmp_path / "j.png")
    with pytest.raises(ValueError, match="Invalid class name"):
        viz.generate_class_samples(ts_, dec.port, "rose", NAMES)


def test_pixel_grid_equals_the_reference(tmp_path):
    js, ts_ = JaxStub((16, 16, 3)), TorchStub((16, 16, 3))
    want = jgrids.generate_pixel_samples_grid(js, save_path=str(tmp_path / "j" / "grid.png"))
    got = grids.generate_pixel_samples_grid(ts_, save_path=str(tmp_path / "p" / "grid.png"))
    assert ts_.calls == js.calls == [("sample", 16, [], None)]
    _same_png(got, want)


def test_pca_projection_equals_the_reference():
    latents = np.random.default_rng(4).standard_normal((60, LATENT)).astype(np.float32)
    got, pca = plots.pca_projection(latents)
    want, jpca = jplots.pca_projection(latents)
    np.testing.assert_allclose(got, want, atol=1e-6)
    probe = latents[:5] * 0.5
    np.testing.assert_allclose(pca.transform(probe), jpca.transform(probe), atol=1e-6)


def test_encode_split_equals_the_reference():
    x, xj, xt = _images(1030)
    got = plots.encode_split(lambda b: b.reshape(b.shape[0], -1)[:, :LATENT], xt)
    want = jplots.encode_split(lambda b: b.reshape(b.shape[0], -1)[:, :LATENT], xj)
    assert got.shape == (1030, LATENT)
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def frame_probe(monkeypatch):
    """The animation's one draw, the fixed eps, injected on both sides, and
    the frames each side builds captured instead of written."""
    frames = {}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(EPS).reshape(shape).astype(dtype))
    monkeypatch.setattr(torch, "randn", lambda *a, **kw: torch.from_numpy(EPS.copy()))
    monkeypatch.setattr(janim, "_write_gif", lambda f, path, fps: frames.update(jax=(f, fps)))
    monkeypatch.setattr(anim, "_write_gif", lambda f, path, fps: frames.update(port=(f, fps)))
    return frames


@pytest.mark.parametrize("reverse", [False, True])
def test_animation_frames_equal_the_reference(tmp_path, frame_probe, reverse):
    js, ts_, dec = JaxStub(), TorchStub(), Decoders()
    janim.create_diffusion_animation(js, dec.jax, 5, NAMES, num_frames=4, reverse=reverse,
                                     fps=15, save_path=str(tmp_path / "a.gif"))
    anim.create_diffusion_animation(ts_, dec.port, 5, NAMES, num_frames=4, reverse=reverse,
                                    fps=15, save_path=str(tmp_path / "b.gif"))
    assert ts_.calls == js.calls == [("sample", 1, [[5]], None)]
    # one batched q_sample of every frame from the one eps, one decode
    assert len(dec.port_in) == len(dec.jax_in) == 1
    np.testing.assert_allclose(dec.port_in[0], dec.jax_in[0], atol=1e-6)
    (got, fps), (want, jfps) = frame_probe["port"], frame_probe["jax"]
    assert fps == jfps == 15 and len(got) == len(want) > 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pixel_animation_frames_equal_the_reference(tmp_path, frame_probe):
    js, ts_ = JaxStub((16, 16, 3)), TorchStub((16, 16, 3))
    janim.create_pixel_diffusion_animation(js, num_frames=4, save_path=str(tmp_path / "a.gif"))
    anim.create_pixel_diffusion_animation(ts_, num_frames=4, save_path=str(tmp_path / "b.gif"))
    assert ts_.calls == js.calls == [("trajectory", 1, [], None)]
    (got, _), (want, _) = frame_probe["port"], frame_probe["jax"]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_render_frame_and_encode_gif_are_the_reference_s():
    """Equal images render to equal frames, and equal frames encode to the
    same GIF bytes."""
    images = np.random.default_rng(9).random((6, 16, 16, 3))
    titles = [anim.frame_title("3", t, T) for t in range(6)]
    frames = [anim._render_frame(im, title) for im, title in zip(images, titles)]
    for frame, im, title in zip(frames, images, titles):
        np.testing.assert_array_equal(frame, janim._render_frame(im, title))
    got = anim.encode_gif(frames, 10)
    assert got[:6] == b"GIF89a"
    assert got == janim.encode_gif(frames, 10)
