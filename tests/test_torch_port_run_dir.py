"""The port's runner resumes from a run directory and serves it: by the
latest step and by an `..._epoch_N` path, `restore_scope="params"`, and the
services built from a run directory (`service_from_run`,
`pixel_service_from_run`, `animate` on both), at the tiny preset on 24
synthetic images, batch 8, on the CPU."""
import os

import numpy as np
import pytest

from flowerdiff_torch.serving import pixel_service_from_run, service_from_run
from flowerdiff_torch.viz import animation
from flowerdiff_torch.train.checkpoints import CheckpointManager
from torch_port_runner_common import BATCH, N, QUIET, STEPS, _port, _steps
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


def test_resume_by_latest_step_and_by_epoch_path(tmp_path, capsys):
    port = _port(tmp_path)
    port.run_latent(total_epochs=2, vae_epochs=1, **QUIET)
    first = capsys.readouterr().out
    assert "No existing autoencoder found" in first
    resumed = _port(tmp_path)
    _, diff = resumed.run_latent(total_epochs=4, **QUIET)
    out = capsys.readouterr().out
    assert "Loading existing autoencoder" in out and "Loaded diffusion model at epoch 2" in out
    assert "Epoch 3/4" in out and "Epoch 2/4" not in out
    assert diff.state.step == 4 * STEPS
    psnr = [line for line in first.splitlines() if line.startswith("VAE recon PSNR")]
    assert psnr and psnr == [line for line in out.splitlines()
                             if line.startswith("VAE recon PSNR")]
    assert os.path.exists(os.path.join(port.results_dir, "diffusion_loss_continued.png"))
    assert _steps(port.results_dir, "ckpt_diffusion") == [1, 2, 3, 4]

    again = _port(tmp_path)
    _, diff = again.run_latent(total_epochs=3,
                               checkpoint_path="somewhere/conditional_diffusion_epoch_1.pt",
                               **QUIET)
    out = capsys.readouterr().out
    assert "Continuing training from epoch 1" in out and "Epoch 2/3" in out
    assert diff.state.step == 3 * STEPS


def test_restore_scope_params_loads_the_sampling_weights(tmp_path, capsys):
    """The flagship's EMA: "params" restores the VAE's generator weights
    and the diffusion weights and EMA the checkpoint holds, leaves the
    moments at zero and skips the recon PSNR."""
    _port(tmp_path, "flagship").run_latent(total_epochs=2, vae_epochs=1, **QUIET)
    capsys.readouterr()
    runner = _port(tmp_path, "flagship")
    vae_trainer, diff = runner.run_latent(total_epochs=2, restore_scope="params", **QUIET)
    assert "VAE recon PSNR" not in capsys.readouterr().out
    run_dir = runner.results_dir
    tree = CheckpointManager(os.path.join(run_dir, "ckpt_diffusion")).restore_host()
    ema = diff.state.ema_params
    assert ema is not None
    for name, value in tree["ema_params"].items():
        np.testing.assert_array_equal(ema[name].numpy(), value, err_msg=name)
        np.testing.assert_array_equal(diff.sampling_params[name].numpy(), value)
        np.testing.assert_array_equal(diff.state.params[diff.state.names.index(name)].numpy(),
                                      tree["params"][name])
    assert any(not np.array_equal(tree["params"][k], v) for k, v in tree["ema_params"].items())
    assert all(not m.any() for m in diff.state.mu)
    vae_tree = CheckpointManager(os.path.join(run_dir, "ckpt_vae")).restore_host()
    gen = vae_trainer.state.gen
    for name, p in zip(gen.names, gen.params):
        np.testing.assert_array_equal(p.numpy(), vae_tree["gen"]["params"][name])
    assert all(not m.any() for m in gen.mu)
    with pytest.raises(ValueError, match="restore_scope"):
        runner.run_latent(total_epochs=2, restore_scope="moments", **QUIET)


def test_service_from_run_serves_what_the_run_saved(tmp_path, monkeypatch):
    """The tiny flagship run: the service samples from the checkpoint's EMA
    weights with the run's latent statistics and x0 clip, at the preset's
    guidance or the one asked for; `animate` returns GIF bytes."""
    runner = _port(tmp_path, "flagship")
    runner.run_latent(total_epochs=2, vae_epochs=1, **QUIET)
    run_dir = runner.results_dir
    kw = dict(version="flagship", tiny=True, synthetic_size=N, seed=0, buckets=(4, 8),
              device="cpu")
    svc = service_from_run(run_dir, **kw)
    assert svc.sampler._inner.guidance_scale == 7.0 and svc.sampler._inner.clip_x0 == 3.0
    stats = np.load(os.path.join(run_dir, "latent_stats.npz"))
    np.testing.assert_array_equal(svc.sampler.mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(svc.sampler.std.numpy(), stats["std"])
    ema = CheckpointManager(os.path.join(run_dir, "ckpt_diffusion")).restore_host()["ema_params"]
    for name, p in svc.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), ema[name], err_msg=name)
    imgs = svc.sample_classes([1, 2], 3, seed=5)
    assert imgs.shape == (6, 64, 64, 3) and np.isfinite(imgs).all()
    np.testing.assert_array_equal(imgs, svc.sample_classes([1, 2], 3, seed=5))
    gif = svc.animate(4, seed=1, num_frames=5)
    assert gif[:6] == b"GIF89a"
    frames = {}
    monkeypatch.setattr(animation, "encode_gif", lambda f, fps: frames.setdefault(
        len(frames), np.stack(f)))
    svc.animate(4, seed=1, num_frames=5)
    service_from_run(run_dir, quantize_uint8=True, **kw).animate(4, seed=1, num_frames=5)
    assert frames[0].shape[0] == 10  # t = 0, 10, .., 40, 49, then 40 .. 10 back
    # the uint8 decode scaled back to [0, 1]: within a count of the float frames
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).max() <= 1
    assert service_from_run(run_dir, guidance_scale=3.0, **kw).sampler._inner.guidance_scale == 3.0
    with pytest.raises(FileNotFoundError, match="no diffusion checkpoint"):
        service_from_run(str(tmp_path / "empty"), **kw)


def test_pixel_service_from_run_serves_what_the_run_saved(tmp_path):
    runner = _port(tmp_path, "v4", name="pixel")
    runner.run_pixel(epochs=2, batch_size=BATCH, cadence_viz=False)
    run_dir = runner.results_dir
    assert _steps(run_dir, "ckpt_pixel") == [2]
    for name in ("samples_grid.png", "diffusion_animation.gif", "generated_pixel_diffusion.png"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    svc = pixel_service_from_run(run_dir, version="v4", tiny=True, buckets=(2, 4),
                                 device="cpu")
    params = CheckpointManager(os.path.join(run_dir, "ckpt_pixel")).restore_host()["params"]
    for name, p in svc.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), params[name], err_msg=name)
    imgs = svc.sample_images(3, seed=2)
    assert imgs.shape == (3, 64, 64, 3) and imgs.min() >= 0.0 and imgs.max() <= 1.0
    assert svc.animate(seed=1, num_frames=5)[:6] == b"GIF89a"
    with pytest.raises(FileNotFoundError, match="no ckpt_pixel"):
        pixel_service_from_run(str(tmp_path / "empty"), tiny=True, device="cpu")


def test_v3_run_labels_colors_and_adapts_class_only_figures(tmp_path):
    """v3: the color labels are extracted once and cached in the run
    directory (the startup color grid beside them), the pipeline trains on
    (class, color), and the class-only figures see a sampler that adds the
    default color."""
    import torch

    from flowerdiff_torch.runner import _CondAdapter

    runner = _port(tmp_path, "v3")
    assert runner.train_ds.colors is not None and runner.train_ds.colors.shape == (N,)
    for name in ("color_labels.npz", "color_visualization.png"):
        assert os.path.exists(os.path.join(runner.results_dir, name)), name
    _, diff = runner.run_latent(total_epochs=1, vae_epochs=1, **QUIET)
    assert diff.cfg.num_colors == 10 and diff.state.step == STEPS
    raw, view = runner._viz_sampler(diff)
    assert isinstance(view, _CondAdapter) and view.latent_dim == raw.latent_dim

    class Recorder:
        sched, event_shape, latent_dim, device = raw.sched, (4,), 4, torch.device("cpu")

        def __init__(self):
            self.calls = []

        def sample(self, batch, *cond, **kw):
            self.calls.append(("sample", batch, [c.tolist() for c in cond], sorted(kw)))

        def masked_denoise(self, x, t_start, *cond, **kw):
            self.calls.append(("masked", x.shape[0], [c.tolist() for c in cond], sorted(kw)))

    inner = Recorder()
    adapter = _CondAdapter(inner, default_color=3)
    adapter.sample(2, torch.tensor([5, 6]), generator=None)
    adapter.masked_denoise(torch.zeros(3, 4), torch.zeros(3), torch.tensor([1, 1, 1]))
    assert inner.calls == [("sample", 2, [[5, 6], [3, 3]], ["generator"]),
                           ("masked", 3, [[1, 1, 1], [3, 3, 3]], [])]
