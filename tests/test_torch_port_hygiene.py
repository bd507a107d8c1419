"""The port stands alone: flowerdiff_torch and chip_smoke.py import neither
JAX nor the JAX package, and entry points refuse to fall back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "flowerdiff_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path[:0] = [{root!r}, {src!r}]
import flowerdiff_torch
names = [mod.name for mod in pkgutil.walk_packages(flowerdiff_torch.__path__,
                                                    "flowerdiff_torch.")]
for name in names:
    importlib.import_module(name)
print("WALKED", sorted(names))
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "flowerdiff" or m.startswith(("flowerdiff.", "jax.", "jaxlib", "flax")))
print("LOADED", bad)
"""


def test_port_imports_without_jax_or_flowerdiff():
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    for name in ("cli", "__main__", "runner", "serving", "data.flowers102",
                 "data.color_labels", "viz", "viz.animation", "viz.color_viz", "viz.curves",
                 "viz.denoise_path", "viz.grids", "viz.latent_compare", "viz.latent_plots",
                 "viz.recon", "serving_http", "utils.torch_import", "tools.serve",
                 "tools.import_torch_checkpoint", "tools.export_torch_checkpoint"):
        assert f"'flowerdiff_torch.{name}'" in out.stdout, name


def test_port_sources_name_no_jax_or_flowerdiff():
    pattern = re.compile(r"^\s*(import\s+(jax|flax|flowerdiff)\b|"
                         r"from\s+(jax|flax|flowerdiff)(\.|\s))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from flowerdiff_torch import resolve_device
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import DiffusionSampler, FusedDiffusionSampler
    from flowerdiff_torch.models import ConditionalLatentDenoiser, FlowerVAE
    from flowerdiff_torch.serving import SamplingService
    from flowerdiff_torch.data import DeviceDataset
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        LatentDiffusionTrainer,
        create_latent_diffusion_state,
    )
    from flowerdiff_torch.models import Discriminator64, VGGPerceptual
    from flowerdiff_torch.train.vae_gan import (
        VAEGANConfig,
        VAEGANTrainer,
        create_vae_gan_state,
    )
    from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params
    from flowerdiff_torch.models.pixel_unet import PixelUNet
    from flowerdiff_torch.serving import PixelSamplingService
    from flowerdiff_torch.train.pixel_ddpm import (
        PixelDiffusionConfig,
        PixelDiffusionTrainer,
        create_pixel_diffusion_state,
    )
    from flowerdiff_torch.utils.weights import pixel_unet_from_params

    from flowerdiff_torch.configs import get_preset, tiny_preset
    from flowerdiff_torch.runner import PipelineRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pix = dict(base_channels=8, time_emb_dim=8)
    pix_cfg = PixelDiffusionConfig(img_size=16, n_steps=3, **pix)
    kw = dict(latent_dim=16, hidden_dims=(16, 16), time_emb_dim=16, num_classes=3)
    model = ConditionalLatentDenoiser(**kw)
    vae = FlowerVAE(latent_dim=16, channels=(8, 16), head_width=16)
    sched = linear_schedule(3)
    cfg = LatentDiffusionConfig(hidden_dims=(16, 16), **{k: v for k, v in kw.items()
                                                         if k != "hidden_dims"})
    gan_cfg = VAEGANConfig(latent_dim=8, channels=(8, 16, 24, 32), head_width=16,
                           num_classes=3, use_perceptual=False)
    calls = [
        lambda: LatentDiffusionTrainer(cfg, vae),
        lambda: create_latent_diffusion_state(0, cfg),
        lambda: DeviceDataset(np.zeros((2, 8, 8, 3), np.uint8), np.zeros(2)),
        lambda: resolve_device(),
        lambda: DiffusionSampler(model, sched, (16,)),
        lambda: FusedDiffusionSampler(model, sched, (16,)),
        lambda: SamplingService(model, vae, sched=sched),
        lambda: denoiser_from_params(init_numpy_params("denoiser", **kw), **kw),
        lambda: VAEGANTrainer(gan_cfg),
        lambda: create_vae_gan_state(0, gan_cfg),
        lambda: Discriminator64(),
        lambda: VGGPerceptual(),
        lambda: PixelDiffusionTrainer(pix_cfg),
        lambda: create_pixel_diffusion_state(0, pix_cfg),
        lambda: PixelSamplingService(PixelUNet(**pix), sched=sched),
        lambda: pixel_unet_from_params(init_numpy_params("pixel", **pix), **pix),
        lambda: PipelineRunner(tiny_preset(get_preset("v4")), results_dir=str(tmp_path),
                               dataset="synthetic", synthetic_size=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_tools_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """Without FLOWERDIFF_PLATFORM the import tool and tools/serve.py build
    on the card, and raise without one: nothing falls back to the CPU."""
    from flowerdiff_torch import configs
    from flowerdiff_torch.models import ConditionalLatentDenoiser
    from flowerdiff_torch.tools import import_torch_checkpoint, serve
    from flowerdiff_torch.train.checkpoints import CheckpointManager
    from flowerdiff_torch.utils.torch_import import export_latent_denoiser

    monkeypatch.delenv("FLOWERDIFF_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    full = configs.get_preset  # the import tool at the preset's tiny widths
    monkeypatch.setattr(configs, "get_preset", lambda name: configs.tiny_preset(full(name)))
    den = ConditionalLatentDenoiser(latent_dim=32, hidden_dims=(32, 64, 32), time_emb_dim=32)
    torch.save(export_latent_denoiser(den).params, tmp_path / "den.pt")
    for version, ckpt in (("v1", "ckpt_diffusion"), ("v4", "ckpt_pixel")):
        CheckpointManager(str(tmp_path / version / ckpt)).save(1, {"step": torch.tensor(1)})
    calls = [
        lambda: import_torch_checkpoint.main(["--preset", "v1", "--out", str(tmp_path / "out"),
                                              "--diffusion", str(tmp_path / "den.pt")]),
        lambda: serve.build_service(serve.build_parser().parse_args(
            ["--results_dir", str(tmp_path / "v1"), "--tiny"])),
        lambda: serve.build_service(serve.build_parser().parse_args(
            ["--results_dir", str(tmp_path / "v4"), "--version", "v4", "--tiny"])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "out" / "ckpt_diffusion").exists()


def test_unported_training_paths_raise_rather_than_run_something_else():
    """A compute dtype other than float32 and bfloat16 raises in both
    trainers and names the setting, and nothing trains in another type
    instead. The train kernel's limits raise as in the reference: no v3
    model, and only with the whole-epoch encode on the uncached path; an
    unknown sampler kind raises in the service."""
    from flowerdiff_torch.data import DeviceDataset
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.models import ConditionalLatentDenoiser, FlowerVAE
    from flowerdiff_torch.serving import SamplingService
    from flowerdiff_torch.train import fused
    from flowerdiff_torch.train.latent_ddpm import LatentDiffusionConfig, LatentDiffusionTrainer

    kw = dict(latent_dim=16, hidden_dims=(16, 16), time_emb_dim=16, num_classes=3)
    vae = FlowerVAE(latent_dim=16, channels=(8, 16), head_width=16)
    imgs, labels = np.zeros((4, 16, 16, 3), np.uint8), np.zeros(4, np.int64)
    from flowerdiff_torch.train.vae_gan import VAEGANConfig, VAEGANTrainer

    with pytest.raises(ValueError, match="compute_dtype"):
        LatentDiffusionTrainer(LatentDiffusionConfig(compute_dtype="float16", **kw), vae,
                               device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        VAEGANTrainer(VAEGANConfig(compute_dtype="float16", use_perceptual=False), device="cpu")
    assert LatentDiffusionTrainer(LatentDiffusionConfig(compute_dtype="bfloat16", **kw), vae,
                                  device="cpu").state.step == 0
    uncached = LatentDiffusionTrainer(LatentDiffusionConfig(train_kernel=True, **kw), vae,
                                      device="cpu")
    with pytest.raises(ValueError, match="epoch_encode"):
        uncached.run_epochs_fused(DeviceDataset(imgs, labels, device="cpu"), 1, None, None,
                                  batch_size=2)
    assert uncached.state.step == 0
    v3 = dict(kw, shared_cond_proj=False, num_colors=2)
    trainer = LatentDiffusionTrainer(
        LatentDiffusionConfig(latent_cache=1, train_kernel=True, **v3), vae, device="cpu")
    with pytest.raises(ValueError, match="v1/v2"):
        trainer.run_epochs_fused(DeviceDataset(imgs, labels, colors=labels, augment=False,
                                               device="cpu"), 1, None, None, batch_size=2)
    with pytest.raises(ValueError, match="v1/v2"):
        fused.make_fused_latent_epochs(trainer.model, vae, trainer.sched, trainer.cfg,
                                       has_colors=True, epoch_encode=True)
    with pytest.raises(ValueError, match="sampler_kind"):
        SamplingService(ConditionalLatentDenoiser(**kw), vae, sched=linear_schedule(3),
                        sampler_kind="euler", device="cpu")
    from flowerdiff_torch.models.pixel_unet import PixelUNet
    from flowerdiff_torch.serving import PixelSamplingService
    from flowerdiff_torch.train.pixel_ddpm import PixelDiffusionConfig, PixelDiffusionTrainer

    with pytest.raises(ValueError, match="compute_dtype"):
        PixelDiffusionTrainer(PixelDiffusionConfig(compute_dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="sampler_kind"):
        PixelSamplingService(PixelUNet(base_channels=8), sched=linear_schedule(3),
                             sampler_kind="euler", device="cpu")


def test_every_cuda_source_is_built_and_keeps_a_plain_c_interface():
    """Each csrc/*.cu is a library `_build` knows, with `extern "C"` entry
    points; no source or shared header pulls in PyTorch's headers, which
    would turn a build of seconds into one of minutes."""
    from flowerdiff_torch.kernels import _build

    sources = sorted(_build.CSRC.glob("*.cu"))
    assert sorted(p.stem for p in sources) == sorted(_build.SOURCES)
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert {p.name for p in headers} >= {"rows.cuh", "philox.cuh", "train_step.cuh"}
    for path in sources + headers:
        text = path.read_text()
        assert "torch/" not in text and "ATen" not in text, path.name
        if path.suffix == ".cu":
            assert 'extern "C"' in text, path.name
    # the epoch library enqueues the train step's own sequence, not a copy of it
    assert '#include "train_step.cuh"' in (_build.CSRC / "train_epoch.cu").read_text()
    assert "train_step_enqueue(" in (_build.CSRC / "train_step.cu").read_text()
