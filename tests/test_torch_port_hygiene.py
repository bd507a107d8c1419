"""The port stands alone: flowerdiff_torch and chip_smoke.py import neither
JAX nor the JAX package, and entry points refuse to fall back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "flowerdiff_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path[:0] = [{root!r}, {src!r}]
import flowerdiff_torch
for mod in pkgutil.walk_packages(flowerdiff_torch.__path__, "flowerdiff_torch."):
    importlib.import_module(mod.name)
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


def test_port_sources_name_no_jax_or_flowerdiff():
    pattern = re.compile(r"^\s*(import\s+(jax|flax|flowerdiff)\b|"
                         r"from\s+(jax|flax|flowerdiff)(\.|\s))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from flowerdiff_torch import resolve_device
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import DiffusionSampler, FusedDiffusionSampler
    from flowerdiff_torch.models import ConditionalLatentDenoiser, FlowerVAE
    from flowerdiff_torch.serving import SamplingService
    from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(latent_dim=16, hidden_dims=(16, 16), time_emb_dim=16, num_classes=3)
    model = ConditionalLatentDenoiser(**kw)
    vae = FlowerVAE(latent_dim=16, channels=(8, 16), head_width=16)
    sched = linear_schedule(3)
    calls = [
        lambda: resolve_device(),
        lambda: DiffusionSampler(model, sched, (16,)),
        lambda: FusedDiffusionSampler(model, sched, (16,)),
        lambda: SamplingService(model, vae, sched=sched),
        lambda: denoiser_from_params(init_numpy_params("denoiser", **kw), **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
