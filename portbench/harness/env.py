"""The process's surroundings: cache directories, the import check, the card."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "flowerdiff")


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own nvcc builds are under src/flowerdiff_torch/kernels/build/);
    nothing of JAX through a library that would load it."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (`flowerdiff_torch` is not `flowerdiff`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them ({} without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
