"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles, with `nvcc` for sm_90a, into its own shared
library with a plain C interface, loaded with ctypes. A library is built on
first use, into `kernels/build/` (git-ignored), under a name keyed by a hash
of its source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is reused. `build_all()` starts one `nvcc` per
source at once and waits for all of them.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on a nonzero code. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from flowerdiff_torch.utils import profiling

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = ("latent_stage", "latent_head", "latent_proj", "reverse_step", "reverse_process",
           "train_step", "train_epoch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "flowerdiff_torch's kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every library not yet built, in parallel. Returns each
    library's ptxas report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List = []
    reports: Dict[str, str] = {}
    for name in names:
        out = _lib_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, log, proc))
    failures = []
    for name, out, tmp, log, proc in jobs:
        text, _ = proc.communicate()
        log.write_text(text)
        reports[name] = text
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, built first if needed. A load
    that is not already done is a span `kernels.load` (library, built)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        with profiling.annotate("kernels.load", library=name) as span:
            built = not path.exists()
            if built:
                build_all([name])
            lib = ctypes.CDLL(str(path))
            span.set(built=built)
        _LIBS[name] = lib
    return lib


def loaded(name: str):
    """The ctypes handle of library `name` if this process has loaded it, else None."""
    return _LIBS.get(name)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")
