"""ctypes binding of the native data-ingest extension (port of
flowerdiff/native/__init__.py).

`decode_jpeg_batch(paths, size)` decodes and bicubic-resizes JPEG files to
(N, size, size, 3) uint8 with the multithreaded C++ decoder of the
repository's `native/jpeg_loader.cpp`. This module builds it on first use,
with g++ and the reference's flags, into the git-ignored `build/` beside
it, named by a hash of the source, the flags and the host; a concurrent
first use by another process is safe (the library is written aside, then
renamed).
Where it cannot be built (no source beside the package, no g++, no
libjpeg headers) the batch decodes with PIL, as the reference does when
its extension is not built, and `build_error()` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.normpath(os.path.join(_HERE, "..", "..", "..", "native", "jpeg_loader.cpp"))
BUILD_DIR = os.path.join(_HERE, "build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")  # tools/build_native.py's
LIBS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> str:
    """Where the library of the current source and flags is built for this
    host (-march=native: a library built on another machine may not run
    here)."""
    with open(SOURCE, "rb") as fh:
        key = fh.read() + " ".join(FLAGS + LIBS + (platform.node(),)).encode()
    digest = hashlib.sha256(key).hexdigest()
    return os.path.join(BUILD_DIR, f"libflowerjpeg-{digest[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE, *LIBS],
                             capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise OSError(f"g++ exited {out.returncode}: {out.stderr.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The built library, building it on first use; None (and the reason
    kept for `build_error`) where it cannot be built or loaded."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as exc:
            _error = f"{type(exc).__name__}: {exc}"
            return None
        lib.flowerdiff_decode_batch.restype = ctypes.c_int
        lib.flowerdiff_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n
            ctypes.c_int,                     # size
            ctypes.POINTER(ctypes.c_uint8),   # out
            ctypes.POINTER(ctypes.c_uint8),   # status
            ctypes.c_int,                     # n_threads
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native decoder is not in use (None when it is)."""
    _load()
    return _error


def decode_jpeg_batch(paths: List[str], size: int,
                      n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, size, size, 3), ok bool (N,)); a file that fails to
    decode is left zero and marked not ok."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    status = np.zeros((n,), np.uint8)
    if lib is not None:
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        lib.flowerdiff_decode_batch(
            c_paths, n, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_threads)
        return out, status.astype(bool)

    from PIL import Image

    for i, path in enumerate(paths):
        try:
            with Image.open(path) as img:
                img = img.convert("RGB").resize((size, size), Image.BICUBIC)
                out[i] = np.asarray(img, np.uint8)
                status[i] = 1
        except (OSError, ValueError):
            out[i] = 0
    return out, status.astype(bool)
