"""Tracing, spans and a NaN/Inf check (port of flowerdiff/utils/profiling.py).

  - `trace(logdir)`: torch.profiler over the block (CPU and, where there is
    a card, CUDA activity), written as a chrome trace `trace.json` into
    `logdir`;
  - `annotate(name)`: a named span in that trace (`record_function`);
  - `debug_mode()`: PyTorch's anomaly detection for the block, plus
    `check_finite`, which raises on a NaN or Inf in the tensors it is given
    (the counterpart of jax_debug_nans / jax_debug_infs; each check
    synchronises with the device, so it is for tests and debugging runs).
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler. The chrome trace lands in
    `logdir/trace.json` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span in the trace: `with annotate('vae_fwd'): ...`."""
    return record_function(name)


def check_finite(*tensors: torch.Tensor, nans: bool = True, infs: bool = True,
                 what: str = "tensor") -> None:
    """Raise FloatingPointError if a floating tensor of `tensors` holds a
    NaN (with `nans`) or an Inf (with `infs`)."""
    for i, t in enumerate(tensors):
        if not t.is_floating_point():
            continue
        if nans and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{what} {i}: NaN in a tensor of shape {tuple(t.shape)}")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"{what} {i}: Inf in a tensor of shape {tuple(t.shape)}")


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Anomaly detection for the block (a backward that makes a NaN
    raises); yields `check_finite` with these `nans` / `infs`, for the
    outputs the caller wants checked."""
    with torch.autograd.detect_anomaly(check_nan=nans):
        yield functools.partial(check_finite, nans=nans, infs=infs)
