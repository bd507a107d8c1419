#!/usr/bin/env python3
"""Where one step of the reverse-process kernel spends its time, phase by
phase, on one CUDA card.

    python3 src/flowerdiff_torch/tools/process_phases.py [--launches 3] [--buckets 8,64]

A diagnostic build, never the library's: this tree's csrc/ is copied under
the git-ignored build/process_phases/, its reverse_process.cu compiled with
the stamp macros defined ahead of it into a library of its own, and that
library put in place of `reverse_process` before the flagship sampler
(seeded weights, 1000 steps, CFG 7.0, x0 clip 3.0) binds its plans. Thread 0
of the first block of the first cluster reads %globaltimer at the launch's
start, after its set-up, at each phase boundary of step T / 2, and at its
end, and adds the time since the launch began into device arrays; waits on
the weight ring inside that step are added up per product on their own.
The library itself has no such switch: its stamps (FD_STAMP,
FD_STEP_STAMP in csrc/reverse_process.cu) compile to nothing unless the
macros are defined ahead of the source, as here.

Per bucket (guided): `launches` launches after one warm-up, the mean of
each phase printed as `[process_phases] bucket B plan: phase us`, then one
JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]
sys.path.insert(0, str(_PORT.parent))

from flowerdiff_torch.diffusion import linear_schedule  # noqa: E402
from flowerdiff_torch.kernels import _build  # noqa: E402
from flowerdiff_torch.kernels import full_sampler as fs  # noqa: E402
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params  # noqa: E402

FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                num_classes=102, shared_cond_proj=True, global_skip=False)
STAMPS = 64

_PRELUDE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long fd_phase_ns[64], fd_wait_ns[8];
__device__ unsigned long long fd_phase_launches;
__device__ int fd_in_step;
__device__ __forceinline__ unsigned long long fd_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool fd_stamping() {
  return blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
}
#define FD_STAMP_BEGIN unsigned long long fd_t0 = 0; bool fd_step_on = false
#define FD_STAMP(i)                                                     \
  do {                                                                  \
    if (fd_stamping()) {                                                \
      const unsigned long long fd_t = fd_globaltimer();                 \
      if ((i) == 0) { fd_t0 = fd_t; ++fd_phase_launches; }              \
      fd_phase_ns[i] += fd_t - fd_t0;                                   \
    }                                                                   \
  } while (0)
#define FD_RING_WAIT(p, wait)                                           \
  do {                                                                  \
    const unsigned long long fd_w = fd_globaltimer();                   \
    wait;                                                               \
    if (fd_stamping() && fd_in_step) fd_wait_ns[p] += fd_globaltimer() - fd_w; \
  } while (0)
#define FD_STEP_STAMPS 1
#define FD_STAMP_STEP(on)                                               \
  do {                                                                  \
    fd_step_on = (on);                                                  \
    if (fd_stamping()) fd_in_step = (on);                               \
  } while (0)
#define FD_STEP_STAMP(i)                                                \
  do {                                                                  \
    if (fd_step_on) FD_STAMP(i);                                        \
  } while (0)
"""

_READOUT = r"""
extern "C" int fd_process_phases_read(unsigned long long* ns, unsigned long long* waits,
                                      unsigned long long* launches) {
  cudaError_t e = cudaMemcpyFromSymbol(ns, fd_phase_ns, sizeof(fd_phase_ns));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(waits, fd_wait_ns, sizeof(fd_wait_ns));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(launches, fd_phase_launches, sizeof(fd_phase_launches));
  return (int)e;
}
extern "C" int fd_process_phases_reset() {
  static unsigned long long zero[64] = {0};
  cudaError_t e = cudaMemcpyToSymbol(fd_phase_ns, zero, sizeof(fd_phase_ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_wait_ns, zero, sizeof(fd_wait_ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_phase_launches, zero, sizeof(unsigned long long));
  return (int)e;
}
"""

_STAGE_PHASES = ["adds, exchange: h operand", "product Wb", "exchange: LN1 stats",
                 "LN1 + swish, exchange: LN2 stats", "LN2, exchange: Wv operand", "product Wv",
                 "exchange: Wo operand", "product Wo", "h += o, exchange: Wd operand",
                 "product Wd"]
_WAIT_NAMES = ["projection", "skip", "Wb", "Wv", "Wo", "Wd", "head"]


def phase_names(n: int):
    """(stamp, the phase that ends there) of one step, in the order taken."""
    out = [(3, "exchange: x operand"), (4, "product: projection (+ skip)")]
    for st in range(n):
        out += [(5 + 10 * st + i, f"stage {st}: {name}") for i, name in enumerate(_STAGE_PHASES)]
    out += [(5 + 10 * n, "head: adds, exchange: LN stats"), (6 + 10 * n, "head: LN, exchange: "
            "operand"), (7 + 10 * n, "head: product Wf"), (8 + 10 * n, "reverse step")]
    return out


def build() -> Path:
    """This tree's reverse_process.cu with stamps, compiled into a library of
    its own under build/process_phases/."""
    work = _ROOT / "build" / "process_phases"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    src = work / "csrc" / "reverse_process_stamped.cu"
    src.write_text(_PRELUDE + (_build.CSRC / "reverse_process.cu").read_text() + _READOUT)
    lib = work / "libreverse_process_stamped.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(work / "csrc"), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"process_phases: nvcc failed:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--buckets", default="8,64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("process_phases: no CUDA device")
    lib = ctypes.CDLL(str(build()))
    _build._LIBS["reverse_process"] = lib
    for fn in (lib.fd_process_phases_read, lib.fd_process_phases_reset):
        fn.restype = ctypes.c_int
    model = denoiser_from_params(init_numpy_params("denoiser", seed=0, **FLAGSHIP),
                                 device="cuda", **FLAGSHIP)
    prep = fs.prepare_fused_sampler(model, linear_schedule(1000))
    process = fs.ReverseProcess(prep)
    n = len(FLAGSHIP["hidden_dims"]) - 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for b in (int(v) for v in args.buckets.split(",")):
        cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
        inputs = fs.draw_request(prep, b, cls, None, torch.Generator(device="cuda").manual_seed(0),
                                 None, guided=True)
        kw = dict(clip_x0=3.0, guidance_scale=7.0)
        process(inputs, **kw)
        torch.cuda.synchronize()
        _build.check(lib.fd_process_phases_reset(), "reset")
        for _ in range(args.launches):
            process(inputs, **kw)
        torch.cuda.synchronize()
        ns = (ctypes.c_ulonglong * STAMPS)()
        waits = (ctypes.c_ulonglong * 8)()
        launches = ctypes.c_ulonglong(0)
        _build.check(lib.fd_process_phases_read(ns, waits, ctypes.byref(launches)), "read")
        k = max(1, launches.value)
        at = np.array(ns[:], dtype=np.float64) / k / 1e3  # us since the launch began
        plan = process.plan_for(b, True)
        phases, prev = {}, at[2]
        for stamp, name in phase_names(n):
            phases[name] = round(at[stamp] - prev, 3)
            prev = at[stamp]
        row = {"bucket": b, "plan": plan._asdict(), "launches": k, "card": smi,
               "set-up us": round(at[1], 3), "launch us": round(at[63], 3),
               "step us": round(at[8 + 10 * n] - at[2], 3),
               "ring waits us": {w: round(v / k / 1e3, 3)
                                 for w, v in zip(_WAIT_NAMES, waits[:7])},
               "phases us": phases}
        for name, us in phases.items():
            print(f"[process_phases] bucket {b} {plan}: {name} {us:.3f} us", flush=True)
        print(f"[process_phases] bucket {b}: set-up {row['set-up us']} us, step {row['step us']} "
              f"us, launch {row['launch us']} us; ring waits {row['ring waits us']}", flush=True)
        print(json.dumps(row), flush=True)
    print(f"[process_phases] card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
