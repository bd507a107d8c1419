#!/usr/bin/env python3
"""What sets the floor of a train-step product launch: the pieces of the
earlier dW kernel (`gemm_kernel<__nv_bfloat16, 64>`, a 64 x 32 tile a block
of 128 threads, operands loaded into registers, then bf16 into shared
memory, `mma.sync`) and the launch of each form's grid, timed apart on one
CUDA card.

    python3 src/flowerdiff_torch/tools/gemm_floor.py [TREE]

TREE (default ".") is a directory inside this checkout that holds
src/flowerdiff_torch; its products are timed through its own library
(`linear_forward`, `linear_dx`, `linear_dw` of kernels/train_step.py). A
probe library built from the C++ source below (self-contained, nvcc into
build/gemm_floor/) times, at each (form, M, N, K) of the flagship step
(`gemm_ab.step_products`):
  - an empty kernel on that kernel's grid (64 x 32 tiles, 128 threads) and
    on the split-K grid of `splitk_gemm_kernel` (clusters of s blocks, 64 KB
    of dynamic shared memory, `splitk_plan`);
  - the dW form's load phase alone: gemm_kernel's global loads into
    registers and their bf16 rounding into shared memory, no product;
  - the dW form's column sum alone (db: one thread a row of the tile's
    first block column, a serial loop over the 64 batch rows);
and prints the ptxas report (registers, shared memory, spills) of the
tree's train_step library and of the probe, then the card's name and power
limit. Times are `cuda_ms` (CUDA-graph replays between events, utils/timing.py
of this checkout), in us.
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int TM = 64, TN = 32, TK = 64, kThreads = 128, LD = TK + 8;

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// gemm_kernel<__nv_bfloat16, 64>'s fetch and stage for one k step (K <= 64),
// then one value a block stored so that nothing is dropped.
__global__ void __launch_bounds__(kThreads)
load_phase(const float* A, long a_sm, long a_sk, const float* B, long b_sn, long b_sk,
           float* out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[TM * LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[TN * LD];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  constexpr int NA = TM * TK / kThreads, NB = TN * TK / kThreads;
  float ra[NA], rb[NB];
  const bool a_kfast = a_sk == 1, b_kfast = b_sk == 1;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = i * kThreads + tid;
    const int r = a_kfast ? e / TK : e % TM, c = a_kfast ? e % TK : e / TM;
    const int m = m0 + r, k = c;
    ra[i] = (m < M && k < K) ? A[(size_t)m * a_sm + (size_t)k * a_sk] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int e = i * kThreads + tid;
    const int r = b_kfast ? e / TK : e % TN, c = b_kfast ? e % TK : e / TN;
    const int n = n0 + r, k = c;
    rb[i] = (n < N && k < K) ? B[(size_t)n * b_sn + (size_t)k * b_sk] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = i * kThreads + tid;
    const int r = a_kfast ? e / TK : e % TM, c = a_kfast ? e % TK : e / TM;
    As[r * LD + c] = __float2bfloat16(ra[i]);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int e = i * kThreads + tid;
    const int r = b_kfast ? e / TK : e % TN, c = b_kfast ? e % TK : e / TN;
    Bs[r * LD + c] = __float2bfloat16(rb[i]);
  }
  __syncthreads();
  if (tid == 0)
    out[blockIdx.y * gridDim.x + blockIdx.x] =
        __bfloat162float(As[(blockIdx.x * 7) % (TM * LD)]) +
        __bfloat162float(Bs[(blockIdx.y * 5) % (TN * LD)]);
}

// gemm_kernel's column sum: block column 0, one thread a row, in row order.
__global__ void __launch_bounds__(kThreads)
colsum_phase(const float* A, long a_sm, long a_sk, float* colsum, int M, int K, float scale) {
  const int tid = threadIdx.x, m0 = blockIdx.y * TM;
  if (blockIdx.x == 0 && tid < TM && m0 + tid < M) {
    const float* a = A + (size_t)(m0 + tid) * a_sm;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += a[(size_t)k * a_sk];
    colsum[m0 + tid] = scale * s;
  }
}

static dim3 gemm_grid(int M, int N) { return dim3((N + TN - 1) / TN, (M + TM - 1) / TM); }

extern "C" int probe_empty_gemm(int M, int N, void* stream) {
  empty_kernel<<<gemm_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// the split-K launch: clusters of s blocks along x, 64 KB of dynamic smem
extern "C" int probe_empty_splitk(int M, int N, int K, void* stream) {
  const size_t smem = 65536;
  cudaError_t e = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (K + 63) / 64;
  int s = 1;
  while (s < 8 && 2 * s <= tiles) s *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + TN - 1) / TN * s), (unsigned)((M + TM - 1) / TM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, empty_kernel);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the dW form: A(m, k) = dY[k][m], B(n, k) = X[k][n]
extern "C" int probe_load_dw(const void* dy, const void* x, void* out, int M, int N, int K,
                             void* stream) {
  load_phase<<<gemm_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, 1, M, (const float*)x, 1, N, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int probe_colsum_dw(const void* dy, void* db, int M, int N, int K, void* stream) {
  colsum_phase<<<gemm_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, 1, M, (float*)db, M, K, 1.f);
  return (int)cudaGetLastError();
}
"""


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, _PORT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build_probe(tree_build: Path):
    from flowerdiff_torch.kernels import _build

    tree_build.mkdir(parents=True, exist_ok=True)
    src = tree_build / "gemm_floor.cu"
    src.write_text(PROBE_CU)
    lib = tree_build / "libgemm_floor.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise SystemExit(f"nvcc failed for the probe:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib)), out.stdout + out.stderr


def _ptxas_lines(report: str, keep=("gemm", "splitk", "load_phase", "colsum", "empty")):
    """ptxas's per-function lines of a report, with each function's name."""
    lines, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and any(k in fn for k in keep) and ("registers" in line or "spill" in line
                                                   or "smem" in line):
            lines.append(f"{fn}: {line.strip()}")
    return lines


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    if tree != _ROOT and _ROOT not in tree.parents:
        raise SystemExit(f"{tree} is not inside the checkout {_ROOT}")
    sys.path.insert(0, str(tree / "src"))
    import torch
    from flowerdiff_torch.kernels import _build
    from flowerdiff_torch.kernels import train_step as ts

    if not torch.cuda.is_available():
        raise SystemExit("gemm_floor needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_ms = _load("_fd_timing", "utils/timing.py").cuda_ms
    step_products = _load("_fd_gemm_ab", "tools/gemm_ab.py").step_products
    reports = _build.build_all(["train_step"])
    probe, probe_report = _build_probe(_ROOT / "build" / "gemm_floor")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    probe.probe_empty_gemm.argtypes = [ci, ci, vp]
    probe.probe_empty_splitk.argtypes = [ci, ci, ci, vp]
    probe.probe_load_dw.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    probe.probe_colsum_dw.argtypes = [vp, vp, ci, ci, ci, vp]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        def run():
            code = fn(*args, stream())
            if code:
                raise RuntimeError(f"probe failed: cudaError {code}")
        return run

    def us(fn):
        return 1000.0 * cuda_ms(fn)

    sums = {}
    for (form, m, n, k), count in step_products().items():
        if form == "dw":
            dy = torch.randn(k, m, generator=gen, device="cuda")
            x = torch.randn(k, n, generator=gen, device="cuda")
            out = torch.empty(m * n, device="cuda")
            db = torch.empty(m, device="cuda")
            rec = {"product": us(lambda: ts.linear_dw(dy, x, exact=False)),
                   "empty on the 64 x 32 grid": us(call(probe.probe_empty_gemm, m, n)),
                   "load phase": us(call(probe.probe_load_dw, dy.data_ptr(), x.data_ptr(),
                                         out.data_ptr(), m, n, k)),
                   "column sum": us(call(probe.probe_colsum_dw, dy.data_ptr(), db.data_ptr(),
                                         m, n, k))}
        else:
            a = torch.randn(m, k, generator=gen, device="cuda")
            if form == "fwd":
                w, b = torch.randn(n, k, generator=gen, device="cuda"), torch.zeros(n, device="cuda")
                product = lambda: ts.linear_forward(a, w, b, exact=False)  # noqa: E731
            else:
                w = torch.randn(k, n, generator=gen, device="cuda")
                product = lambda: ts.linear_dx(a, w, exact=False)  # noqa: E731
            rec = {"product": us(product),
                   "empty on the split-K grid": us(call(probe.probe_empty_splitk, m, n, k))}
        print(f"[gemm_floor] {form} M={m} N={n} K={k} x{count}: "
              + ", ".join(f"{what} {v:.3f} us" for what, v in rec.items()), flush=True)
        for what, v in rec.items():
            sums[(form, what)] = sums.get((form, what), 0.0) + count * v
    for (form, what), v in sums.items():
        print(f"[gemm_floor] sum over a step's {form} products: {what} {v:.2f} us")
    for line in _ptxas_lines(reports.get("train_step", "")) + _ptxas_lines(probe_report):
        print(f"[gemm_floor] ptxas {line}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[gemm_floor] card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
