#!/usr/bin/env python3
"""How fast one multiprocessor can pull bf16 weights out of L2, by the
means a stage kernel has: TMA tile loads (128-byte-swizzled boxes of 64
k's by `lines` rows) through a ring of `slots` shared-memory slots, filled
by one producer thread and released by the consumer warps, against plain
16-byte loads of 256 threads with 8 in flight each.

    python3 src/flowerdiff_torch/tools/ingress_probe.py

A diagnostic of its own, built into the git-ignored build/ingress_probe/
with nvcc; nothing of the library. Each case streams 512 KB of a
(3584, 1024) bf16 matrix that stays in L2 (7.3 MB, read once before the
timing; block b from row 256 b modulo 3584) into each of `blocks` blocks (one a multiprocessor), in a CUDA
graph of 20 launches between CUDA events; prints GB/s a block and in all.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]
CSRC = _PORT / "kernels" / "csrc"

SOURCE = r"""
#include <cstring>

#include "wgmma.cuh"

__device__ unsigned long long g_sink;

// Block b streams 256 rows (from row 256 b modulo rows_total) of the K =
// 1024 wide matrix in chunks of `lines` rows x 64 k's x kb k-tiles, through
// `slots` slots. mode 0: one 2-D box a k-tile; 1: the same after
// prefetch.tensormap; 2: one 1-D bulk copy a chunk of the bytes (no map, the
// chunk's bytes contiguous from the row's start: what the bytes cost alone);
// 3: one 3-D box (64, lines, kb) a chunk.
__global__ void __launch_bounds__(288, 1)
tma_ring(const __grid_constant__ CUtensorMap map, const __grid_constant__ CUtensorMap map3,
         const uint8_t* w, int rows_per, int lines, int slots, int rows_total, int kb, int mode) {
  extern __shared__ uint8_t raw[];
  const uint32_t r = fdh::smem_u32(raw);
  uint8_t* base = raw + (((r + 1023u) & ~1023u) - r);
  const int slot_bytes = lines * 128 * kb;
  const uint32_t bars = fdh::smem_u32(base + slots * slot_bytes);
  const int per_col = rows_per / lines, total = 16 / kb * per_col;
  auto full = [&](int q) { return bars + 8 * (q % slots); };
  auto empty = [&](int q) { return bars + 8 * (slots + q % slots); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      fdh::mbar_init(full(s), 1);
      fdh::mbar_init(empty(s), 8);
    }
    fdh::fence_barrier_init();
  }
  __syncthreads();
  const int row0 = (blockIdx.x * rows_per) % rows_total;
  if (threadIdx.x == 256) {
    if (mode == 1) fdh::tma_prefetch(&map);
    if (mode == 3) fdh::tma_prefetch(&map3);
    for (int q = 0; q < total; ++q) {
      if (q >= slots) fdh::mbar_wait(empty(q), ((q - slots) / slots) & 1);
      fdh::mbar_expect_tx(full(q), slot_bytes);
      const int kc = q / per_col, rr = q % per_col;
      const uint32_t dst = fdh::smem_u32(base + (q % slots) * slot_bytes);
      if (mode <= 1) {
        for (int b = 0; b < kb; ++b)
          fdh::tma_load_2d(dst + b * lines * 128, &map, (kc * kb + b) * 64, row0 + rr * lines,
                           full(q));
      } else if (mode == 2) {
        const uint8_t* src = w + ((size_t)(row0 + rr * lines) * 1024 + kc * kb * 64) * 2;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(dst), "l"(src), "r"(slot_bytes), "r"(full(q))
            : "memory");
      } else {
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
            "l"((uint64_t)&map3), "r"(0), "r"(row0 + rr * lines), "r"(kc * kb), "r"(full(q))
            : "memory");
      }
    }
  } else if (threadIdx.x < 256) {
    unsigned int acc = 0;
    for (int q = 0; q < total; ++q) {
      fdh::mbar_wait(full(q), (q / slots) & 1);
      acc += *(const unsigned int*)(base + (q % slots) * slot_bytes + 4 * (threadIdx.x & 31));
      __syncwarp();
      if ((threadIdx.x & 31) == 0) fdh::mbar_arrive(empty(q));
    }
    if (acc == 0x12345678u) g_sink = acc;
  }
}

__global__ void __launch_bounds__(256, 1)
ldg_stream(const uint4* __restrict__ w, int vecs_per, int vecs_total) {
  const uint4* p = w + ((size_t)blockIdx.x * vecs_per) % vecs_total;
  unsigned int acc = 0;
  for (int i = threadIdx.x; i < vecs_per; i += 256 * 8) {
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + 256 * j < vecs_per) v[j] = __ldg(p + i + 256 * j);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + 256 * j < vecs_per) acc += v[j].x ^ v[j].w;
  }
  if (acc == 0x12345678u) g_sink = acc;
}

// (1024, rows) 2-D, boxes of (64, lines)
extern "C" int probe_map(const void* w, int rows, int lines, void* map) {
  const cuuint64_t dims[2] = {1024, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2048};
  const cuuint32_t box[2] = {64, (cuuint32_t)lines};
  const cuuint32_t elem[2] = {1, 1};
  return fdh::encode_tiled()((CUtensorMap*)map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)w,
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : 1;
}

// (64, rows, 16) over the (rows, 1024) matrix: k-tile t of row r at byte
// 2048 r + 128 t; boxes of (64, lines, kb).
extern "C" int probe_map3(const void* w, int rows, int lines, int kb, void* map) {
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, 16};
  const cuuint64_t strides[2] = {2048, 128};
  const cuuint32_t box[3] = {64, (cuuint32_t)lines, (cuuint32_t)kb};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fdh::encode_tiled()((CUtensorMap*)map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)w,
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : 1;
}

extern "C" int probe_tma(const void* map, const void* map3, const void* w, int blocks,
                         int rows_per, int lines, int slots, int rows_total, int kb, int mode,
                         void* stream) {
  const int smem = 1024 + slots * lines * 128 * kb + 16 * slots;
  cudaFuncSetAttribute(tma_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  CUtensorMap m, m3;
  memcpy(&m, map, sizeof(m));
  memcpy(&m3, map3, sizeof(m3));
  tma_ring<<<blocks, 288, smem, (cudaStream_t)stream>>>(m, m3, (const uint8_t*)w, rows_per,
                                                         lines, slots, rows_total, kb, mode);
  return (int)cudaGetLastError();
}

extern "C" int probe_ldg(const void* w, int blocks, int vecs_per, int vecs_total,
                         void* stream) {
  ldg_stream<<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)w, vecs_per, vecs_total);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    work = _ROOT / "build" / "ingress_probe"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "probe.cu"
    src.write_text(SOURCE)
    out = work / "libprobe.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def main() -> int:
    import torch

    sys.path.insert(0, str(_PORT.parent))
    from flowerdiff_torch.utils.timing import cuda_ms

    lib = build()
    for fn in (lib.probe_map, lib.probe_map3, lib.probe_tma, lib.probe_ldg):
        fn.restype = ctypes.c_int
    lib.probe_map.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_map3.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.probe_tma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.probe_ldg.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[ingress] card: {name.strip()}")
    rows = 3584  # 7.3 MB of bf16 at K = 1024: the 1024 -> 512 stage's weights
    w = torch.randn(rows, 1024, device="cuda").to(torch.bfloat16)
    w.float().sum()

    def stream():  # the current stream: inside a graph's capture, the capture's
        return torch.cuda.current_stream().cuda_stream

    rows_per = 256  # 512 KB a block, about the 1024 -> 512 stage's 460 KB a block
    per_block = rows_per * 1024 * 2
    modes = {0: "2-D box a k-tile", 1: "2-D box a k-tile, prefetched map",
             2: "1-D bulk copy a chunk", 3: "3-D box a chunk"}
    for blocks in (1, 16, 128):
        cases = [(0, 16, 1, 8), (0, 64, 1, 8), (0, 64, 1, 24), (0, 256, 1, 2), (1, 64, 1, 8),
                 (2, 64, 1, 8), (2, 64, 4, 4), (0, 64, 4, 4), (3, 64, 4, 4), (3, 16, 16, 4),
                 (3, 128, 2, 4), (3, 64, 2, 8)]
        for mode, lines, kb, slots in cases:
            maps = []
            for enc, args in ((lib.probe_map, (lines,)), (lib.probe_map3, (lines, kb))):
                buf = ctypes.create_string_buffer(128 + 64)
                at = -(-ctypes.addressof(buf) // 64) * 64
                assert enc(w.data_ptr(), rows, *args, at) == 0
                maps.append((buf, at))
            fn = lambda: lib.probe_tma(maps[0][1], maps[1][1], w.data_ptr(), blocks,  # noqa: E731
                                       rows_per, lines, slots, rows, kb, mode, stream())
            ms = cuda_ms(fn, iters=20)
            chunk = lines * 128 * kb
            print(f"[ingress] blocks {blocks} {modes[mode]}: chunk {lines} lines x {64 * kb} k "
                  f"({chunk} B), {slots} slots: {per_block / ms / 1e6:.1f} GB/s a block, "
                  f"{blocks * per_block / ms / 1e6:.1f} in all ({ms * 1e3:.2f} us for "
                  f"{per_block} B a block)", flush=True)
        vecs = per_block // 16
        ms = cuda_ms(lambda: lib.probe_ldg(w.data_ptr(), blocks, vecs, rows * 1024 // 8, stream()),
                     iters=20)
        print(f"[ingress] blocks {blocks} ldg (256 threads, 8 x 16 B in flight each): "
              f"{per_block / ms / 1e6:.1f} GB/s a block, {blocks * per_block / ms / 1e6:.1f} in "
              f"all ({ms * 1e3:.2f} us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
