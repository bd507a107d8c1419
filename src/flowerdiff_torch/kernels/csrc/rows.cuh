// Building blocks for kernels in which a block (or a cluster of blocks)
// holds kRows = 16 whole rows of a (B, d) activation in shared memory, so
// that LayerNorm row statistics never leave the block.
//
// Activations live in shared memory as f32, row-major with the row stride
// equal to their width; the operand of a product is a bf16 copy with rows
// padded by kPad elements (bank-conflict-free fragment loads). Products run
// on the tensor cores as `mma.sync` m16n8k16 bf16 tiles with f32
// accumulators: bf16 x bf16 products are exact in f32, so only the
// summation order differs from a bf16-operand, f32-accumulate matmul.
// Weights are read from global memory (L2-resident across the launch) in
// PyTorch's Linear layout (out, in), 16 contiguous bytes a lane.
//
// Every phase is latency-bound at these sizes, so each thread issues all of
// a batch of independent loads before it uses any of them: 8 weight loads
// in flight a lane in the products (16 made the kernels spill registers),
// 8 float4 loads a thread in the row copies. Widths are multiples of 4
// floats and rows start on 16-byte boundaries, but in the `_ragged` and
// operand loads, which read a float at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fd {

constexpr int kThreads = 256;   // threads per block, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // rows per block: one m16 tile
constexpr int kPad = 32;        // bf16 elements of padding per operand row
constexpr int kRedFloats = kRows * 64;  // split-K partials (fewer than 8 tiles)
constexpr int kBatch = 8;       // float4 loads in flight a thread in row copies

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A 16-byte shared-memory load kept in program order with the mma's, so
// that unrolling does not hoist every A fragment into registers at once.
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// gemm_tc with TPW n8 tiles a warp; see gemm_tc.
template <int TPW>
__device__ void gemm_tc_tiles(const __nv_bfloat16* A, int K,
                              const __nv_bfloat16* __restrict__ Wt, int ldw, int col0,
                              int ncols, float* C, float* red, int wpt) {
  constexpr int U = TPW >= 8 ? 1 : 8 / TPW;  // 32-wide k chunks loaded ahead: 8 loads a lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = ncols >> 3;
  const int tile0 = (warp / wpt) * TPW;
  const int ks = warp % wpt;
  const int kchunk = K / wpt;
  const int k0 = ks * kchunk, k1 = k0 + kchunk;
  const int lda = K + kPad;
  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (tile0 < tiles) {
    const __nv_bfloat16* a_lo = A + g * lda + 8 * t;
    const __nv_bfloat16* a_hi = A + (g + 8) * lda + 8 * t;
    const __nv_bfloat16* w = Wt + (size_t)(col0 + tile0 * 8 + g) * ldw + 8 * t;
#pragma unroll 1
    for (int k = k0; k < k1; k += 32 * U) {
      uint4 b[U][TPW];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < TPW; ++i)
          if (k + 32 * u < k1 && tile0 + i < tiles)
            b[u][i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)i * 8 * ldw + k + 32 * u));
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + 32 * u < k1) {
          const uint4 alo = lds128(a_lo + k + 32 * u);
          const uint4 ahi = lds128(a_hi + k + 32 * u);
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            if (tile0 + i < tiles) {
              mma_bf16(acc[i], alo.x, ahi.x, alo.y, ahi.y, b[u][i].x, b[u][i].y);
              mma_bf16(acc[i], alo.z, ahi.z, alo.w, ahi.w, b[u][i].z, b[u][i].w);
            }
          }
        }
      }
    }
    float* dst = wpt == 1 ? C : red + ks * kRows * ncols;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (tile0 + i < tiles) {
        const int n = (tile0 + i) * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + g * ncols + n) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * ncols + n) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  }
  if (wpt > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * ncols; i += kThreads) {
      float v = 0.f;
      for (int j = 0; j < wpt; ++j) v += red[j * kRows * ncols + i];
      C[i] = v;
    }
  }
  __syncthreads();
}

// C[r][n] = sum_k A[r][k] * Wt[col0 + n][k] for r < 16, n < ncols.
//
// A: shared bf16, 16 x K, row stride K + kPad. Wt: global bf16 (N, K) rows
// of stride ldw. C: shared f32, 16 x ncols. red: shared, kRedFloats.
// The ncols / 8 n8 tiles go to the 8 warps; with fewer than 8 tiles,
// several warps share a tile and split K (in 32-wide chunks), and a second
// pass adds their partial sums. Requires K % 32 == 0, ncols % 8 == 0 and
// ncols <= 512.
//
// Fragments: within each 32-wide k chunk, lane (g = lane / 4, t = lane % 4)
// loads the 8 contiguous k's 8t..8t+7 of A rows g and g + 8 and of Wt row
// n = g (16 bytes each). Its k's 8t..8t+3 serve as the logical k's
// {2t, 2t+1, 2t+8, 2t+9} of the first m16n8k16 step and 8t+4..8t+7 those of
// the second. A and B use the same relabelling, so each step still sums
// over the same 16 k's; only the order of the sum changes.
__device__ void gemm_tc(const __nv_bfloat16* A, int K, const __nv_bfloat16* __restrict__ Wt,
                        int ldw, int col0, int ncols, float* C, float* red) {
  const int tiles = ncols >> 3;
  int wpt = tiles >= kWarps ? 1 : kWarps / tiles;  // warps sharing a tile
  while (wpt > 1 && K % (32 * wpt)) wpt >>= 1;     // each a whole number of chunks
  const int tpw = (tiles + kWarps - 1) / kWarps;   // tiles per warp
  if (tpw <= 1) {
    gemm_tc_tiles<1>(A, K, Wt, ldw, col0, ncols, C, red, wpt);
  } else if (tpw <= 2) {
    gemm_tc_tiles<2>(A, K, Wt, ldw, col0, ncols, C, red, 1);
  } else if (tpw <= 4) {
    gemm_tc_tiles<4>(A, K, Wt, ldw, col0, ncols, C, red, 1);
  } else {
    gemm_tc_tiles<8>(A, K, Wt, ldw, col0, ncols, C, red, 1);
  }
}

// Q (bf16, row stride ld + kPad) = LayerNorm(X[r]) * g + b over the first n
// of the ld columns of each of the kRows rows of X (f32, row stride ld, a
// multiple of 4, zeros past n), g and b (ld, zeros past n: so are those
// columns of Q). One warp a row: biased variance as a two-pass mean and
// centred square, each lane summing its float4s c = lane + 32 j in order.
__device__ void rows_layernorm_operand(const float* X, int n, int ld,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b, float eps,
                                       __nv_bfloat16* Q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = ld / 4;
  for (int r = warp; r < kRows; r += kWarps) {
    const float* x = X + r * ld;
    float s = 0.f;
    for (int c = lane; c < q; c += 32) {
      const float4 v = ld4(x + 4 * c);
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = warp_sum(s) / n;
    float v = 0.f;
    for (int c = lane; c < q; c += 32) {
      const float4 xv = ld4(x + 4 * c);
      const float d0 = 4 * c < n ? xv.x - mean : 0.f, d1 = 4 * c + 1 < n ? xv.y - mean : 0.f,
                  d2 = 4 * c + 2 < n ? xv.z - mean : 0.f, d3 = 4 * c + 3 < n ? xv.w - mean : 0.f;
      v += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
    const float rstd = rsqrtf(warp_sum(v) / n + eps);
    for (int c = lane; c < q; c += 32) {
      const float4 xv = ld4(x + 4 * c), gv = ldg4(g + 4 * c), bv = ldg4(b + 4 * c);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(Q + r * (ld + kPad) + 4 * c);
      d[0] = __floats2bfloat162_rn((xv.x - mean) * rstd * gv.x + bv.x,
                                   (xv.y - mean) * rstd * gv.y + bv.y);
      d[1] = __floats2bfloat162_rn((xv.z - mean) * rstd * gv.z + bv.z,
                                   (xv.w - mean) * rstd * gv.w + bv.w);
    }
  }
  __syncthreads();
}

// Q (bf16, row stride ld + kPad) = bf16 of rows [row0, row0 + kRows) of src
// (B x n), zero past n up to ld and for rows past B.
__device__ __forceinline__ void load_operand(__nv_bfloat16* Q, const float* __restrict__ src,
                                             int row0, int B, int n, int ld) {
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const int r = i / ld, k = i - r * ld, row = row0 + r;
    Q[r * (ld + kPad) + k] = __float2bfloat16_rn(row < B && k < n ? __ldg(src + (size_t)row * n + k)
                                                                 : 0.f);
  }
  __syncthreads();
}

// load_rows for a width n that need not be a multiple of 4: X (row stride
// ld >= n) from a float at a time, zero past n.
__device__ __forceinline__ void load_rows_ragged(float* X, const float* __restrict__ src,
                                                 const float* __restrict__ row_add,
                                                 const float* __restrict__ rows_add,
                                                 int row0, int B, int n, int ld) {
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const int r = i / ld, k = i - r * ld, row = row0 + r;
    float v = 0.f;
    if (row < B && k < n) {
      v = __ldg(src + (size_t)row * n + k);
      if (row_add) v += __ldg(row_add + k);
      if (rows_add) v += __ldg(rows_add + (size_t)row * n + k);
    }
    X[i] = v;
  }
  __syncthreads();
}

// X = rows [row0, row0 + kRows) of src (B x n) + row_add (n) + rows_add
// (B x n); rows past B are zero. Either add may be null.
__device__ __forceinline__ void load_rows(float* X, const float* __restrict__ src,
                                          const float* __restrict__ row_add,
                                          const float* __restrict__ rows_add,
                                          int row0, int B, int n) {
  const int q = n / 4, total = kRows * q;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      const int r = i / q, c = 4 * (i - r * q), row = row0 + r;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && row < B) {
        v[j] = ldg4(src + (size_t)row * n + c);
        if (row_add) v[j] = add4(v[j], ldg4(row_add + c));
        if (rows_add) v[j] = add4(v[j], ldg4(rows_add + (size_t)row * n + c));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) st4(X + 4 * i, v[j]);
    }
  }
  __syncthreads();
}

}  // namespace fd
