// Forward + backward of the latent-DDPM training objective for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of flowerdiff/kernels/train_step.py
// (reached through `_kernel_loss_and_grads`): q_sample, the sinusoid and the
// time MLP, the class-table lookup and the class MLP with the condition
// keep-mask, `latent_proj`, every hourglass stage with its two dropout
// masks, the head, the optional v2 skip, the euclidean epsilon-loss, and one
// f32 gradient per weight leaf. The TPU kernel derives its backward with
// `jax.vjp` inside the kernel; here the backward is written out by hand.
//
// Bound on the card: at 64 rows the step reads every f32 weight once and
// writes an f32 gradient of the same size, and does three products a weight
// over 64 rows: tens of flops a byte, far below the card's ~295 bf16 flops a
// byte, so the ideal step is bound by weight and gradient bytes.
//
// Design: the TPU kernel is one program because its weights and activations
// stay in VMEM; at ~29 MB of f32 weights against 50 MB of L2 that reason has
// no counterpart here, so `fd_train_step_launch` enqueues a sequence of
// small kernels on the caller's stream (it captures into a CUDA graph):
//
//   * the product C[m][n] = sum_k A(m,k) B(n,k), both operands addressed
//     through (row, k) strides, which gives the three forms of a Linear in
//     PyTorch's (out, in) layout: Y = X W^T + b, dX = dY W, and dW = dY^T X
//     with db = colsum(dY). `product_plan` sends each to one of four
//     kernels (`fd_product_plan` exports the plan) from its form, its shape
//     and whether tensor maps can read its operands: every base 16-byte
//     aligned and every line stride a whole number of 16-byte units (a
//     width that is a multiple of 4; `latent_dim` and `time_emb_dim` need
//     not be, `StepPlan` below):
//     - `wg_gemm_kernel`, the bf16 lane on Hopper's own path: TMA loads of
//       f32 operand tiles (`cp.async.bulk.tensor` through a CUtensorMap,
//       completing on mbarriers) into a shared-memory ring filled by one
//       producer warp; two consumer warpgroups round each landed tile to a
//       bf16, 128-byte-swizzled operand tile and run `wgmma.mma_async`
//       m64n32k16 with f32 accumulators, one 64 x 64 output tile a block.
//       For the bf16 lane it stands in for the products inside the Pallas
//       kernels `_make_kernel` of flowerdiff/kernels/train_step.py and
//       `_make_epoch_kernel` of train_epoch.py. It takes every dW form that
//       tensor maps can read (K = the 64 batch rows: one k tile, so every
//       tile is independent) and such Y and dX forms with N * K >= 512 x
//       512, but Y at 1024 x 512 (`wgmma_takes`; the shapes where the two
//       kernels, timed in turns, put it ahead). At M = 64 rows a Y or dX
//       product has at most 16 output tiles, so K is split over a cluster
//       of up to 8 blocks whose partials meet in rank order through
//       distributed shared memory, as below.
//       Bound: the dW form at 1024 x 1024 writes 4 MB of f32 dW, ~1.3 us at
//       3.35 TB/s (0.13 GFLOP of products); at the step's smaller shapes the
//       launch itself (~1.2 us for an empty kernel on the same grid, in a
//       CUDA graph) and one load round trip. Design against it: two blocks
//       a multiprocessor, so one tile's epilogue and store run beside the
//       next tile's loads; the epilogue stages the tile in shared memory and
//       stores it with one TMA store a warpgroup; db is summed by the
//       producer warp while the consumers convert. A block runs its code
//       once, from a cold instruction cache: with an unrolled epilogue that
//       branched on every epilogue term the dW product took 5.8-6.5 us,
//       with the short branch-free one 3.8 (`tools/gemm_ab.py`), so the
//       common paths are short and branch-free.
//       How the port's constraints are met:
//       * the operands are f32 in device memory and are rounded to bf16 as
//         the consumers copy a landed tile into the operand tile (the same
//         rounding as the other kernels); A goes to wgmma as it lands (the
//         dW form's dY MN-major, under the transpose flag), B always K-major
//         (`wg_convert_t` transposes the dW form's X and the dX form's W);
//       * each operand's tensor map (and C's, for the TMA store) is encoded
//         on the host once, when the step is planned (`make_step_plan`,
//         from `bind_train_step`), through `cudaGetDriverEntryPoint` (no
//         -lcuda): every operand of every product is a weight, a gradient
//         or a slice of the bound workspace, so the maps hold for every
//         step of the binding, and the epoch kernel launches from the same
//         plan. A launch encodes nothing and passes the plan's maps by value
//         (`__grid_constant__`), so a CUDA graph captures them;
//       * ragged edges: TMA fills the parts of a box outside the matrix
//         with zeros and the TMA store writes none of them; the split's
//         epilogue masks them;
//       * the route is chosen when the step is planned, never after a
//         refusal: a refused tensor-map encode fails the plan and a refused
//         launch is the sequence's error, which the wrapper raises.
//       Semantics as before: operands rounded to bf16, f32 accumulation, dX
//       and dW rounded to bf16 after the whole sum, db = scale * colsum(dY)
//       summed in row order in the same launch, no atomics.
//     - `mma_dw_kernel`, the bf16 lane's dW form where a tensor map cannot
//       read an operand (a row of dY, X or dW not a whole number of 16-byte
//       units): one block a 64 x 32 tile over the whole of K, 32-deep k
//       tiles copied with `cp.async` (16 bytes where aligned, else 4) into
//       a two-deep ring, rounded to bf16 as the fragments are built,
//       `mma.sync` m16n8k16; the blocks of the first tile column sum db
//       from the landed tiles in row order. The same semantics, bit for bit
//       repeatable.
//     - `splitk_gemm_kernel`, the bf16 lane's other Y and dX forms (those
//       a tensor map cannot read among them: its copies are 16 bytes where
//       aligned, else 4; `cp_async_quad`): one row of 64 x 32 tiles gives 16-32 blocks, each on a chain of K / 64
//       dependent k steps. Here each output tile is a cluster of up to 8
//       blocks, each block summing its slice of K (one or two 64-deep tiles,
//       copied with `cp.async` into a two-deep shared-memory ring, rounded
//       to bf16 as the fragments are built, `mma.sync` m16n8k16 with f32
//       accumulators). Each block finishes 64 / s of the tile's rows: the
//       others store their partial rows into its shared memory (distributed
//       shared memory, one cluster barrier after the stores; the barrier
//       that lets them store is hidden behind the k loop), it adds the s
//       partials in rank order and runs the epilogue (bias, the bf16
//       rounding of dX, mul, res) once on the whole sum. No atomics and one
//       launch: a product repeats bit for bit. (Reading the partials
//       remotely after a barrier, then a second barrier before leaving, was
//       0.1-0.65 us a product slower.)
//     - `gemm_kernel`, f32 FMA tiles of 64 x 32 over the whole of K: every
//       form of the exact lane and the three f32 products of the bf16 lane
//       (the `final` product and the v2 skip).
//   * row kernels, one block a row: q_sample + sinusoid, LayerNorm forward
//     (saving mean and rstd) with the dropout mask, swish and residual fused
//     in, LayerNorm backward, the loss with its seed gradient;
//   * column kernels that reduce over the rows in order (LayerNorm dgamma and
//     dbeta, bias gradients, the class-table gradient as an ordered sum per
//     class), so a step repeats bit for bit.
//
// bf16 lane and gradients: the reference's vjp passes through the casts of
// each product's operands, so dX and dW of a cast operand are rounded to
// bf16; the epilogue does the same. The incoming gradient dY is an operand
// of the tensor-core product here and so is rounded to bf16 too, which the
// reference leaves in f32: that difference is inside the bf16 lane's limit.
//
// A header, because two libraries enqueue this sequence: train_step.cu (one
// step a call) and train_epoch.cu (every step of an epoch in one call).
#pragma once
#include <stdint.h>

#include <algorithm>
#include <cooperative_groups.h>
#include <memory>
#include <mutex>
#include <set>
#include <utility>
#include <vector>

#include "rows.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

using fd::warp_sum;

constexpr int TM = 64, TN = 32;           // the f32 and split-K products' tile
constexpr int kGemmThreads = 128;         // 4 warps, 16 rows of the tile each
constexpr int kRowThreads = 256;

struct Epilogue {
  const float* bias;   // [N] or null: + bias_scale * bias[n]
  float bias_scale;
  int round_bf16;      // round (acc + bias) to bf16 (a gradient through a cast)
  const float* mul;    // [M][N] or null: then * mul[m][n]
  const float* res;    // [M][N] or null: then + res[m][n] (may alias C)
  float* colsum;       // [M] or null: colsum[m] = colsum_scale * sum_k A(m, k), in f32
  float colsum_scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// v = epilogue(acc) at (m, n); i = m * N + n
__device__ __forceinline__ float epi(float acc, const Epilogue& ep, int n, size_t i) {
  float v = acc;
  if (ep.bias) v += ep.bias_scale * ep.bias[n];
  if (ep.round_bf16) v = round_bf16(v);
  if (ep.mul) v *= ep.mul[i];
  if (ep.res) v += ep.res[i];
  return v;
}

__device__ __forceinline__ void emit(float* C, int M, int N, int m, int n, float acc,
                                     const Epilogue& ep) {
  if (m >= M || n >= N) return;
  const size_t i = (size_t)m * N + n;
  C[i] = epi(acc, ep, n, i);
}

// The f32 products: C[m][n] = epilogue(sum_k A(m, k) * B(n, k)), A(m, k) =
// A[m * a_sm + k * a_sk], B(n, k) = B[n * b_sn + k * b_sk], C row-major
// (M, N); one block a 64 x 32 tile over the whole of K, f32 FMA, a 4 x 4
// patch a thread. One of each stride pair is 1; tiles are read along that
// dimension. The next tile's global loads are started before the current
// tile's products.
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* A, long a_sm, long a_sk, const float* B, long b_sn, long b_sk,
            float* C, int M, int N, int K, Epilogue ep) {
  constexpr int TK = 32, LD = TK + 1;
  __shared__ float As[TM * LD];
  __shared__ float Bs[TN * LD];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  if (ep.colsum && blockIdx.x == 0 && tid < TM && m0 + tid < M) {
    const float* a = A + (size_t)(m0 + tid) * a_sm;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += a[(size_t)k * a_sk];
    ep.colsum[m0 + tid] = ep.colsum_scale * s;
  }

  constexpr int NA = TM * TK / kGemmThreads, NB = TN * TK / kGemmThreads;
  float ra[NA], rb[NB];
  const bool a_kfast = a_sk == 1, b_kfast = b_sk == 1;

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = i * kGemmThreads + tid;
      const int r = a_kfast ? e / TK : e % TM, c = a_kfast ? e % TK : e / TM;
      const int m = m0 + r, k = k0 + c;
      ra[i] = (m < M && k < K) ? A[(size_t)m * a_sm + (size_t)k * a_sk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = i * kGemmThreads + tid;
      const int r = b_kfast ? e / TK : e % TN, c = b_kfast ? e % TK : e / TN;
      const int n = n0 + r, k = k0 + c;
      rb[i] = (n < N && k < K) ? B[(size_t)n * b_sn + (size_t)k * b_sk] : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = i * kGemmThreads + tid;
      const int r = a_kfast ? e / TK : e % TM, c = a_kfast ? e % TK : e / TM;
      As[r * LD + c] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = i * kGemmThreads + tid;
      const int r = b_kfast ? e / TK : e % TN, c = b_kfast ? e % TK : e / TN;
      Bs[r * LD + c] = rb[i];
    }
  };

  const int ty = tid >> 3, tx = tid & 7;  // a 4 x 4 patch a thread
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    stage();
    __syncthreads();
    if (k0 + TK < K) fetch(k0 + TK);
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(4 * ty + i) * LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(4 * tx + j) * LD + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) emit(C, M, N, m0 + 4 * ty + i, n0 + 4 * tx + j, acc[i][j], ep);
}

// ---------------------------------------------------------------------------
// The split-K product of the bf16 lane (see the note at the top).

constexpr int kSplitTK = 64;              // k's a tile
constexpr int kMaxSplit = 8;              // blocks a cluster: the portable maximum
constexpr int kSplitLDA = kSplitTK + 8;   // f32 stride of a k-fast tile row (A, and B of Y)
constexpr int kSplitLDB = TN + 4;         // f32 stride of an n-fast tile row (B of dX)
constexpr int kSplitLDP = TN + 8;         // f32 stride of a row of the partial tile
constexpr int kSplitA = TM * kSplitLDA;   // floats of an A tile
constexpr int kSplitB = TN * kSplitLDA > kSplitTK * kSplitLDB ? TN * kSplitLDA
                                                              : kSplitTK * kSplitLDB;
constexpr int kSplitStage = kSplitA + kSplitB;
// a ring of two tiles, then the slots of the cluster's sum: row rr of this
// block's share of the output tile from block q at row q * (TM / s) + rr
constexpr size_t kSplitSmem = sizeof(float) * (2 * kSplitStage + TM * kSplitLDP);

// The plan of a product over K: clusters of *s blocks, *s the largest power
// of two up to kMaxSplit that leaves each block at least one tile (K = 1024:
// 8 blocks of two tiles; K = 512: 8 of one; K = 256: 4); block r sums k in
// [r * *kc, r * *kc + *kc), *kc a multiple of kSplitTK (the last blocks'
// slices may be short or empty). `fd_splitk_plan` exports it.
inline void splitk_plan(int K, int* s, int* kc) {
  const int tiles = (K + kSplitTK - 1) / kSplitTK;
  *s = 1;
  while (*s < kMaxSplit && 2 * *s <= tiles) *s *= 2;
  *kc = (tiles + *s - 1) / *s * kSplitTK;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared, or a zero where !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Four consecutive floats along a row of a tile: one 16-byte copy where all
// four lie inside the bounds and the source is 16-byte aligned, else four
// 4-byte copies with zeros outside (`n_valid` of the four are inside).
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src, int n_valid,
                                              const float* any_valid_address) {
  if (n_valid == 4 && ((uintptr_t)src & 15) == 0) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp_async4(dst + j, j < n_valid ? src + j : any_valid_address, j < n_valid);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2(float2 v) { return bf16x2(v.x, v.y); }

// C = epilogue(sum_k A(m, k) B(n, k)) with A read along k (a_sk = 1) and B
// read along k (b_sk = 1: the Y form, B = W) or along n (b_sn = 1: the dX
// form, B(n, k) = W[k][n]). Launched as clusters of s blocks along x:
// blockIdx.x = n_tile * s + rank, blockIdx.y = m_tile; block `rank` sums
// k in [rank * kc, rank * kc + kc), kc a multiple of kSplitTK.
template <bool kBAlongK>
__global__ void __launch_bounds__(kGemmThreads)
splitk_gemm_kernel(const float* __restrict__ A, long a_sm, const float* __restrict__ B,
                   long b_stride, float* C, int M, int N, int K, int kc, Epilogue ep) {
  extern __shared__ __align__(16) float sk_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = (blockIdx.x / s) * TN;
  const int kb = rank * kc, ke = min(K, kb + kc);
  const int n_tiles = ke > kb ? (ke - kb + kSplitTK - 1) / kSplitTK : 0;
  // a block may write into another's shared memory only once that one has
  // started: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // tile i of this block's slice into ring slot `slot`: 8 quads of A and 4
  // of B a thread
  auto load = [&](int i, int slot) {
    float* As = sk_smem + slot * kSplitStage;
    float* Bs = As + kSplitA;
    const int k0 = kb + i * kSplitTK;
#pragma unroll
    for (int q = 0; q < TM * kSplitTK / 4 / kGemmThreads; ++q) {
      const int e = q * kGemmThreads + tid;
      const int r = e / (kSplitTK / 4), c = (e % (kSplitTK / 4)) * 4;
      const int m = m0 + r, k = k0 + c;
      const int nv = m < M ? max(0, min(4, ke - k)) : 0;
      cp_async_quad(As + r * kSplitLDA + c, A + (size_t)m * a_sm + k, nv, A);
    }
#pragma unroll
    for (int q = 0; q < TN * kSplitTK / 4 / kGemmThreads; ++q) {
      const int e = q * kGemmThreads + tid;
      if constexpr (kBAlongK) {  // Bs[n][k]
        const int r = e / (kSplitTK / 4), c = (e % (kSplitTK / 4)) * 4;
        const int n = n0 + r, k = k0 + c;
        const int nv = n < N ? max(0, min(4, ke - k)) : 0;
        cp_async_quad(Bs + r * kSplitLDA + c, B + (size_t)n * b_stride + k, nv, B);
      } else {  // Bs[k][n]
        const int r = e / (TN / 4), c = (e % (TN / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        const int nv = k < ke ? max(0, min(4, N - n)) : 0;
        cp_async_quad(Bs + r * kSplitLDB + c, B + (size_t)k * b_stride + n, nv, B);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // tensor-core fragment coordinates
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (n_tiles > 0) load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load(i + 1, (i + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile i has landed
    __syncthreads();
    const float* As = sk_smem + (i & 1) * kSplitStage;
    const float* Bs = As + kSplitA;
    const float* a_lo = As + (16 * warp + g) * kSplitLDA + 2 * t;
    const float* a_hi = a_lo + 8 * kSplitLDA;
#pragma unroll
    for (int kk = 0; kk < kSplitTK; kk += 16) {
      const uint32_t a0 = bf16x2(*reinterpret_cast<const float2*>(a_lo + kk));
      const uint32_t a1 = bf16x2(*reinterpret_cast<const float2*>(a_hi + kk));
      const uint32_t a2 = bf16x2(*reinterpret_cast<const float2*>(a_lo + kk + 8));
      const uint32_t a3 = bf16x2(*reinterpret_cast<const float2*>(a_hi + kk + 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * j + g;
        uint32_t b0, b1;
        if constexpr (kBAlongK) {
          const float* b = Bs + n * kSplitLDA + kk + 2 * t;
          b0 = bf16x2(*reinterpret_cast<const float2*>(b));
          b1 = bf16x2(*reinterpret_cast<const float2*>(b + 8));
        } else {
          const float* b = Bs + (kk + 2 * t) * kSplitLDB + n;
          b0 = bf16x2(b[0], b[kSplitLDB]);
          b1 = bf16x2(b[8 * kSplitLDB], b[9 * kSplitLDB]);
        }
        fd::mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();  // slot i & 1 is refilled by the next iteration
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // each row of this block's partial tile into the slot of the block that
  // finishes that row, then the cluster's sum in rank order
  float* R = sk_smem + 2 * kSplitStage;
  const int rows = TM / s;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * warp + g + 8 * half;
    float* dst = cluster.map_shared_rank(R, r / rows) + (rank * rows + r % rows) * kSplitLDP;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
  cluster.sync();  // every slot is written and visible; no remote access follows
  for (int e = tid; e < rows * TN; e += kGemmThreads) {
    const int rr = e / TN, c = e % TN;
    float v = 0.f;
    for (int q = 0; q < s; ++q) v += R[(q * rows + rr) * kSplitLDP + c];
    emit(C, M, N, m0 + rank * rows + rr, n0 + c, v, ep);
  }
}

// ---------------------------------------------------------------------------
// The bf16 lane's dW form that tensor maps cannot read (see the note at the
// top): C[m][n] = epilogue(sum_k A[k][m] B[k][n]), A = dY (K rows of M, line
// stride a_ld), B = X (K rows of N, line stride b_ld), C row-major (M, N).
// One block a 64 x 32 tile over the whole of K, 32 k's a ring slot: A's
// slot is [k][m], B's [k][n], each line padded by 4 floats so that a warp's
// fragment loads fall in 32 different banks.

constexpr int kDwTK = 32;                 // k's a ring slot
constexpr int kDwLDA = TM + 4;            // f32 stride of a k line of an A slot
constexpr int kDwLDB = TN + 4;            // f32 stride of a k line of a B slot

__global__ void __launch_bounds__(kGemmThreads)
mma_dw_kernel(const float* __restrict__ A, long a_ld, const float* __restrict__ B, long b_ld,
              float* C, int M, int N, int K, Epilogue ep) {
  __shared__ __align__(16) float As[2][kDwTK * kDwLDA];
  __shared__ __align__(16) float Bs[2][kDwTK * kDwLDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int n_tiles = (K + kDwTK - 1) / kDwTK;
  const bool sums = ep.colsum && blockIdx.x == 0;

  // k tile i into ring slot `slot`: 4 quads of A and 2 of B a thread, along
  // m and n (contiguous in device memory)
  auto load = [&](int i, int slot) {
    const int k0 = i * kDwTK;
#pragma unroll
    for (int q = 0; q < kDwTK * TM / 4 / kGemmThreads; ++q) {
      const int e = q * kGemmThreads + tid;
      const int r = e / (TM / 4), c = (e % (TM / 4)) * 4;
      const int k = k0 + r, m = m0 + c;
      const int nv = k < K ? max(0, min(4, M - m)) : 0;
      cp_async_quad(&As[slot][r * kDwLDA + c], A + (size_t)k * a_ld + m, nv, A);
    }
#pragma unroll
    for (int q = 0; q < kDwTK * TN / 4 / kGemmThreads; ++q) {
      const int e = q * kGemmThreads + tid;
      const int r = e / (TN / 4), c = (e % (TN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      const int nv = k < K ? max(0, min(4, N - n)) : 0;
      cp_async_quad(&Bs[slot][r * kDwLDB + c], B + (size_t)k * b_ld + n, nv, B);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // tensor-core fragment coordinates
  const int mr = 16 * warp + g;           // the warp's first fragment row in the tile
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float colsum = 0.f;

  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load(i + 1, (i + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile i has landed
    __syncthreads();
    const float* as = As[i & 1];
    const float* bs = Bs[i & 1];
    if (sums && tid < TM) {  // db: A's column tid down k, in row order, in f32
      const int kv = min(kDwTK, K - i * kDwTK);
      for (int k = 0; k < kv; ++k) colsum += as[k * kDwLDA + tid];
    }
#pragma unroll
    for (int kk = 0; kk < kDwTK; kk += 16) {
      const float* a = as + (kk + 2 * t) * kDwLDA + mr;
      const uint32_t a0 = bf16x2(a[0], a[kDwLDA]);
      const uint32_t a1 = bf16x2(a[8], a[kDwLDA + 8]);
      const uint32_t a2 = bf16x2(a[8 * kDwLDA], a[9 * kDwLDA]);
      const uint32_t a3 = bf16x2(a[8 * kDwLDA + 8], a[9 * kDwLDA + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* b = bs + (kk + 2 * t) * kDwLDB + 8 * j + g;
        fd::mma_bf16(acc[j], a0, a1, a2, a3, bf16x2(b[0], b[kDwLDB]),
                     bf16x2(b[8 * kDwLDB], b[9 * kDwLDB]));
      }
    }
    __syncthreads();  // slot i & 1 is refilled by the next iteration
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (sums && tid < TM && m0 + tid < M) ep.colsum[m0 + tid] = ep.colsum_scale * colsum;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        emit(C, M, N, m0 + mr + 8 * h, n0 + 8 * j + 2 * t + e, acc[j][2 * h + e], ep);
}

// ---------------------------------------------------------------------------
// The bf16 lane's product on wgmma fed by TMA (see the note at the top).

constexpr int kWgTile = 64;          // output tile 64 x 64; a k tile is 64 deep
constexpr int kWgSlots = 2;          // f32 ring slots, each an A and a B tile
constexpr int kWgThreads = 288;      // two consumer warpgroups, then the producer warp
constexpr int kWgMaxSplit = 8;       // blocks a cluster: the portable maximum
constexpr uint32_t kWgF32Bytes = kWgTile * kWgTile * 4;  // a landed f32 tile
constexpr uint32_t kWgOpBytes = kWgTile * kWgTile * 2;   // a bf16 operand tile
constexpr int kWgLDP = kWgTile + 8;  // f32 stride of a row of the split's partials
constexpr size_t kWgRingBytes = (size_t)kWgSlots * 2 * kWgF32Bytes;
constexpr size_t kWgPartialBytes = sizeof(float) * kWgTile * kWgLDP;

// Shared memory of a launch: 1024 bytes of alignment slack, the ring, the A
// and B operand tiles, the output tile (split == 1) or the split's partial
// tile, the mbarriers: 97-99 KB, two blocks a multiprocessor.
inline size_t wg_smem_bytes(int split) {
  return 1024 + kWgRingBytes + 2 * kWgOpBytes + (split > 1 ? kWgPartialBytes : kWgF32Bytes) +
         2 * kWgSlots * sizeof(uint64_t);
}

struct WgShape {
  int M, N, K;
  int n_tiles;        // 64 x 64 output tiles a row of C
  int split, kt_per;  // blocks a cluster, each summing kt_per k tiles
};

// A landed f32 tile (64 lines of 64 floats, 256 bytes a line) rounded to a
// bf16 operand tile of the same lines, swizzled: 256 threads, each one
// 16-byte chunk of 2 lines. The 8 lanes of a line read its 8 chunks'
// halves so that each 16-byte load touches 8 different bank groups, and
// store to 8 different swizzled chunks.
__device__ __forceinline__ void wg_convert(const float* src, uint8_t* dst, int tid) {
  const int c = tid & 7;
  const int first = c & 4;  // lanes 4-7 read their chunk's upper half first
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int line = (tid >> 3) + 32 * i;
    const float* p = src + line * kWgTile + 8 * c;
    const float4 u = *reinterpret_cast<const float4*>(p + first);
    const float4 v = *reinterpret_cast<const float4*>(p + (first ^ 4));
    const float4 lo = first ? v : u, hi = first ? u : v;
    *reinterpret_cast<uint4*>(dst + line * 128 + ((c ^ (line & 7)) << 4)) =
        make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w), bf16x2(hi.x, hi.y),
                   bf16x2(hi.z, hi.w));
  }
}

// The same, transposed: the landed tile's lines are k (64 values of n a
// line) and the operand tile's lines are n (64 k's a line, K-major). A
// thread makes chunk c (k in [8c, 8c + 8)) of lines n and n + 32 from 8
// single loads each; a warp's 32 lanes are 32 consecutive n, so each load
// reads 128 consecutive bytes and each 16-byte store lands in its own bank
// group.
__device__ __forceinline__ void wg_convert_t(const float* src, uint8_t* dst, int tid) {
  const int n = tid & 31, c = tid >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int line = n + 32 * i;
    const float* p = src + 8 * c * kWgTile + line;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k * kWgTile];
    *reinterpret_cast<uint4*>(dst + line * 128 + ((c ^ (line & 7)) << 4)) =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                   bf16x2(v[6], v[7]));
  }
}

// C = epilogue(sum_k A(m, k) B(n, k)), one 64 x 64 output tile a block (a
// rank of a cluster when split > 1). kAmn / kBmn: the operand is MN-major
// in device memory (A(m, k) = A[k][m], the dW form's dY; B(n, k) = B[k][n],
// dW's X and dX's W) or K-major (Y's X and W, dX's dY). Each comes through
// its tensor map in 64 x 64 f32 boxes.
//
// Thread 0 initialises the mbarriers and issues the first TMA loads before
// the block's first barrier; warp 8, the producer, then refills each slot
// as it is released. Each slot's `full` mbarrier completes on its bytes.
// Warps 0-7 are two consumer warpgroups: together they round a landed A and
// B tile to bf16 operand tiles (A as it lands, MN- or K-major; B always
// K-major, `wg_convert_t` transposing an MN-major one), release the slot,
// and each runs four wgmma.m64n32k16 on its half of the tile's columns.
//
// split == 1: the block's k tiles are all of K. Each warpgroup writes its
// accumulators, through `epi`, into its 32-column half of the output tile
// in shared memory (128-byte swizzle) and one thread stores it with TMA
// (`map_c`; rows and columns outside C are not written). Two blocks fit a
// multiprocessor, so one tile's epilogue runs beside the next one's loads.
// split > 1: rank r sums kt_per k tiles from r kt_per; the ranks' partials
// meet in rank order through distributed shared memory and `emit`, as in
// splitk_gemm_kernel.
//
// ep.colsum (the dW form, split == 1): in the blocks of the first tile
// column the producer warp sums A's landed tiles down k, in row order (two
// columns a lane), while the consumers convert; a slot is then released by
// both (its `empty` mbarrier counts two arrivals).
template <bool kAmn, bool kBmn>
__global__ void __launch_bounds__(kWgThreads, 2)
wg_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c, float* C, WgShape sh, Epilogue ep) {
  extern __shared__ uint8_t wg_raw[];
  const uint32_t raw = fdh::smem_u32(wg_raw);
  uint8_t* ring = wg_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* op_a = ring + kWgRingBytes;
  uint8_t* op_b = op_a + kWgOpBytes;
  uint8_t* out = op_b + kWgOpBytes;  // split == 1: two 32-column halves, swizzled
  float* part = reinterpret_cast<float*>(out);  // split > 1
  const bool split = sh.split > 1;
  const uint32_t full0 = fdh::smem_u32(out + (split ? kWgPartialBytes : kWgF32Bytes));
  const uint32_t empty0 = full0 + 8 * kWgSlots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int tile = (int)blockIdx.x / sh.split;
  const int m0 = tile / sh.n_tiles * kWgTile, n0 = tile % sh.n_tiles * kWgTile;
  const int nk = (sh.K + kWgTile - 1) / kWgTile;
  int rank = 0, k_first = 0, k_count = nk;
  if (split) {
    rank = (int)cg::this_cluster().block_rank();
    k_first = rank * sh.kt_per;
    k_count = max(0, min(nk, k_first + sh.kt_per) - k_first);
  }
  const bool sums = kAmn && ep.colsum && n0 == 0 && !split;

  auto load = [&](int i) {  // k tile i of this block into slot i % kWgSlots
    const int slot = i % kWgSlots;
    const uint32_t full = full0 + 8 * slot;
    const uint32_t dst = fdh::smem_u32(ring + (size_t)slot * 2 * kWgF32Bytes);
    const int k0 = (k_first + i) * kWgTile;
    fdh::mbar_expect_tx(full, 2 * kWgF32Bytes);
    if (kAmn) fdh::tma_load_2d(dst, &map_a, m0, k0, full);
    else fdh::tma_load_2d(dst, &map_a, k0, m0, full);
    if (kBmn) fdh::tma_load_2d(dst + kWgF32Bytes, &map_b, n0, k0, full);
    else fdh::tma_load_2d(dst + kWgF32Bytes, &map_b, k0, n0, full);
  };

  if (threadIdx.x == 0) {  // warp 0 starts first
    fdh::tma_prefetch(&map_a);
    fdh::tma_prefetch(&map_b);
    if (!split) fdh::tma_prefetch(&map_c);
    for (int i = 0; i < kWgSlots; ++i) {
      fdh::mbar_init(full0 + 8 * i, 1);
      fdh::mbar_init(empty0 + 8 * i, sums ? 2 : 1);
    }
    fdh::fence_barrier_init();
    for (int i = 0; i < min(k_count, kWgSlots); ++i) load(i);
  }
  __syncthreads();
  if (split)  // a block may write into another's shared memory only once that
              // one has started: arrive now, wait before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const int half = warp >> 2;  // the consumer warpgroup: its 32 columns of the tile
  if (warp == 8) {
    // ---- producer: the column sums, then the refill of the slot
    float s0 = 0.f, s1 = 0.f;
    for (int i = 0; i < k_count; ++i) {
      const int slot = i % kWgSlots;
      if (sums) {
        fdh::mbar_wait(full0 + 8 * slot, (i / kWgSlots) & 1);
        const float* fa = reinterpret_cast<const float*>(ring + (size_t)slot * 2 * kWgF32Bytes);
        const int kv = min(kWgTile, sh.K - (k_first + i) * kWgTile);
#pragma unroll 16
        for (int k = 0; k < kv; ++k) {  // A's landed tile is [k][m]
          s0 += fa[k * kWgTile + lane];
          s1 += fa[k * kWgTile + lane + 32];
        }
        __syncwarp();
        if (lane == 0) fdh::mbar_arrive(empty0 + 8 * slot);
      }
      if (lane == 0 && i + kWgSlots < k_count) {
        fdh::mbar_wait(empty0 + 8 * slot, (i / kWgSlots) & 1);
        load(i + kWgSlots);
      }
      __syncwarp();
    }
    if (sums) {
      if (m0 + lane < sh.M) ep.colsum[m0 + lane] = ep.colsum_scale * s0;
      if (m0 + lane + 32 < sh.M) ep.colsum[m0 + lane + 32] = ep.colsum_scale * s1;
    }
  } else {
    // ---- consumers
    const int tid = threadIdx.x;  // 0-255
    const uint32_t a_s = fdh::smem_u32(op_a), b_s = fdh::smem_u32(op_b) + half * 32 * 128;
    for (int i = 0; i < k_count; ++i) {
      const int slot = i % kWgSlots;
      if (i > 0) {  // both warpgroups' last products have read the operand tiles
        fdh::wgmma_wait_all();
        fdh::named_bar_sync(1, 256);
      }
      fdh::mbar_wait(full0 + 8 * slot, (i / kWgSlots) & 1);
      const float* fa = reinterpret_cast<const float*>(ring + (size_t)slot * 2 * kWgF32Bytes);
      wg_convert(fa, op_a, tid);
      if (kBmn) wg_convert_t(fa + kWgTile * kWgTile, op_b, tid);
      else wg_convert(fa + kWgTile * kWgTile, op_b, tid);
      fdh::fence_proxy_async();
      fdh::named_bar_sync(1, 256);
      if (tid == 0) fdh::mbar_arrive(empty0 + 8 * slot);
      __syncwarp();
      fdh::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgTile / 16; ++kk)
        // a k16 step: 16 lines of an MN-major tile, 32 bytes along a K-major line
        fdh::wgmma_m64n32k16<kAmn ? 1 : 0>(acc, fdh::wg_desc(a_s + (kAmn ? kk * 2048 : kk * 32)),
                                           fdh::wg_desc(b_s + kk * 32));
      fdh::wgmma_commit();
    }
    fdh::wgmma_wait_all();
    if (!split) {
      // The accumulators into this warpgroup's half of the output tile; the
      // bf16 rounding here where it is the whole epilogue (the dW form),
      // else `epi` over the half after. Short code: it runs once a tile,
      // from a cold instruction cache.
      const int w = warp & 3, g = lane >> 2, tq = lane & 3, t128 = tid & 127;
      uint8_t* mine = out + half * 8192;
      const bool whole = !ep.bias && !ep.mul && !ep.res;
      const bool rnd = whole && ep.round_bf16;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + g + 8 * h, cc = 8 * j + 2 * tq;
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (rnd) v = make_float2(round_bf16(v.x), round_bf16(v.y));
          *reinterpret_cast<float2*>(mine + r * 128 + (((cc >> 2) ^ (r & 7)) << 4) +
                                     (cc & 3) * 4) = v;
        }
      if (!whole) {
        fdh::named_bar_sync(2 + half, 128);
        for (int e = t128; e < kWgTile * 32; e += 128) {
          const int r = e >> 5, cc = e & 31;
          const int m = m0 + r, n = n0 + 32 * half + cc;
          if (m >= sh.M || n >= sh.N) continue;
          float* v = reinterpret_cast<float*>(mine + r * 128 + (((cc >> 2) ^ (r & 7)) << 4) +
                                              (cc & 3) * 4);
          *v = epi(*v, ep, n, (size_t)m * sh.N + n);
        }
      }
      fdh::fence_proxy_async();
      fdh::named_bar_sync(2 + half, 128);
      if (t128 == 0 && n0 + 32 * half < sh.N) {
        fdh::tma_store_2d(&map_c, n0 + 32 * half, m0, fdh::smem_u32(mine));
        fdh::bulk_commit();
        fdh::bulk_wait_read();  // the block may leave once the store has read its tile
      }
    }
  }

  if (split) {
    // each row of this block's partial tile into the slot of the block that
    // finishes that row, then the cluster's sum in rank order
    cg::cluster_group cluster = cg::this_cluster();
    const int s = sh.split, rows = kWgTile / s;
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (warp < 8) {
      const int w = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w + g + 8 * h;
        float* dst = cluster.map_shared_rank(part, r / rows) +
                     (rank * rows + r % rows) * kWgLDP + 32 * half;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * tq) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    cluster.sync();  // every slot is written and visible; no remote access follows
    if (warp < 8) {
      for (int e = threadIdx.x; e < rows * kWgTile; e += 256) {
        const int rr = e / kWgTile, col = e % kWgTile;
        float v = 0.f;
        for (int qq = 0; qq < s; ++qq) v += part[(qq * rows + rr) * kWgLDP + col];
        emit(C, sh.M, sh.N, m0 + rank * rows + rr, n0 + col, v, ep);
      }
    }
  }
}

// An empty kernel, launched on a product's grid to time its launch alone.
__global__ void product_empty_kernel(int) {}

// Sum over the block, the warps' partial sums added in order. `red` holds
// one float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// x_t = sa z + s1a eps; sin_emb = [sin(t f), cos(t f)]. One block a row.
__global__ void prep_kernel(const float* z, const float* eps, const float* sa,
                            const float* s1a, const float* t_f, const float* freqs,
                            float* x_t, float* sin_emb, int latent, int half) {
  const int r = blockIdx.x;
  const float a = sa[r], b = s1a[r], tf = t_f[r];
  for (int j = threadIdx.x; j < latent; j += blockDim.x)
    x_t[(size_t)r * latent + j] = a * z[(size_t)r * latent + j] + b * eps[(size_t)r * latent + j];
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const float arg = tf * freqs[j];
    sin_emb[(size_t)r * 2 * half + j] = sinf(arg);
    sin_emb[(size_t)r * 2 * half + half + j] = cosf(arg);
  }
}

// e_c[r] = table[label[r]], rounded to bf16 in the bf16 lane (the reference
// reads the table through a bf16 one-hot product).
__global__ void gather_kernel(const float* table, const int* labels, float* e_c, int width,
                              int round) {
  const int r = blockIdx.x;
  const float* src = table + (size_t)labels[r] * width;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const float v = src[j];
    e_c[(size_t)r * width + j] = round ? round_bf16(v) : v;
  }
}

// dtable[c] = sum over the rows with label c, in row order; one block a class.
__global__ void table_grad_kernel(const float* d_ec, const int* labels, float* dtable,
                                  int B, int width, int round) {
  const int c = blockIdx.x;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < B; ++r)
      if (labels[r] == c) s += d_ec[(size_t)r * width + j];
    dtable[(size_t)c * width + j] = round ? round_bf16(s) : s;
  }
}

__global__ void swish_kernel(const float* a, float* s, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) s[i] = a[i] * sigmoidf(a[i]);
}

// da = ds * swish'(a)
__global__ void swish_bwd_kernel(const float* ds, const float* a, float* da, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float sg = sigmoidf(a[i]);
    da[i] = ds[i] * sg * (1.f + a[i] * (1.f - sg));
  }
}

// c_base = c2 * cond_mask[row]; tc = t_base + c_base
__global__ void cond_kernel(const float* c2, const float* t_base, const float* cond_mask,
                            float* c_base, float* tc, size_t n, int width) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float c = c2[i] * cond_mask[i / width];
    c_base[i] = c;
    tc[i] = t_base[i] + c;
  }
}

// d_t += d_tc; d_c2 = (d_c + d_tc) * cond_mask[row]
__global__ void cond_bwd_kernel(float* d_t, const float* d_c, const float* d_tc,
                                const float* cond_mask, float* d_c2, size_t n, int width) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    d_t[i] += d_tc[i];
    d_c2[i] = (d_c[i] + d_tc[i]) * cond_mask[i / width];
  }
}

// y = f(LN(x) * g + b), f(v) = [v * mask] -> [swish] -> [+ res]; saves the
// row's mean and rstd. One block a row, two-pass mean and centred square.
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_kernel(const float* x, const float* g, const float* b, const float* mask,
              int swish, const float* res, float* y, float* mean_out, float* rstd_out,
              int d, float eps) {
  __shared__ float red[kRowThreads / 32];
  const size_t row = (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s += x[row + j];
  const float mean = block_sum(s, red) / d;
  float v = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float c = x[row + j] - mean;
    v += c * c;
  }
  const float rstd = rsqrtf(block_sum(v, red) / d + eps);
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float o = (x[row + j] - mean) * rstd * g[j] + b[j];
    if (mask) o *= mask[row + j];
    if (swish) o = o * sigmoidf(o);
    if (res) o += res[row + j];
    y[row + j] = o;
  }
}

// Backward of ln_fwd_kernel for one row. dy_in is the gradient of the
// kernel's output (without its residual). Writes dyhat, the gradient of
// LN's affine output (dy_in through swish and the mask), for the column
// reduction, and dx = rstd * (w - mean(w) - xhat * mean(w * xhat)),
// w = dyhat * g, plus `res` where given.
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_kernel(const float* dy_in, const float* x, const float* mean_in, const float* rstd_in,
              const float* g, const float* b, const float* mask, int swish,
              const float* res, float* dyhat, float* dx, int d) {
  __shared__ float red[kRowThreads / 32];
  const size_t row = (size_t)blockIdx.x * d;
  const float mean = mean_in[blockIdx.x], rstd = rstd_in[blockIdx.x];
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float xhat = (x[row + j] - mean) * rstd;
    float dy = dy_in[row + j];
    if (swish) {
      float o = xhat * g[j] + b[j];
      if (mask) o *= mask[row + j];
      const float sg = sigmoidf(o);
      dy *= sg * (1.f + o * (1.f - sg));
    }
    if (mask) dy *= mask[row + j];
    dyhat[row + j] = dy;
    const float w = dy * g[j];
    s1 += w;
    s2 += w * xhat;
  }
  const float c1 = block_sum(s1, red) / d;
  const float c2 = block_sum(s2, red) / d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float xhat = (x[row + j] - mean) * rstd;
    float o = rstd * (dyhat[row + j] * g[j] - c1 - xhat * c2);
    if (res) o += res[row + j];
    dx[row + j] = o;
  }
}

// dgamma[j] = sum_r dyhat[r][j] * xhat[r][j], dbeta[j] = sum_r dyhat[r][j],
// over the rows in order; one thread a column.
__global__ void ln_param_grad_kernel(const float* dyhat, const float* x, const float* mean,
                                     const float* rstd, float* dgamma, float* dbeta, int B,
                                     int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float dg = 0.f, db = 0.f;
  for (int r = 0; r < B; ++r) {
    const float dy = dyhat[(size_t)r * d + j];
    dg += dy * (x[(size_t)r * d + j] - mean[r]) * rstd[r];
    db += dy;
  }
  dgamma[j] = dg;
  dbeta[j] = db;
}

// The loss and its seed gradient, one block for the whole batch.
//   o = out + s * skipv (s = sigmoid(rw) under the v2 skip, else no skip)
//   dist_r = sqrt(sum_j (eps - o)^2 + 1e-8); loss = mean_r dist_r
//   dout = -(eps - o) / (B * dist_r)
//   d bf2 = (1 + s) * colsum(dout); d rw = s (1 - s) * sum(dout * skipv)
//   hsk = hnf + s * x_t, so that d wf = dout^T hsk covers both uses of `final`
__global__ void __launch_bounds__(kRowThreads)
loss_kernel(const float* out, const float* skipv, const float* eps, const float* rw,
            const float* hnf, const float* x_t, float* dout, float* rowbuf, float* hsk,
            float* loss, float* dbf2, float* drw, int B, int latent, int skip) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float s = skip ? sigmoidf(rw[0]) : 0.f;
  for (int r = warp; r < B; r += nwarps) {
    const size_t row = (size_t)r * latent;
    float ss = 0.f;
    for (int j = lane; j < latent; j += 32) {
      float o = out[row + j];
      if (skip) o += s * skipv[row + j];
      const float diff = eps[row + j] - o;
      ss += diff * diff;
    }
    const float dist = sqrtf(warp_sum(ss) + 1e-8f);
    const float inv = 1.f / ((float)B * dist);
    float dot = 0.f;
    for (int j = lane; j < latent; j += 32) {
      float o = out[row + j];
      if (skip) o += s * skipv[row + j];
      const float dv = -(eps[row + j] - o) * inv;
      dout[row + j] = dv;
      if (skip) {
        dot += dv * skipv[row + j];
        hsk[row + j] = hnf[row + j] + s * x_t[row + j];
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      rowbuf[r] = dist;
      rowbuf[B + r] = dot;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f, dr = 0.f;
    for (int r = 0; r < B; ++r) {
      l += rowbuf[r];
      dr += rowbuf[B + r];
    }
    loss[0] = l / (float)B;
    drw[0] = skip ? s * (1.f - s) * dr : 0.f;
  }
  for (int j = threadIdx.x; j < latent; j += blockDim.x) {
    float c = 0.f;
    for (int r = 0; r < B; ++r) c += dout[(size_t)r * latent + j];
    dbf2[j] = (1.f + s) * c;
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan of a product, the plan of a step, and the sequence of
// launches.

// The kernel a product runs on.
enum ProductKernel { kFmaKernel = 0, kSplitKernel = 1, kWgmmaKernel = 2, kMmaDwKernel = 3 };
// The kernel a bf16 product is sent to: the plan's choice, or one kernel
// forced (the kernels timed against each other, `fd_gemm_launch`).
enum ProductRoute { kRoutePlan = 0, kRouteSplit = 1, kRouteWgmma = 2, kRouteMmaDw = 3 };
static_assert((int)kRouteSplit == (int)kSplitKernel && (int)kRouteWgmma == (int)kWgmmaKernel &&
                  (int)kRouteMmaDw == (int)kMmaDwKernel,
              "a forced route names its kernel");

// The three forms of a Linear's product.
enum ProductForm { kFormY = 0, kFormDx = 1, kFormDw = 2 };

// The kernel, its output tile, its split of K over a cluster and the k's a
// block sums, and the blocks, threads and dynamic shared memory launched.
struct ProductPlan {
  int kernel, tile_m, tile_n, split, kc, blocks, threads;
  size_t smem;
};

// The bf16 lane's Y and dX forms that wg_gemm_kernel takes from
// splitk_gemm_kernel where tensor maps can read them: those with N * K >=
// 2^18 (512 x 512 and up), where the two, timed in turns at the flagship's
// shapes, put wg_gemm_kernel ahead (PERF.md), except Y at N = 1024, K = 512,
// where it was not.
inline bool wgmma_takes(int form, int N, int K) {
  if (form == kFormY && N == 1024 && K == 512) return false;
  return (long long)N * K >= (1LL << 18);
}

// Line strides (elements) of the operands of a product of this form on
// contiguous tensors: Y reads X (M, K) and W (N, K), dX reads dY (M, K) and
// W (K, N), dW reads dY (K, M) and X (K, N); C is (M, N).
inline void contiguous_lds(int form, int M, int N, int K, long* a_ld, long* b_ld, long* c_ld) {
  *a_ld = form == kFormDw ? M : K;
  *b_ld = form == kFormY ? K : N;
  *c_ld = N;
}

// Whether tensor maps can read a matrix with this line stride (elements):
// whole 16-byte units.
inline bool tma_stride(long ld) { return (ld * (long)sizeof(float)) % 16 == 0; }
inline bool tma_base(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The plan of a product of `form`. tma: tensor maps can read every operand
// (`tma_stride`, `tma_base`). route: kRoutePlan, or the kernel forced. False
// where the route is refused: a kernel the form does not run on (split-K for
// dW, mma_dw for Y and dX), or wgmma for operands a tensor map cannot read.
// The f32 lane runs every form on the FMA kernel, whatever the route.
inline bool product_plan(bool f32, int form, int M, int N, int K, bool tma, int route,
                         ProductPlan* out) {
  if (f32) {
    *out = {kFmaKernel, TM, TN, 1, K, ((N + TN - 1) / TN) * ((M + TM - 1) / TM), kGemmThreads,
            0};
    return true;
  }
  const bool dw = form == kFormDw;
  int kernel = route;
  if (route == kRoutePlan)
    kernel = !tma ? (dw ? kMmaDwKernel : kSplitKernel)
                  : (dw || wgmma_takes(form, N, K) ? kWgmmaKernel : kSplitKernel);
  if ((kernel == kWgmmaKernel && !tma) || (kernel == kSplitKernel && dw) ||
      (kernel == kMmaDwKernel && !dw) || kernel < kSplitKernel || kernel > kMmaDwKernel)
    return false;
  if (kernel == kMmaDwKernel) {
    *out = {kMmaDwKernel, TM, TN, 1, K, ((N + TN - 1) / TN) * ((M + TM - 1) / TM),
            kGemmThreads, 0};
  } else if (kernel == kSplitKernel) {
    int s, kc;
    splitk_plan(K, &s, &kc);
    *out = {kSplitKernel, TM, TN, s, kc, ((N + TN - 1) / TN) * s * ((M + TM - 1) / TM),
            kGemmThreads, kSplitSmem};
  } else {
    const int tiles = ((M + kWgTile - 1) / kWgTile) * ((N + kWgTile - 1) / kWgTile);
    const int nk = (K + kWgTile - 1) / kWgTile;
    int s = 1;
    if (!dw)
      while (s < kWgMaxSplit && 2 * s <= nk) s *= 2;
    const int kt = (nk + s - 1) / s;
    *out = {kWgmmaKernel, kWgTile, kWgTile, s, kt * kWgTile, tiles * s, kWgThreads,
            wg_smem_bytes(s)};
  }
  return true;
}

// Allow `kernel` `bytes` of dynamic shared memory (the most any plan gives
// it), once a (kernel, device).
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex lock;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(lock);
  if (done.count({kernel, dev})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.insert({kernel, dev});
  return e;
}

inline size_t wg_smem_max() { return std::max(wg_smem_bytes(1), wg_smem_bytes(2)); }

// Host structs sized from the stage count at bind: any depth. The bound
// keeps a step's leaf and product counts in an int.
constexpr int kMaxStages = 1 << 16;

struct Dims {
  int B, latent, te, classes, n_stages;
  std::vector<int> hidden;  // n_stages + 1
};

bool read_dims(const int* dims, Dims* d) {
  d->B = dims[0];
  d->latent = dims[1];
  d->te = dims[2];
  d->classes = dims[3];
  d->n_stages = dims[4];
  if (d->n_stages < 1 || d->n_stages > kMaxStages || d->B < 1 || d->te % 2) return false;
  d->hidden.assign(dims + 5, dims + 6 + d->n_stages);
  return true;
}

struct StageBufs {
  float *h_a, *u, *mean1, *rstd1, *h_b, *mean2, *rstd2, *hn, *v, *h_c;
};

struct Workspace {
  float *x_t, *sin_emb, *a1, *s1, *t_base, *e_c, *c1, *sc, *c2, *c_base, *tc;
  std::vector<float*> hin;     // the input of each stage; hin[n] is the head's
  std::vector<StageBufs> st;
  float *hf, *meanf, *rstdf, *hnf, *out, *skipv, *hsk, *dout, *rowbuf;
  float *d_t, *d_c, *d_tc, *d_c2, *d_wide, *d_mlp, *d_ec;
  float *G[2], *T[5];
  size_t floats;
};

// Carve the workspace out of `base` (null: only count).
void layout(const Dims& d, float* base, Workspace* w) {
  size_t n = 0;
  auto take = [&](size_t k) {
    float* p = base ? base + n : nullptr;
    n += (k + 3) / 4 * 4;
    return p;
  };
  const size_t B = d.B, te = d.te, L = d.latent;
  w->x_t = take(B * L);
  w->sin_emb = take(B * te);
  w->a1 = take(B * 2 * te);
  w->s1 = take(B * 2 * te);
  w->t_base = take(B * te);
  w->e_c = take(B * te);
  w->c1 = take(B * te);
  w->sc = take(B * te);
  w->c2 = take(B * te);
  w->c_base = take(B * te);
  w->tc = take(B * te);
  size_t dmax = L;
  w->hin.assign(d.n_stages + 1, nullptr);
  w->st.assign(d.n_stages, StageBufs{});
  for (int i = 0; i <= d.n_stages; ++i) {
    w->hin[i] = take(B * d.hidden[i]);
    if ((size_t)d.hidden[i] > dmax) dmax = d.hidden[i];
  }
  for (int i = 0; i < d.n_stages; ++i) {
    const size_t k = B * d.hidden[i];
    StageBufs& s = w->st[i];
    s.h_a = take(k);
    s.u = take(k);
    s.mean1 = take(B);
    s.rstd1 = take(B);
    s.h_b = take(k);
    s.mean2 = take(B);
    s.rstd2 = take(B);
    s.hn = take(k);
    s.v = take(k);
    s.h_c = take(k);
  }
  const size_t dl = d.hidden[d.n_stages];
  w->hf = take(B * dl);
  w->meanf = take(B);
  w->rstdf = take(B);
  w->hnf = take(B * dl);
  w->out = take(B * L);
  w->skipv = take(B * L);
  w->hsk = take(B * dl);
  w->dout = take(B * L);
  w->rowbuf = take(2 * B);
  w->d_t = take(B * te);
  w->d_c = take(B * te);
  w->d_tc = take(B * te);
  w->d_c2 = take(B * te);
  w->d_wide = take(B * 2 * te);
  w->d_mlp = take(B * 2 * te);
  w->d_ec = take(B * te);
  for (float*& p : w->G) p = take(B * dmax);
  for (float*& p : w->T) p = take(B * dmax);
  w->floats = n;
}

// Indices into the weight and gradient pointer arrays (the order of
// `weights_spec` in kernels/train_step.py).
enum { WT1, BT1, WT2, BT2, TABLE, WC1, BC1, WC2, BC2, WL, BL, kHeadLeaves };
enum { S_WT, S_BT, S_WB, S_BB, S_G1, S_B1, S_G2, S_B2, S_WV, S_BV, S_WO, S_BO, S_WD, S_BD,
       kStageLeaves };
enum { WTF, BTF, WCF, BCF, GF, BF, WF, BF2, RW, kTailLeaves };

// One product of a plan: its operands as the step passes them, its kernel,
// and for wg_gemm_kernel the tensor maps of A, B and C, encoded once.
struct Product {
  int form;
  const float* A;
  const float* B;
  float* C;
  long a_sm, a_sk, b_sn, b_sk;
  int M, N, K;
  ProductPlan plan;
  CUtensorMap ma, mb, mc;
};

// The plan of a bound train step (`fd_step_plan_create`): its widths, lane,
// weight, gradient and workspace pointers, and every product of the step in
// the order the step launches them, each with its route and, on the TMA
// route, its maps. Made once a binding; every launch of the step, alone or
// inside an epoch, reads it and encodes nothing. The tools' one-product
// plans (`fd_gemm_launch`) are made a call.
struct StepPlan {
  Dims d{};
  bool f32 = false;
  int global_skip = 0;
  float ln_eps = 0.f;
  std::vector<const void*> weights;
  std::vector<void*> grads;
  void* workspace = nullptr;
  std::vector<Product> products;
};

inline int n_leaves(const Dims& d) { return kHeadLeaves + kStageLeaves * d.n_stages + kTailLeaves; }

struct Run {
  cudaStream_t stream;
  bool exact;  // the f32 lane
  cudaError_t err;
  StepPlan* rec = nullptr;         // planning: products go into rec, nothing launches
  const StepPlan* plan = nullptr;  // launching: products come from plan, in order
  size_t next = 0;

  // The first error of the sequence: a refused launch's own code, else the
  // launch's cudaGetLastError.
  void note(cudaError_t launch = cudaSuccess) {
    const cudaError_t e = rec ? cudaSuccess : cudaGetLastError();
    if (err == cudaSuccess) err = launch != cudaSuccess ? launch : e;
  }

  // A row or column kernel on (grid, block); none while planning.
  template <typename... P, typename... A>
  void launch(void (*kernel)(P...), unsigned grid, unsigned block, A&&... args) {
    if (rec) return;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(block);
    cfg.stream = stream;
    note(cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...));
  }

  // The launch of plan p: grid, block, shared memory and cluster.
  void config(const ProductPlan& p, int M, int N, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) const {
    *cfg = {};
    if (p.kernel == kWgmmaKernel)
      cfg->gridDim = dim3((unsigned)p.blocks);
    else
      cfg->gridDim = dim3((unsigned)((N + p.tile_n - 1) / p.tile_n * p.split),
                          (unsigned)((M + p.tile_m - 1) / p.tile_m));
    cfg->blockDim = dim3((unsigned)p.threads);
    cfg->dynamicSmemBytes = p.smem;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = p.split;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    // the split-K kernel reads its cluster even where it is one block
    cfg->numAttrs = p.split > 1 || p.kernel == kSplitKernel ? 1 : 0;
  }

  // Plan one product into rec: its route from its form, shape and operands,
  // its operands checked against the kernel's layout, and on the TMA route
  // its maps encoded. A refusal is the sequence's error.
  void plan_product(bool f32, int form, const float* A, long a_sm, long a_sk, const float* B,
                    long b_sn, long b_sk, float* C, int M, int N, int K, const Epilogue& ep,
                    int route) {
    Product q{};
    q.form = form;
    q.A = A, q.B = B, q.C = C;
    q.a_sm = a_sm, q.a_sk = a_sk, q.b_sn = b_sn, q.b_sk = b_sk;
    q.M = M, q.N = N, q.K = K;
    const long a_ld = form == kFormDw ? a_sk : a_sm, b_ld = form == kFormY ? b_sn : b_sk;
    const bool tma = tma_base(A) && tma_base(B) && tma_base(C) && tma_stride(a_ld) &&
                     tma_stride(b_ld) && tma_stride(N);
    if (M < 1 || N < 1 || K < 1 || !product_plan(f32, form, M, N, K, tma, route, &q.plan)) {
      note(cudaErrorInvalidValue);
      return;
    }
    // each kernel's operand layout: A(m, k) = A[m a_sm + k a_sk], B(n, k) = B[n b_sn + k b_sk]
    const bool y = form == kFormY, dw = form == kFormDw;
    const bool laid = dw ? a_sm == 1 && b_sn == 1 : a_sk == 1 && (y ? b_sk == 1 : b_sn == 1);
    bool ok = true;
    switch (q.plan.kernel) {
      case kSplitKernel: ok = laid && !ep.colsum; break;
      case kMmaDwKernel: ok = laid; break;
      case kWgmmaKernel:
        ok = laid && (!ep.colsum || (dw && q.plan.split == 1)) &&
             fdh::wg_map(&q.ma, A, dw ? M : K, dw ? K : M, a_ld) &&
             fdh::wg_map(&q.mb, B, y ? K : N, y ? N : K, b_ld) &&
             fdh::wg_map(&q.mc, C, N, M, N, 32, kWgTile, true);
        break;
      default: break;  // the FMA kernel reads any strides
    }
    if (!ok) {
      note(cudaErrorInvalidValue);
      return;
    }
    rec->products.push_back(q);
  }

  // Launch planned product q with this call's epilogue.
  void launch_product(const Product& q, const Epilogue& ep) {
    const ProductPlan& p = q.plan;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(p, q.M, q.N, &cfg, &attr);
    if (p.kernel == kSplitKernel) {
      cudaError_t e = allow_smem((const void*)splitk_gemm_kernel<true>, kSplitSmem);
      if (e == cudaSuccess) e = allow_smem((const void*)splitk_gemm_kernel<false>, kSplitSmem);
      if (e != cudaSuccess) return note(e);
      if (q.form == kFormY)
        note(cudaLaunchKernelEx(&cfg, splitk_gemm_kernel<true>, q.A, q.a_sm, q.B, q.b_sn, q.C,
                                q.M, q.N, q.K, p.kc, ep));
      else
        note(cudaLaunchKernelEx(&cfg, splitk_gemm_kernel<false>, q.A, q.a_sm, q.B, q.b_sk, q.C,
                                q.M, q.N, q.K, p.kc, ep));
    } else if (p.kernel == kWgmmaKernel) {
      // dW: A and B MN-major; Y: both K-major; dX: B MN-major
      const WgShape sh{q.M, q.N, q.K, (q.N + kWgTile - 1) / kWgTile, p.split, p.kc / kWgTile};
      const void* kernel = q.form == kFormDw  ? (const void*)wg_gemm_kernel<true, true>
                           : q.form == kFormDx ? (const void*)wg_gemm_kernel<false, true>
                                               : (const void*)wg_gemm_kernel<false, false>;
      const cudaError_t e = allow_smem(kernel, wg_smem_max());
      if (e != cudaSuccess) return note(e);
      if (q.form == kFormDw)
        note(cudaLaunchKernelEx(&cfg, wg_gemm_kernel<true, true>, q.ma, q.mb, q.mc, q.C, sh, ep));
      else if (q.form == kFormDx)
        note(cudaLaunchKernelEx(&cfg, wg_gemm_kernel<false, true>, q.ma, q.mb, q.mc, q.C, sh,
                                ep));
      else
        note(cudaLaunchKernelEx(&cfg, wg_gemm_kernel<false, false>, q.ma, q.mb, q.mc, q.C, sh,
                                ep));
    } else if (p.kernel == kMmaDwKernel) {
      note(cudaLaunchKernelEx(&cfg, mma_dw_kernel, q.A, q.a_sk, q.B, q.b_sk, q.C, q.M, q.N, q.K,
                              ep));
    } else {
      note(cudaLaunchKernelEx(&cfg, gemm_kernel, q.A, q.a_sm, q.a_sk, q.B, q.b_sn, q.b_sk, q.C,
                              q.M, q.N, q.K, ep));
    }
  }

  // Every product of the step: planned into rec, or launched as the plan's
  // next product (the same operands in the same order, else an error).
  void gemm(bool f32, int form, const float* A, long a_sm, long a_sk, const float* B, long b_sn,
            long b_sk, float* C, int M, int N, int K, const Epilogue& ep,
            int route = kRoutePlan) {
    if (rec) return plan_product(f32, form, A, a_sm, a_sk, B, b_sn, b_sk, C, M, N, K, ep, route);
    if (!plan || next >= plan->products.size()) return note(cudaErrorInvalidValue);
    const Product& q = plan->products[next++];
    if (q.form != form || q.A != A || q.B != B || q.C != C || q.M != M || q.N != N ||
        q.K != K || q.a_sm != a_sm || q.a_sk != a_sk || q.b_sn != b_sn || q.b_sk != b_sk)
      return note(cudaErrorInvalidValue);
    launch_product(q, ep);
  }

  // An empty kernel on the grid, block, shared memory and cluster of the
  // plan of a product of this form on contiguous tensors: its launch alone.
  void gemm_empty(bool f32, int form, int M, int N, int K, int route = kRoutePlan) {
    long a_ld, b_ld, c_ld;
    contiguous_lds(form, M, N, K, &a_ld, &b_ld, &c_ld);
    ProductPlan p;
    if (!product_plan(f32, form, M, N, K, tma_stride(a_ld) && tma_stride(b_ld) && tma_stride(c_ld),
                      route, &p))
      return note(cudaErrorInvalidValue);
    const cudaError_t e =
        allow_smem((const void*)product_empty_kernel, std::max(wg_smem_max(), kSplitSmem));
    if (e != cudaSuccess) return note(e);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(p, M, N, &cfg, &attr);
    note(cudaLaunchKernelEx(&cfg, product_empty_kernel, 0));
  }

  // Y (rows, out) = (X (rows, in) W^T + scale * bias) [* mul] [+ res]; W (out, in)
  void fwd(const float* X, const float* W, const float* bias, float* Y, int rows, int in,
           int out, float scale = 1.f, const float* mul = nullptr, const float* res = nullptr,
           bool f32 = false) {
    gemm(f32 || exact, kFormY, X, in, 1, W, in, 1, Y, rows, out, in,
         Epilogue{bias, scale, 0, mul, res, nullptr, 0.f});
  }

  // dX (rows, in) = round(dY (rows, out) W) [* mul] [+ res]
  void dx(const float* dY, const float* W, float* dX, int rows, int in, int out,
          const float* mul = nullptr, const float* res = nullptr, bool f32 = false) {
    const bool e = f32 || exact;
    gemm(e, kFormDx, dY, out, 1, W, 1, in, dX, rows, in, out,
         Epilogue{nullptr, 0.f, e ? 0 : 1, mul, res, nullptr, 0.f});
  }

  // dW (out, in) = round(dY^T X), db (out) = scale * colsum(dY)
  void dw(const float* dY, const float* X, float* dW, float* db, int rows, int in, int out,
          float scale = 1.f, bool f32 = false) {
    const bool e = f32 || exact;
    gemm(e, kFormDw, dY, 1, out, X, 1, in, dW, out, in, rows,
         Epilogue{nullptr, 0.f, e ? 0 : 1, nullptr, nullptr, db, scale});
  }

  void ln_fwd(const float* x, const float* g, const float* b, const float* mask, int swish,
              const float* res, float* y, float* mean, float* rstd, int rows, int d,
              float eps) {
    launch(ln_fwd_kernel, rows, kRowThreads, x, g, b, mask, swish, res, y, mean, rstd, d, eps);
  }

  // dx and the affine's gradients; dyhat is scratch of x's shape
  void ln_bwd(const float* dy, const float* x, const float* mean, const float* rstd,
              const float* g, const float* b, const float* mask, int swish, const float* res,
              float* dyhat, float* dx_out, float* dgamma, float* dbeta, int rows, int d) {
    launch(ln_bwd_kernel, rows, kRowThreads, dy, x, mean, rstd, g, b, mask, swish, res, dyhat,
           dx_out, d);
    launch(ln_param_grad_kernel, (d + 127) / 128, 128, dyhat, x, mean, rstd, dgamma, dbeta,
           rows, d);
  }

  static unsigned blocks(size_t n) { return (unsigned)((n + 255) / 256); }
};

// The sequence of one train step (forward, loss, backward: 119 launches at
// four stages) on `run`: planned (run.rec: the products only, nothing
// launched; data, masks and loss may then be null pointers) or launched from
// run.plan on run.stream. p's weights and grads: 11 + 14 * n_stages + 9 f32
// tensors, matrices in PyTorch's (out, in) layout; data: z, t_f, sa, s1a,
// eps, labels (int32), cond_mask, freqs; masks: block and attention mask of
// each stage, (B, d_i); loss: one f32.
void step_sequence(Run& run, const StepPlan& p, const void* const* data,
                   const void* const* masks, void* loss) {
  const Dims& d = p.d;
  const int n = d.n_stages, B = d.B, te = d.te, L = d.latent, dl = d.hidden[n];
  const int global_skip = p.global_skip;
  const float ln_eps = p.ln_eps;
  Workspace w;
  layout(d, (float*)p.workspace, &w);
  auto W = [&](int i) { return (const float*)p.weights[i]; };
  auto G = [&](int i) { return (float*)p.grads[i]; };
  const int tail = kHeadLeaves + kStageLeaves * n;
  const float* z = (const float*)data[0];
  const float* t_f = (const float*)data[1];
  const float* sa = (const float*)data[2];
  const float* s1a = (const float*)data[3];
  const float* eps = (const float*)data[4];
  const int* labels = (const int*)data[5];
  const float* cond_mask = (const float*)data[6];
  const float* freqs = (const float*)data[7];
  const int round = p.f32 ? 0 : 1;
  const size_t nte = (size_t)B * te;

  // ---- forward
  run.launch(prep_kernel, B, 128, z, eps, sa, s1a, t_f, freqs, w.x_t, w.sin_emb, L, te / 2);
  run.fwd(w.sin_emb, W(WT1), W(BT1), w.a1, B, te, 2 * te);
  run.launch(swish_kernel, Run::blocks(2 * nte), 256, w.a1, w.s1, 2 * nte);
  run.fwd(w.s1, W(WT2), W(BT2), w.t_base, B, 2 * te, te);
  run.launch(gather_kernel, B, 128, W(TABLE), labels, w.e_c, te, round);
  run.fwd(w.e_c, W(WC1), W(BC1), w.c1, B, te, te);
  run.launch(swish_kernel, Run::blocks(nte), 256, w.c1, w.sc, nte);
  run.fwd(w.sc, W(WC2), W(BC2), w.c2, B, te, te);
  run.launch(cond_kernel, Run::blocks(nte), 256, w.c2, w.t_base, cond_mask, w.c_base, w.tc, nte,
             te);
  run.fwd(w.x_t, W(WL), W(BL), w.hin[0], B, L, d.hidden[0]);
  for (int i = 0; i < n; ++i) {
    const int s0 = kHeadLeaves + kStageLeaves * i, di = d.hidden[i], dn = d.hidden[i + 1];
    const StageBufs& s = w.st[i];
    const float* m_blk = (const float*)masks[2 * i];
    const float* m_attn = (const float*)masks[2 * i + 1];
    // h_a = h + (t_base + c_base) Wt^T + 2 bt: the class embedding goes
    // through the time projection, bias and all
    run.fwd(w.tc, W(s0 + S_WT), W(s0 + S_BT), s.h_a, B, te, di, 2.f, nullptr, w.hin[i]);
    run.fwd(s.h_a, W(s0 + S_WB), W(s0 + S_BB), s.u, B, di, di);
    // h_b = h_a + swish(mask * LN1(u)): the mask before the swish
    run.ln_fwd(s.u, W(s0 + S_G1), W(s0 + S_B1), m_blk, 1, s.h_a, s.h_b, s.mean1, s.rstd1, B,
               di, ln_eps);
    run.ln_fwd(s.h_b, W(s0 + S_G2), W(s0 + S_B2), nullptr, 0, nullptr, s.hn, s.mean2,
               s.rstd2, B, di, ln_eps);
    run.fwd(s.hn, W(s0 + S_WV), W(s0 + S_BV), s.v, B, di, di, 1.f, m_attn);
    run.fwd(s.v, W(s0 + S_WO), W(s0 + S_BO), s.h_c, B, di, di, 1.f, nullptr, s.h_b);
    run.fwd(s.h_c, W(s0 + S_WD), W(s0 + S_BD), w.hin[i + 1], B, di, dn);
  }
  run.fwd(w.t_base, W(tail + WTF), W(tail + BTF), w.hf, B, te, dl, 1.f, nullptr, w.hin[n]);
  run.fwd(w.c_base, W(tail + WCF), W(tail + BCF), w.hf, B, te, dl, 1.f, nullptr, w.hf);
  run.ln_fwd(w.hf, W(tail + GF), W(tail + BF), nullptr, 0, nullptr, w.hnf, w.meanf, w.rstdf,
             B, dl, ln_eps);
  run.fwd(w.hnf, W(tail + WF), W(tail + BF2), w.out, B, dl, L, 1.f, nullptr, nullptr, true);
  if (global_skip)
    run.fwd(w.x_t, W(tail + WF), W(tail + BF2), w.skipv, B, L, L, 1.f, nullptr, nullptr, true);
  run.launch(loss_kernel, 1, kRowThreads, w.out, w.skipv, eps, W(tail + RW), w.hnf, w.x_t,
             w.dout, w.rowbuf, w.hsk, (float*)loss, G(tail + BF2), G(tail + RW), B, L,
             global_skip);

  // ---- backward
  run.dw(w.dout, global_skip ? w.hsk : w.hnf, G(tail + WF), nullptr, B, dl, L, 1.f, true);
  run.dx(w.dout, W(tail + WF), w.T[0], B, dl, L, nullptr, nullptr, true);
  float* gcur = w.G[0];
  float* gnext = w.G[1];
  run.ln_bwd(w.T[0], w.hf, w.meanf, w.rstdf, W(tail + GF), W(tail + BF), nullptr, 0, nullptr,
             w.T[1], gcur, G(tail + GF), G(tail + BF), B, dl);
  run.dw(gcur, w.t_base, G(tail + WTF), G(tail + BTF), B, te, dl);
  run.dw(gcur, w.c_base, G(tail + WCF), G(tail + BCF), B, te, dl);
  run.dx(gcur, W(tail + WTF), w.d_t, B, te, dl);
  run.dx(gcur, W(tail + WCF), w.d_c, B, te, dl);
  for (int i = n - 1; i >= 0; --i) {
    const int s0 = kHeadLeaves + kStageLeaves * i, di = d.hidden[i], dn = d.hidden[i + 1];
    const StageBufs& s = w.st[i];
    const float* m_blk = (const float*)masks[2 * i];
    const float* m_attn = (const float*)masks[2 * i + 1];
    float *g_hc = w.T[0], *d_v = w.T[1], *d_hn = w.T[2], *dyhat = w.T[3], *g_hb = w.T[4];
    run.dw(gcur, s.h_c, G(s0 + S_WD), G(s0 + S_BD), B, di, dn);
    run.dx(gcur, W(s0 + S_WD), g_hc, B, di, dn);
    run.dw(g_hc, s.v, G(s0 + S_WO), G(s0 + S_BO), B, di, di);
    run.dx(g_hc, W(s0 + S_WO), d_v, B, di, di, m_attn);
    run.dw(d_v, s.hn, G(s0 + S_WV), G(s0 + S_BV), B, di, di);
    run.dx(d_v, W(s0 + S_WV), d_hn, B, di, di);
    run.ln_bwd(d_hn, s.h_b, s.mean2, s.rstd2, W(s0 + S_G2), W(s0 + S_B2), nullptr, 0, g_hc,
               dyhat, g_hb, G(s0 + S_G2), G(s0 + S_B2), B, di);
    float* d_u = w.T[2];  // d_hn is spent
    run.ln_bwd(g_hb, s.u, s.mean1, s.rstd1, W(s0 + S_G1), W(s0 + S_B1), m_blk, 1, nullptr,
               dyhat, d_u, G(s0 + S_G1), G(s0 + S_B1), B, di);
    run.dw(d_u, s.h_a, G(s0 + S_WB), G(s0 + S_BB), B, di, di);
    run.dx(d_u, W(s0 + S_WB), gnext, B, di, di, nullptr, g_hb);  // d h_a
    run.dw(gnext, w.tc, G(s0 + S_WT), G(s0 + S_BT), B, te, di, 2.f);
    run.dx(gnext, W(s0 + S_WT), w.d_tc, B, te, di, nullptr, i == n - 1 ? nullptr : w.d_tc);
    float* swap = gcur;
    gcur = gnext;
    gnext = swap;
  }
  run.dw(gcur, w.x_t, G(WL), G(BL), B, L, d.hidden[0]);
  run.launch(cond_bwd_kernel, Run::blocks(nte), 256, w.d_t, w.d_c, w.d_tc, cond_mask, w.d_c2,
             nte, te);
  // time MLP
  run.dw(w.d_t, w.s1, G(WT2), G(BT2), B, 2 * te, te);
  run.dx(w.d_t, W(WT2), w.d_wide, B, 2 * te, te);
  run.launch(swish_bwd_kernel, Run::blocks(2 * nte), 256, w.d_wide, w.a1, w.d_mlp, 2 * nte);
  run.dw(w.d_mlp, w.sin_emb, G(WT1), G(BT1), B, te, 2 * te);
  // class MLP and table
  run.dw(w.d_c2, w.sc, G(WC2), G(BC2), B, te, te);
  run.dx(w.d_c2, W(WC2), w.d_wide, B, te, te);
  run.launch(swish_bwd_kernel, Run::blocks(nte), 256, w.d_wide, w.c1, w.d_mlp, nte);
  run.dw(w.d_mlp, w.e_c, G(WC1), G(BC1), B, te, te);
  run.dx(w.d_mlp, W(WC1), w.d_ec, B, te, te);
  run.launch(table_grad_kernel, d.classes, 128, w.d_ec, labels, G(TABLE), B, te, round);
}

// The plan of a train step bound to these weights, gradients and workspace
// (pointer arrays in `weights_spec` order; dims: B, latent, time_emb,
// classes, n_stages, hidden[0..n_stages]): every product's route, and the
// maps of the TMA routes encoded once. Null, with *err set, where the dims
// or a product are refused (a refused encode among them).
StepPlan* make_step_plan(const void* const* weights, void* const* grads, void* workspace,
                         const int* dims, int f32_lane, int global_skip, float ln_eps,
                         cudaError_t* err) {
  auto p = std::make_unique<StepPlan>();
  *err = cudaErrorInvalidValue;
  if (!read_dims(dims, &p->d) || (global_skip && p->d.hidden[p->d.n_stages] != p->d.latent))
    return nullptr;
  p->f32 = f32_lane != 0;
  p->global_skip = global_skip;
  p->ln_eps = ln_eps;
  p->weights.assign(weights, weights + n_leaves(p->d));
  p->grads.assign(grads, grads + n_leaves(p->d));
  p->workspace = workspace;
  Run run{nullptr, p->f32, cudaSuccess};
  run.rec = p.get();
  const std::vector<const void*> none(8 + 2 * (size_t)p->d.n_stages, nullptr);
  step_sequence(run, *p, none.data(), none.data(), nullptr);
  *err = run.err;
  return run.err == cudaSuccess ? p.release() : nullptr;
}

// Enqueue one train step of plan p on `stream` (see step_sequence).
cudaError_t train_step_enqueue(const StepPlan& p, const void* const* data,
                               const void* const* masks, void* loss, cudaStream_t stream) {
  Run run{stream, p.f32, cudaSuccess};
  run.plan = &p;
  step_sequence(run, p, data, masks, loss);
  if (run.err == cudaSuccess && run.next != p.products.size()) return cudaErrorInvalidValue;
  return run.err;
}

}  // namespace
