// Fused latent-denoiser stage and head kernels for sm_90a.
//
// Replace the Pallas kernels `_stage_kernel` and `_head_kernel` of
// flowerdiff/kernels/latent_stage.py:
//
//   stage: h = h + row_add + rows_add
//          h = h + swish(LN1(bf16(h) @ Wb + bb))
//          h = h + (bf16(bf16(LN2(h)) @ Wv + bv) @ Wo + bo)
//          out = bf16(h) @ Wd + bd
//   head:  h = h + row_add + rows_add [+ bf16(t_base) @ Wt + bt] [+ bf16(c_base) @ Wc + bc]
//          out = bf16(LN(h)) @ Wf + bf
//
// Weights are bf16 in PyTorch's Linear layout (out, in); everything else f32.
//
// Bound on the card: at the sampler's 128 rows a stage reads up to 7.3 MB
// of bf16 weights for 2 x 128 x 3.67 M flops, ~68 flops a byte, far below
// the H100's ~295 bf16 flops a byte: the ideal kernel is bound by weight
// bytes. LayerNorm needs whole rows, which on the TPU sat in one core's
// VMEM.
//
// Stage design: a cluster of `cluster` blocks owns fd::kRows = 16 rows (one
// m16 tile); the host's plan (kernels/latent_stage.py::stage_plan) takes 16
// for the 1024-wide stage and 8 for the others. Where the card cannot run
// the wide stage's clusters of 16 of all the row tiles at once, the plan
// takes the whole-row kernel below (stage_rows_kernel) instead, which was
// measured faster there than the ring on clusters of 8 or of 32 rows.
// Block `rank` owns columns [rank sd, (rank + 1) sd) of the rows, sd = d /
// cluster: its slice of the residual stream h and of every product's output
// (`mma.sync` m16n8k16 bf16 tiles, f32 accumulators). The elementwise work
// runs on the slice; LayerNorm combines the blocks' partial row statistics
// (Chan's formula in rank order: the same numbers in every block); and the
// bf16 operand of the next product, which needs whole rows, is assembled in
// every block by stores from each block into the others' shared memory
// (distributed shared memory), one cluster barrier after each exchange.
//
// The weights do not depend on the activations: a block's stream is a fixed
// sequence of k-chunks (its rows of Wb, Wv, Wo, then Wd, `chunk` k's each).
// The chunks flow through a ring of `slots` shared-memory slots, each filled
// by 1-D bulk copies (`cp.async.bulk`) that complete on the slot's mbarrier.
// The weights are packed once, when a stage is bound, so that a block's
// chunk is one contiguous run of bytes (two at clusters of 8): on the H100
// a chunk carries ~1000 cycles of fixed cost (chunks of 128 k's against 256),
// and a bulk copy a weight row made the copies' issue the limit. A ninth warp refills a slot with the
// next chunk of the sequence as soon as the 8 compute warps are done with
// it, so while the exchanges and LayerNorms run the ring already holds the
// next product's first chunks; it issues the first `slots` chunks while the
// rows are loaded. Slot rows are padded by 16 bytes and the operand rows by
// 8 elements, so that the `ldmatrix` fragment loads hit eight different
// bank groups.
//
// Every phase runs once a launch, so its code is fetched cold each time:
// loops stay rolled and the product is one function called from four places.
// No atomics: split-K partial sums and statistics are added in a fixed order.
//
// Head design (the form with the t_base / c_base products, which are added
// to whole rows before the LayerNorm): one block owns 16 whole rows and all
// columns (the head's products are at most 512 wide). The sampler's form,
// with its adds from tables, runs on csrc/latent_head.cu's column tiles.
#include <cooperative_groups.h>

#include "rows.cuh"

namespace cg = cooperative_groups;
using fd::kPad;
using fd::kRows;
using fd::kThreads;
using fd::kWarps;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kPieces = kMaxCluster;  // row pieces of a packed weight
constexpr int kMaxSlots = 8;
constexpr int kStageThreads = kThreads + 32;  // 8 compute warps and the ring's producer
constexpr int kQPad = 8;          // bf16 elements of padding a stage operand row
constexpr int kSlotPad = 16;      // bytes of padding a ring slot row
constexpr int kBarBytes = 128;    // the ring's full and empty mbarriers, kMaxSlots each
constexpr int kStageRed = kWarps * kRows * 8;  // split-K partials: one n8 tile a warp
constexpr long long kWaitCycles = 1LL << 31;   // ~1 s: a lost copy traps, never hangs

// ---------------------------------------------------------------------------
// mbarrier, bulk copy and ldmatrix primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed; trap (a launch
// error the host sees at its next synchronise) if it never does.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = clock64();
    else if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Order this thread's generic-proxy reads of shared memory before later
// async-proxy writes (the bulk copy that refills a slot).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// bf16(a), bf16(b) as one 32-bit word, a in the low half.
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split cluster barrier: arrive early, wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The weight ring

// The weights come packed (kernels/latent_stage.py::pack_stage_weight): an
// (N, K) matrix is cut into kPieces pieces of N / kPieces whole rows, and
// piece j's chunk kc (its rows, k's [kc chunk, (kc + 1) chunk), each row
// padded to row_bytes) is one contiguous run of bytes at ((j nk + kc) N /
// kPieces) row_bytes. A block of rank r owns pieces [r, r + 1) kPieces /
// cluster, so a chunk of its stream is kPieces / cluster bulk copies, and
// lands in a slot as rows of stride row_bytes, whatever the cluster size.
//
// Chunk q of the block's stream is chunk q % nk of product q / nk (0 Wb,
// 1 Wv, 2 Wo, 3 Wd). It lives in slot q % slots: its copies complete phase
// q / slots of the slot's `full` mbarrier, and the block's 8 compute warps,
// one arrival each when they are done reading it, phase q / slots of its
// `empty` mbarrier. A ninth warp waits for that and refills the slot with
// chunk q + slots: issuing a bulk copy takes the issuing warp ~600 cycles,
// which, issued by a compute warp, lay on the path of every chunk.
struct Ring {
  uint32_t slot0, full0, empty0;  // shared addresses of slot 0 and its mbarriers
  int slots, slot_bytes, row_bytes, chunk, nk, total;
  int pieces, piece0;             // pieces a block, its first
  int piece_rows_d, piece_rows_o; // rows a piece of Wb, Wv, Wo and of Wd
  const unsigned char *wb, *wv, *wo, *wd;

  __device__ uint32_t slot(int q) const { return slot0 + (uint32_t)((q % slots) * slot_bytes); }
  __device__ uint32_t full(int q) const { return full0 + 8u * (uint32_t)(q % slots); }
  __device__ uint32_t empty(int q) const { return empty0 + 8u * (uint32_t)(q % slots); }
  __device__ uint32_t parity(int q) const { return (uint32_t)((q / slots) & 1); }
  __device__ int rows(int p) const { return pieces * (p < 3 ? piece_rows_d : piece_rows_o); }

  // Called by all of one warp.
  __device__ void issue(int q) const {
    const int lane = threadIdx.x & 31, p = q / nk, kc = q - p * nk;
    const int piece_rows = p < 3 ? piece_rows_d : piece_rows_o;
    const uint32_t piece_bytes = (uint32_t)(piece_rows * row_bytes), b = full(q);
    if (lane == 0) bar_expect_tx(b, piece_bytes * (uint32_t)pieces);
    __syncwarp();
    const unsigned char* w = p == 0 ? wb : p == 1 ? wv : p == 2 ? wo : wd;
    for (int j = lane; j < pieces; j += 32)
      bulk_copy(slot(q) + (uint32_t)j * piece_bytes,
                w + ((size_t)(piece0 + j) * nk + kc) * piece_bytes, piece_bytes, b);
  }

  // Called by all of a compute warp once it has read chunk q.
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bar_arrive(empty(q));
  }

  // Called by all of the producer warp: once chunk q is read, chunk q + slots
  // into its slot.
  __device__ void refill(int q) const {
    if (q + slots >= total) return;
    bar_wait(empty(q), parity(q));
    if ((threadIdx.x & 31) == 0) fence_proxy_async();
    issue(q + slots);
  }
};

// dst[r][n] = sum_k A[r][k] * W_p[row0 + n][k] + bias[n] for r < rows_valid,
// n < ncols (= the ring's rows of product p), A: bf16 16 x K in shared
// memory, row stride lda. dst: shared or global, row stride ldd. The ncols
// / 8 n8 tiles go to the warps, TPW a warp; with fewer than 8 tiles, `wpt`
// warps share a tile and split each chunk's k16 steps, and their partial
// sums are added in order. Two accumulators a tile (even and odd k16 steps)
// halve the chain of dependent mma's.
//
// Every compute warp, idle or not, waits for chunk q before it releases it:
// the slot's `empty` mbarrier counts one arrival a warp a chunk, so an idle
// warp that arrived for chunk q + slots before chunk q was read would
// complete the phase early and let the producer overwrite a slot still
// being read.
template <int TPW>
__device__ __noinline__ void ring_gemm(const Ring& ring, int p, const __nv_bfloat16* A,
                                       int lda, int ncols, const float* __restrict__ bias,
                                       float* dst, int ldd, int rows_valid, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = ncols >> 3, steps = ring.chunk / 16;
  int wpt = 1;
  if (tiles < kWarps) {
    wpt = kWarps / tiles;
    if (wpt > steps) wpt = steps;
  }
  const int spw = steps / wpt;                      // k16 steps a warp a chunk
  const int tile0 = (warp / wpt) * TPW, ks = warp % wpt;
  const bool active = warp < kWarps && tile0 < tiles;  // warp kWarps: the producer
  float acc[2][TPW][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < TPW; ++i) acc[e][i][0] = acc[e][i][1] = acc[e][i][2] = acc[e][i][3] = 0.f;
  // ldmatrix rows: A rows lane % 16 at k + 8 (lane / 16); B rows lane % 8 at
  // k + 8 ((lane / 8) % 2).
  const uint32_t a_base = smem_addr(A + (lane & 15) * lda + 8 * (lane >> 4));
  const uint32_t b_off = (uint32_t)(((tile0 * 8 + (lane & 7)) * ring.row_bytes) +
                                    16 * ((lane >> 3) & 1));
  const int q0 = p * ring.nk;
  for (int kc = 0; kc < ring.nk; ++kc) {
    const int q = q0 + kc;
    if (warp == kWarps) {
      ring.refill(q);
      continue;
    }
    bar_wait(ring.full(q), ring.parity(q));
    if (active) {
      const uint32_t sb = ring.slot(q) + b_off;
      auto step = [&](int s, float (&c)[TPW][4]) {
        const int kl = (ks * spw + s) * 16;
        uint32_t a0, a1, a2, a3;
        ldsm_x4(a_base + 2u * (uint32_t)(kc * ring.chunk + kl), a0, a1, a2, a3);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          if (tile0 + i < tiles) {
            uint32_t b0, b1;
            ldsm_x2(sb + (uint32_t)(i * 8 * ring.row_bytes + 2 * kl), b0, b1);
            fd::mma_bf16(c[i], a0, a1, a2, a3, b0, b1);
          }
        }
      };
      for (int s = 0; s < spw; s += 2) {
        step(s, acc[0]);
        if (s + 1 < spw) step(s + 1, acc[1]);
      }
    }
    ring.release(q);
  }
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][i][c] += acc[1][i][c];
  if (wpt == 1) {
    if (active) {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (tile0 + i < tiles) {
          const int n = (tile0 + i) * 8 + 2 * t;
          const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
          if (g < rows_valid)
            *reinterpret_cast<float2*>(dst + g * ldd + n) =
                make_float2(acc[0][i][0] + b0, acc[0][i][1] + b1);
          if (g + 8 < rows_valid)
            *reinterpret_cast<float2*>(dst + (g + 8) * ldd + n) =
                make_float2(acc[0][i][2] + b0, acc[0][i][3] + b1);
        }
      }
    }
  } else {
    if (active) {  // TPW == 1: this warp's partial of tile tile0
      float* part = red + (ks * tiles + tile0) * (kRows * 8);
      *reinterpret_cast<float2*>(part + g * 8 + 2 * t) =
          make_float2(acc[0][0][0], acc[0][0][1]);
      *reinterpret_cast<float2*>(part + (g + 8) * 8 + 2 * t) =
          make_float2(acc[0][0][2], acc[0][0][3]);
    }
    __syncthreads();
    for (int i = threadIdx.x; warp < kWarps && i < rows_valid * ncols; i += kThreads) {
      const int r = i / ncols, n = i - r * ncols, tile = n >> 3;
      float v = 0.f;
      for (int j = 0; j < wpt; ++j) v += red[(j * tiles + tile) * (kRows * 8) + r * 8 + (n & 7)];
      dst[r * ldd + n] = v + __ldg(bias + n);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void ring_product(const Ring& ring, int p, const __nv_bfloat16* A,
                                             int lda, const float* __restrict__ bias,
                                             float* dst, int ldd, int rows_valid, float* red) {
  const int ncols = ring.rows(p), tiles = ncols >> 3;
  if (tiles <= kWarps) {
    ring_gemm<1>(ring, p, A, lda, ncols, bias, dst, ldd, rows_valid, red);
  } else if (tiles <= 2 * kWarps) {
    ring_gemm<2>(ring, p, A, lda, ncols, bias, dst, ldd, rows_valid, red);
  } else {
    ring_gemm<4>(ring, p, A, lda, ncols, bias, dst, ldd, rows_valid, red);
  }
}

// ---------------------------------------------------------------------------
// Row phases of the stage. Each block holds only its column slice of the
// rows (16 x sd f32, sd = d / cluster): the elementwise work and the
// LayerNorm partial statistics run on the slice, and what the next product
// needs from the other blocks goes to them by stores into their shared
// memory (fire and forget), followed by one cluster barrier. Every phase
// runs once a launch, so its code is fetched cold each time: loops stay
// rolled and the products are one function called from four places.

// Block barrier, then cluster barrier: every store of this block's threads
// into any block's shared memory is visible to every block after it.
__device__ __forceinline__ void cluster_sync_all() {
  __syncthreads();
  cluster_arrive();
  cluster_wait();
}

// The block's slice (16 x sd f32, row stride sd) as bf16 into columns [c0,
// c0 + sd) of the operand Q (16 x lda bf16) of every block of the cluster,
// 16 bytes a store, each thread's stores to one block after another,
// starting at a block that depends on the rank so that the blocks spread
// their stores over the cluster.
__device__ __noinline__ void push_operand(cg::cluster_group& cluster, const float* V, int sd,
                                          __nv_bfloat16* Q, int lda, int c0, int n_cl,
                                          int rank) {
  const int vecs = kRows * sd / 8, items = n_cl * vecs;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int k = i / vecs, e = i - k * vecs, r = e / (sd / 8), c = 8 * (e - r * (sd / 8));
    const float4 lo = fd::ld4(V + r * sd + c), hi = fd::ld4(V + r * sd + c + 4);
    const uint4 packed = make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w),
                                    bf16x2(hi.x, hi.y), bf16x2(hi.z, hi.w));
    __nv_bfloat16* dst = cluster.map_shared_rank(Q, (rank + k) % n_cl);
    *reinterpret_cast<uint4*>(dst + r * lda + c0 + c) = packed;
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float swish(float u) { return u / (1.f + expf(-u)); }

// Row r of the slice V (16 x sd), half a warp a row (lane l: columns l, l +
// 16, ...): its mean and sum of squared deviations (two passes), stored as
// (mean, m2) at stats[rank][r] in every block of the cluster.
__device__ void push_row_stats(cg::cluster_group& cluster, const float* V, int sd,
                               float2* stats, int n_cl, int rank) {
  const int r = threadIdx.x >> 4, l = threadIdx.x & 15;
  float s = 0.f;
  for (int c = l; c < sd; c += 16) s += V[r * sd + c];
  const float mean = half_warp_sum(s) / sd;
  float ss = 0.f;
  for (int c = l; c < sd; c += 16) {
    const float e = V[r * sd + c] - mean;
    ss += e * e;
  }
  const float m2 = half_warp_sum(ss);
  for (int k = l; k < n_cl; k += 16)
    cluster.map_shared_rank(stats, k)[rank * kRows + r] = make_float2(mean, m2);
}

// The whole row's mean and reciprocal standard deviation from the cluster's
// partial statistics of slices of equal size sd: the mean of the means, and
// the squared deviations as the sum of m2 + sd (mean_j - mean)^2 (Chan et
// al.), both added in rank order, so every block gets the same numbers.
__device__ void row_moments(const float2* stats, int sd, int n_cl, float eps, float& mean,
                            float& rstd) {
  const int r = threadIdx.x >> 4;
  float m = 0.f;
  for (int j = 0; j < n_cl; ++j) m += stats[j * kRows + r].x;
  m /= n_cl;
  float m2 = 0.f;
  for (int j = 0; j < n_cl; ++j) {
    const float2 st = stats[j * kRows + r];
    const float e = st.x - m;
    m2 += st.y + sd * e * e;
  }
  mean = m;
  rstd = rsqrtf(m2 / (sd * n_cl) + eps);
}

// Shared memory of a stage launch, in this order: the ring's mbarriers, the
// ring, the block's slices Xs (h) and U (a product's output) (16 x sd f32
// each), the operands Q0 and Q1 (16 x (d + kQPad) bf16 each), two sets of
// row statistics (kMaxCluster x 16 float2 each), the split-K partials.
// kernels/latent_stage.py::stage_plan computes the same sum.
size_t stage_smem_bytes(int d, int dout, int cluster, int slots, int chunk) {
  const int sd = d / cluster, so = dout / cluster, sm = sd > so ? sd : so;
  const size_t slot_bytes = (size_t)sm * (2 * chunk + kSlotPad);
  return kBarBytes + slots * slot_bytes + sizeof(float) * 2 * kRows * (size_t)sd +
         sizeof(__nv_bfloat16) * 2 * kRows * (size_t)(d + kQPad) +
         sizeof(float2) * 2 * kMaxCluster * kRows + sizeof(float) * kStageRed;
}

__global__ void __launch_bounds__(kStageThreads, 1)
stage_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
             const float* __restrict__ rows_add,
             const __nv_bfloat16* __restrict__ wb, const float* __restrict__ bb,
             const float* __restrict__ g1, const float* __restrict__ b1,
             const float* __restrict__ g2, const float* __restrict__ b2,
             const __nv_bfloat16* __restrict__ wv, const float* __restrict__ bv,
             const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
             const __nv_bfloat16* __restrict__ wd, const float* __restrict__ bd,
             float* __restrict__ out, int B, int d, int dout, float eps, int slots,
             int chunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int sd = d / n_cl, so = dout / n_cl, sm = sd > so ? sd : so;
  const int c0 = rank * sd, o0 = rank * so;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;

  Ring ring;
  ring.slots = slots;
  ring.chunk = chunk;
  ring.row_bytes = 2 * chunk + kSlotPad;
  ring.slot_bytes = sm * ring.row_bytes;
  ring.nk = d / chunk;
  ring.total = 4 * ring.nk;
  ring.pieces = kPieces / n_cl;
  ring.piece0 = rank * ring.pieces;
  ring.piece_rows_d = d / kPieces;
  ring.piece_rows_o = dout / kPieces;
  ring.wb = reinterpret_cast<const unsigned char*>(wb);
  ring.wv = reinterpret_cast<const unsigned char*>(wv);
  ring.wo = reinterpret_cast<const unsigned char*>(wo);
  ring.wd = reinterpret_cast<const unsigned char*>(wd);
  ring.full0 = smem_addr(smem_raw);
  ring.empty0 = ring.full0 + 8u * kMaxSlots;
  ring.slot0 = ring.full0 + kBarBytes;

  unsigned char* p = smem_raw + kBarBytes + (size_t)slots * ring.slot_bytes;
  float* Xs = reinterpret_cast<float*>(p);        // 16 x sd: this block's columns of h
  float* U = Xs + kRows * sd;                     // 16 x sd: a product's output slice
  __nv_bfloat16* Q0 = reinterpret_cast<__nv_bfloat16*>(U + kRows * sd);  // operands,
  __nv_bfloat16* Q1 = Q0 + kRows * (d + kQPad);                          //   full rows
  float2* st1 = reinterpret_cast<float2*>(Q1 + kRows * (d + kQPad));  // row statistics
  float2* st2 = st1 + kMaxCluster * kRows;
  float* red = reinterpret_cast<float*>(st2 + kMaxCluster * kRows);   // split-K partials
  const int lda = d + kQPad;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      bar_init(ring.full0 + 8u * s, 1);
      bar_init(ring.empty0 + 8u * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // this block has started: the others may write to it
  const bool producer = tid >= kThreads;
  if (producer) {
    for (int q = 0; q < slots && q < ring.total; ++q) ring.issue(q);
  }

  // Xs = h + row_add + rows_add (zero past B), this block's columns
  for (int i = tid; !producer && i < kRows * sd / 4; i += kThreads) {
    const int r = i / (sd / 4), c = c0 + 4 * (i - r * (sd / 4)), row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < B) {
      v = fd::ldg4(h + (size_t)row * d + c);
      if (row_add) v = fd::add4(v, fd::ldg4(row_add + c));
      if (rows_add) v = fd::add4(v, fd::ldg4(rows_add + (size_t)row * d + c));
    }
    fd::st4(Xs + 4 * i, v);
  }
  __syncthreads();
  cluster_wait();
  if (!producer) push_operand(cluster, Xs, sd, Q0, lda, c0, n_cl, rank);
  cluster_sync_all();

  // h += swish(LN1(h @ Wb + bb))
  ring_product(ring, 0, Q0, lda, bb + c0, U, sd, kRows, red);
  if (!producer) push_row_stats(cluster, U, sd, st1, n_cl, rank);
  cluster_sync_all();
  const int r = tid >> 4, l = tid & 15;  // half a warp a row
  float mean, rstd;
  if (!producer) {
    row_moments(st1, sd, n_cl, eps, mean, rstd);
    for (int c = l; c < sd; c += 16) {
      const float u = (U[r * sd + c] - mean) * rstd * __ldg(g1 + c0 + c) + __ldg(b1 + c0 + c);
      Xs[r * sd + c] += swish(u);
    }
    __syncwarp();  // the row's new values, written by the half warp, read back
    push_row_stats(cluster, Xs, sd, st2, n_cl, rank);
  }
  cluster_sync_all();
  // Q1 = bf16(LN2(h)), Wv's operand
  if (!producer) {
    row_moments(st2, sd, n_cl, eps, mean, rstd);
    for (int c = l; c < sd; c += 16)
      U[r * sd + c] = (Xs[r * sd + c] - mean) * rstd * __ldg(g2 + c0 + c) + __ldg(b2 + c0 + c);
  }
  __syncthreads();
  if (!producer) push_operand(cluster, U, sd, Q1, lda, c0, n_cl, rank);
  cluster_sync_all();

  // h += (LN2(h) @ Wv + bv) @ Wo + bo  (attention over one key)
  ring_product(ring, 1, Q1, lda, bv + c0, U, sd, kRows, red);
  if (!producer) push_operand(cluster, U, sd, Q0, lda, c0, n_cl, rank);  // Wo's operand
  cluster_sync_all();
  ring_product(ring, 2, Q0, lda, bo + c0, U, sd, kRows, red);
  for (int i = tid; !producer && i < kRows * sd; i += kThreads) Xs[i] += U[i];
  __syncthreads();
  if (!producer) push_operand(cluster, Xs, sd, Q1, lda, c0, n_cl, rank);  // Wd's operand
  cluster_sync_all();

  // out = h @ Wd + bd, this block's columns
  const int valid = B - row0 < kRows ? B - row0 : kRows;
  ring_product(ring, 3, Q1, lda, bd + o0, out + (size_t)row0 * dout + o0, dout, valid, red);
}

// ---------------------------------------------------------------------------
// The whole-row stage kernel (PR 1's design), for the wide stage where its
// clusters of 16 cannot all run at once: a cluster of kRowsCluster = 8
// blocks owns 16 whole rows; every block keeps the rows' residual stream in
// its shared memory and computes 1/8 of each product's columns on the tensor
// cores (fd::gemm_tc, weights read from global memory), after each product
// the blocks exchange their column slices through DSMEM, and LayerNorm runs
// on whole rows in every block.

constexpr int kRowsCluster = 8;

// Every block's column slice S (kRows x sw f32) -> the full rows in this
// block: into F (kRows x kRowsCluster*sw f32) or, when F is null, into the bf16
// product operand Q (row stride kRowsCluster*sw + kPad). Each thread loads its
// float4 of all kRowsCluster slices before it stores any.
//
// One cluster barrier a gather: the products alternate between two slice
// buffers, so a block that has passed this barrier knows every block has
// finished the gather before, which read the buffer it writes next. After
// the last gather each block arrives at one more barrier and waits on it
// only before it exits, so that no block's shared memory goes while another
// still reads it.
__device__ void cluster_gather(cg::cluster_group& cluster, float* S, int sw, float* F,
                               __nv_bfloat16* Q, bool last) {
  cluster.sync();  // every slice written
  const float4* remote[kRowsCluster];
#pragma unroll
  for (int j = 0; j < kRowsCluster; ++j)
    remote[j] = reinterpret_cast<const float4*>(cluster.map_shared_rank(S, j));
  const int width = sw * kRowsCluster, q4 = sw / 4;
  for (int i = threadIdx.x; i < kRows * q4; i += kThreads) {
    float4 v[kRowsCluster];
#pragma unroll
    for (int j = 0; j < kRowsCluster; ++j) v[j] = remote[j][i];
    const int r = i / q4, c = 4 * (i - r * q4);
#pragma unroll
    for (int j = 0; j < kRowsCluster; ++j) {
      if (F) {
        fd::st4(F + r * width + j * sw + c, v[j]);
      } else {
        __nv_bfloat162* q =
            reinterpret_cast<__nv_bfloat162*>(Q + r * (width + kPad) + j * sw + c);
        q[0] = __floats2bfloat162_rn(v[j].x, v[j].y);
        q[1] = __floats2bfloat162_rn(v[j].z, v[j].w);
      }
    }
  }
  if (last) cluster_arrive();
  __syncthreads();
}

__global__ void __cluster_dims__(kRowsCluster, 1, 1) __launch_bounds__(kThreads)
stage_rows_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
                  const float* __restrict__ rows_add,
                  const __nv_bfloat16* __restrict__ wb, const float* __restrict__ bb,
                  const float* __restrict__ g1, const float* __restrict__ b1,
                  const float* __restrict__ g2, const float* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ wv, const float* __restrict__ bv,
                  const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
                  const __nv_bfloat16* __restrict__ wd, const float* __restrict__ bd,
                  float* __restrict__ out, int B, int d, int dout, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int sd = d / kRowsCluster, so = dout / kRowsCluster;
  const int sm = sd > so ? sd : so;
  float* X = smem;                  // kRows x d: the residual stream h
  float* F = X + kRows * d;         // kRows x d: gathered product results
  float* S0 = F + kRows * d;        // kRows x sm: this block's column slice,
  float* S1 = S0 + kRows * sm;      //   double-buffered
  float* red = S1 + kRows * sm;     // split-K partial sums
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(red + fd::kRedFloats);  // operand
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int c0 = rank * sd;

  fd::load_rows(X, h, row_add, rows_add, row0, B, d);

  // h += swish(LN1(h @ Wb + bb))
  fd::to_operand(X, Q, d);
  fd::gemm_tc(Q, d, wb, d, c0, sd, S0, red);
  fd::add_bias(S0, sd, bb + c0);
  cluster_gather(cluster, S0, sd, F, nullptr, false);
  fd::rows_layernorm(F, F, d, g1, b1, eps, true);
  fd::add_rows(X, F, d);

  // h += (LN2(h) @ Wv + bv) @ Wo + bo  (attention over one key)
  fd::rows_layernorm(X, F, d, g2, b2, eps, false);
  fd::to_operand(F, Q, d);
  fd::gemm_tc(Q, d, wv, d, c0, sd, S1, red);
  fd::add_bias(S1, sd, bv + c0);
  cluster_gather(cluster, S1, sd, nullptr, Q, false);  // rounded to bf16: Wo's operand
  fd::gemm_tc(Q, d, wo, d, c0, sd, S0, red);
  fd::add_bias(S0, sd, bo + c0);
  cluster_gather(cluster, S0, sd, F, nullptr, true);
  fd::add_rows(X, F, d);

  // out = h @ Wd + bd, this block's columns
  fd::to_operand(X, Q, d);
  const int o0 = rank * so;
  fd::gemm_tc(Q, d, wd, d, o0, so, S1, red);
  for (int i = tid; i < kRows * so; i += kThreads) {
    const int r = i / so, n = i - r * so, row = row0 + r;
    if (row < B) out[(size_t)row * dout + o0 + n] = S1[i] + bd[o0 + n];
  }
  cluster_wait();  // every block done reading this block's S0
}

__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
            const float* __restrict__ rows_add,
            const float* __restrict__ t_base, const __nv_bfloat16* __restrict__ wt,
            const float* __restrict__ bt,
            const float* __restrict__ c_base, const __nv_bfloat16* __restrict__ wc,
            const float* __restrict__ bc,
            const float* __restrict__ g, const float* __restrict__ b,
            const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bf,
            float* __restrict__ out, int B, int dl, int de, int latent, float eps) {
  extern __shared__ __align__(16) float smem[];
  int dm = dl > de ? dl : de;
  dm = dm > latent ? dm : latent;
  float* X = smem;                  // kRows x dl: h
  float* U = X + kRows * dl;        // kRows x dm: inputs and product results
  float* red = U + kRows * dm;
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(red + fd::kRedFloats);
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

  fd::load_rows(X, h, row_add, rows_add, row0, B, dl);
  const float* bases[2] = {t_base, c_base};
  const __nv_bfloat16* ws[2] = {wt, wc};
  const float* bs[2] = {bt, bc};
  for (int j = 0; j < 2; ++j) {
    if (!bases[j]) continue;
    fd::load_rows(U, bases[j], nullptr, nullptr, row0, B, de);
    fd::to_operand(U, Q, de);
    fd::gemm_tc(Q, de, ws[j], de, 0, dl, U, red);
    for (int i = tid; i < kRows * dl; i += kThreads) X[i] += U[i] + bs[j][i % dl];
    __syncthreads();
  }
  fd::rows_layernorm(X, U, dl, g, b, eps, false);
  fd::to_operand(U, Q, dl);
  fd::gemm_tc(Q, dl, wf, dl, 0, latent, U, red);
  for (int i = tid; i < kRows * latent; i += kThreads) {
    const int r = i / latent, n = i - r * latent, row = row0 + r;
    if (row < B) out[(size_t)row * latent + n] = U[i] + bf[n];
  }
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

// Shared memory of f32 buffers `floats` (times kRows) plus the split-K
// partials plus a bf16 operand of width k.
size_t smem_bytes(int floats, int k) {
  return sizeof(float) * ((size_t)kRows * floats + fd::kRedFloats) +
         sizeof(__nv_bfloat16) * (size_t)kRows * (k + kPad);
}

size_t g_stage_smem = 0;
size_t g_stage_rows_smem = 0;
size_t g_head_smem = 0;

// Shared memory and non-portable cluster sizes for stage_kernel.
cudaError_t stage_attributes(size_t smem) {
  static bool nonportable = false;
  if (!nonportable) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  return reserve_smem(stage_kernel, smem, &g_stage_smem);
}

cudaLaunchConfig_t stage_config(dim3 grid, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Shared memory of stage_rows_kernel: h and the gathered rows (16 x d f32
// each), two column slices, the split-K partials and the bf16 operand.
size_t stage_rows_smem_bytes(int d, int dout) {
  const int sd = d / kRowsCluster, so = dout / kRowsCluster;
  return smem_bytes(2 * d + 2 * (sd > so ? sd : so), d);
}

// The plan's fields, checked against what the kernel assumes.
cudaError_t check_plan(int d, int dout, int cluster, int slots, int chunk, int smem) {
  if (slots == 0)  // the whole-row kernel
    return cluster != kRowsCluster || chunk != 0 || d % 64 || dout % 64 || d > 1024 ||
                   dout > 4096 || (size_t)smem < stage_rows_smem_bytes(d, dout)
               ? cudaErrorInvalidValue
               : cudaSuccess;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || slots < 2 ||
      slots > kMaxSlots || chunk % 64 || d % chunk || d % 64 || d > 1024 ||
      dout % kPieces ||
      d % (8 * cluster) || dout % (8 * cluster) || d / cluster > 32 * kWarps ||
      dout / cluster > 32 * kWarps ||
      (size_t)smem < stage_smem_bytes(d, dout, cluster, slots, chunk))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// The launch plan (cluster size, ring slots, chunk depth, shared memory) is
// made by kernels/latent_stage.py::stage_plan; a plan of no slots launches
// the whole-row kernel. A plan the kernel cannot run returns
// cudaErrorInvalidValue, and a launch the card refuses (say,
// cudaErrorClusterOutOfResources) returns its error. Nothing retries.
extern "C" int fd_stage_launch(const void* h, const void* row_add, const void* rows_add,
                               const void* wb, const void* bb, const void* g1,
                               const void* b1, const void* g2, const void* b2,
                               const void* wv, const void* bv, const void* wo,
                               const void* bo, const void* wd, const void* bd,
                               void* out, int B, int d, int dout, int cluster, int slots,
                               int chunk, int smem, float eps, void* stream) {
  cudaError_t err = check_plan(d, dout, cluster, slots, chunk, smem);
  if (err != cudaSuccess) return (int)err;
  if (slots == 0) {
    err = reserve_smem(stage_rows_kernel, (size_t)smem, &g_stage_rows_smem);
    if (err != cudaSuccess) return (int)err;
    stage_rows_kernel<<<dim3(kRowsCluster, (B + kRows - 1) / kRows), kThreads, smem,
                        (cudaStream_t)stream>>>(
        (const float*)h, (const float*)row_add, (const float*)rows_add,
        (const __nv_bfloat16*)wb, (const float*)bb, (const float*)g1, (const float*)b1,
        (const float*)g2, (const float*)b2, (const __nv_bfloat16*)wv, (const float*)bv,
        (const __nv_bfloat16*)wo, (const float*)bo, (const __nv_bfloat16*)wd,
        (const float*)bd, (float*)out, B, d, dout, eps);
    return (int)cudaGetLastError();
  }
  err = stage_attributes((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = stage_config(dim3(cluster, (B + kRows - 1) / kRows),
                                              (size_t)smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, stage_kernel, (const float*)h, (const float*)row_add, (const float*)rows_add,
      (const __nv_bfloat16*)wb, (const float*)bb, (const float*)g1, (const float*)b1,
      (const float*)g2, (const float*)b2, (const __nv_bfloat16*)wv, (const float*)bv,
      (const __nv_bfloat16*)wo, (const float*)bo, (const __nv_bfloat16*)wd,
      (const float*)bd, (float*)out, B, d, dout, eps, slots, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` stage blocks with `smem` bytes each the card
// runs at once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int fd_stage_max_clusters(int cluster, int smem, int* count) {
  cudaError_t err = stage_attributes((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = stage_config(dim3(cluster, 1), (size_t)smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, stage_kernel, &cfg);
}

// dl, de: multiples of 32; latent: a multiple of 8; all <= 512.
extern "C" int fd_head_launch(const void* h, const void* row_add, const void* rows_add,
                              const void* t_base, const void* wt, const void* bt,
                              const void* c_base, const void* wc, const void* bc,
                              const void* g, const void* b, const void* wf,
                              const void* bf, void* out, int B, int dl, int de,
                              int latent, float eps, void* stream) {
  int dm = dl > de ? dl : de;
  dm = dm > latent ? dm : latent;
  const size_t smem = smem_bytes(dl + dm, dm);
  cudaError_t err = reserve_smem(head_kernel, smem, &g_head_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  head_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)row_add, (const float*)rows_add,
      (const float*)t_base, (const __nv_bfloat16*)wt, (const float*)bt,
      (const float*)c_base, (const __nv_bfloat16*)wc, (const float*)bc,
      (const float*)g, (const float*)b, (const __nv_bfloat16*)wf, (const float*)bf,
      (float*)out, B, dl, de, latent, eps);
  return (int)cudaGetLastError();
}
