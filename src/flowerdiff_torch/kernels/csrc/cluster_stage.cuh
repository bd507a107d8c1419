// The phases of a denoiser stage on a cluster of blocks that share rows and
// split columns, for sm_90a. Used by the stage kernel (latent_stage.cu,
// one stage a launch) and the reverse-process kernel (reverse_process.cu,
// every stage of every step in one launch).
//
// A cluster holds `rows` rows (N, the wgmma's N). Its `cols` blocks split
// each product's output columns: block c owns a slice of each. A block is
// two consumer warpgroups and one producer warp.
//
//   - Products: warpgroup MMAs with the weight as the A operand, D^T = W X^T,
//     M = 64 of the block's output columns a tile, N = the cluster's rows,
//     K-major on both sides. The two warpgroups split each product's k64
//     tiles by parity and add each other's sums, so both hold the same
//     values. A thread of warp w of its warpgroup, lane 4 gq + t, holds for
//     each unit u (an m64 tile of the block's columns) the values
//     v[u][4 j + 2 h + e] of row n = 8 j + 2 t + e, column m = 64 u + 16 w +
//     gq + 8 h of the slice: the accumulators' layout of Wgmma<N>.
//   - Weights: the producer warp streams chunks (kb k64 tiles of the block's
//     column slice of one product, one TMA box of up to 32 KB through a 3-D
//     tensor map) through a ring of `slots` shared-memory slots, in a fixed
//     order that both sides know, so it runs ahead across the exchanges. A
//     slot is refilled once the 8 consumer warps have released it.
//   - Exchanges: the next product's bf16 operand (whole rows) and a
//     LayerNorm's per-block row statistics go to the other blocks as
//     st.async stores that complete on the receiver's mbarrier. The caller
//     names the mbarrier and the parity of the phase to wait for, and arms
//     it itself (at launch, or with `arm` bytes at each use), so one
//     mbarrier serves one exchange a launch or thousands.
//   - LayerNorm statistics are each block's (mean, m2) of its slice of a
//     row, combined in rank order (Chan et al.), so every block gets the
//     same numbers. No atomics: repeated launches are bit-equal.
//
// Shared memory: the caller's layout (`Offsets`) places the ring at the
// 1024-byte-aligned base and gives the offsets of the rest.
#pragma once

#include "rows.cuh"
#include "wgmma.cuh"

// Phase stamps of the diagnostic builds (tools/stage_phases.py,
// tools/process_phases.py), which define these macros ahead of the source;
// nothing in the library's build.
#ifndef FD_STAMP
#define FD_STAMP_BEGIN
#define FD_STAMP(i)
#define FD_RING_WAIT(p, wait) wait
#endif

namespace fdc {

constexpr int kStageThreads = 288;  // two consumer warpgroups and the producer warp
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = 32;
constexpr int kTileBytes = 8192;    // a weight tile in a slot: 64 lines of 128 bytes

// k64 tiles a weight chunk takes for a column slice of `slice` rows: the
// most, a power of two dividing d / 64, whose box stays within 32 KB. A
// TMA request costs ~0.37 us whatever its size up to 32 KB, and a block's
// requests run one after another (PERF.md section 6, tools/ingress_probe.py),
// so a chunk is one request as large as a box may be.
__host__ __device__ inline int chunk_tiles(int slice, int d) {
  int kb = 1;
  while (2 * kb * slice * 128 <= 32768 && (d / 64) % (2 * kb) == 0) kb *= 2;
  return kb;
}

// Bytes from a slot's start that a chunk's wgmma reads may reach: its last
// k64 tile's last m64 tile (64 lines, past a slice's own where it has
// fewer).
__host__ __device__ inline int chunk_reach(int slice, int kb) {
  return (kb - 1) * slice * 128 + (slice + 63) / 64 * kTileBytes;
}

__device__ __forceinline__ float swish(float u) { return u / (1.f + expf(-u)); }

// Pins the accumulators around the asynchronous products: no read or write
// of them moves across this point (CUTLASS's warpgroup_fence_operand).
template <int MT, int V>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][V]) {
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int i = 0; i < V; ++i) asm volatile("" : "+f"(acc[u][i])::"memory");
}

// Byte offset of (row n, k) in an operand buffer of `rows` lines a chunk.
__device__ __forceinline__ uint32_t swz(int n, int k, int rows) {
  return (uint32_t)((k >> 6) * rows * 128 + n * 128 + ((((k >> 3) & 7) ^ (n & 7)) << 4) +
                    (k & 7) * 2);
}

// The cluster's shape: rows a block (N), blocks a cluster, ring slots and
// operand buffers. Read through a reference, from the kernel's parameters.
struct Shape {
  int rows, cols, slots, qbufs;
};

// Where the phases find their shared memory, in bytes from the aligned
// base, and the launch's chunk count (`total`: a slot whose chunk is among
// the last `slots` is not released). The stage kernel computes these in
// its registers, the reverse-process kernel reads them from its parameters.
struct Offsets {
  int slot_bytes;  // a ring slot
  int q, q_bytes;  // the operand buffers and the bytes of each
  int stats;       // two LayerNorms' statistics, cols x rows float2 each
  int red;         // row sums: [pass][warpgroup][warp][row]
  int mr;          // (mean, rstd) a row
  int part;        // both warpgroups' partial sums, units m64 tiles of rows / 2 a thread
  int units;
  int bars;        // full[slots], empty[slots], then the exchanges' mbarriers
  int total;
};

template <int N, int MT>
struct Phases {
  static constexpr int V = N / 2;  // values a unit
  uint8_t* base;
  const Shape& sh;
  const Offsets& lay;
  int c, wg, w, gq, t, tid;
  bool lead;

  __device__ Phases(uint8_t* b, const Shape& shape, const Offsets& offsets)
      : base(b), sh(shape), lay(offsets) {
    c = (int)blockIdx.x;  // the block's rank in its cluster
    tid = (int)threadIdx.x;
    wg = tid >> 7;
    w = (tid >> 5) & 3;
    gq = (tid & 31) >> 2;
    t = tid & 3;
    lead = wg == 0;
  }

  __device__ uint32_t addr(int off) const { return fdh::smem_u32(base + off); }
  __device__ uint32_t full(int q) const { return addr(lay.bars + 8 * (q % sh.slots)); }
  __device__ uint32_t empty(int q) const { return addr(lay.bars + 8 * (sh.slots + q % sh.slots)); }
  __device__ uint32_t xbar(int i) const { return addr(lay.bars + 8 * (2 * sh.slots + i)); }
  __device__ uint8_t* qbuf(int i) const { return base + lay.q + (sh.qbufs == 2 ? i : 0) * lay.q_bytes; }
  __device__ uint32_t slot(int q) const { return addr(lay.slot_bytes * (q % sh.slots)); }

  __device__ int row(int j, int e) const { return 8 * j + 2 * t + e; }
  __device__ int col(int u, int h) const { return 64 * u + 16 * w + gq + 8 * h; }

  // All 8 consumer warps, or one warpgroup's 4.
  __device__ void sync_all() const { fdh::named_bar_sync(1, 256); }
  __device__ void sync_wg() const { fdh::named_bar_sync(2 + wg, 128); }

  // Each warp's lane 0 releases chunk q, unless no refill follows it.
  __device__ void release(int q) const {
    __syncwarp();
    if ((tid & 31) == 0 && q + sh.slots < lay.total) fdh::mbar_arrive(empty(q));
  }

  // acc = the block's `slice` columns of the product over the operand in
  // buffer `qb`, plus the bias (the block's slice of it, in shared memory).
  // The product's chunks are q0 .. q0 + nk - 1 of the stream, each kb k64
  // tiles; this warpgroup multiplies the tiles of its parity. `tag` names
  // the product for the stamps' ring waits.
  __device__ __forceinline__ void product(int q0, int nk, int kb, int slice, const uint8_t* qb,
                                          const float* bias, float (&acc)[MT][V],
                                          int tag) const {
    const int units = (slice + 63) / 64;
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.f;
    fence_acc(acc);
    const uint32_t b0 = fdh::smem_u32(qb);
    for (int kc = 0; kc < nk; ++kc) {
      const int q = q0 + kc;
      FD_RING_WAIT(tag, fdh::mbar_wait(full(q), (uint32_t)((q / sh.slots) & 1)));
      const uint32_t a0 = slot(q);
      fdh::wgmma_fence();
#pragma unroll 1
      for (int b = (kc * kb + wg) & 1; b < kb; b += 2) {
        const uint32_t at = a0 + (uint32_t)(b * slice * 128);
        const uint32_t bt = b0 + (uint32_t)((kc * kb + b) * sh.rows * 128);
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          if (u < units) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              fdh::Wgmma<N>::template run<0>(acc[u], fdh::wg_desc(at + u * kTileBytes + kk * 32),
                                             fdh::wg_desc(bt + kk * 32));
          }
        }
      }
      fdh::wgmma_commit();
      if (kc > 0) {
        fdh::wgmma_wait_one();
        release(q - 1);
      }
    }
    fdh::wgmma_wait_all();
    fence_acc(acc);
    release(q0 + nk - 1);
    // the other warpgroup's partial sums, added (a + b == b + a: both
    // warpgroups get the same bits)
    float* part = reinterpret_cast<float*>(base + lay.part);
    const int lane128 = tid & 127;
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (u < units) part[((wg * lay.units + u) * V + i) * 128 + lane128] = acc[u][i];
    sync_all();
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (u < units) acc[u][i] += part[(((1 - wg) * lay.units + u) * V + i) * 128 + lane128];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = col(u, h);
        if (u < units && m < slice) {
          const float bv = bias[m];
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            acc[u][4 * j + 2 * h] += bv;
            acc[u][4 * j + 2 * h + 1] += bv;
          }
        }
      }
  }

  // This block's `sd` columns of v (an operand of rows x cols sd, bf16)
  // into its own buffer `qb`, by the first warpgroup.
  __device__ __forceinline__ void write_own(const float (&v)[MT][V], uint8_t* qb, int sd) const {
    if (!lead) return;
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = col(u, h);
        if (m < sd) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<__nv_bfloat16*>(qb + swz(row(j, e), c * sd + m, sh.rows)) =
                  __float2bfloat16_rn(v[u][4 * j + 2 * h + e]);
        }
      }
  }

  // This block's slice (written by write_own or the caller) from `qb` into
  // the same buffer of every other block of the cluster, by st.async
  // completing on their exchange mbarrier `x`; then wait for the others'
  // slices in this block's buffer: the phase of parity `parity`. With `arm`
  // the mbarrier is armed here for those bytes; else at launch.
  __device__ __forceinline__ void send(uint8_t* qb, int sd, int x, uint32_t parity,
                                       bool arm) const {
    const uint32_t bar = xbar(x);
    if (arm && tid == 0)
      fdh::mbar_expect_tx(bar, (uint32_t)((sh.cols - 1) * sh.rows * sd * 2));
    fdh::fence_proxy_async();
    sync_all();
    const int vecs = sd / 8, units = sh.rows * vecs;
    const uint32_t q0 = fdh::smem_u32(qb);
    for (int i = tid; i < units && sh.cols > 1; i += 256) {
      const int n = i / vecs, k = c * sd + 8 * (i - n * vecs);
      const uint32_t off = q0 + swz(n, k, sh.rows);
      const uint4 val = *reinterpret_cast<const uint4*>(qb + swz(n, k, sh.rows));
      for (int j = 1; j < sh.cols; ++j) {
        const int to = (c + j) % sh.cols;
        fdh::st_async(fdh::mapa(off, to), val, fdh::mapa(bar, to));
      }
    }
    fdh::mbar_wait(bar, parity);
    fdh::fence_proxy_async();
  }

  __device__ __forceinline__ void share(const float (&v)[MT][V], uint8_t* qb, int sd, int x,
                                        uint32_t parity = 0, bool arm = false) const {
    write_own(v, qb, sd);
    send(qb, sd, x, parity, arm);
  }

  // (mean, rstd) of each of the thread's rows of v over the row's `width`
  // true columns (cols slices of sd; where width < cols sd, the columns
  // past it are padding and count for nothing), in mr: the block's (mean,
  // m2) of its slice's true columns (two passes), exchanged through
  // stats[which] and mbarrier x, combined in rank order by one thread a
  // row, each block weighted by its count (Chan et al.). kWhole: the
  // caller knows width == cols sd, and the code has no other case.
  template <bool kWhole = false>
  __device__ __forceinline__ void row_moments(const float (&v)[MT][V], int which, int sd,
                                              int width, int x, float eps, uint32_t parity = 0,
                                              bool arm = false) const {
    float* red = reinterpret_cast<float*>(base + lay.red);
    float2* stats = reinterpret_cast<float2*>(base + lay.stats) + which * sh.cols * sh.rows;
    float2* mr = reinterpret_cast<float2*>(base + lay.mr);
    if (arm && tid == 0)
      fdh::mbar_expect_tx(xbar(x), (uint32_t)((sh.cols - 1) * sh.rows * 8));
    const int own = kWhole ? sd : min(sd, max(0, width - c * sd));  // this block's true columns
    float mean[N / 8][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float* rp = red + ((pass * 2 + wg) * 4) * N;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < MT; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (col(u, h) < own) {
                const float x0 = v[u][4 * j + 2 * h + e];
                s += pass ? (x0 - mean[j][e]) * (x0 - mean[j][e]) : x0;
              }
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (gq == 0) rp[w * N + 8 * j + 2 * t + e] = s;
        }
      sync_wg();
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t + e;
          const float s = rp[n] + rp[N + n] + rp[2 * N + n] + rp[3 * N + n];
          if (pass == 0) {
            mean[j][e] = kWhole ? s / sd : own > 0 ? s / own : 0.f;
          } else if (lead) {
            // thread (w, gq) sends the row's pair to column slice 8 w + gq
            const int to = 8 * w + gq;
            const float2 st = make_float2(mean[j][e], s);
            float2* dst = stats + c * sh.rows + row(j, e);
            if (to == c) *dst = st;
            else if (to < sh.cols)
              fdh::st_async(fdh::mapa(fdh::smem_u32(dst), to), st, fdh::mapa(xbar(x), to));
          }
        }
    }
    sync_all();
    if (tid < sh.rows) {
      fdh::mbar_wait(xbar(x), parity);
      const float2* st = stats + tid;
      float m = 0.f, m2 = 0.f;
      if (kWhole || width == sd * sh.cols) {  // every slice whole: equal weights
        for (int j = 0; j < sh.cols; ++j) m += st[j * sh.rows].x;
        m /= sh.cols;
        for (int j = 0; j < sh.cols; ++j) {
          const float2 sj = st[j * sh.rows];
          const float e = sj.x - m;
          m2 += sj.y + sd * e * e;
        }
        mr[tid] = make_float2(m, rsqrtf(m2 / (sd * sh.cols) + eps));
      } else {
        for (int j = 0; j < sh.cols; ++j) m += min(sd, max(0, width - j * sd)) * st[j * sh.rows].x;
        m /= width;
        for (int j = 0; j < sh.cols; ++j) {
          const float2 sj = st[j * sh.rows];
          const float e = sj.x - m;
          m2 += sj.y + min(sd, max(0, width - j * sd)) * e * e;
        }
        mr[tid] = make_float2(m, rsqrtf(m2 / width + eps));
      }
    }
    sync_all();
  }

  // One operand buffer: every block of the cluster has read it (the product
  // just done) before anyone writes the next operand there. Mbarrier x
  // counts one arrival a block a phase.
  __device__ void buffer_free(int x, uint32_t parity = 0) const {
    if (sh.qbufs == 2) return;
    sync_all();
    if (tid == 0)
      for (int j = 0; j < sh.cols; ++j) fdh::mbar_arrive_remote(fdh::mapa(xbar(x), j));
    fdh::mbar_wait(xbar(x), parity);
  }
};

}  // namespace fdc
