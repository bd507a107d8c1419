// The whole ancestral reverse process in one launch, for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of
// flowerdiff/kernels/full_sampler.py, which runs all T steps of a request in
// one TPU kernel (its `fori_loop`) with x and every weight on chip. Each
// step, for every row:
//
//   h   = bf16(x) Wl^T + bl                         (the CFG copy: rows b and B + b)
//   skip = sigmoid(rw) (bf16(x) Wf^T + bf)          (a v2 model)
//   h   = stage_i(h + tadd_i[t] + cond_i)            for each stage (latent_stage.cu)
//   eps = bf16(LN(h + tadd_f[t] + cond_f)) Wf^T + bf
//   x   = reverse_step(eps + skip, x, t)             (CFG, x0 clip, mean, noise: reverse_step.cuh)
//
// under the port's rules for it (kernels/full_sampler.py): the CFG null rows
// keep the projection biases, the v2 skip is applied, LayerNorm eps is the
// model's. The time adds come from (T, d) tables, the condition adds from
// the request's (rows, d) rows, as the host loop takes them.
//
// Design. The denoiser never mixes rows, and CFG pairs a sample's
// conditional row only with its own null row. So the launch is `clusters`
// clusters of `cols` blocks, and each cluster owns `rows` rows for all T
// steps: some samples' conditional rows and, when guided, their null rows
// (row r and r + rows / 2). No cluster waits on another: there is no
// grid-wide barrier, the launch cannot deadlock, and clusters past the first
// wave are still right (only later). The blocks of a cluster split every
// product's columns as the stage kernel's do, with its phases
// (cluster_stage.cuh): weights as wgmma's A operand streamed by TMA through
// 3-D tensor maps encoded at bind, st.async exchanges into mbarriers,
// LayerNorm statistics combined in rank order. A block keeps its column
// slice of x and of the request's condition adds in shared memory for the
// whole launch, reads one row of each time table a step, and writes x once,
// at the end. Its producer warp streams the chunks of every product of every
// step in one fixed order, so it runs ahead across exchanges, stages and
// steps; a slot is refilled only after the 8 consumer warps released it.
// Each exchange mbarrier is armed at each use and waited on by parity: two
// for the operands (alternating, as the buffers do), two for the LayerNorm
// statistics, one counting the blocks' releases of a single operand buffer.
// Between two uses of one mbarrier lies another exchange that needs this
// block's data, so no block can send for the next use before this block has
// seen the last one complete.
//
// The noise: Philox4x32-10 under the request's key (device memory), counter
// (element index / 4 in the (B, L) layout, t, 0, 0), as reverse_step.cu
// draws it. Where the latent is unpadded, each group of 4 lies in one
// block's slice (a multiple of 8 columns) and one call serves it; else a
// group may span two rows, which may lie in two clusters, so each element
// draws its own group and keeps its lane (Philox is stateless).
//
// Widths. The kernel tiles with padded widths (`dims`, `L`): each a
// multiple of 64, or of 128 at 16 blocks a cluster, so every block's slice
// is a whole number of 8-column units. The weights, biases, LayerNorm
// affines and time tables are padded with zeros at bind
// (kernels/full_sampler.py::pad_process), so the padded columns of h stay
// exactly 0 through every product, LayerNorm (its affine is 0 there) and
// swish(0) = 0. The model's own widths (`wid`, `lat`) bound what is read
// from and written to the request's tensors (x, the condition rows, x_0),
// which the kernel reads at their own strides, and the LayerNorms count
// only the true columns (cluster_stage.cuh::row_moments). A denoiser that
// needs no padding (the flagship) runs the instances without that case
// (`kExact`), whose code is the kernel's before widths were padded: the
// padded case, present but not taken, slowed the flagship's step by ~3%.
// A denoiser wider than 1024 may take slices of 4 m64 tiles at 8 and 16
// rows (kernels/full_sampler.py::process_units), which at 16 blocks a
// cluster reach widths of 4096.
//
// Depth. A denoiser of up to 8 stages whose vectors and condition adds fit
// beside the ring keeps them resident, its tensor maps and per-stage
// pointers in the launch's parameters. A deeper one, or one whose resident
// slices would not fit (`kStream`), keeps none of them on chip: its tensor
// maps, widths and time-table pointers lie in device memory written at bind,
// its vectors in one (cols, slice) table a block reads from L2 (each block's
// row laid out as the resident slices are), its condition adds are read
// from the request's rows where they are added, through a table of their
// pointers that each launch writes ahead of itself on its stream. Nothing on
// chip then grows with depth, and the parameters stay the same size.
//
// Wide nets. A last hidden width or a latent past what a block's slice and
// shared memory hold (each past 4096 beside narrow stages: the JAX kernel
// holds a 25,706-wide last width at the 8 bucket, a 1,047,802-wide latent)
// runs the wide layout (`kWide`, streamed, instances of its own). The
// latent L and the last width dims[n] are wide vectors, each padded to a
// multiple of 64 and split among the blocks by m64 units (block c owns
// units [c U / cols, (c + 1) U / cols)), a block's units taken in passes of
// MT. What is per row and wide lives in device memory, per cluster: x in
// the output itself (copied from x_T at launch), the skip, the head's
// pre-LN rows, and the two wide products' bf16 operands (bf16(x) for the
// projection and the skip, LN(h) for the head), stored in the swizzled
// tile order a slot holds them in. A wide product reads its operand in K
// chunks by a bulk copy into the same ring slot as its weight chunk, after
// every block of the cluster has published its columns (a cluster-scope
// release on an mbarrier of each block that the producer acquires), not by
// a DSMEM exchange. Its output runs in column passes: the skip's into
// device memory, the last stage's Wd into the head's pre-LN rows (time and
// condition adds included), whose LayerNorm statistics are the blocks'
// (mean, m2) over their units, exchanged and combined as the stages' are;
// the head's, pass by pass, straight into the reverse step of its columns,
// each element drawing its own Philox group (the same x_0 as the host loop).
// Stage inputs stay in the narrow layout (at most 4096, past the JAX edge of
// ~3852 at T = 1000: three d x d weights).
//
// Bound on the card: operations, 1.652 ms for 1000 steps at 128 rows with
// every weight read once (chip_smoke.py::sampler_bound_ms). Each cluster
// reads the ~12.7 MB of bf16 weights every step from L2; the plan
// (kernels/full_sampler.py::process_plan) trades that against the
// exchanges' bytes, which grow with the rows a cluster, and the clusters
// that fit in one wave.
#include "cluster_stage.cuh"
#include "reverse_step.cuh"

#ifndef FD_STEP_STAMPS
#define FD_STEP_STAMP(i)
#define FD_STAMP_STEP(on)
#endif

namespace {

using fdc::chunk_reach;
using fdc::chunk_tiles;
using fdc::kMaxCluster;
using fdc::kMaxSlots;
using fdc::kStageThreads;
using fdc::swish;

constexpr int kMaxStages = 8;                 // resident: maps and pointers in the parameters
constexpr int kMaxMaps = 2 + 4 * kMaxStages;  // Wl, four a stage, Wf
constexpr int kMaxStreamStages = 32768;       // streamed
constexpr int kMaxDim = 4096;                 // 16 blocks of 4 m64 tiles
constexpr int kMaxWide = 1 << 22;             // the wide layout's latent and last width
constexpr int kWideChunk = 36864;             // a wide chunk's slot: weights and operand
// m64 tiles of a block's widest slice at `rows` rows a cluster: the
// instances hold at most 64 accumulators a thread (MT x rows / 2 x 2)
__host__ __device__ inline int max_units(int rows) { return rows <= 16 ? 4 : 2; }
constexpr int kBars = 5;
constexpr int kWideBars = kBars + 2;
enum { kOp0 = 0, kOp1 = 1, kSt0 = 2, kSt1 = 3, kFree = 4, kReady0 = 5, kReady1 = 6 };

// The wide layout's split of a W-wide vector (W a multiple of 64): block c
// of `cols` owns the m64 units [wide_u0(c), wide_u0(c + 1)), in passes of
// mt units; every block runs the most passes any block needs (a pass past
// its units computes nothing), so every block streams the same chunks.
__host__ __device__ inline int wide_u0(int W, int cols, int c) {
  return (int)((long long)c * (W / 64) / cols);
}
__host__ __device__ inline int wide_passes(int W, int cols, int mt) {
  const int per = (W / 64 + cols - 1) / cols;
  return (per + mt - 1) / mt;
}
// k64 tiles of a wide chunk of `lines` weight rows and `rows` operand rows:
// the most, a power of two dividing K / 64, whose slot stays within
// kWideChunk (one tile where a single one is larger).
__host__ __device__ inline int wide_tiles(int lines, int rows, int K) {
  int kb = 1;
  while ((K / 64) % (2 * kb) == 0 && 2 * kb * (lines + rows) * 128 <= kWideChunk) kb *= 2;
  return kb;
}

// Product p of a step on the wide layout, in stream order as product_shape:
// its tensor map, the weight rows of its chunks (`lines`: the block's slice
// for a narrow output, a pass of mt units for a wide one), its depth K,
// k64 tiles a chunk, passes, the wide output's width W (0: narrow) and its
// operand: -1 the operand buffer (a DSMEM exchange), 0 or 1 the device
// scratch of bf16(x) or of the head's LN(h), read through the ring.
struct WideShape {
  int map, lines, K, kb, passes, W, op;
};
__host__ __device__ inline WideShape wide_shape(const int* dims, int n, int L, int cols,
                                                int rows, int mt, int p) {
  const int tw = 64 * mt;
  WideShape w;
  if (p == 0) {
    w = {0, dims[0] / cols, L, 0, 1, 0, 0};
    w.kb = wide_tiles(w.lines, rows, L);
  } else if (p == 1 || p == 2 + 4 * n) {
    w = {1 + 4 * n, tw < L ? tw : L, p == 1 ? L : dims[n], 0, wide_passes(L, cols, mt), L,
         p == 1 ? 0 : 1};
    w.kb = wide_tiles(w.lines, rows, w.K);
  } else {
    const int i = (p - 2) / 4, j = (p - 2) % 4;
    if (i == n - 1 && j == 3) {
      w = {1 + 4 * i + j, tw < dims[n] ? tw : dims[n], dims[i], 0, wide_passes(dims[n], cols, mt),
           dims[n], -1};
    } else {
      w = {1 + 4 * i + j, (j < 3 ? dims[i] : dims[i + 1]) / cols, dims[i], 0, 1, 0, -1};
    }
    w.kb = chunk_tiles(w.lines, w.K);
  }
  return w;
}

// Byte offset of (row r, column k) in a wide operand of `rows` rows in
// device memory: k64 tiles of `rows` lines of 128 bytes, each line
// 128-byte swizzled, so a chunk of kb tiles is kb rows 128 contiguous bytes
// that land in a slot as a TMA box of the same tiles would.
__device__ __forceinline__ size_t wide_swz(int r, int k, int rows) {
  return (size_t)(k >> 6) * rows * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4);
}

// `bytes` from device memory at `src` into shared memory at `dst`, one bulk
// copy completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"((uint64_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

// One arrival, a cluster-scope release, on the mbarrier at the
// shared::cluster address `bar`: what this block wrote to device memory
// before it is visible to whoever acquires the phase.
__device__ __forceinline__ void arrive_release(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` of this block's mbarrier `bar`
// with a cluster-scope acquire, then order it before this thread's
// async-proxy reads of device memory (the bulk copies of what was
// published); trap after ~1 s, as fdh::mbar_wait.
__device__ __forceinline__ void wait_published(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (spins == 0) t0 = clock64();
    else if (clock64() - t0 > fdh::kWaitCycles) __trap();
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// acc = `real` columns of a product on the wide layout, chunks q0 .. q0 + nk
// - 1 of kb k64 tiles of `lines` weight rows, plus the bias (real entries
// from `bias`). The operand is the buffer `qb`, or where qb is null the
// rows of each chunk's slot after its weights (a bulk copy). As
// fdc::Phases::product, with the slot's line count and the output's
// columns apart (a pass's box may hold more rows than it computes).
template <int N, int MT>
__device__ __forceinline__ void wide_mma(const fdc::Phases<N, MT>& k, int q0, int nk, int kb,
                                         int lines, int real, const uint8_t* qb,
                                         const float* bias, float (&acc)[MT][N / 2]) {
  constexpr int V = N / 2;
  const int units = (real + 63) / 64;
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[u][i] = 0.f;
  fdc::fence_acc(acc);
  const uint32_t b0 = qb ? fdh::smem_u32(qb) : 0u;
  for (int kc = 0; kc < nk; ++kc) {
    const int q = q0 + kc;
    fdh::mbar_wait(k.full(q), (uint32_t)((q / k.sh.slots) & 1));
    const uint32_t a0 = k.slot(q);
    const uint32_t bb = qb ? b0 + (uint32_t)(kc * kb * N * 128) : a0 + (uint32_t)(kb * lines * 128);
    fdh::wgmma_fence();
#pragma unroll 1
    for (int b = (kc * kb + k.wg) & 1; b < kb; b += 2) {
      const uint32_t at = a0 + (uint32_t)(b * lines * 128);
      const uint32_t bt = bb + (uint32_t)(b * N * 128);
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (u < units) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fdh::Wgmma<N>::template run<0>(acc[u], fdh::wg_desc(at + u * fdc::kTileBytes + kk * 32),
                                           fdh::wg_desc(bt + kk * 32));
        }
      }
    }
    fdh::wgmma_commit();
    if (kc > 0) {
      fdh::wgmma_wait_one();
      k.release(q - 1);
    }
  }
  fdh::wgmma_wait_all();
  fdc::fence_acc(acc);
  k.release(q0 + nk - 1);
  float* part = reinterpret_cast<float*>(k.base + k.lay.part);
  const int lane128 = k.tid & 127;
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (u < units) part[((k.wg * k.lay.units + u) * V + i) * 128 + lane128] = acc[u][i];
  k.sync_all();
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (u < units) acc[u][i] += part[(((1 - k.wg) * k.lay.units + u) * V + i) * 128 + lane128];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = k.col(u, h);
      if (u < units && m < real) {
        const float bv = bias[m];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          acc[u][4 * j + 2 * h] += bv;
          acc[u][4 * j + 2 * h + 1] += bv;
        }
      }
    }
}

// Product p of a step, in stream order: 0 the projection, 1 the skip, 2 +
// 4 i + j stage i's Wb, Wv, Wo, Wd, 2 + 4 n the head. Its tensor map, the
// block's column slice and its depth K.
__host__ __device__ inline void product_shape(const int* dims, int n, int L, int cols, int p,
                                              int* map, int* slice, int* K) {
  if (p == 0) {
    *map = 0, *slice = dims[0] / cols, *K = L;
  } else if (p == 1) {
    *map = 1 + 4 * n, *slice = L / cols, *K = L;
  } else if (p < 2 + 4 * n) {
    const int i = (p - 2) / 4, j = (p - 2) % 4;
    *map = 1 + 4 * i + j, *slice = (j < 3 ? dims[i] : dims[i + 1]) / cols, *K = dims[i];
  } else {
    *map = 1 + 4 * n, *slice = L / cols, *K = dims[n];
  }
}

// Shared memory of a block, in bytes from a 1024-byte-aligned base: the
// ring, the operand buffers (rows x the widest operand, bf16, swizzled),
// two LayerNorms' statistics, the row sums, (mean, rstd) a row, both
// warpgroups' partial sums, the block's slices of every vector (bl; per
// stage bb g1 b1 g2 b2 bv bo, then bd; the head's g, b and bf), of the
// condition adds (rows x each stage's slice, then the head's), its slice of
// x, eps and the skip (rows x L / cols f32 each), the mbarriers, and padding
// where the last slot's reads would reach past the end. Streamed, the
// vectors and adds take no room (`vec_floats`, the floats of a block's row
// of the vector table, is counted all the same).
// kernels/full_sampler.py::process_smem computes the same. The wide
// layout keeps none of x, eps, the skip, the vectors or the adds: its
// operand buffers hold the narrow products' (the stages'), its ring slots a
// wide product's operand chunk after the weights, and `eps` a pass's eps
// (rows x 64 MT f32) for the reverse step.
struct ProcessLayout {
  int units, slot_bytes, chunks, vec_floats, q, q_bytes, stats, red, mr, part, vec, adds, xs, eps,
      skip, bars, total;
  ProcessLayout() = default;
  __host__ __device__ ProcessLayout(const int* dims, int n, int L, bool with_skip, int cols,
                                    int rows, int qbufs, int slots, bool streamed = false,
                                    bool wide = false) {
    int widest = 0, dmax = wide ? 64 : L, reach = 0, nvec = dims[0] / cols, nadds = 0;
    slot_bytes = chunks = 0;
    for (int p = 0; p < 3 + 4 * n; ++p) {
      if (p == 1 && !with_skip) continue;
      if (wide) {
        const WideShape w = wide_shape(dims, n, L, cols, rows, max_units(rows), p);
        const int bytes = w.kb * (w.lines + (w.op >= 0 ? rows : 0)) * 128;
        slot_bytes = bytes > slot_bytes ? bytes : slot_bytes;
        reach = chunk_reach(w.lines, w.kb) > reach ? chunk_reach(w.lines, w.kb) : reach;
        chunks += w.passes * (w.K / 64 / w.kb);
        if (w.op < 0) dmax = w.K > dmax ? w.K : dmax;
        continue;
      }
      int map, slice, K;
      product_shape(dims, n, L, cols, p, &map, &slice, &K);
      const int kb = chunk_tiles(slice, K);
      widest = slice > widest ? slice : widest;
      dmax = K > dmax ? K : dmax;
      slot_bytes = kb * slice * 128 > slot_bytes ? kb * slice * 128 : slot_bytes;
      reach = chunk_reach(slice, kb) > reach ? chunk_reach(slice, kb) : reach;
      chunks += K / 64 / kb;
    }
    for (int i = 0; i < n; ++i) {
      nvec += (7 * dims[i] + dims[i + 1]) / cols;
      nadds += dims[i] / cols;
    }
    nvec += 2 * dims[n] / cols + L / cols;
    nadds += dims[n] / cols;
    vec_floats = nvec;
    if (wide) {
      units = max_units(rows);
      q = slots * slot_bytes;
      q_bytes = rows * dmax * 2;
      stats = q + qbufs * q_bytes;
      red = stats + 2 * cols * rows * 8;
      mr = red + 2 * 2 * 4 * rows * 4;
      part = mr + rows * 8;
      vec = adds = xs = skip = eps = part + 2 * 128 * units * (rows / 2) * 4;
      bars = eps + rows * 64 * units * 4;
      total = bars + (2 * slots + kWideBars) * 8;
      const int over = reach - slot_bytes - (total - q);
      if (over > 0) total += over;
      return;
    }
    if (streamed) nvec = nadds = 0;
    units = (widest + 63) / 64;
    q = slots * slot_bytes;
    q_bytes = rows * dmax * 2;
    stats = q + qbufs * q_bytes;
    red = stats + 2 * cols * rows * 8;
    mr = red + 2 * 2 * 4 * rows * 4;
    part = mr + rows * 8;
    vec = part + 2 * 128 * units * (rows / 2) * 4;
    adds = vec + (nvec * 4 + 15) / 16 * 16;
    xs = adds + rows * nadds * 4;
    eps = xs + rows * (L / cols) * 4;
    skip = eps + rows * (L / cols) * 4;
    bars = skip + rows * (L / cols) * 4;
    total = bars + (2 * slots + kBars) * 8;
    const int over = reach - slot_bytes - (total - q);
    if (over > 0) total += over;
  }
};

struct Maps {
  CUtensorMap m[kMaxMaps];
};

struct ProcessArgs {
  const float* x;        // (B, L) x_T
  float* out;            // (B, L) x_0
  const uint32_t* key;   // the Philox key, two words
  const float* coefs;    // (T, 3): alpha, alpha_bar, beta
  const float* bl;       // (dims[0]) the projection's bias
  const float* rw;       // the v2 skip's gate, or null: no skip
  const float* tadd_f;   // (T, dims[n]) the head's time adds
  const float* adds_f;   // (rows, dims[n]) the head's condition adds
  const float *hg, *hb;  // the head's LayerNorm affine
  const float* hbf;      // (L) the head's bias (and the skip's)
  const float* tadd[kMaxStages];
  const float* adds[kMaxStages];
  const float* vec[kMaxStages][8];  // bb g1 b1 g2 b2 bv bo bd
  int dims[kMaxStages + 1];         // the hidden widths, padded
  int wid[kMaxStages + 1];          // the hidden widths
  int lat;                          // the latent width (L: padded)
  int n, B, L, T, guided, clip, stochastic;
  float scale, clip_val, eps;
  int cols, rows, qbufs, slots;
  ProcessLayout lay;  // set at launch, read from the parameters
  fdc::Shape sh;      // the phases' view of them
  fdc::Offsets off;
  // streamed (kStream): device memory in place of the arrays above
  const CUtensorMap* smaps;    // 2 + 4 n maps, 64-byte aligned, in stream order
  const int* sdims;            // dims[0..n], then wid[0..n]
  const float* const* stadd;   // (n) the stages' time tables
  const float* const* sadds;   // (n) the stages' condition adds, a table of the launch's own
  const float* svec;           // (cols, lay.vec_floats) each block's vector slices
  // wide (kWide): the last stage's bd (dims[n]) and the clusters' scratch
  // (wide_scratch)
  const float* bd_last;
  uint8_t* scratch;
};

// The wide layout's scratch of the `clusters` clusters of `rows` rows (S
// samples each), bytes: bf16(x) (rows x L), the head's operand (rows x
// dims[n]) bf16, its pre-LN rows (rows x dims[n]) f32, the skip (S x L) f32;
// each cluster's at its own offset. kernels/full_sampler.py::process_scratch
// computes the same.
struct WideScratch {
  size_t op0, op1, hrow, skip, total;
  __host__ __device__ WideScratch(int clusters, int rows, int S, int L, int Dn, bool with_skip) {
    const size_t C = (size_t)clusters;
    op0 = 0;
    op1 = C * rows * L * 2;
    hrow = op1 + C * rows * Dn * 2;
    skip = hrow + C * rows * Dn * 4;
    total = skip + (with_skip ? C * S * L * 4 : 0);
  }
};

// kExact: every width is its own padded width (the flagship's), and the
// code has no padded case: the loads, LayerNorms and reverse step of a
// denoiser that needs no padding, as before widths were padded. kStream:
// the streamed layout (any depth; padded code), in instances of its own.
// kWide: the wide layout (streamed, and its own instances too).
template <int N, int MT, bool kExact, bool kStream = false, bool kWide = false>
__global__ void __launch_bounds__(kStageThreads, 1)
process_kernel(const __grid_constant__ Maps maps, const __grid_constant__ ProcessArgs a) {
  static_assert(!(kExact && kStream), "the streamed instances take the padded code");
  static_assert(!kWide || kStream, "the wide layout is streamed");
  FD_STAMP_BEGIN;
  FD_STAMP(0);
  extern __shared__ uint8_t process_raw[];
  const uint32_t raw = fdh::smem_u32(process_raw);
  uint8_t* base = process_raw + (((raw + 1023u) & ~1023u) - raw);
  const int n = a.n, cols = a.cols;
  const bool with_skip = a.rw != nullptr;
  const ProcessLayout& L = a.lay;
  const fdc::Phases<N, MT> k(base, a.sh, a.off);
  const int c = k.c, tid = (int)threadIdx.x, lane = tid & 31;
  const bool producer = tid >= 256;
  const int S = a.guided ? N / 2 : N;  // samples a cluster
  const int s0 = (int)blockIdx.y * S;  // its first sample
  const int* const dims = kStream ? a.sdims : a.dims;
  const int* const wid = kStream ? a.sdims + n + 1 : a.wid;
  const CUtensorMap* const mp = kStream ? a.smaps : maps.m;
  const int sl = a.L / cols, sh0 = dims[0] / cols, sdl = dims[n] / cols;
  float* vec_s = reinterpret_cast<float*>(base + L.vec);
  const float* vec = kStream ? a.svec + (size_t)c * L.vec_floats : vec_s;
  float* adds = reinterpret_cast<float*>(base + L.adds);
  float* xs_s = reinterpret_cast<float*>(base + L.xs);
  float* eps_s = reinterpret_cast<float*>(base + L.eps);
  float* skip_s = reinterpret_cast<float*>(base + L.skip);

  // the (rows, d) condition adds' row of cluster row r, or -1 past the batch
  auto add_row = [&](int r) {
    const int b = s0 + (a.guided && r >= S ? r - S : r);
    if (b >= a.B) return -1;
    return a.guided && r >= S ? a.B + b : b;
  };
  auto load = [&](float* dst, const float* src, int count) {
    for (int i = tid; i < count; i += 256) dst[i] = __ldg(src + i);
  };
  // the wide layout: this cluster's scratch, and the block's units of L
  [[maybe_unused]] uint8_t *op0 = nullptr, *op1 = nullptr;
  [[maybe_unused]] float *hrow = nullptr, *skipg = nullptr;
  [[maybe_unused]] int lu0 = 0, lu1 = 0;
  if constexpr (kWide) {
    const WideScratch ws(gridDim.y, N, S, a.L, dims[n], with_skip);
    const size_t y = blockIdx.y;
    op0 = a.scratch + ws.op0 + y * N * a.L * 2;
    op1 = a.scratch + ws.op1 + y * N * dims[n] * 2;
    hrow = reinterpret_cast<float*>(a.scratch + ws.hrow) + y * N * dims[n];
    skipg = reinterpret_cast<float*>(a.scratch + ws.skip) + y * S * a.L;
    lu0 = wide_u0(a.L, cols, c);
    lu1 = wide_u0(a.L, cols, c + 1);
  }

  if (!producer && kWide) {  // x_T into the output, which holds x all launch long
    const int w0 = 64 * lu0, ow = 64 * (lu1 - lu0);
    for (int i = tid; i < S * ow; i += 256) {
      const int r = i / ow, b = s0 + r, col = w0 + (i - r * ow);
      if (b < a.B && col < a.lat) a.out[(size_t)b * a.lat + col] = __ldg(a.x + (size_t)b * a.lat + col);
    }
  } else if (!producer && kStream) {  // x only: the vectors and adds stay in device memory
    for (int i = tid; i < S * sl; i += 256) {
      const int r = i / sl, b = s0 + r, col = c * sl + (i - r * sl);
      xs_s[i] = b < a.B && col < a.lat ? __ldg(a.x + (size_t)b * a.lat + col) : 0.f;
    }
  } else if (!producer) {
    if constexpr (kExact) {
      for (int i = tid; i < S * sl; i += 256) {
        const int r = i / sl, b = s0 + r;
        xs_s[i] = b < a.B ? __ldg(a.x + (size_t)b * a.L + c * sl + (i - r * sl)) : 0.f;
      }
      int off = 0;
      for (int st = 0; st <= n; ++st) {
        const int d = a.dims[st], sd = d / cols, q4 = sd / 4;
        const float* src = st < n ? a.adds[st] : a.adds_f;
        for (int i = tid; i < N * q4; i += 256) {
          const int r = i / q4, m = 4 * (i - r * q4), gr = add_row(r);
          const float4 v = gr >= 0 ? fd::ldg4(src + (size_t)gr * d + c * sd + m)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          fd::st4(adds + off + r * sd + m, v);
        }
        off += N * sd;
      }
    } else {  // padded: the request's tensors at their own widths, zeros past them
      for (int i = tid; i < S * sl; i += 256) {
        const int r = i / sl, b = s0 + r, col = c * sl + (i - r * sl);
        xs_s[i] = b < a.B && col < a.lat ? __ldg(a.x + (size_t)b * a.lat + col) : 0.f;
      }
      int off = 0;
      for (int st = 0; st <= n; ++st) {
        const int w = a.wid[st], sd = a.dims[st] / cols;
        const float* src = st < n ? a.adds[st] : a.adds_f;
        for (int i = tid; i < N * sd; i += 256) {
          const int r = i / sd, col = c * sd + (i - r * sd), gr = add_row(r);
          adds[off + i] = gr >= 0 && col < w ? __ldg(src + (size_t)gr * w + col) : 0.f;
        }
        off += N * sd;
      }
    }
    int vo = 0;
    load(vec_s, a.bl + c * sh0, sh0);
    vo += sh0;
    for (int st = 0; st < n; ++st) {
      const int sd = a.dims[st] / cols, so = a.dims[st + 1] / cols;
      for (int v = 0; v < 7; ++v, vo += sd) load(vec_s + vo, a.vec[st][v] + c * sd, sd);
      load(vec_s + vo, a.vec[st][7] + c * so, so);
      vo += so;
    }
    load(vec_s + vo, a.hg + c * sdl, sdl);
    load(vec_s + vo + sdl, a.hb + c * sdl, sdl);
    load(vec_s + vo + 2 * sdl, a.hbf + c * sl, sl);
  }
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) {
      fdh::mbar_init(k.full(s), 1);
      fdh::mbar_init(k.empty(s), 8);
    }
    for (int i = 0; i < kFree; ++i) fdh::mbar_init(k.xbar(i), 1);
    fdh::mbar_init(k.xbar(kFree), cols);
    if constexpr (kWide) {  // one arrival a block a phase: its columns published
      fdh::mbar_init(k.xbar(kReady0), cols);
      fdh::mbar_init(k.xbar(kReady1), cols);
    }
    fdh::fence_barrier_init();
  }
  __syncthreads();
  fdh::cluster_arrive();  // this block's barriers exist: the others may use them

  // the producer: every product's chunks, step after step, in the order the
  // consumers take them; chunk q into slot q % slots once chunk q - slots
  // has been released
  auto walk = [&](int lo, int hi) {
    int q = 0;
    for (int s = 0; s < a.T; ++s)
      for (int p = 0; p < 3 + 4 * n; ++p) {
        if (p == 1 && !with_skip) continue;
        int map, slice, K;
        product_shape(dims, n, a.L, cols, p, &map, &slice, &K);
        const int kb = chunk_tiles(slice, K), nk = K / 64 / kb;
        for (int kc = 0; kc < nk; ++kc, ++q) {
          if (q >= hi) return;
          if (q < lo) continue;
          if (q >= a.slots) fdh::mbar_wait(k.empty(q), (uint32_t)(((q - a.slots) / a.slots) & 1));
          fdh::mbar_expect_tx(k.full(q), (uint32_t)(kb * slice * 128));
          fdh::tma_load_3d(k.slot(q), mp + map, 0, c * slice, kc * kb, k.full(q));
        }
      }
  };
  // the wide layout's producer: the same stream, a wide product's chunks in
  // its passes, each chunk that reads an operand from the scratch issued
  // once every block has published it (the phase of its ready mbarrier)
  auto walk_wide = [&]() {
    int q = 0;
    uint32_t ready = 0;  // the parity of each ready mbarrier's next phase
    for (int s = 0; s < a.T; ++s)
      for (int p = 0; p < 3 + 4 * n; ++p) {
        if (p == 1 && !with_skip) continue;
        const WideShape w = wide_shape(dims, n, a.L, cols, N, MT, p);
        const uint8_t* src = nullptr;
        if (w.op >= 0) {
          if (p != 1) {  // the skip reads what the projection's wait found published
            wait_published(k.xbar(kReady0 + w.op), (ready >> w.op) & 1u);
            ready ^= 1u << w.op;
          }
          src = w.op == 0 ? op0 : op1;
        }
        const int nk = w.K / 64 / w.kb, u0 = w.W ? wide_u0(w.W, cols, c) : 0;
        const uint32_t wbytes = (uint32_t)(w.kb * w.lines * 128);
        const uint32_t obytes = src ? (uint32_t)(w.kb * N * 128) : 0u;
        for (int ps = 0; ps < w.passes; ++ps) {
          const int col = w.W ? 64 * (u0 + ps * MT) : c * w.lines;
          for (int kc = 0; kc < nk; ++kc, ++q) {
            if (q >= a.slots) fdh::mbar_wait(k.empty(q), (uint32_t)(((q - a.slots) / a.slots) & 1));
            fdh::mbar_expect_tx(k.full(q), wbytes + obytes);
            fdh::tma_load_3d(k.slot(q), mp + w.map, 0, col, kc * w.kb, k.full(q));
            if (src)
              bulk_load(k.slot(q) + wbytes, src + (size_t)kc * w.kb * N * 128, obytes, k.full(q));
          }
        }
      }
  };
  // (the wide layout issues nothing before the cluster meets: its first
  // chunk waits for the others' operand columns)
  const int first = kWide ? 0 : a.slots < a.off.total ? a.slots : a.off.total;
  if (producer && lane == 0) {  // the first chunks at once: only this block's barriers
    for (int i = 0; i < 2 + 4 * n && i < kMaxMaps; ++i) fdh::tma_prefetch(mp + i);
    if constexpr (!kWide) walk(0, first);
  }
  fdh::cluster_wait();
  FD_STAMP(1);
  if (producer) {
    if constexpr (kWide) {
      if (lane == 0) walk_wide();
    } else if (lane == 0) {
      walk(first, a.off.total);
    }
    __syncwarp();
    fdh::cluster_arrive();
    fdh::cluster_wait();
    return;
  }

  // f(u, i, m, r) over the thread's values within a slice of `slice`
  // columns (m local, r the cluster row)
  auto each = [&](int slice, auto&& f) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k.col(u, h) < slice) f(u, 4 * j + 2 * h + e, k.col(u, h), k.row(j, e));
  };
  const float2* mr = reinterpret_cast<const float2*>(base + L.mr);
  float xs[MT][N / 2], acc[MT][N / 2];
  uint32_t phases = 0;  // the parity of each exchange mbarrier's next phase
  auto parity = [&](int x) {
    const uint32_t p = (phases >> x) & 1u;
    phases ^= 1u << x;
    return p;
  };
  int q = 0;            // the next chunk of the stream
  int ops = 0;          // operand exchanges so far: buffer and mbarrier ops & 1
  bool read = false;    // a product read the operand buffer since the last exchange
  auto next_operand = [&]() {
    if (a.qbufs == 1 && read) k.buffer_free(kFree, parity(kFree));
    return k.qbuf(ops & 1);
  };
  auto send_operand = [&](uint8_t* qb, int sd) {
    const int x = kOp0 + (ops & 1);
    k.send(qb, sd, x, parity(x), true);
    ++ops;
    read = false;
  };
  auto moments = [&](const float(&v)[MT][N / 2], int which, int sd, int width) {
    k.template row_moments<kExact>(v, which, sd, width, kSt0 + which, a.eps,
                                   parity(kSt0 + which), true);
    read = false;
  };
  auto product = [&](int p, const uint8_t* qb, const float* bias, float(&out)[MT][N / 2]) {
    int map, slice, K;
    product_shape(dims, n, a.L, cols, p, &map, &slice, &K);
    const int kb = chunk_tiles(slice, K), nk = K / 64 / kb;
    k.product(q, nk, kb, slice, qb, bias, out, p < 2 ? p : p < 2 + 4 * n ? 2 + (p - 2) % 4 : 6);
    q += nk;
    read = true;
  };
  const float gate = with_skip ? 1.f / (1.f + expf(-__ldg(a.rw))) : 0.f;
  const int hoff = sh0 + [&] {
    int v = 0;
    for (int st = 0; st < n; ++st) v += (7 * dims[st] + dims[st + 1]) / cols;
    return v;
  }();

  // The wide layout's phases. publish: this block's columns of an operand
  // in the scratch, written by its consumers, made visible to every block's
  // producer (a cluster-scope release on its ready mbarrier x).
  auto publish = [&](int x) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __threadfence();
    k.sync_all();
    if (tid == 0)
      for (int j = 0; j < cols; ++j) arrive_release(fdh::mapa(k.xbar(x), j));
  };
  // bf16 of 8 floats, in column order, as one 16-byte unit
  auto pack8 = [](const float (&v)[8]) {
    uint4 out;
    uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return out;
  };
  // the pass ps of product p on the wide layout, its chunks next in the
  // stream: *col0 its first column, *real its columns (none past the
  // block's units of a wide output); returns the product's passes
  auto product_w = [&](int p, int ps, const uint8_t* qb, const float* bias, float(&out)[MT][N / 2],
                       int* col0, int* real) {
    const WideShape w = wide_shape(dims, n, a.L, cols, N, MT, p);
    *col0 = 0;
    *real = w.lines;
    if (w.W) {
      const int u0 = wide_u0(w.W, cols, c) + ps * MT, u1 = wide_u0(w.W, cols, c + 1);
      *col0 = 64 * u0;
      *real = 64 * (u1 - u0 < 0 ? 0 : u1 - u0 < MT ? u1 - u0 : MT);
    }
    const int nk = w.K / 64 / w.kb;
    wide_mma(k, q, nk, w.kb, w.lines, *real, qb, bias + *col0, out);
    q += nk;
    return w.passes;
  };
  // the LayerNorm statistics of the head's pre-LN rows (device memory) over
  // their `width` true columns: each block's (mean, m2) over its units,
  // exchanged through stats[0] and combined in rank order as row_moments'
  auto wide_moments = [&](int W, int width) {
    float2* stats = reinterpret_cast<float2*>(base + L.stats);
    float2* mrw = reinterpret_cast<float2*>(base + L.mr);
    if (tid == 0) fdh::mbar_expect_tx(k.xbar(kSt0), (uint32_t)((cols - 1) * N * 8));
    auto owned = [&](int j) {
      const int lo = 64 * wide_u0(W, cols, j), hi = 64 * wide_u0(W, cols, j + 1);
      return (hi < width ? hi : width) - lo > 0 ? (hi < width ? hi : width) - lo : 0;
    };
    const int lo = 64 * wide_u0(W, cols, c), own = owned(c), warp = tid >> 5;
    for (int r = warp; r < N; r += 8) {
      const float* row = hrow + (size_t)r * W + lo;
      float sum = 0.f;
      for (int m = lane; m < own; m += 32) sum += row[m];
      sum = fd::warp_sum(sum);
      const float mean = own > 0 ? sum / own : 0.f;
      float m2 = 0.f;
      for (int m = lane; m < own; m += 32) m2 += (row[m] - mean) * (row[m] - mean);
      m2 = fd::warp_sum(m2);
      if (lane < cols) {
        const float2 st = make_float2(mean, m2);
        float2* dst = stats + c * N + r;
        if (lane == c) *dst = st;
        else fdh::st_async(fdh::mapa(fdh::smem_u32(dst), lane), st, fdh::mapa(k.xbar(kSt0), lane));
      }
    }
    k.sync_all();
    const uint32_t par = parity(kSt0);
    if (tid < N) {
      fdh::mbar_wait(k.xbar(kSt0), par);
      const float2* st = stats + tid;
      float m = 0.f, m2 = 0.f;
      for (int j = 0; j < cols; ++j) m += owned(j) * st[j * N].x;
      m /= width;
      for (int j = 0; j < cols; ++j) {
        const float2 sj = st[j * N];
        const float e = sj.x - m;
        m2 += sj.y + owned(j) * e * e;
      }
      mrw[tid] = make_float2(m, rsqrtf(m2 / width + a.eps));
    }
    k.sync_all();
    read = false;  // every block sent after its last read of the operand buffer
  };

  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    FD_STAMP_STEP(s == a.T / 2);
    FD_STEP_STAMP(2);
    if constexpr (kWide) {
      // the projection's and the skip's operand: bf16(x) of the block's
      // columns, a sample's row in both halves when guided, into the
      // scratch; then the projection (a narrow output) and the skip's passes
      const int w0 = 64 * lu0, ow8 = 8 * (lu1 - lu0);
      for (int i = tid; i < N * ow8; i += 256) {
        const int r = i / ow8, col = w0 + 8 * (i - r * ow8), b = s0 + (r < S ? r : r - S);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = b < a.B && col + e < a.lat ? a.out[(size_t)b * a.lat + col + e] : 0.f;
        *reinterpret_cast<uint4*>(op0 + wide_swz(r, col, N)) = pack8(v);
      }
      publish(kReady0);
      int col0, real;
      product_w(0, 0, nullptr, vec, xs, &col0, &real);
      for (int ps = 0, passes = 1; with_skip && ps < passes; ++ps) {
        k.sync_all();  // both warpgroups done with the partial sums
        passes = product_w(1, ps, nullptr, a.hbf, acc, &col0, &real);
        if (k.lead)
          each(real, [&](int u, int i, int m, int r) {
            if (r < S) skipg[(size_t)r * a.L + col0 + m] = gate * acc[u][i];
          });
      }
    } else {
      // the projection's operand: bf16(x), a sample's row in both halves when guided
      uint8_t* qb = next_operand();
      for (int i = tid; i < N * sl; i += 256) {
        const int r = i / sl, m = i - r * sl;
        const float v = xs_s[(r < S ? r : r - S) * sl + m];
        *reinterpret_cast<__nv_bfloat16*>(qb + fdc::swz(r, c * sl + m, N)) =
            __float2bfloat16_rn(v);
      }
      send_operand(qb, sl);
      FD_STEP_STAMP(3);
      product(0, qb, vec, xs);
      if (with_skip) {
        k.sync_all();  // both warpgroups done with the partial sums
        product(1, qb, vec + hoff + 2 * sdl, acc);
        if (k.lead) each(sl, [&](int u, int i, int m, int r) { skip_s[r * sl + m] = gate * acc[u][i]; });
      }
      FD_STEP_STAMP(4);
    }
    // the stages
    int voff = sh0, aoff = 0;
    for (int st = 0; st < n; ++st) {
      const int d = dims[st], sd = d / cols, so = dims[st + 1] / cols;
      const float* tadd = (kStream ? a.stadd[st] : a.tadd[st]) + (size_t)t * d + c * sd;
      const float* add = adds + aoff;
      const float* sv = vec + voff;
      if constexpr (kStream) {  // the request's rows, where they are added
        const float* src = a.sadds[st];
        const int w = wid[st];
        each(sd, [&](int u, int i, int m, int r) {
          const int gr = add_row(r), col = c * sd + m;
          xs[u][i] = (xs[u][i] + __ldg(tadd + m)) +
                     (gr >= 0 && col < w ? __ldg(src + (size_t)gr * w + col) : 0.f);
          acc[u][i] = xs[u][i];
        });
      } else {
        each(sd, [&](int u, int i, int m, int r) {
          xs[u][i] = (xs[u][i] + __ldg(tadd + m)) + add[r * sd + m];
          acc[u][i] = xs[u][i];
        });
      }
      for (int p = 0; p < 4; ++p) {
        uint8_t* qb = next_operand();
        k.write_own(acc, qb, sd);
        send_operand(qb, sd);
        FD_STEP_STAMP(5 + 10 * st + (p == 0 ? 0 : 2 + 2 * p));
        if constexpr (!kWide) {
          product(2 + 4 * st + p, qb, sv + (p == 0 ? 0 : (4 + p) * sd), acc);
        } else if (st == n - 1 && p == 3) {
          // the last Wd (a wide output) in passes, each into the head's
          // pre-LN rows with the head's time and condition adds
          const float* tadd_f = a.tadd_f + (size_t)t * dims[n];
          const int wn = wid[n];
          for (int ps = 0, passes = 1; ps < passes; ++ps) {
            if (ps) k.sync_all();  // both warpgroups done with the partial sums
            int col0, real;
            passes = product_w(2 + 4 * st + p, ps, qb, a.bd_last, acc, &col0, &real);
            if (k.lead)
              each(real, [&](int u, int i, int m, int r) {
                const int gr = add_row(r), col = col0 + m;
                hrow[(size_t)r * dims[n] + col] =
                    (acc[u][i] + __ldg(tadd_f + col)) +
                    (gr >= 0 && col < wn ? __ldg(a.adds_f + (size_t)gr * wn + col) : 0.f);
              });
          }
          read = true;
        } else {
          product(2 + 4 * st + p, qb, sv + (p == 0 ? 0 : (4 + p) * sd), acc);
        }
        FD_STEP_STAMP(5 + 10 * st + (p == 0 ? 1 : 3 + 2 * p));
        if (p == 0) {
          for (int ln = 0; ln < 2; ++ln) {
            moments(acc, ln, sd, wid[st]);
            FD_STEP_STAMP(5 + 10 * st + 2 + ln);
            each(sd, [&](int u, int i, int m, int r) {
              const float2 ms = mr[r];
              const float x = (acc[u][i] - ms.x) * ms.y * sv[(1 + 2 * ln) * sd + m] +
                              sv[(2 + 2 * ln) * sd + m];
              if (ln == 0) {
                xs[u][i] += swish(x);
                acc[u][i] = xs[u][i];
              } else {
                acc[u][i] = x;
              }
            });
          }
        } else if (p == 2) {
          each(sd, [&](int u, int i, int, int) {
            xs[u][i] += acc[u][i];
            acc[u][i] = xs[u][i];
          });
        }
      }
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) xs[u][i] = acc[u][i];
      voff += 7 * sd + so;
      aoff += N * sd;
    }
    if constexpr (kWide) {
      // the head: its LayerNorm over the pre-LN rows, its operand into the
      // scratch, then its passes, each followed by the reverse step of its
      // columns (x in the output; a Philox group an element)
      const int dl = dims[n];
      k.sync_all();  // the pre-LN rows written
      wide_moments(dl, wid[n]);
      FD_STEP_STAMP(5 + 10 * n);
      {
        const int hu0 = wide_u0(dl, cols, c), ow8 = 8 * (wide_u0(dl, cols, c + 1) - hu0);
        const float2* mrw = reinterpret_cast<const float2*>(base + L.mr);
        for (int i = tid; i < N * ow8; i += 256) {
          const int r = i / ow8, col = 64 * hu0 + 8 * (i - r * ow8);
          const float2 ms = mrw[r];
          const float* src = hrow + (size_t)r * dl + col;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (src[e] - ms.x) * ms.y * __ldg(a.hg + col + e) + __ldg(a.hb + col + e);
          *reinterpret_cast<uint4*>(op1 + wide_swz(r, col, N)) = pack8(v);
        }
      }
      publish(kReady1);
      FD_STEP_STAMP(6 + 10 * n);
      const float at = __ldg(a.coefs + 3 * t), abt = __ldg(a.coefs + 3 * t + 1),
                  bt = __ldg(a.coefs + 3 * t + 2);
      const bool noisy = a.stochastic && t > 0;
      const int tw = 64 * MT;
      for (int ps = 0, passes = 1; ps < passes; ++ps) {
        int col0, real;
        passes = product_w(2 + 4 * n, ps, nullptr, a.hbf, acc, &col0, &real);
        if (k.lead) each(real, [&](int u, int i, int m, int r) { eps_s[r * tw + m] = acc[u][i]; });
        k.sync_all();
        for (int i = tid; i < S * real; i += 256) {
          const int r = i / real, m = i - r * real, b = s0 + r, col = col0 + m;
          if (b >= a.B || col >= a.lat) continue;
          const size_t at0 = (size_t)b * a.lat + col;
          a.out[at0] = fd::step_mean(
              a.out[at0], eps_s[r * tw + m], a.guided ? eps_s[(r + S) * tw + m] : 0.f,
              with_skip ? skipg[(size_t)r * a.L + col] : 0.f, a.guided != 0, a.scale, a.clip != 0,
              a.clip_val, at, abt, bt, noisy, noisy ? fd::element_noise(at0, t, a.key) : 0.f);
        }
        k.sync_all();
      }
      FD_STEP_STAMP(8 + 10 * n);
      FD_STAMP_STEP(false);
      continue;
    }
    // the head: eps = bf16(LN(h + tadd_f[t] + cond_f)) Wf^T + bf
    {
      const int dl = dims[n];
      const float* tadd = a.tadd_f + (size_t)t * dl + c * sdl;
      const float* add = adds + aoff;
      const float* hv = vec + hoff;
      if constexpr (kStream) {
        const int w = wid[n];
        each(sdl, [&](int u, int i, int m, int r) {
          const int gr = add_row(r), col = c * sdl + m;
          xs[u][i] = (xs[u][i] + __ldg(tadd + m)) +
                     (gr >= 0 && col < w ? __ldg(a.adds_f + (size_t)gr * w + col) : 0.f);
        });
      } else {
        each(sdl, [&](int u, int i, int m, int r) {
          xs[u][i] = (xs[u][i] + __ldg(tadd + m)) + add[r * sdl + m];
        });
      }
      moments(xs, 0, sdl, wid[n]);
      FD_STEP_STAMP(5 + 10 * n);
      each(sdl, [&](int u, int i, int m, int r) {
        const float2 ms = mr[r];
        acc[u][i] = (xs[u][i] - ms.x) * ms.y * hv[m] + hv[sdl + m];
      });
      uint8_t* qb = next_operand();
      k.write_own(acc, qb, sdl);
      send_operand(qb, sdl);
      FD_STEP_STAMP(6 + 10 * n);
      product(2 + 4 * n, qb, hv + 2 * sdl, acc);
      FD_STEP_STAMP(7 + 10 * n);
    }
    // the reverse step on the block's columns of its samples
    if (k.lead) each(sl, [&](int u, int i, int m, int r) { eps_s[r * sl + m] = acc[u][i]; });
    k.sync_all();
    {
      const float at = __ldg(a.coefs + 3 * t), abt = __ldg(a.coefs + 3 * t + 1),
                  bt = __ldg(a.coefs + 3 * t + 2);
      const bool noisy = a.stochastic && t > 0;
      if constexpr (kExact) {  // whole Philox groups of 4 in each slice
        const int groups = sl / 4;
        for (int i = tid; i < S * groups; i += 256) {
          const int r = i / groups, m0 = 4 * (i - r * groups), b = s0 + r;
          if (b >= a.B) continue;
          float z[4] = {0.f, 0.f, 0.f, 0.f};
          if (noisy)
            fd::step_noise((uint32_t)(((size_t)b * a.L + c * sl + m0) / 4), t, a.key, z);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + j;
            const float v = fd::step_mean(
                xs_s[r * sl + m], eps_s[r * sl + m], a.guided ? eps_s[(r + S) * sl + m] : 0.f,
                with_skip ? skip_s[r * sl + m] : 0.f, a.guided != 0, a.scale, a.clip != 0,
                a.clip_val, at, abt, bt, noisy, z[j]);
            xs_s[r * sl + m] = v;
            if (t == 0) a.out[(size_t)b * a.L + c * sl + m] = v;
          }
        }
      } else {  // padded: the true columns only (padding keeps x = 0), a draw each
        for (int i = tid; i < S * sl; i += 256) {
          const int r = i / sl, m = i - r * sl, b = s0 + r, col = c * sl + m;
          if (b >= a.B || col >= a.lat) continue;
          const size_t at0 = (size_t)b * a.lat + col;
          const float v = fd::step_mean(
              xs_s[r * sl + m], eps_s[r * sl + m], a.guided ? eps_s[(r + S) * sl + m] : 0.f,
              with_skip ? skip_s[r * sl + m] : 0.f, a.guided != 0, a.scale, a.clip != 0,
              a.clip_val, at, abt, bt, noisy, noisy ? fd::element_noise(at0, t, a.key) : 0.f);
          xs_s[r * sl + m] = v;
          if (t == 0) a.out[at0] = v;
        }
      }
    }
    k.sync_all();
    FD_STEP_STAMP(8 + 10 * n);
    FD_STAMP_STEP(false);
  }
  FD_STAMP(63);
  fdh::cluster_arrive();  // nothing more comes into this block from the others
  fdh::cluster_wait();    // and no block leaves while another may still write to it
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, size_t* configured, bool* nonportable) {
  if (!*nonportable) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *nonportable = true;
  }
  if (smem <= 48 * 1024 || smem <= *configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = smem;
  return err;
}

// The instance <N, MT, kExact, kStream, kWide>, its attributes set for
// `smem` bytes (once an instance).
template <int N, int MT, bool kExact, bool kStream = false, bool kWide = false>
cudaError_t pick(size_t smem, const void** kernel) {
  static size_t configured = 0;
  static bool nonportable = false;
  *kernel = (const void*)process_kernel<N, MT, kExact, kStream, kWide>;
  return prepare(process_kernel<N, MT, kExact, kStream, kWide>, smem, &configured, &nonportable);
}

// The kernel's instance for `rows` rows a cluster, slices of up to `units`
// m64 tiles (2, or 4 at 8 and 16 rows) and, where `exact` (no width
// padded) at 2 units, the instance with no padded case; `streamed`: the
// streamed layout's instances; `wide`: the wide layout's (max_units(rows)).
cudaError_t instance(int rows, int units, bool exact, bool streamed, bool wide, size_t smem,
                     const void** kernel) {
  if (wide) {
    if (rows == 8) return pick<8, 4, false, true, true>(smem, kernel);
    if (rows == 16) return pick<16, 4, false, true, true>(smem, kernel);
    if (rows == 32) return pick<32, 2, false, true, true>(smem, kernel);
  } else if (streamed) {
    if (units <= 2 && rows == 8) return pick<8, 2, false, true>(smem, kernel);
    if (units <= 2 && rows == 16) return pick<16, 2, false, true>(smem, kernel);
    if (units <= 2 && rows == 32) return pick<32, 2, false, true>(smem, kernel);
    if (units <= 4 && rows == 8) return pick<8, 4, false, true>(smem, kernel);
    if (units <= 4 && rows == 16) return pick<16, 4, false, true>(smem, kernel);
  } else if (units <= 2 && exact) {
    if (rows == 8) return pick<8, 2, true>(smem, kernel);
    if (rows == 16) return pick<16, 2, true>(smem, kernel);
    if (rows == 32) return pick<32, 2, true>(smem, kernel);
  } else if (units <= 2) {
    if (rows == 8) return pick<8, 2, false>(smem, kernel);
    if (rows == 16) return pick<16, 2, false>(smem, kernel);
    if (rows == 32) return pick<32, 2, false>(smem, kernel);
  } else if (units <= 4) {
    if (rows == 8) return pick<8, 4, false>(smem, kernel);
    if (rows == 16) return pick<16, 4, false>(smem, kernel);
  }
  return cudaErrorInvalidValue;
}

// Whether `pad` is the padded width the kernel tiles `width` with at `cols`
// blocks a cluster (kernels/full_sampler.py::process_width); `wide`: a wide
// vector's (a multiple of 64, up to kMaxWide).
bool padded_ok(int width, int pad, int cols, bool wide = false) {
  const int unit = wide ? 64 : 8 * cols > 64 ? 8 * cols : 64;
  return width >= 1 && width <= (wide ? kMaxWide : kMaxDim) && pad >= width && pad - width < unit &&
         pad % unit == 0;
}

// The widths and the plan's fields, checked against what the kernel
// assumes (kernels/full_sampler.py::process_plan makes them).
bool plan_ok(const int* dims, const int* wid, int n, int L, int lat, bool with_skip, int B,
             int T, int guided, int clusters, int cols, int rows, int qbufs, int slots, int smem,
             bool streamed, bool wide) {
  if (n < 1 || n > (streamed ? kMaxStreamStages : kMaxStages) || B < 1 || T < 1 || cols < 1 ||
      cols > kMaxCluster || (cols & (cols - 1)) || (wide && !streamed))
    return false;
  if (!padded_ok(lat, L, cols, wide)) return false;
  for (int i = 0; i <= n; ++i)
    if (!padded_ok(wid[i], dims[i], cols, wide && i == n)) return false;
  // the wide layout: every narrow slice within the instance's units
  for (int i = 0; wide && i < n; ++i)
    if (dims[i] / cols > 64 * max_units(rows)) return false;
  if (with_skip && (wid[n] != lat || dims[n] != L)) return false;
  if (rows != 8 && rows != 16 && rows != 32) return false;
  const int samples = guided ? rows / 2 : rows;
  if (clusters < 1 || (long long)clusters * samples < B) return false;
  if (qbufs < 1 || qbufs > 2 || slots < 2 || slots > kMaxSlots) return false;
  const ProcessLayout Lay(dims, n, L, with_skip, cols, rows, qbufs, slots, streamed, wide);
  // the launch's chunk count (every chunk of every step) is an int
  return Lay.units <= max_units(rows) && smem >= 1024 + Lay.total && smem <= 232448 &&
         (long long)Lay.chunks * T < (1LL << 31);
}

}  // namespace

// The tensor maps of a bound sampler (bf16 (out, in) as 3-D, boxes of a
// chunk: the rows of one column slice of `cols` by chunk_tiles k64 tiles),
// in stream order of their products: weights[0] Wl, then Wb, Wv, Wo, Wd of
// each stage, then the head's Wf (the skip's too). Encoded into `maps`
// (2 + 4 n CUtensorMap, 64-byte aligned), once, when the plan is bound.
// rows: 0 for the narrow layouts; the wide layout's rows a cluster, whose
// boxes are its chunks' (wide_shape).
extern "C" int fd_process_maps(const void* const* weights, const int* dims, int n, int L,
                               int cols, int rows, void* maps) {
  if (n < 1 || n > kMaxStreamStages || cols < 1 || (uintptr_t)maps % 64 ||
      (rows && rows != 8 && rows != 16 && rows != 32))
    return (int)cudaErrorInvalidValue;
  CUtensorMap* m = static_cast<CUtensorMap*>(maps);
  for (int i = 0; i < 2 + 4 * n; ++i) {
    // the product whose map this is: 0 the projection, 2 + 4 s + j a stage's, the head last
    const int p = i == 0 ? 0 : i < 1 + 4 * n ? i + 1 : 2 + 4 * n;
    int map, slice, K, kb;
    if (rows) {
      const WideShape w = wide_shape(dims, n, L, cols, rows, max_units(rows), p);
      map = w.map, slice = w.lines, K = w.K, kb = w.kb;
    } else {
      product_shape(dims, n, L, cols, p, &map, &slice, &K);
      kb = chunk_tiles(slice, K);
    }
    const int out = map == 0 ? dims[0] : map == 1 + 4 * n ? L
                    : (map - 1) % 4 == 3 ? dims[(map - 1) / 4 + 1] : dims[(map - 1) / 4];
    if (K % cols || slice < 8 || !fdh::wg_map_bf16(&m[i], weights[i], out, K, K, slice, kb))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Calls of cuTensorMapEncodeTiled by this library so far.
extern "C" long long fd_process_map_encodes() { return fdh::map_encodes(); }

// Clusters of `cols` blocks of `smem` bytes at `rows` rows a cluster that the
// card runs at once (cudaOccupancyMaxActiveClusters), into *out. Asked of
// the exact 2-unit instance: every instance runs one block an SM.
extern "C" int fd_process_max_clusters(int rows, int cols, int smem, int* out) {
  const void* kernel = nullptr;
  cudaError_t err = instance(rows, 2, true, false, false, (size_t)smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols, 1);
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cols;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// One launch: all T steps of a bucket call. ptrs: x, out, key, coefs, bl,
// rw (null: no skip), tadd_f, adds_f, hg, hb, hbf, then resident: per stage
// tadd, adds, bb, g1, b1, g2, b2, bv, bo, bd; streamed: the device tables
// smaps (2 + 4 n tensor maps), sdims (dims then wid, int32), stadd (n
// pointers), svec ((cols, vec_floats) f32), sadds (the n stages' condition
// adds: a table of this launch's own, written on `stream` ahead of it, so
// that launches on other streams cannot overwrite what it reads); wide,
// then bd_last (the last stage's bd, dims[n]) and the scratch
// (WideScratch's bytes, the launch's own). ints: n, B, L, T, guided, clip,
// stochastic, clusters, cols, rows, qbufs, slots, smem, dims[0..n] (padded,
// the widths the weights were padded to), lat, wid[0..n] (the model's
// widths: x, out and the condition rows have these), streamed, wide. floats:
// scale, clip_val, eps. `maps`: the resident launch's 2 + 4 n tensor maps
// (host memory, copied into the parameters); streamed, unused. A plan the
// kernel cannot run returns cudaErrorInvalidValue, and a launch the card
// refuses returns its error.
extern "C" int fd_process_launch(const void* maps, const void* const* ptrs, const int* ints,
                                 const float* floats, void* stream) {
  static const Maps kNoMaps = {};
  ProcessArgs a = {};
  a.n = ints[0];
  if (a.n < 1 || a.n > kMaxStreamStages) return (int)cudaErrorInvalidValue;
  const int* dims = ints + 13;
  const int* wid = ints + 15 + a.n;
  const bool streamed = ints[16 + 2 * a.n] != 0, wide = ints[17 + 2 * a.n] != 0;
  if (!streamed && (!maps || a.n > kMaxStages)) return (int)cudaErrorInvalidValue;
  a.x = (const float*)ptrs[0];
  a.out = (float*)ptrs[1];
  a.key = (const uint32_t*)ptrs[2];
  a.coefs = (const float*)ptrs[3];
  a.bl = (const float*)ptrs[4];
  a.rw = (const float*)ptrs[5];
  a.tadd_f = (const float*)ptrs[6];
  a.adds_f = (const float*)ptrs[7];
  a.hg = (const float*)ptrs[8];
  a.hb = (const float*)ptrs[9];
  a.hbf = (const float*)ptrs[10];
  if (streamed) {
    a.smaps = (const CUtensorMap*)ptrs[11];
    a.sdims = (const int*)ptrs[12];
    a.stadd = (const float* const*)ptrs[13];
    a.svec = (const float*)ptrs[14];
    a.sadds = (const float* const*)ptrs[15];
    if (!a.smaps || (uintptr_t)a.smaps % 64 || !a.sdims || !a.stadd || !a.svec || !a.sadds)
      return (int)cudaErrorInvalidValue;
    if (wide) {
      a.bd_last = (const float*)ptrs[16];
      a.scratch = (uint8_t*)ptrs[17];
      if (!a.bd_last || !a.scratch || (uintptr_t)a.scratch % 16) return (int)cudaErrorInvalidValue;
    }
  } else {
    for (int i = 0; i < a.n; ++i) {
      a.tadd[i] = (const float*)ptrs[11 + 10 * i];
      a.adds[i] = (const float*)ptrs[12 + 10 * i];
      for (int v = 0; v < 8; ++v) a.vec[i][v] = (const float*)ptrs[13 + 10 * i + v];
    }
    for (int i = 0; i <= a.n; ++i) {
      a.dims[i] = dims[i];
      a.wid[i] = wid[i];
    }
  }
  a.B = ints[1];
  a.L = ints[2];
  a.T = ints[3];
  a.guided = ints[4];
  a.clip = ints[5];
  a.stochastic = ints[6];
  const int clusters = ints[7];
  a.cols = ints[8];
  a.rows = ints[9];
  a.qbufs = ints[10];
  a.slots = ints[11];
  const int smem = ints[12];
  a.lat = ints[14 + a.n];
  a.scale = floats[0];
  a.clip_val = floats[1];
  a.eps = floats[2];
  if (!plan_ok(dims, wid, a.n, a.L, a.lat, a.rw != nullptr, a.B, a.T, a.guided, clusters,
               a.cols, a.rows, a.qbufs, a.slots, smem, streamed, wide))
    return (int)cudaErrorInvalidValue;
  a.lay = ProcessLayout(dims, a.n, a.L, a.rw != nullptr, a.cols, a.rows, a.qbufs, a.slots,
                        streamed, wide);
  a.sh = {a.rows, a.cols, a.slots, a.qbufs};
  a.off = {a.lay.slot_bytes, a.lay.q,    a.lay.q_bytes, a.lay.stats, a.lay.red,
           a.lay.mr,         a.lay.part, a.lay.units,   a.lay.bars,  a.lay.chunks * a.T};
  const void* kernel = nullptr;
  bool exact = a.lat == a.L;
  for (int i = 0; i <= a.n; ++i) exact = exact && wid[i] == dims[i];
  cudaError_t err = instance(a.rows, a.lay.units, exact, streamed, wide, (size_t)smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cols, clusters);
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cols;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<void*>(streamed ? (const void*)&kNoMaps : maps), (void*)&a};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
