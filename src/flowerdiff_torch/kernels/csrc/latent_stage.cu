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
// VMEM; here the rows of a launch sit in one cluster.
//
// Stage design (the plan: kernels/latent_stage.py::stage_plan; the phases,
// shared with the reverse-process kernel, in cluster_stage.cuh). A launch
// is `tiles` clusters along the rows, each of `cols` blocks that share
// `rows` rows: column slice c owns the columns [c sd, (c + 1) sd) of h and of
// each d-wide product, sd = d / cols, and [c so, (c + 1) so) of the last,
// so = d_out / cols. The products are warpgroup MMAs with the weight as the
// A operand: D^T = W X^T, M = 64 of the block's output columns a tile, N =
// the block's rows, K-major on both sides, so neither the weight nor the
// activations are transposed. The two consumer warpgroups split each
// product's k64 tiles and add each other's sums (a wgmma of so few rows
// costs ~60-70 ns whatever N: PERF.md section 6). The block's slice of h
// lives in the consumer threads' registers in the accumulators' layout all
// launch long.
//
// Weights: a producer warp streams the block's chunks (kb k64 tiles of its
// column slice of one product, one TMA box of up to 32 KB through the 3-D
// tensor map encoded when the stage was bound, 128-byte swizzled: a
// block's TMA requests run one after another, ~0.37 us each, so the boxes
// are as large as they may be) through a ring of `slots` shared-memory
// slots, the fixed sequence Wb, Wv, Wo, Wd known in advance, so it runs
// ahead across the exchanges. A slot is refilled once the 8 consumer warps
// have released it. Each cluster reads the weights once; more clusters of
// fewer rows cost less than one that holds them all (the measurements
// behind the plan's cost model: PERF.md section 6).
//
// Exchanges: what the next step needs from the other blocks of a cluster
// (the next product's bf16 operand, whole rows; a LayerNorm's per-block row
// statistics) goes to them as st.async stores that complete on the
// receiver's mbarrier, one mbarrier an exchange, used once a launch: no
// cluster barrier between phases. An operand buffer is rewritten only once
// every block has finished reading it: where two buffers fit, the exchanges
// that must come before already say so; with one, the readers of the Wv and
// Wo products each arrive on a `free` mbarrier of every block first.
// LayerNorm statistics are each block's (mean, m2) of its slice of a row,
// combined in rank order (Chan et al.), so every block gets the same numbers.
// No atomics: repeated launches are bit-equal.
//
// A wide d_out (a block's slice of Wd's rows past the m64 tiles its
// accumulators hold: past 4096 at 16 blocks) runs Wd in column passes of
// `pw` rows (StageLayout), each pass's chunks in the stream after the last,
// its bias staged and its columns stored before the next, in instances of
// their own (kWide). d keeps its bound of 4096 (16 slices of 256), above the
// ~3852 the JAX kernel's 100 MiB of VMEM holds at T = 1000.
//
// Head design (the form with the t_base / c_base products, which are added
// to whole rows before the LayerNorm): one block owns 16 whole rows and all
// columns. Its weights and vectors are padded with zeros at bind (dl, de to
// multiples of 32, the latent to one of 8), its activations read at their
// own widths. The pre-LN rows go to device memory (the caller's, 16 rows a
// block, read back only by the block that wrote them), so no width is
// bounded by shared memory: kept whole in shared memory, f32, they bound
// every width at 2048; kept in bf16 they would bound it at twice that, and
// the LayerNorm would read rounded values. Each
// product runs column blocks of 512, K in passes of 2048 whose bf16 operand
// is loaded (a base's) or normalised (LN(h)'s) into shared memory per pass,
// the statistics in a pass of their own over the row before the output's.
// The sampler's form, with its adds from tables, runs on
// csrc/latent_head.cu's column tiles.
#include "cluster_stage.cuh"

using fd::kPad;
using fd::kRows;
using fd::kThreads;
using fdc::chunk_reach;
using fdc::chunk_tiles;
using fdc::kMaxCluster;
using fdc::kMaxSlots;
using fdc::kStageThreads;
using fdc::swish;

namespace {

constexpr int kBarriers = 8;        // the exchanges' mbarriers: X0-X5, free after Wv, Wo

// Shared memory of a stage block, in bytes from a 1024-byte-aligned base:
// the ring (slots of one chunk: kb tiles of slice lines of 128 bytes), the
// operand buffers (rows x d bf16, k64 chunks of rows lines of 128 bytes,
// swizzled), the two LayerNorms' statistics (cols x rows float2), the row
// sums, (mean, rstd) a row, the block's slices of the biases and LayerNorm
// affines (bb g1 b1 g2 b2 bv bo, sd each, then bd, so), the warpgroups'
// partial sums (each thread's accumulators of each m64 tile, for both), the
// mbarriers, and padding where the last slot's reads would reach past the
// end. kernels/latent_stage.py::_stage_smem computes the same.
struct StageLayout {
  int sd, so, pw, npass, kbd, kbo, units, slot_bytes, q, q_bytes, stats, red, mr, vec, part, bars,
      total;
  __host__ __device__ StageLayout(int d, int dout, int cols, int rows, int qbufs, int slots,
                                  bool wide = false) {
    sd = d / cols;
    so = dout / cols;
    // Wd's rows a pass: the slice, or (wide) the m64 tiles the accumulators
    // hold at `rows` (stage_units)
    const int most = 64 * (rows == 128 ? 1 : rows == 64 ? 2 : 4);
    pw = wide && so > most ? most : so;
    npass = (so + pw - 1) / pw;
    kbd = chunk_tiles(sd, d);
    kbo = chunk_tiles(pw, d);
    slot_bytes = (kbd * sd > kbo * pw ? kbd * sd : kbo * pw) * 128;
    q = slots * slot_bytes;
    q_bytes = rows * d * 2;
    stats = q + qbufs * q_bytes;
    red = stats + 2 * cols * rows * 8;
    mr = red + 2 * 2 * 4 * rows * 4;  // row sums: [pass][warpgroup][warp][row]
    vec = mr + rows * 8;
    part = vec + ((7 * sd + pw) * 4 + 15) / 16 * 16;
    units = ((sd > pw ? sd : pw) + 63) / 64;
    bars = part + 2 * 128 * units * (rows / 2) * 4;
    total = bars + (2 * slots + kBarriers) * 8;
    const int reach = chunk_reach(sd, kbd) > chunk_reach(pw, kbo) ? chunk_reach(sd, kbd)
                                                                  : chunk_reach(pw, kbo);
    const int over = reach - slot_bytes - (total - q);
    if (over > 0) total += over;
  }
};

struct StageArgs {
  const float *h, *row_add, *rows_add, *bb, *g1, *b1, *g2, *b2, *bv, *bo, *bd;
  float* out;
  int B, d, dout;      // the padded widths the weights and vectors have
  int width, width_out;  // the stage's widths: h, the adds and out have these
  fdc::Shape sh;  // rows a block, blocks a cluster, ring slots, operand buffers
  float eps;
};

template <int N, int MT, bool kWide = false>
__global__ void __launch_bounds__(kStageThreads, 1)
stage_kernel(const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_o, const __grid_constant__ CUtensorMap map_d,
             const __grid_constant__ StageArgs a) {
  FD_STAMP_BEGIN;
  FD_STAMP(0);
  extern __shared__ uint8_t stage_raw[];
  const uint32_t raw = fdh::smem_u32(stage_raw);
  uint8_t* base = stage_raw + (((raw + 1023u) & ~1023u) - raw);
  const StageLayout L(a.d, a.dout, a.sh.cols, a.sh.rows, a.sh.qbufs, a.sh.slots, kWide);
  const int sd = L.sd, so = L.so, nkd = a.d / 64 / L.kbd, nko = a.d / 64 / L.kbo;
  // kWide: Wd's chunks in L.npass passes of pw rows
  const int total = 3 * nkd + (kWide ? L.npass : 1) * nko, row0 = (int)blockIdx.y * a.sh.rows;
  // the chunk stream is Wb, Wv, Wo (nkd chunks each), then Wd (nko)
  const fdc::Offsets lay = {L.slot_bytes, L.q, L.q_bytes, L.stats, L.red,
                            L.mr,         L.part, L.units, L.bars, total};
  const fdc::Phases<N, MT> k(base, a.sh, lay);
  const int lane = (int)threadIdx.x & 31;
  const bool producer = threadIdx.x >= 256;

  // this block's slices of h + row_add + rows_add (zero past B) and of the
  // vectors into shared memory first, whole 16-byte loads, all in flight
  // while the barriers are set up; h staged in the partial sums' room
  // (free until the first product's end; 512 units rows >= 4 rows sd bytes)
  float* vec = reinterpret_cast<float*>(base + L.vec);
  float* stage = reinterpret_cast<float*>(base + L.part);
  float xs[MT][N / 2], acc[MT][N / 2];
  if (!producer && a.width != a.d) {  // padded: scalar reads at the true stride, zeros past it
    for (int i = threadIdx.x; i < a.sh.rows * sd; i += 256) {
      const int r = i / sd, row = row0 + r, cc = k.c * sd + (i - r * sd);
      float v = 0.f;
      if (row < a.B && cc < a.width) {
        const size_t at = (size_t)row * a.width + cc;
        v = __ldg(a.h + at);
        if (a.row_add) v += __ldg(a.row_add + cc);
        if (a.rows_add) v += __ldg(a.rows_add + at);
      }
      stage[i] = v;
    }
  } else if (!producer) {
    const int q4 = sd / 4;
    for (int i = threadIdx.x; i < a.sh.rows * q4; i += 256) {
      const int r = i / q4, row = row0 + r, cc = k.c * sd + 4 * (i - r * q4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.B) {
        const size_t at = (size_t)row * a.d + cc;
        v = fd::ldg4(a.h + at);
        if (a.row_add) v = fd::add4(v, fd::ldg4(a.row_add + cc));
        if (a.rows_add) v = fd::add4(v, fd::ldg4(a.rows_add + at));
      }
      fd::st4(stage + 4 * i, v);
    }
  }
  if (!producer) {
    // (7 sd + so <= 2048: at most 8 a thread, all loaded before any is
    // stored; kWide: bd's slice is staged a pass at a time)
    const int nv = 7 * sd + (kWide ? 0 : so);
    float t8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = threadIdx.x + 256 * j, v = i < 7 * sd ? i / sd : 7, e = i - v * sd;
      const float* src = v == 0 ? a.bb : v == 1 ? a.g1 : v == 2 ? a.b1 : v == 3 ? a.g2
                         : v == 4 ? a.b2 : v == 5 ? a.bv : v == 6 ? a.bo : a.bd;
      if (i < nv) t8[j] = __ldg(src + (v < 7 ? k.c * sd : k.c * so) + e);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (threadIdx.x + 256 * j < nv) vec[threadIdx.x + 256 * j] = t8[j];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.sh.slots; ++s) {
      fdh::mbar_init(k.full(s), 1);
      fdh::mbar_init(k.empty(s), 8);
    }
    for (int i = 0; i < 6; ++i) fdh::mbar_init(k.xbar(i), 1);
    fdh::mbar_init(k.xbar(6), a.sh.cols);
    fdh::mbar_init(k.xbar(7), a.sh.cols);
    fdh::fence_barrier_init();
    const uint32_t op = (uint32_t)((a.sh.cols - 1) * a.sh.rows * sd * 2);
    const uint32_t st = (uint32_t)((a.sh.cols - 1) * a.sh.rows * 8);
    const uint32_t bytes[6] = {op, st, st, op, op, op};
    for (int i = 0; i < 6; ++i) fdh::mbar_expect_tx(k.xbar(i), bytes[i]);
  }
  __syncthreads();
  FD_STAMP(12);
  fdh::cluster_arrive();  // this block's barriers exist: the others may use them
  if (!producer) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = k.col(u, h);
            xs[u][4 * j + 2 * h + e] = m < sd ? stage[k.row(j, e) * sd + m] : 0.f;
          }
  }

  // the producer: the stream is the chunks of Wb, Wv, Wo (nkd each), then
  // Wd's (nko); chunk q, one box of slice rows x kb k64 tiles, into slot
  // q % slots
  auto map = [&](int p) { return p == 0 ? &map_b : p == 1 ? &map_v : p == 2 ? &map_o : &map_d; };
  auto issue = [&](int q) {
    const int p = q < 3 * nkd ? q / nkd : 3, kc = p < 3 ? q - p * nkd : q - 3 * nkd;
    const int slice = p < 3 ? sd : so, kb = p < 3 ? L.kbd : L.kbo;
    if constexpr (kWide) {  // Wd's pass kc / nko: pw rows from k.c so + pass pw
      const int pass = p < 3 ? 0 : kc / nko, lines = p < 3 ? sd : L.pw;
      fdh::mbar_expect_tx(k.full(q), (uint32_t)(kb * lines * 128));
      fdh::tma_load_3d(k.slot(q), map(p), 0, k.c * slice + pass * L.pw, (kc - pass * nko) * kb,
                       k.full(q));
    } else {
      fdh::mbar_expect_tx(k.full(q), (uint32_t)(kb * slice * 128));
      fdh::tma_load_3d(k.slot(q), map(p), 0, k.c * slice, kc * kb, k.full(q));
    }
  };
  const int first = a.sh.slots < total ? a.sh.slots : total;
  if (producer && lane == 0) {  // the first chunks at once: only this block's barriers
    for (int p = 0; p < 4; ++p) fdh::tma_prefetch(map(p));
    for (int q = 0; q < first; ++q) issue(q);
  }

  FD_STAMP(13);
  fdh::cluster_wait();
  FD_STAMP(1);

  if (producer) {
    if (lane == 0) {
      for (int q = first; q < total; ++q) {
        fdh::mbar_wait(k.empty(q), (uint32_t)(((q - a.sh.slots) / a.sh.slots) & 1));  // chunk q - slots read
        issue(q);
      }
    }
    __syncwarp();
    fdh::cluster_arrive();
    fdh::cluster_wait();
    return;
  }

  auto for_each = [&](auto&& f) {  // f(u, i, m, n) over the thread's values in the slice (m local)
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k.col(u, h) < sd) f(u, 4 * j + 2 * h + e, k.col(u, h), k.row(j, e));
  };
  auto for_each_cols = [&](int width, auto&& f) {  // the same over `width` columns
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k.col(u, h) < width) f(u, 4 * j + 2 * h + e, k.col(u, h), k.row(j, e));
  };
  const float2* mr = reinterpret_cast<const float2*>(base + L.mr);

  // The four products in one loop, so that each step's code (the exchange,
  // the product, the LayerNorms) exists once: every phase runs once a
  // launch and is fetched cold from L2 each time. acc holds the operand each
  // product takes, then its output:
  //   p 0: h -> U = bf16(h) Wb + bb; h += swish(LN1(U)); acc = LN2(h)
  //   p 1: acc = V = bf16(acc) Wv + bv
  //   p 2: O = bf16(V) Wo + bo; h += O; acc = h
  //   p 3: out = bf16(h) Wd + bd
  // Operand buffers: p even the first, p odd the second (one and the same
  // where only one fits, rewritten after every block's release).
  for_each([&](int u, int i, int, int) { acc[u][i] = xs[u][i]; });
  for (int p = 0; p < 4; ++p) {
    if (p >= 2) k.buffer_free(4 + p);
    k.share(acc, k.qbuf(p & 1), sd, p == 0 ? 0 : 2 + p);
    if (p == 3) fdh::cluster_arrive();  // nothing more comes into this block from the others
    FD_STAMP(p == 0 ? 2 : 4 + 2 * p);
    if constexpr (kWide) {
      if (p == 3) {  // Wd's passes: the pass's bias staged, its columns stored
        for (int pass = 0; pass < L.npass; ++pass) {
          const int real = so - pass * L.pw < L.pw ? so - pass * L.pw : L.pw;
          k.sync_all();  // the last pass's bias and partial sums read
          for (int i = threadIdx.x; i < L.pw; i += 256)
            vec[7 * sd + i] = i < real ? __ldg(a.bd + k.c * so + pass * L.pw + i) : 0.f;
          k.product(3 * nkd + pass * nko, nko, L.kbo, L.pw, k.qbuf(1), vec + 7 * sd, acc, 3);
          for_each_cols(L.pw, [&](int u, int i, int m, int n) {
            const int row = row0 + n, col = k.c * so + pass * L.pw + m;
            if (k.lead && m < real && col < a.width_out && row < a.B)
              a.out[(size_t)row * a.width_out + col] = acc[u][i];
          });
        }
        break;
      }
    }
    k.product(p < 3 ? p * nkd : 3 * nkd, p < 3 ? nkd : nko, p < 3 ? L.kbd : L.kbo,
              p < 3 ? sd : so, k.qbuf(p & 1), vec + (p == 0 ? 0 : (4 + p) * sd), acc, p);
    FD_STAMP(p == 0 ? 3 : 5 + 2 * p);
    if (p == 0) {
      for (int ln = 0; ln < 2; ++ln) {
        k.row_moments(acc, ln, sd, a.width, 1 + ln, a.eps);
        FD_STAMP(ln == 0 ? 4 : 5);
        for_each([&](int u, int i, int m, int n) {
          const float2 st = mr[n];
          const float x = (acc[u][i] - st.x) * st.y * vec[(1 + 2 * ln) * sd + m] +
                          vec[(2 + 2 * ln) * sd + m];
          if (ln == 0) {
            xs[u][i] += swish(x);
            acc[u][i] = xs[u][i];
          } else {
            acc[u][i] = x;
          }
        });
        if (ln == 0) FD_STAMP(14);
      }
    } else if (p == 2) {
      for_each([&](int u, int i, int, int) {
        xs[u][i] += acc[u][i];
        acc[u][i] = xs[u][i];
      });
    }
  }

  // out: this block's columns of the last product (kWide: stored a pass at a time)
  if constexpr (!kWide) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = k.col(u, h), row = row0 + k.row(j, e), col = k.c * so + m;
            if (k.lead && m < so && col < a.width_out && row < a.B)
              a.out[(size_t)row * a.width_out + col] = acc[u][4 * j + 2 * h + e];
          }
  }
  FD_STAMP(15);
  fdh::cluster_wait();  // no block leaves while another may still write to it
}

// The head's widths: the activations' own (dl, de, latent) and the padded
// ones of its weights and vectors (dlp, dep: multiples of 32; latp: of 8).
struct HeadDims {
  int dl, de, latent, dlp, dep, latp;
};

constexpr int kHeadPass = 2048;  // K of a product pass of head_kernel
constexpr int kHeadCols = 512;   // its output columns a block of the product

// The head's product form (see the head design above). X: the pre-LN rows,
// (ceil(B / 16) 16, dlp) f32 in device memory.
__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
                 const float* __restrict__ rows_add,
                 const float* __restrict__ t_base, const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ bt,
                 const float* __restrict__ c_base, const __nv_bfloat16* __restrict__ wc,
                 const float* __restrict__ bc,
                 const float* __restrict__ g, const float* __restrict__ b,
                 const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bf,
                 float* __restrict__ out, int B, HeadDims n, float eps, float* X) {
  extern __shared__ __align__(16) float smem[];
  float* U = smem;                     // kRows x kHeadCols: a pass's products
  float* S = U + kRows * kHeadCols;    // kRows x kHeadCols: their sum over the passes
  float* red = S + kRows * kHeadCols;
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(red + fd::kRedFloats);  // a pass's operand
  __shared__ float2 stat[kRows];       // (mean, rstd) a row
  const int row0 = blockIdx.x * kRows, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Xb = X + (size_t)row0 * n.dlp;

  // 1. the rows and their adds, zeros past dl and past B
  for (int i = tid; i < kRows * n.dlp; i += kThreads) {
    const int r = i / n.dlp, k = i - r * n.dlp, row = row0 + r;
    float v = 0.f;
    if (row < B && k < n.dl) {
      v = __ldg(h + (size_t)row * n.dl + k);
      if (row_add) v += __ldg(row_add + k);
      if (rows_add) v += __ldg(rows_add + (size_t)row * n.dl + k);
    }
    Xb[i] = v;
  }
  __syncthreads();
  // a column block of `cols` outputs from col0 of the product of Q's source
  // (`fill` writes pass k0's kw columns into Q) with W (ldw wide): S
  auto product = [&](auto&& fill, int K, const __nv_bfloat16* W, int ldw, int col0, int cols,
                     bool refill) {
    for (int k0 = 0; k0 < K; k0 += kHeadPass) {
      const int kw = K - k0 < kHeadPass ? K - k0 : kHeadPass;
      if (refill) {
        fill(k0, kw);
        __syncthreads();
      }
      fd::gemm_tc(Q, kw, W + k0, ldw, col0, cols, U, red);
      for (int i = tid; i < kRows * cols; i += kThreads) S[i] = k0 ? S[i] + U[i] : U[i];
      __syncthreads();
    }
  };
  // 2. the base products, added to the rows with their biases
  const float* bases[2] = {t_base, c_base};
  const __nv_bfloat16* ws[2] = {wt, wc};
  const float* bs[2] = {bt, bc};
  for (int j = 0; j < 2; ++j) {
    if (!bases[j]) continue;
    auto fill = [&](int k0, int kw) {
      for (int i = tid; i < kRows * kw; i += kThreads) {
        const int r = i / kw, k = k0 + i - r * kw, row = row0 + r;
        Q[r * (kw + kPad) + k - k0] = __float2bfloat16_rn(
            row < B && k < n.de ? __ldg(bases[j] + (size_t)row * n.de + k) : 0.f);
      }
    };
    for (int c0 = 0; c0 < n.dlp; c0 += kHeadCols) {
      const int cols = n.dlp - c0 < kHeadCols ? n.dlp - c0 : kHeadCols;
      product(fill, n.dep, ws[j], n.dep, c0, cols, c0 == 0 || n.dep > kHeadPass);
      for (int i = tid; i < kRows * cols; i += kThreads) {
        const int r = i / cols, m = c0 + i - r * cols;
        Xb[(size_t)r * n.dlp + m] += S[i] + bs[j][m];
      }
      __syncthreads();
    }
  }
  // 3. each row's statistics over its dl columns: a warp a row, as
  // fd::rows_layernorm_operand (float4 c = lane + 32 j, two passes)
  for (int r = warp; r < kRows; r += fd::kWarps) {
    const float* x = Xb + (size_t)r * n.dlp;
    const int q = n.dlp / 4;
    float s = 0.f;
    for (int c = lane; c < q; c += 32) {
      const float4 v = fd::ld4(x + 4 * c);
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = fd::warp_sum(s) / n.dl;
    float v = 0.f;
    for (int c = lane; c < q; c += 32) {
      const float4 xv = fd::ld4(x + 4 * c);
      const float d0 = 4 * c < n.dl ? xv.x - mean : 0.f, d1 = 4 * c + 1 < n.dl ? xv.y - mean : 0.f,
                  d2 = 4 * c + 2 < n.dl ? xv.z - mean : 0.f,
                  d3 = 4 * c + 3 < n.dl ? xv.w - mean : 0.f;
      v += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
    const float rstd = rsqrtf(fd::warp_sum(v) / n.dl + eps);
    if (lane == 0) stat[r] = make_float2(mean, rstd);
  }
  __syncthreads();
  // 4. the output: bf16(LN(rows)) Wf^T + bf, K (dl) in passes
  auto norm = [&](int k0, int kw) {
    const int q = kw / 4;
    for (int i = tid; i < kRows * q; i += kThreads) {
      const int r = i / q, k = k0 + 4 * (i - r * q);
      const float4 xv = fd::ld4(Xb + (size_t)r * n.dlp + k), gv = fd::ldg4(g + k),
                   bv = fd::ldg4(b + k);
      const float2 st = stat[r];
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(Q + r * (kw + kPad) + k - k0);
      d[0] = __floats2bfloat162_rn((xv.x - st.x) * st.y * gv.x + bv.x,
                                   (xv.y - st.x) * st.y * gv.y + bv.y);
      d[1] = __floats2bfloat162_rn((xv.z - st.x) * st.y * gv.z + bv.z,
                                   (xv.w - st.x) * st.y * gv.w + bv.w);
    }
  };
  for (int c0 = 0; c0 < n.latp; c0 += kHeadCols) {
    const int cols = n.latp - c0 < kHeadCols ? n.latp - c0 : kHeadCols;
    product(norm, n.dlp, wf, n.dlp, c0, cols, c0 == 0 || n.dlp > kHeadPass);
    for (int i = tid; i < kRows * cols; i += kThreads) {
      const int r = i / cols, m = c0 + i - r * cols, row = row0 + r;
      if (row < B && m < n.latent) out[(size_t)row * n.latent + m] = S[i] + bf[m];
    }
    __syncthreads();
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

size_t g_head_smem = 0;

// The stage kernel's instance for `rows` a block: N = rows, MT = the m64
// tiles a block's slice may have at that N (at most 64 accumulators a
// thread); kWide: Wd in column passes. Its non-portable cluster sizes and
// shared memory set once.
template <int N, int MT, bool kWide = false>
cudaError_t stage_prepare(const void** kernel, size_t smem) {
  static size_t configured = 0;
  static bool nonportable = false;
  *kernel = (const void*)stage_kernel<N, MT, kWide>;
  if (!nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<N, MT, kWide>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  return reserve_smem(stage_kernel<N, MT, kWide>, smem, &configured);
}

int stage_units(int rows) { return rows == 128 ? 1 : rows == 64 ? 2 : 4; }

// Whether Wd's slice needs column passes at `rows` (the kWide instances).
bool stage_wide(int dout, int cols, int rows) { return dout / cols > 64 * stage_units(rows); }

constexpr int kMaxDout = 1 << 22;

// The plan's fields, checked against what the kernel assumes
// (kernels/latent_stage.py::stage_plan makes them).
bool plan_ok(int B, int d, int dout, int width, int width_out, int tiles, int cols, int rows,
             int qbufs, int slots, int smem) {
  if (d < 64 || d > 4096 || d % 64 || dout < 8 || dout > kMaxDout || cols < 1 ||
      cols > kMaxCluster || d % cols || dout % cols)
    return false;
  // padded by less than 128 (whole 8-column units in 16 slices past 2048)
  if (width < 1 || width > d || d - width >= 128 || width_out < 1 || width_out > dout ||
      dout - width_out >= 128)
    return false;
  const int sd = d / cols, so = dout / cols;
  if (rows != 8 && rows != 16 && rows != 32 && rows != 64 && rows != 128) return false;
  const int mt = stage_units(rows);
  const bool wide = stage_wide(dout, cols, rows);
  if (sd % 8 || so % 8 || sd > 256 || (!wide && so > 256)) return false;
  if ((sd + 63) / 64 > mt || (!wide && (so + 63) / 64 > mt)) return false;
  if (qbufs < 1 || qbufs > 2 || slots < 2 || slots > kMaxSlots || tiles < 1 ||
      (long long)tiles * rows < B)
    return false;
  const StageLayout L(d, dout, cols, rows, qbufs, slots, wide);
  return smem >= 1024 + L.total && smem <= 232448;
}

}  // namespace

// The four tensor maps of a bound stage (Wb, Wv, Wo, Wd: bf16 (out, in) as
// 3-D, boxes of a chunk: the rows of one column slice of `cols` by
// chunk_tiles k64 tiles; Wd's `pw` rows, its slice or a pass of it),
// encoded into `maps` (4 CUtensorMap, 64-byte aligned), once, when the
// stage is bound.
extern "C" int fd_stage_maps(const void* wb, const void* wv, const void* wo, const void* wd,
                             int d, int dout, int cols, int pw, void* maps) {
  if (cols < 1 || d % cols || dout % cols || pw < 8 || pw > dout / cols || (uintptr_t)maps % 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap* m = static_cast<CUtensorMap*>(maps);
  const int sd = d / cols, kbd = chunk_tiles(sd, d), kbo = chunk_tiles(pw, d);
  const bool ok = fdh::wg_map_bf16(&m[0], wb, d, d, d, sd, kbd) &&
                  fdh::wg_map_bf16(&m[1], wv, d, d, d, sd, kbd) &&
                  fdh::wg_map_bf16(&m[2], wo, d, d, d, sd, kbd) &&
                  fdh::wg_map_bf16(&m[3], wd, dout, d, d, pw, kbo);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// Calls of cuTensorMapEncodeTiled by this library so far.
extern "C" long long fd_stage_map_encodes() { return fdh::map_encodes(); }

// One stage launch on the plan's geometry, from the maps fd_stage_maps
// encoded (Wd's with the pass rows of StageLayout). d, dout: the padded
// widths of the weights and vectors (d a multiple of 64 up to 4096, each
// past width, width_out by less than 128: their columns are zeros);
// h, row_add, rows_add and out have the stage's own widths. A plan the
// kernel cannot run returns cudaErrorInvalidValue, and a launch the card
// refuses returns its error. Nothing retries.
extern "C" int fd_stage_launch(const void* maps, const void* h, const void* row_add,
                               const void* rows_add, const void* bb, const void* g1,
                               const void* b1, const void* g2, const void* b2, const void* bv,
                               const void* bo, const void* bd, void* out, int B, int d,
                               int dout, int width, int width_out, int tiles, int cols, int rows,
                               int qbufs, int slots, int smem, float eps, void* stream) {
  if (!plan_ok(B, d, dout, width, width_out, tiles, cols, rows, qbufs, slots, smem) || !maps)
    return (int)cudaErrorInvalidValue;
  const CUtensorMap* m = static_cast<const CUtensorMap*>(maps);
  StageArgs a;
  a.h = (const float*)h;
  a.row_add = (const float*)row_add;
  a.rows_add = (const float*)rows_add;
  a.bb = (const float*)bb;
  a.g1 = (const float*)g1;
  a.b1 = (const float*)b1;
  a.g2 = (const float*)g2;
  a.b2 = (const float*)b2;
  a.bv = (const float*)bv;
  a.bo = (const float*)bo;
  a.bd = (const float*)bd;
  a.out = (float*)out;
  a.B = B;
  a.d = d;
  a.dout = dout;
  a.width = width;
  a.width_out = width_out;
  a.sh.rows = rows;
  a.sh.cols = cols;
  a.sh.slots = slots;
  a.sh.qbufs = qbufs;
  a.eps = eps;
  const void* kernel = nullptr;
  cudaError_t err;
  if (stage_wide(dout, cols, rows)) {
    err = rows == 128  ? stage_prepare<128, 1, true>(&kernel, smem)
          : rows == 64 ? stage_prepare<64, 2, true>(&kernel, smem)
          : rows == 32 ? stage_prepare<32, 4, true>(&kernel, smem)
          : rows == 16 ? stage_prepare<16, 4, true>(&kernel, smem)
                       : stage_prepare<8, 4, true>(&kernel, smem);
  } else {
    err = rows == 128  ? stage_prepare<128, 1>(&kernel, smem)
          : rows == 64 ? stage_prepare<64, 2>(&kernel, smem)
          : rows == 32 ? stage_prepare<32, 4>(&kernel, smem)
          : rows == 16 ? stage_prepare<16, 4>(&kernel, smem)
                       : stage_prepare<8, 4>(&kernel, smem);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols, tiles);
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cols;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&m[0], (void*)&m[1], (void*)&m[2], (void*)&m[3], (void*)&a};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// h (B, dl), rows_add (B, dl), row_add (dl), t_base and c_base (B, de) f32,
// any but h null; the weights and vectors padded with zeros to dlp, dep
// (dl, de rounded up to multiples of 32) and latp (latent rounded up to a
// multiple of 8): wt, wc (dlp, dep), bt, bc, g, b (dlp), wf (latp, dlp), bf
// (latp); x: the caller's (ceil(B / 16) 16, dlp) f32 device memory for the
// pre-LN rows. Any dl, de, latent.
extern "C" int fd_head_launch(const void* h, const void* row_add, const void* rows_add,
                              const void* t_base, const void* wt, const void* bt,
                              const void* c_base, const void* wc, const void* bc,
                              const void* g, const void* b, const void* wf, const void* bf,
                              void* out, void* x, int B, int dl, int de, int latent, float eps,
                              void* stream) {
  const HeadDims n = {dl, de, latent, (dl + 31) / 32 * 32, (de + 31) / 32 * 32,
                      (latent + 7) / 8 * 8};
  if (B < 1 || dl < 1 || de < 1 || latent < 1 || !x || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * kRows * kHeadCols + fd::kRedFloats) +
                      sizeof(__nv_bfloat16) * kRows * (kHeadPass + kPad);
  cudaError_t err = reserve_smem(head_kernel, smem, &g_head_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  head_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)row_add, (const float*)rows_add,
      (const float*)t_base, (const __nv_bfloat16*)wt, (const float*)bt,
      (const float*)c_base, (const __nv_bfloat16*)wc, (const float*)bc,
      (const float*)g, (const float*)b, (const __nv_bfloat16*)wf, (const float*)bf,
      (float*)out, B, n, eps, (float*)x);
  return (int)cudaGetLastError();
}
