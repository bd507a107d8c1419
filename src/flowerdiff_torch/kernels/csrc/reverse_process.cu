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
// m64 tiles of a block's widest slice at `rows` rows a cluster: the
// instances hold at most 64 accumulators a thread (MT x rows / 2 x 2)
__host__ __device__ inline int max_units(int rows) { return rows <= 16 ? 4 : 2; }
constexpr int kBars = 5;
enum { kOp0 = 0, kOp1 = 1, kSt0 = 2, kSt1 = 3, kFree = 4 };

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
// kernels/full_sampler.py::process_smem computes the same.
struct ProcessLayout {
  int units, slot_bytes, chunks, vec_floats, q, q_bytes, stats, red, mr, part, vec, adds, xs, eps,
      skip, bars, total;
  ProcessLayout() = default;
  __host__ __device__ ProcessLayout(const int* dims, int n, int L, bool with_skip, int cols,
                                    int rows, int qbufs, int slots, bool streamed = false) {
    int widest = 0, dmax = L, reach = 0, nvec = dims[0] / cols, nadds = 0;
    slot_bytes = chunks = 0;
    for (int p = 0; p < 3 + 4 * n; ++p) {
      if (p == 1 && !with_skip) continue;
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
};

// kExact: every width is its own padded width (the flagship's), and the
// code has no padded case: the loads, LayerNorms and reverse step of a
// denoiser that needs no padding, as before widths were padded. kStream:
// the streamed layout (any depth; padded code), in instances of its own.
template <int N, int MT, bool kExact, bool kStream = false>
__global__ void __launch_bounds__(kStageThreads, 1)
process_kernel(const __grid_constant__ Maps maps, const __grid_constant__ ProcessArgs a) {
  static_assert(!(kExact && kStream), "the streamed instances take the padded code");
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

  if (!producer && kStream) {  // x only: the vectors and adds stay in device memory
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
  const int first = a.slots < a.off.total ? a.slots : a.off.total;
  if (producer && lane == 0) {  // the first chunks at once: only this block's barriers
    for (int i = 0; i < 2 + 4 * n && i < kMaxMaps; ++i) fdh::tma_prefetch(mp + i);
    walk(0, first);
  }
  fdh::cluster_wait();
  FD_STAMP(1);
  if (producer) {
    if (lane == 0) walk(first, a.off.total);
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

  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    FD_STAMP_STEP(s == a.T / 2);
    FD_STEP_STAMP(2);
    // the projection's operand: bf16(x), a sample's row in both halves when guided
    {
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
        product(2 + 4 * st + p, qb, sv + (p == 0 ? 0 : (4 + p) * sd), acc);
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

// The instance <N, MT, kExact, kStream>, its attributes set for `smem`
// bytes (once an instance).
template <int N, int MT, bool kExact, bool kStream = false>
cudaError_t pick(size_t smem, const void** kernel) {
  static size_t configured = 0;
  static bool nonportable = false;
  *kernel = (const void*)process_kernel<N, MT, kExact, kStream>;
  return prepare(process_kernel<N, MT, kExact, kStream>, smem, &configured, &nonportable);
}

// The kernel's instance for `rows` rows a cluster, slices of up to `units`
// m64 tiles (2, or 4 at 8 and 16 rows) and, where `exact` (no width
// padded) at 2 units, the instance with no padded case; `streamed`: the
// streamed layout's instances.
cudaError_t instance(int rows, int units, bool exact, bool streamed, size_t smem,
                     const void** kernel) {
  if (streamed) {
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
// blocks a cluster (kernels/full_sampler.py::process_width).
bool padded_ok(int width, int pad, int cols) {
  const int unit = 8 * cols > 64 ? 8 * cols : 64;
  return width >= 1 && width <= kMaxDim && pad >= width && pad - width < unit && pad % unit == 0;
}

// The widths and the plan's fields, checked against what the kernel
// assumes (kernels/full_sampler.py::process_plan makes them).
bool plan_ok(const int* dims, const int* wid, int n, int L, int lat, bool with_skip, int B,
             int T, int guided, int clusters, int cols, int rows, int qbufs, int slots, int smem,
             bool streamed) {
  if (n < 1 || n > (streamed ? kMaxStreamStages : kMaxStages) || B < 1 || T < 1 || cols < 1 ||
      cols > kMaxCluster || (cols & (cols - 1)))
    return false;
  if (!padded_ok(lat, L, cols)) return false;
  for (int i = 0; i <= n; ++i)
    if (!padded_ok(wid[i], dims[i], cols)) return false;
  if (with_skip && (wid[n] != lat || dims[n] != L)) return false;
  if (rows != 8 && rows != 16 && rows != 32) return false;
  const int samples = guided ? rows / 2 : rows;
  if (clusters < 1 || (long long)clusters * samples < B) return false;
  if (qbufs < 1 || qbufs > 2 || slots < 2 || slots > kMaxSlots) return false;
  const ProcessLayout Lay(dims, n, L, with_skip, cols, rows, qbufs, slots, streamed);
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
extern "C" int fd_process_maps(const void* const* weights, const int* dims, int n, int L,
                               int cols, void* maps) {
  if (n < 1 || n > kMaxStreamStages || cols < 1 || (uintptr_t)maps % 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap* m = static_cast<CUtensorMap*>(maps);
  for (int i = 0; i < 2 + 4 * n; ++i) {
    // the product whose map this is: 0 the projection, 2 + 4 s + j a stage's, the head last
    const int p = i == 0 ? 0 : i < 1 + 4 * n ? i + 1 : 2 + 4 * n;
    int map, slice, K;
    product_shape(dims, n, L, cols, p, &map, &slice, &K);
    const int out = map == 0 ? dims[0] : map == 1 + 4 * n ? L
                    : (map - 1) % 4 == 3 ? dims[(map - 1) / 4 + 1] : dims[(map - 1) / 4];
    if (K % cols || slice < 8 || !fdh::wg_map_bf16(&m[i], weights[i], out, K, K, slice,
                                                   chunk_tiles(slice, K)))
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
  cudaError_t err = instance(rows, 2, true, false, (size_t)smem, &kernel);
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
// that launches on other streams cannot overwrite what it reads). ints:
// n, B, L, T, guided, clip,
// stochastic, clusters, cols, rows, qbufs, slots, smem, dims[0..n] (padded,
// the widths the weights were padded to), lat, wid[0..n] (the model's
// widths: x, out and the condition rows have these), streamed. floats:
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
  const bool streamed = ints[16 + 2 * a.n] != 0;
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
               a.cols, a.rows, a.qbufs, a.slots, smem, streamed))
    return (int)cudaErrorInvalidValue;
  a.lay = ProcessLayout(dims, a.n, a.L, a.rw != nullptr, a.cols, a.rows, a.qbufs, a.slots,
                        streamed);
  a.sh = {a.rows, a.cols, a.slots, a.qbufs};
  a.off = {a.lay.slot_bytes, a.lay.q,    a.lay.q_bytes, a.lay.stats, a.lay.red,
           a.lay.mr,         a.lay.part, a.lay.units,   a.lay.bars,  a.lay.chunks * a.T};
  const void* kernel = nullptr;
  bool exact = a.lat == a.L;
  for (int i = 0; i <= a.n; ++i) exact = exact && wid[i] == dims[i];
  cudaError_t err = instance(a.rows, a.lay.units, exact, streamed, (size_t)smem, &kernel);
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
