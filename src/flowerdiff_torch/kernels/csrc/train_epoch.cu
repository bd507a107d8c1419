// A whole epoch of latent-DDPM train steps from one call, for sm_90a.
//
// Replaces the Pallas kernel `_make_epoch_kernel` of
// flowerdiff/kernels/train_epoch.py (reached through `make_mega_epoch_fn`):
// S steps of in-kernel draws (timesteps, noise, the condition keep-mask, two
// dropout masks a stage), abar[t], forward and backward of the eps-loss,
// the global-norm clip and AdamW from per-step tables of the learning rate
// and the bias corrections, with the losses of all S steps as output.
//
// The TPU kernel is one program because 128 MB of VMEM hold w, m and v for
// the whole epoch. This card has no such memory (50 MB of L2, 227 KB of
// shared memory a block, against ~31 MB each of w, m, v and g), so every
// step reads and writes them in device memory once. What carries over is
// what is computed and where: `fd_train_epoch_launch` enqueues every step
// of the epoch on the caller's stream, and between two steps there is no
// host code: no Python, no PyTorch op, no synchronisation. A step is
//
//   draws_kernel     t, sqrt(abar[t]), sqrt(1 - abar[t]), eps, the keep-mask
//                    and the masks into fixed buffers (Philox4x32-10, keyed
//                    by the seed; counter = (element group, global step,
//                    tensor id), so no two tensors or steps share bits);
//   the train step   the launches of train_step.cuh from the bound step's
//                    plan (its routes and tensor maps, made when the step
//                    was bound: the epoch encodes nothing), reading those
//                    buffers and writing its loss straight into losses[i];
//   sumsq_kernel     per-chunk partial sums of g^2 over all leaves, then
//   norm_kernel      one block adds the partials in order: no atomics, so an
//                    epoch repeats bit for bit from the same seed;
//   adamw_kernel     one launch over all leaves: clip scale, moments, bias
//                    corrections, decoupled weight decay, the update of w in
//                    place; m and v in f32 or bf16 storage, f32 arithmetic.
//
// After the last step the q and k projections, which the train step never
// sees (zero gradient) but AdamW still decays, are scaled by
// prod_i (1 - lr_i wd), and the EMA copy takes one blend with decay^S.
//
// Bound on the card: bytes. On top of the train step's weights read and
// gradients written, a step reads g, w, m, v and writes w, m, v once.
// The optimizer kernels are elementwise and stream at chunk granularity
// (4096 elements a block); the leaf and chunk tables live in device memory,
// written once when the epoch function is bound to its weights.
#include <cuda_bf16.h>

#include <type_traits>

#include "philox.cuh"
#include "train_step.cuh"

namespace {

constexpr int kChunk = 4096;  // elements of one leaf a block handles
constexpr int kOptThreads = 256;
constexpr int kHeads = 8;     // attention heads: one attention-mask draw a (row, head)

// One weight leaf as the optimizer sees it: a row of the (n, 7) int64 table.
struct Leaf {
  float* w;
  const float* g;
  float* m32;  // the state's f32 moments
  float* v32;
  __nv_bfloat16* m16;  // the epoch's bf16 moments, or null
  __nv_bfloat16* v16;
  long long n;
};

// dst = a * dst + b * src over n elements: a row of the (n, 3) int64 table.
struct Blend {
  float* dst;
  const float* src;
  long long n;
};

struct Chunk {
  int item;   // row of the leaf or blend table
  int index;  // which kChunk-sized piece of it
};

struct Hyper {
  float clip, wd, b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ float load_moment(const float* p) { return *p; }
__device__ __forceinline__ float load_moment(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_moment(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_moment(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// partials[block] = sum of g^2 over the block's chunk, summed in a fixed order.
__global__ void __launch_bounds__(kOptThreads)
sumsq_kernel(const Leaf* leaves, const Chunk* chunks, float* partials) {
  __shared__ float red[kOptThreads / 32];
  const Chunk c = chunks[blockIdx.x];
  const Leaf lf = leaves[c.item];
  const long long base = (long long)c.index * kChunk;
  const long long end = base + kChunk < lf.n ? base + kChunk : lf.n;
  float s = 0.f;
  for (long long i = base + threadIdx.x; i < end; i += kOptThreads) {
    const float g = lf.g[i];
    s += g * g;
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// gnorm[0] = sqrt(sum of the partials), one block, in order.
__global__ void __launch_bounds__(1024)
norm_kernel(const float* partials, int n, float* gnorm) {
  __shared__ float red[32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partials[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) gnorm[0] = sqrtf(s);
}

// clip_by_global_norm -> scale_by_adam -> decoupled weight decay -> -lr, as
// optax chains them: g *= min(1, clip / max(gnorm, 1e-16));
// m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
// w -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd w). tables: (3, steps) f32
// rows lr, bc1, bc2. M is the moments' storage type; the update uses the
// unrounded new moments.
template <typename M>
__global__ void __launch_bounds__(kOptThreads)
adamw_kernel(const Leaf* leaves, const Chunk* chunks, const float* gnorm, const float* tables,
             int steps, int step, Hyper h) {
  const Chunk c = chunks[blockIdx.x];
  const Leaf lf = leaves[c.item];
  M* m;
  M* v;
  if constexpr (std::is_same<M, float>::value) {
    m = lf.m32;
    v = lf.v32;
  } else {
    m = lf.m16;
    v = lf.v16;
  }
  const float cscale = fminf(1.f, h.clip / fmaxf(gnorm[0], 1e-16f));
  const float lr = tables[step], bc1 = tables[steps + step], bc2 = tables[2 * steps + step];
  const long long base = (long long)c.index * kChunk;
  const long long end = base + kChunk < lf.n ? base + kChunk : lf.n;
  for (long long i = base + threadIdx.x; i < end; i += kOptThreads) {
    const float g = lf.g[i] * cscale;
    const float m_new = h.b1 * load_moment(m + i) + h.omb1 * g;
    const float v_new = h.b2 * load_moment(v + i) + h.omb2 * g * g;
    const float w = lf.w[i];
    const float upd = (m_new / bc1) / (sqrtf(v_new / bc2) + h.eps) + h.wd * w;
    lf.w[i] = w - lr * upd;
    store_moment(m + i, m_new);
    store_moment(v + i, v_new);
  }
}

// The state's f32 moments into the epoch's bf16 buffers, or back.
__global__ void __launch_bounds__(kOptThreads)
moments_cast_kernel(const Leaf* leaves, const Chunk* chunks, int to_bf16) {
  const Chunk c = chunks[blockIdx.x];
  const Leaf lf = leaves[c.item];
  const long long base = (long long)c.index * kChunk;
  const long long end = base + kChunk < lf.n ? base + kChunk : lf.n;
  for (long long i = base + threadIdx.x; i < end; i += kOptThreads) {
    if (to_bf16) {
      lf.m16[i] = __float2bfloat16(lf.m32[i]);
      lf.v16[i] = __float2bfloat16(lf.v32[i]);
    } else {
      lf.m32[i] = __bfloat162float(lf.m16[i]);
      lf.v32[i] = __bfloat162float(lf.v16[i]);
    }
  }
}

__global__ void __launch_bounds__(kOptThreads)
blend_kernel(const Blend* items, const Chunk* chunks, float a, float b) {
  const Chunk c = chunks[blockIdx.x];
  const Blend it = items[c.item];
  const long long base = (long long)c.index * kChunk;
  const long long end = base + kChunk < it.n ? base + kChunk : it.n;
  for (long long i = base + threadIdx.x; i < end; i += kOptThreads)
    it.dst[i] = a * it.dst[i] + b * it.src[i];
}

// sa = sqrt(abar[t]), s1a = sqrt(1 - abar[t]) for injected timesteps.
__global__ void sched_kernel(const float* t_f, const float* abar, float* sa, float* s1a, int B,
                             int n_sched) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const int t = min(max((int)t_f[r], 0), n_sched - 1);
  const float ab = abar[t];
  sa[r] = sqrtf(ab);
  s1a[r] = sqrtf(1.f - ab);
}

// ---------------------------------------------------------------------------
// The draws. Every tensor of a step is a segment of whole blocks; a thread
// makes one Philox call, counter (group, global step, tensor id, 0), and
// turns its four words into four outputs (two normals for eps).

enum { kDrawT, kDrawKeep, kDrawEps, kDrawMask, kDrawHeadMask, kDrawOnes };

struct DrawSeg {
  float* out;
  int kind;
  int n;       // outputs
  int width;   // columns of a row (the head mask repeats a draw over width / 8)
  int stream;  // tensor id: 0 t, 1 keep, 2 eps, 3 + 2 i block mask, 4 + 2 i attention mask
  int first_block;
  float thresh;  // keep where u >= thresh
  float scale;   // value of a kept element
};

// Segments a launch of the draws takes in its parameters (the flagship's 4
// stages need 11). A step of a deeper net draws in several launches, each a
// window of its segments: a draw's counter does not depend on the launch
// it lies in, so the bits are the same.
constexpr int kMaxSegs = 3 + 2 * 16;

struct DrawPlan {
  DrawSeg seg[kMaxSegs];
  int n_seg;
  int blocks;
  float* sa;
  float* s1a;
  const float* abar;
  int n_sched;
};


// Box-Muller as the reference writes it: 24-bit uniforms, u1 >= 1e-7, the
// cosine branch.
__device__ __forceinline__ float normal24(uint32_t a, uint32_t b) {
  const float u1 = fmaxf(fd::uniform24(a), 1e-7f);
  const float u2 = fd::uniform24(b);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}

__global__ void __launch_bounds__(kOptThreads)
draws_kernel(DrawPlan p, uint32_t key0, uint32_t key1, uint32_t gstep) {
  int s = 0;
  while (s + 1 < p.n_seg && (int)blockIdx.x >= p.seg[s + 1].first_block) ++s;
  const DrawSeg sg = p.seg[s];
  const uint32_t item = (blockIdx.x - sg.first_block) * kOptThreads + threadIdx.x;
  const int per = sg.kind == kDrawEps ? 2 : 4;
  const long long first = (long long)item * per;
  if (first >= sg.n) return;
  if (sg.kind == kDrawOnes) {
    for (int j = 0; j < 4 && first + j < sg.n; ++j) sg.out[first + j] = 1.f;
    return;
  }
  if (sg.kind == kDrawHeadMask) {
    // output element e = (row, column): the draw of (row, head of the column)
    const int hd = sg.width / kHeads;
    uint32_t c[4];
    uint32_t have = 0xFFFFFFFFu;
    for (int j = 0; j < 4 && first + j < sg.n; ++j) {
      const long long e = first + j;
      const uint32_t q = (uint32_t)(e / sg.width) * kHeads + (uint32_t)(e % sg.width) / hd;
      if ((q >> 2) != have) {
        have = q >> 2;
        c[0] = have, c[1] = gstep, c[2] = (uint32_t)sg.stream, c[3] = 0u;
        fd::philox4x32_10(c, key0, key1);
      }
      sg.out[e] = fd::uniform24(c[q & 3]) >= sg.thresh ? sg.scale : 0.f;
    }
    return;
  }
  uint32_t c[4] = {item, gstep, (uint32_t)sg.stream, 0u};
  fd::philox4x32_10(c, key0, key1);
  if (sg.kind == kDrawEps) {
    sg.out[first] = normal24(c[0], c[1]);
    if (first + 1 < sg.n) sg.out[first + 1] = normal24(c[2], c[3]);
    return;
  }
  for (int j = 0; j < 4 && first + j < sg.n; ++j) {
    const float u = fd::uniform24(c[j]);
    const long long e = first + j;
    if (sg.kind == kDrawT) {
      // t ~ U{0 .. n_sched - 1} as a float index, and the schedule at t
      const float t = fminf(floorf(u * (float)p.n_sched), (float)(p.n_sched - 1));
      const float ab = p.abar[(int)t];
      sg.out[e] = t;
      p.sa[e] = sqrtf(ab);
      p.s1a[e] = sqrtf(1.f - ab);
    } else {
      sg.out[e] = u >= sg.thresh ? sg.scale : 0.f;
    }
  }
}

// A step's draws as launches of at most kMaxSegs segments, each numbering
// its blocks from 0. bufs: t_f, sa, s1a, eps, cond_mask, then block and
// attention mask a stage.
bool make_plan(const Dims& d, float* const* bufs, const float* abar, int n_sched, float rate,
               float mask_scale, float cond_dropout, std::vector<DrawPlan>* launches) {
  std::vector<DrawSeg> segs;
  int blocks = 0;
  auto add = [&](float* o, int kind, int n, int width, int stream, float thresh, float scale) {
    const int per = kind == kDrawEps ? 2 : 4;
    segs.push_back(DrawSeg{o, kind, n, width, stream, blocks, thresh, scale});
    blocks += ((n + per - 1) / per + kOptThreads - 1) / kOptThreads;
  };
  add(bufs[0], kDrawT, d.B, 1, 0, 0.f, 0.f);
  add(bufs[4], cond_dropout > 0.f ? kDrawKeep : kDrawOnes, d.B, 1, 1, cond_dropout, 1.f);
  add(bufs[3], kDrawEps, d.B * d.latent, d.latent, 2, 0.f, 0.f);
  for (int i = 0; i < d.n_stages; ++i) {
    const int di = d.hidden[i];
    if (di % kHeads) return false;
    const bool drop = rate > 0.f;
    add(bufs[5 + 2 * i], drop ? kDrawMask : kDrawOnes, d.B * di, di, 3 + 2 * i, rate,
        mask_scale);
    add(bufs[6 + 2 * i], drop ? kDrawHeadMask : kDrawOnes, d.B * di, di, 4 + 2 * i, rate,
        mask_scale);
  }
  segs.push_back(DrawSeg{nullptr, 0, 0, 0, 0, blocks, 0.f, 0.f});  // the end
  launches->clear();
  for (size_t s0 = 0; s0 + 1 < segs.size(); s0 += kMaxSegs) {
    const size_t s1 = std::min(segs.size() - 1, s0 + kMaxSegs);
    DrawPlan p{};
    p.n_seg = (int)(s1 - s0);
    p.blocks = segs[s1].first_block - segs[s0].first_block;
    for (size_t j = s0; j < s1; ++j) {
      p.seg[j - s0] = segs[j];
      p.seg[j - s0].first_block -= segs[s0].first_block;
    }
    p.sa = bufs[1];
    p.s1a = bufs[2];
    p.abar = abar;
    p.n_sched = n_sched;
    launches->push_back(p);
  }
  return true;
}

struct Note {
  cudaError_t err = cudaSuccess;
  void operator()(cudaError_t e) {
    if (err == cudaSuccess) err = e;
  }
  void operator()() { (*this)(cudaGetLastError()); }
};

}  // namespace

// The arguments of one epoch; mirrored field for field by `_EpochArgs` in
// kernels/train_epoch.py (pointers and 64-bit integers first, then ints,
// then floats).
struct EpochArgs {
  const void* plan;            // the bound train step's (fd_step_plan_create): its
                               // weights, gradients, workspace, dims and lane
  const float* z_rows;         // (steps * B, latent)
  const int* labels;           // (steps * B)
  const float* freqs;          // (time_emb / 2)
  const float* abar;           // (n_sched)
  const void* const* injected; // stochastic == 0: t_f, eps, cond_mask, masks: (steps * B, .)
  void* const* draw_bufs;      // one step's t_f, sa, s1a, eps, cond_mask, masks: (B, .)
  float* losses;               // (steps)
  float* gnorms;               // (steps): each step's gradient norm before the clip
  const float* tables;         // (3, steps): lr, bc1, bc2
  const void* leaves;          // Leaf rows
  const void* leaf_chunks;
  float* partials;             // (n_leaf_chunks)
  const void* blends;          // Blend rows: q and k of every stage, then the EMA pairs
  const void* qk_chunks;
  const void* ema_chunks;
  unsigned long long seed;
  long long count0;            // the optimizer's step count at the epoch's start
  int steps, n_sched, n_leaf_chunks, n_qk_chunks, n_ema_chunks;
  int bf16_moments, stochastic;
  float grad_clip, weight_decay, b1, b2, omb1, omb2, eps_adam;
  float dropout, mask_scale, cond_dropout;
  float qk_factor;             // prod_i (1 - lr_i wd)
  float ema_keep, ema_take;    // ema = ema_keep ema + ema_take w
};

extern "C" int fd_train_epoch_launch(const EpochArgs* a, void* stream) {
  if (!a->plan || a->steps < 1 || a->n_sched < 1) return (int)cudaErrorInvalidValue;
  const StepPlan& step = *(const StepPlan*)a->plan;
  const Dims& d = step.d;
  cudaStream_t st = (cudaStream_t)stream;
  float* const* bufs = (float* const*)a->draw_bufs;
  const float* const* inj = (const float* const*)a->injected;
  std::vector<DrawPlan> draws;
  if (!make_plan(d, bufs, a->abar, a->n_sched, a->dropout, a->mask_scale, a->cond_dropout,
                 &draws))
    return (int)cudaErrorInvalidValue;
  if (!a->stochastic && !inj) return (int)cudaErrorInvalidValue;
  const Leaf* leaves = (const Leaf*)a->leaves;
  const Chunk* chunks = (const Chunk*)a->leaf_chunks;
  const Hyper h{a->grad_clip, a->weight_decay, a->b1, a->b2, a->omb1, a->omb2, a->eps_adam};
  const uint32_t key0 = (uint32_t)a->seed, key1 = (uint32_t)(a->seed >> 32);
  const size_t B = d.B, L = d.latent;
  Note note;

  if (a->bf16_moments) {
    moments_cast_kernel<<<a->n_leaf_chunks, kOptThreads, 0, st>>>(leaves, chunks, 1);
    note();
  }
  for (int i = 0; i < a->steps; ++i) {
    const void* data[8];
    std::vector<const void*> masks(2 * (size_t)d.n_stages);
    data[0] = a->z_rows + i * B * L;
    data[2] = bufs[1];
    data[3] = bufs[2];
    data[5] = a->labels + i * B;
    data[7] = a->freqs;
    if (a->stochastic) {
      for (const DrawPlan& p : draws) {
        draws_kernel<<<p.blocks, kOptThreads, 0, st>>>(p, key0, key1, (uint32_t)(a->count0 + i));
        note();
      }
      data[1] = bufs[0];
      data[4] = bufs[3];
      data[6] = bufs[4];
      for (int j = 0; j < 2 * d.n_stages; ++j) masks[j] = bufs[5 + j];
    } else {
      data[1] = inj[0] + i * B;
      data[4] = inj[1] + i * B * L;
      data[6] = inj[2] + i * B;
      for (int j = 0; j < 2 * d.n_stages; ++j) masks[j] = inj[3 + j] + i * B * d.hidden[j / 2];
      sched_kernel<<<(d.B + 127) / 128, 128, 0, st>>>((const float*)data[1], a->abar, bufs[1],
                                                     bufs[2], d.B, a->n_sched);
      note();
    }
    note(train_step_enqueue(step, data, masks.data(), a->losses + i, st));
    sumsq_kernel<<<a->n_leaf_chunks, kOptThreads, 0, st>>>(leaves, chunks, a->partials);
    note();
    norm_kernel<<<1, 1024, 0, st>>>(a->partials, a->n_leaf_chunks, a->gnorms + i);
    note();
    if (a->bf16_moments)
      adamw_kernel<__nv_bfloat16><<<a->n_leaf_chunks, kOptThreads, 0, st>>>(
          leaves, chunks, a->gnorms + i, a->tables, a->steps, i, h);
    else
      adamw_kernel<float><<<a->n_leaf_chunks, kOptThreads, 0, st>>>(
          leaves, chunks, a->gnorms + i, a->tables, a->steps, i, h);
    note();
  }
  if (a->bf16_moments) {
    moments_cast_kernel<<<a->n_leaf_chunks, kOptThreads, 0, st>>>(leaves, chunks, 0);
    note();
  }
  if (a->n_qk_chunks > 0) {
    blend_kernel<<<a->n_qk_chunks, kOptThreads, 0, st>>>(
        (const Blend*)a->blends, (const Chunk*)a->qk_chunks, a->qk_factor, 0.f);
    note();
  }
  if (a->n_ema_chunks > 0) {
    blend_kernel<<<a->n_ema_chunks, kOptThreads, 0, st>>>(
        (const Blend*)a->blends, (const Chunk*)a->ema_chunks, a->ema_keep, a->ema_take);
    note();
  }
  return (int)note.err;
}

// Calls of cuTensorMapEncodeTiled by this library so far (none: the epoch
// launches from the train step's plan).
extern "C" long long fd_tensor_map_encodes() { return fdh::map_encodes(); }

// One step's draws alone, into the caller's buffers (t_f, sa, s1a, eps,
// cond_mask, masks): the bits step `gstep` of an epoch with this seed uses.
extern "C" int fd_epoch_draws_launch(void* const* draw_bufs, const void* abar, const int* dims,
                                     int n_sched, float dropout, float mask_scale,
                                     float cond_dropout, unsigned long long seed,
                                     long long gstep, void* stream) {
  Dims d;
  std::vector<DrawPlan> draws;
  if (!read_dims(dims, &d) || n_sched < 1 ||
      !make_plan(d, (float* const*)draw_bufs, (const float*)abar, n_sched, dropout, mask_scale,
                 cond_dropout, &draws))
    return (int)cudaErrorInvalidValue;
  for (const DrawPlan& p : draws) {
    draws_kernel<<<p.blocks, kOptThreads, 0, (cudaStream_t)stream>>>(
        p, (uint32_t)seed, (uint32_t)(seed >> 32), (uint32_t)gstep);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The gradient norm alone, for tests: gnorm[0] = sqrt(sum over the leaves of sum g^2).
extern "C" int fd_grad_norm_launch(const void* leaves, const void* chunks, int n_chunks,
                                   void* partials, void* gnorm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Note note;
  sumsq_kernel<<<n_chunks, kOptThreads, 0, st>>>((const Leaf*)leaves, (const Chunk*)chunks,
                                                 (float*)partials);
  note();
  norm_kernel<<<1, 1024, 0, st>>>((const float*)partials, n_chunks, (float*)gnorm);
  note();
  return (int)note.err;
}

// One AdamW step alone, for tests: tables is (3, 1): lr, bc1, bc2; hyper is
// clip, wd, b1, b2, 1 - b1, 1 - b2, eps. With bf16 moments the leaves' m16 and
// v16 are updated, else m32 and v32.
extern "C" int fd_adamw_launch(const void* leaves, const void* chunks, int n_chunks,
                               const void* gnorm, const void* tables, const float* hyper,
                               int bf16_moments, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6]};
  if (bf16_moments)
    adamw_kernel<__nv_bfloat16><<<n_chunks, kOptThreads, 0, st>>>(
        (const Leaf*)leaves, (const Chunk*)chunks, (const float*)gnorm, (const float*)tables, 1,
        0, h);
  else
    adamw_kernel<float><<<n_chunks, kOptThreads, 0, st>>>(
        (const Leaf*)leaves, (const Chunk*)chunks, (const float*)gnorm, (const float*)tables, 1,
        0, h);
  return (int)cudaGetLastError();
}
