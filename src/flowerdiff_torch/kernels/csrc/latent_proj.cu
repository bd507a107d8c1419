// The latent projection of one ancestral reverse step, for sm_90a.
//
// The first product of the Pallas kernel `_make_kernel` in
// flowerdiff/kernels/full_sampler.py, `h = _mm(x, wl, bl)` (`:118`): the
// (B, L) latent state through the denoiser's `latent_proj` into the first
// stage's input. With classifier-free guidance the TPU kernel runs the model
// twice on the same h; here the stage chain runs once on 2B rows, so the
// projection is written to rows r and B + r (`copies` = 2). For a v2 model it
// also computes the global skip of the model, sigmoid(rw) * (x Wf^T + bf)
// (`denoiser_apply.py:142-145`; the TPU kernel has no skip term, and the port
// follows the model), which `reverse_step` adds to both halves of eps.
//
// Products as the reference's `_mm`: x rounded to bf16, bf16 weights in
// PyTorch's (out, in) layout, f32 sums and bias. bf16 x bf16 products are
// exact in f32, so only the order of the sum differs from the plain twin.
//
// Bound on the card: at 64 rows and 256 x 256 the launch moves ~0.3 MB
// (two bf16 weights, x in, h twice and the skip out): ~0.1 us at 3.35 TB/s,
// and 8.4 MFLOP, ~0.01 us on the tensor cores. What is left is latency:
// the launch, one load round trip, the sum, the stores. The design keeps
// that chain short and puts the whole card on it. A block owns a tile of
// 16 rows x 16 columns (two m16n8 tiles), so at 64 rows the grid is 16 x 4
// = 64 blocks (128 with the skip). Its 8 warps split K into 32-wide chunks,
// warp w taking chunks w, w + 8, ...; every lane loads the fragments of its
// chunks straight into registers, the weight rows first (they do not depend
// on x) and then the x rows, all in flight before the first product. Each
// chunk is two `mma.sync` m16n8k16 bf16 steps a tile, f32 accumulators. The
// warps' partial tiles meet in shared memory and are added in warp order, so
// a repeat gives the same bits (no atomics); the epilogue adds the bias (or
// applies the skip's gate) and writes the CFG copies.
//
// Widths: any L and any H. The weights' rows are padded with zeros to ldw,
// L rounded up to a multiple of 8, at bind
// (kernels/full_sampler.py::bind_latent_proj), so every 16-byte weight load
// is aligned and whole; where L is not a multiple of 8, x is read a float at
// a time, zero past L. Above 2048 (8 warps x 8 chunks x 32) a block sums
// K in passes of 2048, as many as L needs, each loading its fragments as
// above, in the instance of its own (P = 0), so the narrower ones keep
// their code.
#include "rows.cuh"

namespace {

using fd::kThreads;
using fd::kWarps;
constexpr int kTileRows = 16;    // rows of x a block: one m16 tile
constexpr int kTileCols = 16;    // output columns a block: two n8 tiles
constexpr int kNTiles = kTileCols / 8;
constexpr int kChunk = 32;       // k's of a chunk: two m16n8k16 steps
constexpr int kPassK = 2048;     // 8 warps x 8 chunks x 32

// f32 (lo, hi) -> packed bf16x2, round to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Blocks [0, h_tiles) along x compute columns of h, the others columns of
// the skip. C: the k chunks a warp takes a pass (L <= 256 C P); P: passes
// of kPassK, or 0: as many as L needs.
//
// Fragments (the relabelling of fd::gemm_tc): within a 32-wide chunk, lane
// (g = lane / 4, t = lane % 4) holds the 8 contiguous k's 8t..8t+7 of x rows
// g and g + 8 and of weight row g of each n8 tile; its k's 8t..8t+3 serve as
// the logical k's {2t, 2t+1, 2t+8, 2t+9} of the first m16n8k16 step and
// 8t+4..8t+7 those of the second, the same on both sides.
template <int C, int P = 1>
__global__ void __launch_bounds__(kThreads)
latent_proj_kernel(const float* __restrict__ x, int B, int L, int ldw,
                   const __nv_bfloat16* __restrict__ wl, const float* __restrict__ bl, int H,
                   float* __restrict__ h, int copies, const __nv_bfloat16* __restrict__ wf,
                   const float* __restrict__ bf, const float* __restrict__ rw,
                   float* __restrict__ skip, int h_tiles) {
  __shared__ __align__(16) float red[kWarps][kTileRows * kTileCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool is_skip = (int)blockIdx.x >= h_tiles;
  const int n0 = (is_skip ? (int)blockIdx.x - h_tiles : (int)blockIdx.x) * kTileCols;
  const int N = is_skip ? L : H;
  const __nv_bfloat16* W = is_skip ? wf : wl;
  const int r0 = blockIdx.y * kTileRows;

  float acc[kNTiles][4];
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int passes = P ? P : (L + kPassK - 1) / kPassK;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int k0 = pass * kPassK;
    // every load of the block in flight before the first product: weights first
    uint4 wq[C][kNTiles];
    float4 xq[C][4];  // rows g (k 8t..8t+3, 8t+4..8t+7), then g + 8
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + (warp + kWarps * c) * kChunk + 8 * t;
#pragma unroll
      for (int i = 0; i < kNTiles; ++i) {
        const int n = n0 + 8 * i + g;
        wq[c][i] = make_uint4(0u, 0u, 0u, 0u);
        if (k < ldw && n < N)
          wq[c][i] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)n * ldw + k));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + (warp + kWarps * c) * kChunk + 8 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        const bool in = k < L && row < B;
        const float* p = x + (size_t)row * L + k;
        if (L % 8 == 0) {
          xq[c][2 * half] = in ? fd::ldg4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
          xq[c][2 * half + 1] = in ? fd::ldg4(p + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = in && k + e < L ? __ldg(p + e) : 0.f;
          xq[c][2 * half] = make_float4(v[0], v[1], v[2], v[3]);
          xq[c][2 * half + 1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }

#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (k0 + (warp + kWarps * c) * kChunk >= L) break;
      const float4 lo0 = xq[c][0], lo1 = xq[c][1], hi0 = xq[c][2], hi1 = xq[c][3];
      const uint32_t a_lo[4] = {pack_bf16(lo0.x, lo0.y), pack_bf16(lo0.z, lo0.w),
                                pack_bf16(lo1.x, lo1.y), pack_bf16(lo1.z, lo1.w)};
      const uint32_t a_hi[4] = {pack_bf16(hi0.x, hi0.y), pack_bf16(hi0.z, hi0.w),
                                pack_bf16(hi1.x, hi1.y), pack_bf16(hi1.z, hi1.w)};
#pragma unroll
      for (int i = 0; i < kNTiles; ++i) {
        fd::mma_bf16(acc[i], a_lo[0], a_hi[0], a_lo[1], a_hi[1], wq[c][i].x, wq[c][i].y);
        fd::mma_bf16(acc[i], a_lo[2], a_hi[2], a_lo[3], a_hi[3], wq[c][i].z, wq[c][i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) {
    const int n = 8 * i + 2 * t;
    *reinterpret_cast<float2*>(&red[warp][g * kTileCols + n]) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(&red[warp][(g + 8) * kTileCols + n]) =
        make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();

  // the warps' partials in warp order, then the epilogue
  for (int e = tid; e < kTileRows * kTileCols; e += kThreads) {
    const int col = n0 + e % kTileCols, row = r0 + e / kTileCols;
    if (row >= B || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][e];
    if (is_skip) {
      skip[(size_t)row * L + col] = (1.f / (1.f + expf(-rw[0]))) * (v + bf[col]);
      continue;
    }
    v += bl[col];
    for (int c = 0; c < copies; ++c) h[((size_t)c * B + row) * H + col] = v;
  }
}

// The launch floor of the same grid: no loads, no work.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

dim3 proj_grid(int B, int L, int H, bool with_skip) {
  const int h_tiles = (H + kTileCols - 1) / kTileCols;
  const int s_tiles = with_skip ? (L + kTileCols - 1) / kTileCols : 0;
  return dim3(h_tiles + s_tiles, (B + kTileRows - 1) / kTileRows);
}

}  // namespace

// x (B, L) f32; wl (H, ldw) bf16, bl (H) f32 -> h (copies * B, H) f32, the
// projection repeated `copies` times along the rows. wf (L, ldw) bf16, bf
// (L), rw (1) f32 and skip (B, L) f32, all null or all given: the v2 skip.
// L: any; ldw: L rounded up to a multiple of 8 (the weights' columns from L
// on zero).
extern "C" int fd_latent_proj_launch(const void* x, const void* wl, const void* bl,
                                     const void* wf, const void* bf, const void* rw,
                                     void* h, void* skip, int B, int L, int ldw, int H,
                                     int copies, void* stream) {
  if (B < 1 || L < 1 || ldw != (L + 7) / 8 * 8 || H < 1 || copies < 1 ||
      copies > 2 || ((wf == nullptr) != (skip == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = proj_grid(B, L, H, skip != nullptr);
  const int h_tiles = (H + kTileCols - 1) / kTileCols;
  const int chunks = (L + kWarps * kChunk - 1) / (kWarps * kChunk);  // a warp's
  decltype(&latent_proj_kernel<1>) kernel =
      chunks <= 1   ? &latent_proj_kernel<1>
      : chunks <= 2 ? &latent_proj_kernel<2>
      : chunks <= 4 ? &latent_proj_kernel<4>
      : chunks <= 8 ? &latent_proj_kernel<8>
                    : &latent_proj_kernel<8, 0>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, B, L, ldw, (const __nv_bfloat16*)wl, (const float*)bl, H, (float*)h, copies,
      (const __nv_bfloat16*)wf, (const float*)bf, (const float*)rw, (float*)skip, h_tiles);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid and block of fd_latent_proj_launch at the same
// arguments: the floor of the launch in any timer (measurement only).
extern "C" int fd_latent_proj_empty_launch(int B, int L, int H, int with_skip, void* stream) {
  empty_kernel<<<proj_grid(B, L, H, with_skip != 0), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
