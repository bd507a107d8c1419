// The denoiser head of the sampler's step, for sm_90a: column tiles.
//
// Replaces the Pallas kernel `_head_kernel` of
// flowerdiff/kernels/latent_stage.py in the form the port's sampler step
// launches (kernels/full_sampler.py): the time and condition projections are
// folded into tables before the loop, so
//
//   out = bf16(LN(h + row_add + rows_add)) @ Wf^T + bf
//
// with h, rows_add (B, dl) f32, row_add (dl) f32, Wf (latent, dl) bf16 in
// PyTorch's (out, in) layout. The form with the t_base / c_base products
// (make_fast_denoiser) needs whole product rows before its LayerNorm and stays
// on csrc/latent_stage.cu::head_kernel; `bind_head` picks the kernel by form.
//
// Bound on the card: at 128 rows and 256 -> 256 the launch moves ~0.4 MB
// (h and rows_add in, out, 128 KB of Wf): ~0.16 us at 3.35 TB/s. What is
// left is latency, and the design spreads it over the card: a block owns 16
// rows and 16 output columns, so the grid is ceil(B / 16) x latent / 16 (8 x
// 16 = 128 blocks at 128 rows; 32 columns a block, 64 blocks, ran 7% slower
// on an H100). Each block computes the LayerNorm of its 16 rows itself (at
// the flagship's 256 columns a row; recomputing it in every column block
// costs less than any exchange between blocks) and reads only its 16-row
// slice of Wf
// (8 KB at dl = 256). The weight fragments do not depend
// on the rows, so each lane issues its loads of them first, straight into
// registers, then its row loads: every load of the block is in flight before
// the first result is used. A warp holds two whole rows for the LayerNorm
// (two-pass mean and centred square over warp shuffles) and writes them
// rounded to bf16 into a shared operand; after one barrier the 8 warps split
// K into 32-wide chunks (warp w: chunks w, w + 8), each two `mma.sync`
// m16n8k16 steps a n8 tile, and their partial tiles are added in warp order
// (no atomics: a repeat gives the same bits) before the bias and the store.
//
// Widths. Wf's rows are padded with zeros to ldw, a multiple of 32, at bind
// (kernels/latent_stage.py::bind_head), so every k chunk is whole and its
// 16-byte loads aligned. Up to dl = 512 in whole 32-column chunks a warp
// holds its two rows in registers, as above; any other dl up to 4096 (a
// ragged one, or one whose rows would not fit a lane's registers) is read
// in three passes over the row (sum, centred square, the normalised bf16
// operand), a float a lane at a time at the rows' own stride, the operand's
// columns past dl zero. Past 4096 (head_cols_pass_kernel) the statistics
// take a pass of their own over the row, then K runs in passes of 4096,
// each normalising its columns into the operand and loading their weight
// fragments before its products, the sums carried across the passes in
// the same chunk order; the latent is any width (its 16-column tiles).
#include "rows.cuh"

namespace {

using fd::kPad;
using fd::kRows;
using fd::kThreads;
using fd::kWarps;
constexpr int kCols = 16;           // output columns a block: two n8 tiles
constexpr int kNTiles = kCols / 8;
constexpr int kChunk = 32;          // k's of a chunk: two m16n8k16 steps
constexpr int kMaxDl = 4096;       // 8 warps x 16 chunks x 32
constexpr int kRegDl = 512;         // rows held in registers up to this width
constexpr int kRowsPerWarp = kRows / kWarps;

// V: float4s of a row a lane holds (dl <= 128 V), or 0: rows read in
// passes; C: a warp's k chunks (ldw <= 256 C).
template <int V, int C>
__global__ void __launch_bounds__(kThreads)
head_cols_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
                 const float* __restrict__ rows_add, const float* __restrict__ g,
                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ wf,
                 const float* __restrict__ bf, float* __restrict__ out, int B, int dl,
                 int ldw, int latent, float eps) {
  extern __shared__ __align__(16) __nv_bfloat16 Q[];  // kRows x (ldw + kPad)
  __shared__ __align__(16) float red[kWarps][kRows * kCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int lda = ldw + kPad;

  // 1. the block's slice of Wf, as this lane's fragments of its k chunks
  uint4 wq[C][kNTiles];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = (warp + kWarps * c) * kChunk + 8 * t;
#pragma unroll
    for (int i = 0; i < kNTiles; ++i) {
      const int n = n0 + 8 * i + gq;
      wq[c][i] = make_uint4(0u, 0u, 0u, 0u);
      if (k < ldw && n < latent)
        wq[c][i] = __ldg(reinterpret_cast<const uint4*>(wf + (size_t)n * ldw + k));
    }
  }
  if constexpr (V == 0) {
    // 2-3. each of the warp's two rows in three passes: its sum, its centred
    // square, its normalised bf16 operand (zeros from dl to ldw)
#pragma unroll 1
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + kWarps * s, row = row0 + r;
      auto x = [&](int i) {
        if (row >= B) return 0.f;
        float v = h[(size_t)row * dl + i];
        if (row_add) v += row_add[i];
        if (rows_add) v += rows_add[(size_t)row * dl + i];
        return v;
      };
      float sum = 0.f;
      for (int i = lane; i < dl; i += 32) sum += x(i);
      const float mean = fd::warp_sum(sum) / dl;
      float var = 0.f;
      for (int i = lane; i < dl; i += 32) {
        const float d0 = x(i) - mean;
        var += d0 * d0;
      }
      const float rstd = rsqrtf(fd::warp_sum(var) / dl + eps);
      for (int i = lane; i < ldw; i += 32)
        Q[r * lda + i] = __float2bfloat16_rn(i < dl ? (x(i) - mean) * rstd * g[i] + b[i] : 0.f);
    }
  } else {
    const int q = dl / 4;
    // 2. the warp's two rows (rows warp and warp + 8 of the tile), the adds and
    // the LayerNorm affine: float4 c = lane + 32 j of each
    float4 xr[kRowsPerWarp][V], ra[kRowsPerWarp][V], r1[V], gv[V], bv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const bool in = c < q;
#pragma unroll
      for (int s = 0; s < kRowsPerWarp; ++s) {
        const int row = row0 + warp + kWarps * s;
        const bool live = in && row < B;
        xr[s][j] = live ? fd::ldg4(h + (size_t)row * dl + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
        ra[s][j] = live && rows_add ? fd::ldg4(rows_add + (size_t)row * dl + 4 * c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      r1[j] = in && row_add ? fd::ldg4(row_add + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[j] = in ? fd::ldg4(g + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      bv[j] = in ? fd::ldg4(b + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // 3. LayerNorm of each row (biased variance, two passes), bf16 into Q
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + kWarps * s;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (lane + 32 * j < q) {
          xr[s][j] = fd::add4(fd::add4(xr[s][j], r1[j]), ra[s][j]);
          sum += (xr[s][j].x + xr[s][j].y) + (xr[s][j].z + xr[s][j].w);
        }
      }
      const float mean = fd::warp_sum(sum) / dl;
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (lane + 32 * j < q) {
          const float d0 = xr[s][j].x - mean, d1 = xr[s][j].y - mean, d2 = xr[s][j].z - mean,
                      d3 = xr[s][j].w - mean;
          var += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
      }
      const float rstd = rsqrtf(fd::warp_sum(var) / dl + eps);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = lane + 32 * j;
        if (c < q) {
          const float4 v = xr[s][j];
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(Q + r * lda + 4 * c);
          d[0] = __floats2bfloat162_rn((v.x - mean) * rstd * gv[j].x + bv[j].x,
                                       (v.y - mean) * rstd * gv[j].y + bv[j].y);
          d[1] = __floats2bfloat162_rn((v.z - mean) * rstd * gv[j].z + bv[j].z,
                                       (v.w - mean) * rstd * gv[j].w + bv[j].w);
        }
      }
    }
  }
  __syncthreads();

  // 4. the warp's k chunks of the 16 x kCols product (fragments as fd::gemm_tc)
  float acc[kNTiles][4];
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = (warp + kWarps * c) * kChunk;
    if (k >= ldw) break;
    const uint4 alo = fd::lds128(Q + gq * lda + k + 8 * t);
    const uint4 ahi = fd::lds128(Q + (gq + 8) * lda + k + 8 * t);
#pragma unroll
    for (int i = 0; i < kNTiles; ++i) {
      fd::mma_bf16(acc[i], alo.x, ahi.x, alo.y, ahi.y, wq[c][i].x, wq[c][i].y);
      fd::mma_bf16(acc[i], alo.z, ahi.z, alo.w, ahi.w, wq[c][i].z, wq[c][i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) {
    const int n = 8 * i + 2 * t;
    *reinterpret_cast<float2*>(&red[warp][gq * kCols + n]) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(&red[warp][(gq + 8) * kCols + n]) =
        make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();

  // 5. the partials in warp order, the bias, the store
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, col = n0 + e % kCols, row = row0 + r;
    if (row >= B || col >= latent) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][e];
    out[(size_t)row * latent + col] = v + bf[col];
  }
}

// The head past kMaxDl: LayerNorm statistics in a pass over the row, then K
// in passes of kMaxDl (16 chunks a warp), each its operand's columns
// normalised into Q (kRows x (kMaxDl + kPad)) and its weight fragments
// loaded, then its products; a warp's chunks in the order of one pass over
// all of K (warp w: chunks w, w + 8, ...), the partials added in warp order.
__global__ void __launch_bounds__(kThreads)
head_cols_pass_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
                      const float* __restrict__ rows_add, const float* __restrict__ g,
                      const float* __restrict__ b, const __nv_bfloat16* __restrict__ wf,
                      const float* __restrict__ bf, float* __restrict__ out, int B, int dl,
                      int ldw, int latent, float eps) {
  constexpr int C = kMaxDl / (kWarps * kChunk);  // a warp's chunks a pass
  extern __shared__ __align__(16) __nv_bfloat16 Q[];  // kRows x (kMaxDl + kPad)
  __shared__ __align__(16) float red[kWarps][kRows * kCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int lda = kMaxDl + kPad;

  // the warp's two rows: h + row_add + rows_add a float at a time
  auto x = [&](int s, int i) {
    const int row = row0 + warp + kWarps * s;
    if (row >= B) return 0.f;
    float v = h[(size_t)row * dl + i];
    if (row_add) v += row_add[i];
    if (rows_add) v += rows_add[(size_t)row * dl + i];
    return v;
  };
  // 1. their statistics: sum, then centred square
  float mean[kRowsPerWarp], rstd[kRowsPerWarp];
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) {
    float sum = 0.f;
    for (int i = lane; i < dl; i += 32) sum += x(s, i);
    mean[s] = fd::warp_sum(sum) / dl;
    float var = 0.f;
    for (int i = lane; i < dl; i += 32) {
      const float d0 = x(s, i) - mean[s];
      var += d0 * d0;
    }
    rstd[s] = rsqrtf(fd::warp_sum(var) / dl + eps);
  }
  float acc[kNTiles][4];
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < ldw; k0 += kMaxDl) {
    const int kw = ldw - k0 < kMaxDl ? ldw - k0 : kMaxDl;
    // 2. the pass's weight fragments (16-byte loads) and its normalised operand
    uint4 wq[C][kNTiles];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = (warp + kWarps * c) * kChunk + 8 * t;
#pragma unroll
      for (int i = 0; i < kNTiles; ++i) {
        const int n = n0 + 8 * i + gq;
        wq[c][i] = make_uint4(0u, 0u, 0u, 0u);
        if (k < kw && n < latent)
          wq[c][i] = __ldg(reinterpret_cast<const uint4*>(wf + (size_t)n * ldw + k0 + k));
      }
    }
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + kWarps * s;
      for (int i = lane; i < kw; i += 32) {
        const int col = k0 + i;
        Q[r * lda + i] = __float2bfloat16_rn(
            col < dl ? (x(s, col) - mean[s]) * rstd[s] * g[col] + b[col] : 0.f);
      }
    }
    __syncthreads();
    // 3. the warp's chunks of the pass
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = (warp + kWarps * c) * kChunk;
      if (k >= kw) break;
      const uint4 alo = fd::lds128(Q + gq * lda + k + 8 * t);
      const uint4 ahi = fd::lds128(Q + (gq + 8) * lda + k + 8 * t);
#pragma unroll
      for (int i = 0; i < kNTiles; ++i) {
        fd::mma_bf16(acc[i], alo.x, ahi.x, alo.y, ahi.y, wq[c][i].x, wq[c][i].y);
        fd::mma_bf16(acc[i], alo.z, ahi.z, alo.w, ahi.w, wq[c][i].z, wq[c][i].w);
      }
    }
    __syncthreads();  // the operand read before the next pass rewrites it
  }
#pragma unroll
  for (int i = 0; i < kNTiles; ++i) {
    const int n = 8 * i + 2 * t;
    *reinterpret_cast<float2*>(&red[warp][gq * kCols + n]) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(&red[warp][(gq + 8) * kCols + n]) =
        make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();
  // 4. the partials in warp order, the bias, the store
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, col = n0 + e % kCols, row = row0 + r;
    if (row >= B || col >= latent) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][e];
    out[(size_t)row * latent + col] = v + bf[col];
  }
}

// The launch floor of the same grid: no loads, no work.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

dim3 head_grid(int B, int latent) {
  return dim3((latent + kCols - 1) / kCols, (B + kRows - 1) / kRows);
}

using HeadKernel = decltype(&head_cols_kernel<2, 1>);

// The instance for (dl, ldw), its dynamic shared memory allowed once.
cudaError_t head_instance(int dl, int ldw, size_t smem, HeadKernel* kernel) {
  static size_t configured[7] = {};
  int i;
  if (dl % kChunk == 0 && dl <= kRegDl) {
    i = dl <= 256 ? 0 : 1;
    *kernel = dl <= 256 ? &head_cols_kernel<2, 1> : &head_cols_kernel<4, 2>;
  } else {
    const int c = (ldw + kWarps * kChunk - 1) / (kWarps * kChunk);
    i = c <= 1 ? 2 : c <= 2 ? 3 : c <= 4 ? 4 : c <= 8 ? 5 : 6;
    *kernel = c <= 1   ? &head_cols_kernel<0, 1>
              : c <= 2 ? &head_cols_kernel<0, 2>
              : c <= 4 ? &head_cols_kernel<0, 4>
              : c <= 8 ? &head_cols_kernel<0, 8>
                       : &head_cols_kernel<0, 16>;
  }
  if (smem <= 48 * 1024 || smem <= configured[i]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured[i] = smem;
  return err;
}

}  // namespace

// h (B, dl), rows_add (B, dl) and row_add (dl) f32, either add may be null;
// g, b (dl), bf (latent) f32; wf (latent, ldw) bf16, its columns from dl on
// zero -> out (B, latent) f32. dl: any (past 4096 in K passes); ldw: dl
// rounded up to a multiple of 32; latent: any.
extern "C" int fd_head_cols_launch(const void* h, const void* row_add, const void* rows_add,
                                   const void* g, const void* b, const void* wf,
                                   const void* bf, void* out, int B, int dl, int ldw, int latent,
                                   float eps, void* stream) {
  if (B < 1 || dl < 1 || ldw % kChunk || ldw < dl || ldw - dl >= kChunk || latent < 1)
    return (int)cudaErrorInvalidValue;
  if (dl > kMaxDl) {
    static size_t configured = 0;
    const size_t smem = sizeof(__nv_bfloat16) * kRows * (size_t)(kMaxDl + kPad);
    if (smem > configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          head_cols_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      configured = smem;
    }
    head_cols_pass_kernel<<<head_grid(B, latent), kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)h, (const float*)row_add, (const float*)rows_add, (const float*)g,
        (const float*)b, (const __nv_bfloat16*)wf, (const float*)bf, (float*)out, B, dl, ldw,
        latent, eps);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(__nv_bfloat16) * kRows * (size_t)(ldw + kPad);
  HeadKernel kernel = nullptr;
  const cudaError_t err = head_instance(dl, ldw, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<head_grid(B, latent), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)row_add, (const float*)rows_add, (const float*)g,
      (const float*)b, (const __nv_bfloat16*)wf, (const float*)bf, (float*)out, B, dl, ldw,
      latent, eps);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid and block of fd_head_cols_launch (measurement
// only: the floor of the launch in any timer).
extern "C" int fd_head_cols_empty_launch(int B, int latent, void* stream) {
  empty_kernel<<<head_grid(B, latent), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
