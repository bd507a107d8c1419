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
// exact in f32, so only the order of the sum (k ascending, one FMA chain a
// thread) differs from the plain twin.
//
// Bound on the card: at 64 rows and 256 x 256 the launch moves ~0.3 MB
// (two bf16 weights, x in, h twice and the skip out): ~0.1 us at 3.35 TB/s.
// Its time is the latency of one load round trip and a 256-long FMA chain;
// the design puts every load of a block in flight at once (16-byte loads of
// x and of the weight rows into shared memory), then reduces from there with
// wide shared-memory reads: per 4 k's one 8-byte read of the lane's weight
// row and two 16-byte broadcasts of x for 8 FMAs (one read an FMA made the
// first version bound by shared-memory reads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRows = 16;   // rows of x a block
constexpr int kBlockCols = 32;   // output columns a block, one a lane
constexpr int kMaxLatent = 1024;

// Shared memory: x rows as f32 (bf16-rounded, rows 16-byte aligned), weight
// rows as bf16 padded by 4, so that the lanes' 8-byte reads of their rows
// fall in distinct banks.
size_t smem_bytes(int L) {
  return sizeof(float) * kBlockRows * (L + 4) + sizeof(__nv_bfloat16) * kBlockCols * (L + 4);
}

// Blocks [0, h_tiles) compute columns of h, the others columns of the skip.
__global__ void __launch_bounds__(kThreads)
latent_proj_kernel(const float* __restrict__ x, int B, int L,
                   const __nv_bfloat16* __restrict__ wl, const float* __restrict__ bl, int H,
                   float* __restrict__ h, int copies, const __nv_bfloat16* __restrict__ wf,
                   const float* __restrict__ bf, const float* __restrict__ rw,
                   float* __restrict__ skip, int h_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem + sizeof(float) * kBlockRows * (L + 4));
  const int tid = threadIdx.x;
  const bool is_skip = (int)blockIdx.x >= h_tiles;
  const int n0 = (is_skip ? (int)blockIdx.x - h_tiles : (int)blockIdx.x) * kBlockCols;
  const int N = is_skip ? L : H;
  const __nv_bfloat16* W = is_skip ? wf : wl;
  const int r0 = blockIdx.y * kBlockRows;

  // x rows r0.. and weight rows n0.., 16 bytes a load, all in flight at once
  const int xq = L / 4, wq = L / 8;
  for (int i = tid; i < kBlockRows * xq; i += kThreads) {
    const int r = i / xq, c = (i - r * xq) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < B) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * L + c));
    *reinterpret_cast<float4*>(xs + r * (L + 4) + c) = make_float4(
        __bfloat162float(__float2bfloat16(v.x)), __bfloat162float(__float2bfloat16(v.y)),
        __bfloat162float(__float2bfloat16(v.z)), __bfloat162float(__float2bfloat16(v.w)));
  }
  for (int i = tid; i < kBlockCols * wq; i += kThreads) {
    const int n = i / wq, c = (i - n * wq) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + n < N) v = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(n0 + n) * L + c));
    // rows of L + 4 bf16 start on 8-byte boundaries: two 8-byte stores
    uint2* d = reinterpret_cast<uint2*>(ws + n * (L + 4) + c);
    d[0] = make_uint2(v.x, v.y);
    d[1] = make_uint2(v.z, v.w);
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;  // column n0 + lane, rows warp and warp + 8
  const float* xa = xs + warp * (L + 4);
  const float* xb = xa + 8 * (L + 4);
  const __nv_bfloat16* wr = ws + lane * (L + 4);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < L; k += 4) {
    const uint2 wq4 = *reinterpret_cast<const uint2*>(wr + k);
    const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wq4.x));
    const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wq4.y));
    const float4 p = *reinterpret_cast<const float4*>(xa + k);
    const float4 q = *reinterpret_cast<const float4*>(xb + k);
    a0 = fmaf(p.x, w01.x, a0);
    a0 = fmaf(p.y, w01.y, a0);
    a0 = fmaf(p.z, w23.x, a0);
    a0 = fmaf(p.w, w23.y, a0);
    a1 = fmaf(q.x, w01.x, a1);
    a1 = fmaf(q.y, w01.y, a1);
    a1 = fmaf(q.z, w23.x, a1);
    a1 = fmaf(q.w, w23.y, a1);
  }
  const int n = n0 + lane;
  if (n >= N) return;
  if (is_skip) {
    const float s = 1.f / (1.f + expf(-rw[0]));
    const float bn = bf[n];
    if (r0 + warp < B) skip[(size_t)(r0 + warp) * L + n] = s * (a0 + bn);
    if (r0 + warp + 8 < B) skip[(size_t)(r0 + warp + 8) * L + n] = s * (a1 + bn);
    return;
  }
  const float bn = bl[n];
  for (int c = 0; c < copies; ++c) {
    const size_t base = (size_t)c * B;
    if (r0 + warp < B) h[(base + r0 + warp) * H + n] = a0 + bn;
    if (r0 + warp + 8 < B) h[(base + r0 + warp + 8) * H + n] = a1 + bn;
  }
}

// the dynamic shared memory the kernel is allowed on each device so far
constexpr int kMaxDevices = 64;
std::atomic<size_t> g_configured_smem[kMaxDevices];

}  // namespace

// x (B, L) f32; wl (H, L) bf16, bl (H) f32 -> h (copies * B, H) f32, the
// projection repeated `copies` times along the rows. wf (L, L) bf16, bf (L),
// rw (1) f32 and skip (B, L) f32, all null or all given: the v2 skip.
// L: a multiple of 8, at most 1024.
extern "C" int fd_latent_proj_launch(const void* x, const void* wl, const void* bl,
                                     const void* wf, const void* bf, const void* rw,
                                     void* h, void* skip, int B, int L, int H, int copies,
                                     void* stream) {
  if (B < 1 || L % 8 || L > kMaxLatent || H < 1 || copies < 1 || copies > 2 ||
      ((wf == nullptr) != (skip == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || smem > g_configured_smem[dev].load()) {
      err = cudaFuncSetAttribute(latent_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) g_configured_smem[dev].store(smem);
    }
  }
  const int h_tiles = (H + kBlockCols - 1) / kBlockCols;
  const int s_tiles = skip ? (L + kBlockCols - 1) / kBlockCols : 0;
  const dim3 grid(h_tiles + s_tiles, (B + kBlockRows - 1) / kBlockRows);
  latent_proj_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, B, L, (const __nv_bfloat16*)wl, (const float*)bl, H, (float*)h, copies,
      (const __nv_bfloat16*)wf, (const float*)bf, (const float*)rw, (float*)skip, h_tiles);
  return (int)cudaGetLastError();
}
