// One ancestral DDPM reverse step, fused, for sm_90a.
//
// The per-step tail of the Pallas kernel `_make_kernel` in
// flowerdiff/kernels/full_sampler.py (its in-kernel step), applied
// elementwise over the (B, L) latent state:
//
//   eps += skip                                            (v2 global skip, optional; to
//                                                            both halves when guided)
//   eps  = guided ? eps_u + s * (eps_c - eps_u) : eps      (CFG from the doubled batch)
//   eps  = clip_eps_for_x0(eps)                            (x0 clamp to [-c, c], optional)
//   mean = (x - (1 - a) / sqrt(1 - abar) * eps) / sqrt(a)
//   out  = mean + sqrt(beta) * z   where t > 0 and stochastic
//
// z is drawn here: Philox4x32-10 keyed by the request's key, two 32-bit
// words read from device memory (as the TPU kernel reads its seed from an
// input ref), counter (group index, t, 0, 0), one call per 4 consecutive
// elements, through Box-Muller. With the key in memory a CUDA graph of the
// step loop serves any request: a replay reads the key its caller copied in.
// The TPU kernel drew from the core's own generator; the stream differs by
// design, the distribution does not.
//
// Bound on the card: bytes (3 f32 reads / writes an element, a few dozen
// flops); at the sampler's 64 x 256 state the launch itself dominates.
// One thread handles 4 elements so each Philox call feeds 4 normals.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// Box-Muller on two 32-bit draws: u1 in (0, 1], u2 in [0, 1), 24 bits each.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* z0, float* z1) {
  const float inv24 = 1.0f / 16777216.0f;
  const float u1 = (float)((a >> 8) + 1u) * inv24;
  const float u2 = (float)(b >> 8) * inv24;
  const float rad = sqrtf(-2.0f * logf(u1));
  const float th = 6.28318530717958647692f * u2;
  *z0 = rad * cosf(th);
  *z1 = rad * sinf(th);
}

__global__ void __launch_bounds__(kThreads)
reverse_step_kernel(const float* __restrict__ eps, const float* __restrict__ skip,
                    const float* __restrict__ x, float* __restrict__ out, int n, int guided,
                    float scale, int clip, float clip_val, float a, float ab, float beta,
                    int t, int stochastic, const uint32_t* __restrict__ key) {
  const uint32_t group = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = (int)group * 4;
  if (base >= n) return;
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  const bool noisy = stochastic && t > 0;
  if (noisy) {
    uint32_t c[4] = {group, (uint32_t)t, 0u, 0u};
    fd::philox4x32_10(c, key[0], key[1]);
    box_muller(c[0], c[1], &z[0], &z[1]);
    box_muller(c[2], c[3], &z[2], &z[3]);
  }
  const float sq1mab = sqrtf(1.f - ab), sqab = sqrtf(ab);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = base + j;
    if (i >= n) break;
    const float xv = x[i];
    float e = eps[i];
    if (skip) e += skip[i];
    if (guided) {
      float eu = eps[n + i];
      if (skip) eu += skip[i];
      e = eu + scale * (e - eu);
    }
    if (clip) {
      float x0 = (xv - sq1mab * e) / sqab;
      x0 = fminf(fmaxf(x0, -clip_val), clip_val);
      e = (xv - sqab * x0) / sq1mab;
    }
    float mean = (xv - ((1.f - a) / sq1mab) * e) / sqrtf(a);
    if (noisy) mean = mean + sqrtf(beta) * z[j];
    out[i] = mean;
  }
}

}  // namespace

// skip: null, or (B, L) f32 added to eps (to both halves when guided);
// key: two 32-bit words in device memory, the Philox key.
extern "C" int fd_reverse_step_launch(const void* eps, const void* skip, const void* x,
                                      void* out, int n, int guided, float scale, int clip,
                                      float clip_val, float a, float ab, float beta, int t,
                                      int stochastic, const void* key, void* stream) {
  const int groups = (n + 3) / 4;
  const dim3 grid((groups + kThreads - 1) / kThreads);
  reverse_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)eps, (const float*)skip, (const float*)x, (float*)out, n, guided, scale,
      clip, clip_val,
      a, ab, beta, t, stochastic, (const uint32_t*)key);
  return (int)cudaGetLastError();
}
