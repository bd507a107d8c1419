// One ancestral DDPM reverse step, fused, for sm_90a.
//
// The per-step tail of the Pallas kernel `_make_kernel` in
// flowerdiff/kernels/full_sampler.py (its in-kernel step), applied
// elementwise over the (B, L) latent state: the skip, CFG, the x0 clip, the
// posterior mean and the noise (reverse_step.cuh, whose arithmetic the
// reverse-process kernel shares).
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

#include "reverse_step.cuh"

namespace {

constexpr int kThreads = 256;

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
  if (noisy) fd::step_noise(group, t, key, z);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = base + j;
    if (i >= n) break;
    out[i] = fd::step_mean(x[i], eps[i], guided ? eps[n + i] : 0.f, skip ? skip[i] : 0.f,
                           guided != 0, scale, clip != 0, clip_val, a, ab, beta, noisy, z[j]);
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
