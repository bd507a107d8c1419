// One ancestral DDPM reverse step on one element, and its noise: the
// arithmetic of the reverse-step kernel (reverse_step.cu) and of the
// reverse-process kernel's last phase (reverse_process.cu), written once so
// that both give the same bits.
//
//   eps += skip                                            (v2 global skip, optional; to
//                                                            both halves when guided)
//   eps  = guided ? eps_u + s * (eps_c - eps_u) : eps      (CFG from the doubled batch)
//   eps  = clip_eps_for_x0(eps)                            (x0 clamp to [-c, c], optional)
//   mean = (x - (1 - a) / sqrt(1 - abar) * eps) / sqrt(a)
//   out  = mean + sqrt(beta) * z   where t > 0 and stochastic
//
// z: Philox4x32-10 keyed by the request's key, counter (group index, t, 0,
// 0), one call per 4 consecutive elements of the (B, L) state, through
// Box-Muller.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace fd {

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

// The four normals of element group `group` at step t.
__device__ __forceinline__ void step_noise(uint32_t group, int t, const uint32_t* key,
                                           float (&z)[4]) {
  uint32_t c[4] = {group, (uint32_t)t, 0u, 0u};
  philox4x32_10(c, key[0], key[1]);
  box_muller(c[0], c[1], &z[0], &z[1]);
  box_muller(c[2], c[3], &z[2], &z[3]);
}

// The normal of element i of the (B, L) state at step t: lane i % 4 of group
// i / 4, whatever row or block the group's other elements lie in.
__device__ __forceinline__ float element_noise(size_t i, int t, const uint32_t* key) {
  float z[4];
  step_noise((uint32_t)(i / 4), t, key, z);
  const int lane = (int)(i & 3);
  return lane == 0 ? z[0] : lane == 1 ? z[1] : lane == 2 ? z[2] : z[3];
}

// x_{t-1} of one element: x_t, eps (conditional when guided), eps_u (the
// null half's, read only when guided), skip (0 without the v2 skip).
__device__ __forceinline__ float step_mean(float xv, float e, float eu, float skip, bool guided,
                                           float scale, bool clip, float clip_val, float a,
                                           float ab, float beta, bool noisy, float z) {
  const float sq1mab = sqrtf(1.f - ab), sqab = sqrtf(ab);
  e += skip;
  if (guided) {
    eu += skip;
    e = eu + scale * (e - eu);
  }
  if (clip) {
    float x0 = (xv - sq1mab * e) / sqab;
    x0 = fminf(fmaxf(x0, -clip_val), clip_val);
    e = (xv - sqab * x0) / sq1mab;
  }
  float mean = (xv - ((1.f - a) / sq1mab) * e) / sqrtf(a);
  if (noisy) mean = mean + sqrtf(beta) * z;
  return mean;
}

}  // namespace fd
