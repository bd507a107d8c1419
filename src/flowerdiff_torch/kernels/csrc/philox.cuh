// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3"), the counter-based generator of every kernel here that draws noise:
// the reverse step (reverse_step.cu) and the epoch's draws (train_epoch.cu).
// A kernel keys it by the caller's seed and gives every (tensor, step,
// element group) its own counter, so no two draws share bits. The PyTorch
// twin is `philox4x32_10` in kernels/full_sampler.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fd {

// c: the 128-bit counter in, four 32-bit outputs back.
__device__ __forceinline__ void philox4x32_10(uint32_t (&c)[4], uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The top 24 bits of a draw as a uniform in [0, 1).
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

}  // namespace fd
