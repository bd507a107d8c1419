// The train step's C interface: `fd_train_step_launch` and, for tests, the
// product and the LayerNorm kernels alone. The kernels and the sequence of
// launches are in train_step.cuh, which train_epoch.cu shares.
#include "train_step.cuh"

extern "C" long long fd_train_step_workspace_floats(const int* dims) {
  Dims d;
  if (!read_dims(dims, &d)) return -1;
  Workspace w;
  layout(d, nullptr, &w);
  return (long long)w.floats;
}

// dims: B, latent, time_emb, classes, n_stages, hidden[0..n_stages]; the other
// arguments as `train_step_enqueue` takes them.
extern "C" int fd_train_step_launch(const void* const* weights, void* const* grads,
                                    const void* const* data, const void* const* masks,
                                    void* workspace, void* loss, const int* dims,
                                    int f32_lane, int global_skip, float ln_eps,
                                    void* stream) {
  Dims d;
  if (!read_dims(dims, &d)) return (int)cudaErrorInvalidValue;
  return (int)train_step_enqueue(weights, grads, data, masks, workspace, loss, d, f32_lane,
                                 global_skip, ln_eps, (cudaStream_t)stream);
}

// The product alone, for tests and timing: C (M, N) = epilogue(sum_k A(m, k)
// B(n, k)). route: the plan's kernel (0), or for the bf16 lane's Y and dX
// forms the split-K kernel (1) or the wgmma kernel (2) forced.
extern "C" int fd_gemm_launch(const void* A, long long a_sm, long long a_sk, const void* B,
                              long long b_sn, long long b_sk, void* C, int M, int N, int K,
                              const void* bias, float bias_scale, int round_bf16,
                              const void* mul, const void* res, void* colsum,
                              float colsum_scale, int f32_lane, int route, void* stream) {
  Run run{(cudaStream_t)stream, f32_lane != 0, cudaSuccess};
  run.gemm(f32_lane != 0, (const float*)A, (long)a_sm, (long)a_sk, (const float*)B,
           (long)b_sn, (long)b_sk, (float*)C, M, N, K,
           Epilogue{(const float*)bias, bias_scale, round_bf16, (const float*)mul,
                    (const float*)res, (float*)colsum, colsum_scale},
           route);
  return (int)run.err;
}

// An empty kernel on the launch (grid, block, shared memory, cluster) that
// fd_gemm_launch makes for a product of this form (0 Y, 1 dX, 2 dW): a
// product's launch floor.
extern "C" int fd_gemm_empty_launch(int form, int M, int N, int K, int f32_lane, int route,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  Run run{(cudaStream_t)stream, f32_lane != 0, cudaSuccess};
  run.gemm_empty(f32_lane != 0, form, M, N, K, route);
  return (int)run.err;
}

// The plan of a product of this form (0 Y, 1 dX, 2 dW; `product_plan`): out =
// kernel (0 f32 FMA, 1 split-K, 2 wgmma), tile_m, tile_n, split (blocks a
// cluster), kc (k's a block sums), blocks launched.
extern "C" int fd_product_plan(int f32_lane, int form, int M, int N, int K, int route,
                               int* out) {
  if (M < 1 || N < 1 || K < 1 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  const ProductPlan p =
      product_plan(f32_lane != 0, form == kFormDw, form == kFormY, M, N, K, route);
  const int v[6] = {p.kernel, p.tile_m, p.tile_n, p.split, p.kc, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The split-K plan of the bf16 lane's Y and dX forms over K (`splitk_plan`).
extern "C" int fd_splitk_plan(int K, int* s, int* kc) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  splitk_plan(K, s, kc);
  return 0;
}

// LayerNorm forward and backward alone, for tests (see ln_fwd_kernel).
extern "C" int fd_ln_fwd_launch(const void* x, const void* g, const void* b, const void* mask,
                                int swish, const void* res, void* y, void* mean, void* rstd,
                                int rows, int d, float eps, void* stream) {
  Run run{(cudaStream_t)stream, false, cudaSuccess};
  run.ln_fwd((const float*)x, (const float*)g, (const float*)b, (const float*)mask, swish,
             (const float*)res, (float*)y, (float*)mean, (float*)rstd, rows, d, eps);
  return (int)run.err;
}

extern "C" int fd_ln_bwd_launch(const void* dy, const void* x, const void* mean,
                                const void* rstd, const void* g, const void* b,
                                const void* mask, int swish, const void* res, void* dyhat,
                                void* dx, void* dgamma, void* dbeta, int rows, int d,
                                void* stream) {
  Run run{(cudaStream_t)stream, false, cudaSuccess};
  run.ln_bwd((const float*)dy, (const float*)x, (const float*)mean, (const float*)rstd,
             (const float*)g, (const float*)b, (const float*)mask, swish, (const float*)res,
             (float*)dyhat, (float*)dx, (float*)dgamma, (float*)dbeta, rows, d);
  return (int)run.err;
}
