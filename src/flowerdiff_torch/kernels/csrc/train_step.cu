// The train step's C interface: the plan of a bound step (`fd_step_plan_*`),
// `fd_train_step_launch` and, for tests and the timing tools, the product and
// the LayerNorm kernels alone. The kernels, the plans and the sequence of
// launches are in train_step.cuh, which train_epoch.cu shares.
#include "train_step.cuh"

extern "C" long long fd_train_step_workspace_floats(const int* dims) {
  Dims d;
  if (!read_dims(dims, &d)) return -1;
  Workspace w;
  layout(d, nullptr, &w);
  return (long long)w.floats;
}

// The plan of a step bound to these weights, gradients (11 + 14 n_stages + 9
// pointers each, `weights_spec` order) and workspace
// (fd_train_step_workspace_floats floats); dims: B, latent, time_emb,
// classes, n_stages, hidden[0..n_stages]. Every product's route is chosen
// and every tensor map of the TMA routes encoded here, once. Null, with
// *err, where a product is refused. Free with fd_step_plan_free; the
// pointers must stay valid as long as the plan.
extern "C" void* fd_step_plan_create(const void* const* weights, void* const* grads,
                                     void* workspace, const int* dims, int f32_lane,
                                     int global_skip, float ln_eps, int* err) {
  cudaError_t e;
  StepPlan* p = make_step_plan(weights, grads, workspace, dims, f32_lane, global_skip, ln_eps, &e);
  *err = (int)e;
  return p;
}

extern "C" void fd_step_plan_free(void* plan) { delete (StepPlan*)plan; }

// The plan's products in launch order, kPlanCols ints a row: form (0 Y,
// 1 dX, 2 dW), M, N, K, the line strides of A, B and C, kernel (0 f32 FMA,
// 1 split-K, 2 wgmma, 3 mma_dw), split, kc, blocks. Writes at most
// `max_rows` rows; returns the number of products.
constexpr int kPlanCols = 11;
extern "C" int fd_step_plan_products(const void* plan, int* out, int max_rows) {
  const StepPlan& p = *(const StepPlan*)plan;
  const int n = (int)p.products.size();
  for (int i = 0; i < n && i < max_rows; ++i) {
    const Product& q = p.products[i];
    const int row[kPlanCols] = {q.form,
                                q.M,
                                q.N,
                                q.K,
                                (int)(q.form == kFormDw ? q.a_sk : q.a_sm),
                                (int)(q.form == kFormY ? q.b_sn : q.b_sk),
                                q.N,
                                q.plan.kernel,
                                q.plan.split,
                                q.plan.kc,
                                q.plan.blocks};
    for (int c = 0; c < kPlanCols; ++c) out[i * kPlanCols + c] = row[c];
  }
  return n;
}

// One step of the plan on `stream`: data z, t_f, sa, s1a, eps, labels
// (int32), cond_mask, freqs; masks: block and attention mask of each stage;
// loss: one f32. Encodes nothing.
extern "C" int fd_train_step_launch(const void* plan, const void* const* data,
                                    const void* const* masks, void* loss, void* stream) {
  if (!plan) return (int)cudaErrorInvalidValue;
  return (int)train_step_enqueue(*(const StepPlan*)plan, data, masks, loss,
                                 (cudaStream_t)stream);
}

// Calls of cuTensorMapEncodeTiled by this library so far.
extern "C" long long fd_tensor_map_encodes() { return fdh::map_encodes(); }

// The product alone, for tests and timing: C (M, N) = epilogue(sum_k A(m, k)
// B(n, k)) of form 0 (Y), 1 (dX) or 2 (dW). route: the plan's kernel (0), or
// for the bf16 lane the split-K (1), wgmma (2) or mma_dw (3) kernel forced;
// a route the product cannot take is refused. A one-product plan, its maps
// encoded for this call.
extern "C" int fd_gemm_launch(int form, const void* A, long long a_sm, long long a_sk,
                              const void* B, long long b_sn, long long b_sk, void* C, int M,
                              int N, int K, const void* bias, float bias_scale, int round_bf16,
                              const void* mul, const void* res, void* colsum,
                              float colsum_scale, int f32_lane, int route, void* stream) {
  if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  const Epilogue ep{(const float*)bias, bias_scale, round_bf16, (const float*)mul,
                    (const float*)res, (float*)colsum, colsum_scale};
  StepPlan one;
  for (int pass = 0; pass < 2; ++pass) {  // plan, then launch
    Run run{(cudaStream_t)stream, f32_lane != 0, cudaSuccess};
    if (pass == 0) run.rec = &one;
    else run.plan = &one;
    run.gemm(f32_lane != 0, form, (const float*)A, (long)a_sm, (long)a_sk, (const float*)B,
             (long)b_sn, (long)b_sk, (float*)C, M, N, K, ep, route);
    if (run.err != cudaSuccess) return (int)run.err;
  }
  return 0;
}

// An empty kernel on the launch (grid, block, shared memory, cluster) that
// fd_gemm_launch makes for a product of this form (0 Y, 1 dX, 2 dW) on
// contiguous tensors: a product's launch floor.
extern "C" int fd_gemm_empty_launch(int form, int M, int N, int K, int f32_lane, int route,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  Run run{(cudaStream_t)stream, f32_lane != 0, cudaSuccess};
  run.gemm_empty(f32_lane != 0, form, M, N, K, route);
  return (int)run.err;
}

// The plan of a product of this form (0 Y, 1 dX, 2 dW; `product_plan`) whose
// operands have line strides a_ld, b_ld, c_ld (elements; tensor maps read
// them where each is a whole number of 16-byte units): out = kernel (0 f32
// FMA, 1 split-K, 2 wgmma, 3 mma_dw), tile_m, tile_n, split (blocks a
// cluster), kc (k's a block sums), blocks launched. A refused route is an
// error.
extern "C" int fd_product_plan(int f32_lane, int form, int M, int N, int K, long long a_ld,
                               long long b_ld, long long c_ld, int route, int* out) {
  ProductPlan p;
  if (M < 1 || N < 1 || K < 1 || form < 0 || form > 2 ||
      !product_plan(f32_lane != 0, form, M, N, K,
                    tma_stride((long)a_ld) && tma_stride((long)b_ld) && tma_stride((long)c_ld),
                    route, &p))
    return (int)cudaErrorInvalidValue;
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
