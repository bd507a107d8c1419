// Fused latent-denoiser stage and head kernels for sm_90a.
//
// Replace the Pallas kernels `_stage_kernel` and `_head_kernel` of
// flowerdiff/kernels/latent_stage.py:
//
//   stage: h = h + row_add + rows_add
//          h = h + swish(LN1(bf16(h) @ Wb + bb))
//          h = h + (bf16(bf16(LN2(h)) @ Wv + bv) @ Wo + bo)
//          out = bf16(h) @ Wd + bd
//   head:  h = h + row_add + rows_add [+ bf16(t_base) @ Wt + bt] [+ bf16(c_base) @ Wc + bc]
//          out = bf16(LN(h)) @ Wf + bf
//
// Weights are bf16 in PyTorch's Linear layout (out, in); everything else f32.
//
// Bound on the card: at the sampler's 128 rows a stage reads up to 7.3 MB
// of bf16 weights for 2 x 128 x 3.67 M flops, ~68 flops a byte, far below
// the H100's ~295 bf16 flops a byte: the ideal kernel is bound by weight
// bytes. LayerNorm needs whole rows, which on the TPU sat in one core's
// VMEM.
//
// Stage design: a cluster of kCluster blocks owns fd::kRows = 16 whole rows
// (one m16 tile). Every block keeps the rows' full residual stream in its
// shared memory and computes 1/kCluster of each product's columns on the
// tensor cores (fd::gemm_tc), so each weight byte is read by one block of
// the cluster, once per 16 rows; after each product the blocks exchange
// their column slices through distributed shared memory (DSMEM), and
// LayerNorm then runs on whole rows in every block. At 128 rows that is 8
// clusters, 64 blocks. TMA, wgmma and a persistent, L2-resident design are
// later work.
//
// Head design: one block owns 16 whole rows and all columns (the head's
// products are at most 512 wide).
#include <cooperative_groups.h>

#include "rows.cuh"

namespace cg = cooperative_groups;
using fd::kPad;
using fd::kRows;
using fd::kThreads;

namespace {

constexpr int kCluster = 8;

// Split cluster barrier: arrive early, wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every block's column slice S (kRows x sw f32) -> the full rows in this
// block: into F (kRows x kCluster*sw f32) or, when F is null, into the bf16
// product operand Q (row stride kCluster*sw + kPad). Each thread loads its
// float4 of all kCluster slices before it stores any.
//
// One cluster barrier a gather: the products alternate between two slice
// buffers, so a block that has passed this barrier knows every block has
// finished the gather before, which read the buffer it writes next. After
// the last gather each block arrives at one more barrier and waits on it
// only before it exits, so that no block's shared memory goes while another
// still reads it.
__device__ void cluster_gather(cg::cluster_group& cluster, float* S, int sw, float* F,
                               __nv_bfloat16* Q, bool last) {
  cluster.sync();  // every slice written
  const float4* remote[kCluster];
#pragma unroll
  for (int j = 0; j < kCluster; ++j)
    remote[j] = reinterpret_cast<const float4*>(cluster.map_shared_rank(S, j));
  const int width = sw * kCluster, q4 = sw / 4;
  for (int i = threadIdx.x; i < kRows * q4; i += kThreads) {
    float4 v[kCluster];
#pragma unroll
    for (int j = 0; j < kCluster; ++j) v[j] = remote[j][i];
    const int r = i / q4, c = 4 * (i - r * q4);
#pragma unroll
    for (int j = 0; j < kCluster; ++j) {
      if (F) {
        fd::st4(F + r * width + j * sw + c, v[j]);
      } else {
        __nv_bfloat162* q =
            reinterpret_cast<__nv_bfloat162*>(Q + r * (width + kPad) + j * sw + c);
        q[0] = __floats2bfloat162_rn(v[j].x, v[j].y);
        q[1] = __floats2bfloat162_rn(v[j].z, v[j].w);
      }
    }
  }
  if (last) cluster_arrive();
  __syncthreads();
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
             const float* __restrict__ rows_add,
             const __nv_bfloat16* __restrict__ wb, const float* __restrict__ bb,
             const float* __restrict__ g1, const float* __restrict__ b1,
             const float* __restrict__ g2, const float* __restrict__ b2,
             const __nv_bfloat16* __restrict__ wv, const float* __restrict__ bv,
             const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
             const __nv_bfloat16* __restrict__ wd, const float* __restrict__ bd,
             float* __restrict__ out, int B, int d, int dout, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int sd = d / kCluster, so = dout / kCluster;
  const int sm = sd > so ? sd : so;
  float* X = smem;                  // kRows x d: the residual stream h
  float* F = X + kRows * d;         // kRows x d: gathered product results
  float* S0 = F + kRows * d;        // kRows x sm: this block's column slice,
  float* S1 = S0 + kRows * sm;      //   double-buffered
  float* red = S1 + kRows * sm;     // split-K partial sums
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(red + fd::kRedFloats);  // operand
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int c0 = rank * sd;

  fd::load_rows(X, h, row_add, rows_add, row0, B, d);

  // h += swish(LN1(h @ Wb + bb))
  fd::to_operand(X, Q, d);
  fd::gemm_tc(Q, d, wb, d, c0, sd, S0, red);
  fd::add_bias(S0, sd, bb + c0);
  cluster_gather(cluster, S0, sd, F, nullptr, false);
  fd::rows_layernorm(F, F, d, g1, b1, eps, true);
  fd::add_rows(X, F, d);

  // h += (LN2(h) @ Wv + bv) @ Wo + bo  (attention over one key)
  fd::rows_layernorm(X, F, d, g2, b2, eps, false);
  fd::to_operand(F, Q, d);
  fd::gemm_tc(Q, d, wv, d, c0, sd, S1, red);
  fd::add_bias(S1, sd, bv + c0);
  cluster_gather(cluster, S1, sd, nullptr, Q, false);  // rounded to bf16: Wo's operand
  fd::gemm_tc(Q, d, wo, d, c0, sd, S0, red);
  fd::add_bias(S0, sd, bo + c0);
  cluster_gather(cluster, S0, sd, F, nullptr, true);
  fd::add_rows(X, F, d);

  // out = h @ Wd + bd, this block's columns
  fd::to_operand(X, Q, d);
  const int o0 = rank * so;
  fd::gemm_tc(Q, d, wd, d, o0, so, S1, red);
  for (int i = tid; i < kRows * so; i += kThreads) {
    const int r = i / so, n = i - r * so, row = row0 + r;
    if (row < B) out[(size_t)row * dout + o0 + n] = S1[i] + bd[o0 + n];
  }
  cluster_wait();  // every block done reading this block's S0
}

__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ h, const float* __restrict__ row_add,
            const float* __restrict__ rows_add,
            const float* __restrict__ t_base, const __nv_bfloat16* __restrict__ wt,
            const float* __restrict__ bt,
            const float* __restrict__ c_base, const __nv_bfloat16* __restrict__ wc,
            const float* __restrict__ bc,
            const float* __restrict__ g, const float* __restrict__ b,
            const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bf,
            float* __restrict__ out, int B, int dl, int de, int latent, float eps) {
  extern __shared__ __align__(16) float smem[];
  int dm = dl > de ? dl : de;
  dm = dm > latent ? dm : latent;
  float* X = smem;                  // kRows x dl: h
  float* U = X + kRows * dl;        // kRows x dm: inputs and product results
  float* red = U + kRows * dm;
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(red + fd::kRedFloats);
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

  fd::load_rows(X, h, row_add, rows_add, row0, B, dl);
  const float* bases[2] = {t_base, c_base};
  const __nv_bfloat16* ws[2] = {wt, wc};
  const float* bs[2] = {bt, bc};
  for (int j = 0; j < 2; ++j) {
    if (!bases[j]) continue;
    fd::load_rows(U, bases[j], nullptr, nullptr, row0, B, de);
    fd::to_operand(U, Q, de);
    fd::gemm_tc(Q, de, ws[j], de, 0, dl, U, red);
    for (int i = tid; i < kRows * dl; i += kThreads) X[i] += U[i] + bs[j][i % dl];
    __syncthreads();
  }
  fd::rows_layernorm(X, U, dl, g, b, eps, false);
  fd::to_operand(U, Q, dl);
  fd::gemm_tc(Q, dl, wf, dl, 0, latent, U, red);
  for (int i = tid; i < kRows * latent; i += kThreads) {
    const int r = i / latent, n = i - r * latent, row = row0 + r;
    if (row < B) out[(size_t)row * latent + n] = U[i] + bf[n];
  }
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

// Shared memory of f32 buffers `floats` (times kRows) plus the split-K
// partials plus a bf16 operand of width k.
size_t smem_bytes(int floats, int k) {
  return sizeof(float) * ((size_t)kRows * floats + fd::kRedFloats) +
         sizeof(__nv_bfloat16) * (size_t)kRows * (k + kPad);
}

size_t g_stage_smem = 0;
size_t g_head_smem = 0;

}  // namespace

// d and dout: multiples of 8 * kCluster = 64, d <= 1024, dout <= 4096
// (checked by the wrapper).
extern "C" int fd_stage_launch(const void* h, const void* row_add, const void* rows_add,
                               const void* wb, const void* bb, const void* g1,
                               const void* b1, const void* g2, const void* b2,
                               const void* wv, const void* bv, const void* wo,
                               const void* bo, const void* wd, const void* bd,
                               void* out, int B, int d, int dout, float eps,
                               void* stream) {
  const int sd = d / kCluster, so = dout / kCluster;
  const size_t smem = smem_bytes(2 * d + 2 * (sd > so ? sd : so), d);
  cudaError_t err = reserve_smem(stage_kernel, smem, &g_stage_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kCluster, (B + kRows - 1) / kRows);
  stage_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)row_add, (const float*)rows_add,
      (const __nv_bfloat16*)wb, (const float*)bb, (const float*)g1, (const float*)b1,
      (const float*)g2, (const float*)b2, (const __nv_bfloat16*)wv, (const float*)bv,
      (const __nv_bfloat16*)wo, (const float*)bo, (const __nv_bfloat16*)wd,
      (const float*)bd, (float*)out, B, d, dout, eps);
  return (int)cudaGetLastError();
}

// dl, de: multiples of 32; latent: a multiple of 8; all <= 512.
extern "C" int fd_head_launch(const void* h, const void* row_add, const void* rows_add,
                              const void* t_base, const void* wt, const void* bt,
                              const void* c_base, const void* wc, const void* bc,
                              const void* g, const void* b, const void* wf,
                              const void* bf, void* out, int B, int dl, int de,
                              int latent, float eps, void* stream) {
  int dm = dl > de ? dl : de;
  dm = dm > latent ? dm : latent;
  const size_t smem = smem_bytes(dl + dm, dm);
  cudaError_t err = reserve_smem(head_kernel, smem, &g_head_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  head_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)row_add, (const float*)rows_add,
      (const float*)t_base, (const __nv_bfloat16*)wt, (const float*)bt,
      (const float*)c_base, (const __nv_bfloat16*)wc, (const float*)bc,
      (const float*)g, (const float*)b, (const __nv_bfloat16*)wf, (const float*)bf,
      (float*)out, B, dl, de, latent, eps);
  return (int)cudaGetLastError();
}
