// Batched dual-LoRA (per-row Eq. 7) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/batched_lora.py::
// batched_dual_lora_matmul:
//     y[i] = x[i]·W + alpha · x[i]·(w1_i A1[g_i] + w2_i A2)
//                              ·(w1_i B1[g_i] + w2_i B2)
// over a personalized client bank A1 (C, K, r), B1 (C, r, N), one global
// pair A2 (K, r), B2 (r, N) shared by every row, per-row client ids g and
// per-row fusion weights (w1_i, w2_i) (M, 2), all fp32, with fp32
// accumulation.
//
// The TPU kernel routes rows with a one-hot over all clients and merges
// the two pairs per row in its accumulators.  Here each row gathers its
// own client's factors, as batched_lora.cu does, and merges them as
// dual_lora.cu does, in two kernels of the shared tile code
// (lora_common.cuh):
//   1. shrink: z[i] = x[i]·(w1_i A1[g_i] + w2_i A2), one CTA per row; the
//      row's two weights are read once from device memory (no host sync)
//      and the merged A element is formed in registers as it multiplies;
//   2. the base product x·W, whose epilogue merges each row's B elements
//      the same way, adds alpha · z[i]·B and rounds ONCE to the output
//      type.
// No merged factor is written to memory.  An id outside [0, C) reads no
// personalized factor (A1[g], B1[g] count as zero), as the TPU kernel's
// all-zero one-hot row does.
//
// Bound on this card: at decode batch sizes the bytes of W plus the
// factors of the active clients and the global pair; at prefill chunk
// sizes the operations of x·W.  Like its three siblings this first version
// computes on the CUDA cores with fp32 FMAs, far from either bound.
// Forward only: no path takes a gradient through it.
#include "lora_common.cuh"

namespace {

using lora::from_f;

template <typename XT>
__global__ void __launch_bounds__(lora::kShrinkThreads)
    batched_dual_xa_kernel(const XT* __restrict__ x,
                           const float* __restrict__ a1,
                           const float* __restrict__ a2,
                           const int* __restrict__ ids,
                           const float* __restrict__ fw,
                           float* __restrict__ z, int K, int C, int r) {
  __shared__ float part[lora::kShrinkThreads];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int g = ids[m];
  const bool live = g >= 0 && g < C;
  const float w1 = live ? fw[2 * (size_t)m] : 0.f;
  const float w2 = fw[2 * (size_t)m + 1];
  const float* ag = a1 + (size_t)(live ? g : 0) * K * r;
  const float tot = lora::shrink_row(
      x + (size_t)m * K, K, r, true,
      [&](int k, int j) {
        const size_t i = (size_t)k * r + j;
        return w1 * ag[i] + w2 * a2[i];
      },
      part);
  if (tid < r) z[(size_t)m * r + tid] = tot;
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(lora::kTX * lora::kTY)
    batched_dual_xw_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                           const float* __restrict__ b1,
                           const float* __restrict__ b2,
                           const int* __restrict__ ids,
                           const float* __restrict__ fw,
                           const float* __restrict__ z, XT* __restrict__ y,
                           int M, int K, int N, int C, int r, float alpha) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * lora::kBM, n0 = blockIdx.x * lora::kBN;
  float acc[4][4];
  lora::base_tile(x, w, M, K, N, m0, n0, acc);

  // epilogue: + alpha · z[m]·(w1 B1[g] + w2 B2), one rounding
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + lora::kTY * i;
    if (m >= M) continue;
    const int g = ids[m];
    const bool live = g >= 0 && g < C;
    const float w1 = live ? fw[2 * (size_t)m] : 0.f;
    const float w2 = fw[2 * (size_t)m + 1];
    const float* zm = z + (size_t)m * r;
    const float* bg = b1 + (size_t)(live ? g : 0) * r * N;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + lora::kTX * jj;
      if (n >= N) continue;
      float delta = 0.f;
      for (int q = 0; q < r; ++q) {
        const size_t e = (size_t)q * N + n;
        delta = fmaf(zm[q], w1 * bg[e] + w2 * b2[e], delta);
      }
      y[(size_t)m * N + n] = from_f<XT>(acc[i][jj] + alpha * delta);
    }
  }
}

template <typename XT, typename WT>
int launch(const void* x, const void* w, const float* a1, const float* b1,
           const float* a2, const float* b2, const int* ids, const float* fw,
           float* z, void* y, int M, int K, int N, int C, int r, float alpha,
           cudaStream_t stream) {
  batched_dual_xa_kernel<XT><<<M, lora::kShrinkThreads, 0, stream>>>(
      (const XT*)x, a1, a2, ids, fw, z, K, C, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  batched_dual_xw_kernel<XT, WT><<<lora::base_grid(M, N), lora::base_block(),
                                   0, stream>>>(
      (const XT*)x, (const WT*)w, b1, b2, ids, fw, z, (XT*)y, M, K, N, C, r,
      alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) and y (M, N): float32 or bfloat16; w (K, N): float32 or
// bfloat16; a1 (C, K, r), b1 (C, r, N), a2 (K, r), b2 (r, N) and the
// fusion weights fw (M, 2): float32; ids (M,) int32; z: (M, r) float32
// scratch.  r <= 128.  Returns the CUDA error code of the launches.
extern "C" int batched_dual_lora_matmul(
    const void* x, const void* w, const float* a1, const float* b1,
    const float* a2, const float* b2, const int* ids, const float* fw,
    float* z, void* y, int M, int K, int N, int C, int r, int x_bf16,
    int w_bf16, float alpha, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    if (w_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, a1, b1, a2, b2, ids,
                                                  fw, z, y, M, K, N, C, r,
                                                  alpha, s);
    return launch<__nv_bfloat16, float>(x, w, a1, b1, a2, b2, ids, fw, z, y,
                                        M, K, N, C, r, alpha, s);
  }
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, a1, b1, a2, b2, ids, fw, z, y,
                                        M, K, N, C, r, alpha, s);
  return launch<float, float>(x, w, a1, b1, a2, b2, ids, fw, z, y, M, K, N,
                              C, r, alpha, s);
}
