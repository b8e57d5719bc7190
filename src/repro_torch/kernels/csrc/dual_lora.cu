// Fused dual-LoRA (AdaFusion, Eq. 7) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dual_lora.py::
// dual_lora_matmul:
//     y = x·W + alpha · x·(w1·A1 + w2·A2)·(w1·B1 + w2·B2)
// with x (M, K), W (K, N), A1/A2 (K, r), B1/B2 (r, N), two fp32 fusion
// weights (read from device memory, as the TPU kernel reads them from
// SMEM) and fp32 accumulation.  It runs every projection of a stage-3
// AdaFusion evaluation: one client, scalar weights.
//
// The TPU kernel's point is that the merged factors never reach device
// memory.  Here too: the shrink reads A1 and A2 and merges them in
// registers as it multiplies (z = x·(w1·A1 + w2·A2), fp32, one CTA per
// row), and the epilogue of the base product reads B1 and B2 and merges
// them the same way before adding alpha·z[m]·B and rounding ONCE to the
// output type.  Both are the shared tile code of lora_common.cuh.
//
// Bound on this card: the operations of x·W at evaluation shapes.  This
// first version computes on the CUDA cores in fp32, far from that bound.
// Forward only: the evaluation takes no gradient.
#include "lora_common.cuh"

namespace {

using lora::from_f;

template <typename XT>
__global__ void __launch_bounds__(lora::kShrinkThreads)
    dual_lora_xa_kernel(const XT* __restrict__ x,
                        const float* __restrict__ a1,
                        const float* __restrict__ a2,
                        const float* __restrict__ fw, float* __restrict__ z,
                        int K, int r) {
  __shared__ float part[lora::kShrinkThreads];
  const int m = blockIdx.x, tid = threadIdx.x;
  const float w1 = fw[0], w2 = fw[1];
  const float tot = lora::shrink_row(
      x + (size_t)m * K, K, r, true,
      [&](int k, int j) {
        const size_t i = (size_t)k * r + j;
        return w1 * a1[i] + w2 * a2[i];
      },
      part);
  if (tid < r) z[(size_t)m * r + tid] = tot;
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(lora::kTX * lora::kTY)
    dual_lora_xw_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2,
                        const float* __restrict__ fw,
                        const float* __restrict__ z, XT* __restrict__ y,
                        int M, int K, int N, int r, float alpha) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * lora::kBM, n0 = blockIdx.x * lora::kBN;
  const float w1 = fw[0], w2 = fw[1];
  float acc[4][4];
  lora::base_tile(x, w, M, K, N, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + lora::kTY * i;
    if (m >= M) continue;
    const float* zm = z + (size_t)m * r;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + lora::kTX * jj;
      if (n >= N) continue;
      float delta = 0.f;
      for (int q = 0; q < r; ++q) {
        const size_t e = (size_t)q * N + n;
        delta = fmaf(zm[q], w1 * b1[e] + w2 * b2[e], delta);
      }
      y[(size_t)m * N + n] = from_f<XT>(acc[i][jj] + alpha * delta);
    }
  }
}

template <typename XT, typename WT>
int launch(const void* x, const void* w, const float* a1, const float* b1,
           const float* a2, const float* b2, const float* fw, float* z,
           void* y, int M, int K, int N, int r, float alpha,
           cudaStream_t stream) {
  dual_lora_xa_kernel<XT><<<M, lora::kShrinkThreads, 0, stream>>>(
      (const XT*)x, a1, a2, fw, z, K, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dual_lora_xw_kernel<XT, WT><<<lora::base_grid(M, N), lora::base_block(),
                                0, stream>>>(
      (const XT*)x, (const WT*)w, b1, b2, fw, z, (XT*)y, M, K, N, r, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) and y (M, N): float32 or bfloat16; w (K, N): float32 or
// bfloat16; a1/a2 (K, r), b1/b2 (r, N), fusion weights fw (2,): float32;
// z: (M, r) float32 scratch.  r <= 128.  Returns the CUDA error code of
// the launches.
extern "C" int dual_lora_matmul(const void* x, const void* w, const float* a1,
                                const float* b1, const float* a2,
                                const float* b2, const float* fw, float* z,
                                void* y, int M, int K, int N, int r,
                                int x_bf16, int w_bf16, float alpha,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    if (w_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, a1, b1, a2, b2, fw, z,
                                                  y, M, K, N, r, alpha, s);
    return launch<__nv_bfloat16, float>(x, w, a1, b1, a2, b2, fw, z, y, M, K,
                                        N, r, alpha, s);
  }
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, a1, b1, a2, b2, fw, z, y, M, K,
                                        N, r, alpha, s);
  return launch<float, float>(x, w, a1, b1, a2, b2, fw, z, y, M, K, N, r,
                              alpha, s);
}
