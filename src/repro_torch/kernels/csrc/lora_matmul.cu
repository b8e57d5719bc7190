// Single-tenant fused LoRA matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lora_matmul.py::lora_matmul:
//     y = x·W + alpha · (x·A)·B
// with x (M, K), W (K, N), A (K, r), B (r, N) and fp32 accumulation.  It
// runs every LoRA projection of a training forward.
//
// The TPU kernel accumulates x·W and x·A in one VMEM pass and applies ·B
// on its last K step.  Here z = x·A is written out (M x r fp32) because
// the backward reuses it (dB = alpha·zᵀ·dy).  The TPU kernel rounds z and
// B to the input type before its last dot; the plain version
// (lora_matmul_ref) keeps them in fp32, and so do both tiles here.  Two
// tiles, picked by dtype:
// - bf16 x with bf16 W: the tensor-core tile of lora_mma.cuh, as one
//   client with no rank mask (a shrink over 64-row tiles, x·W on mma.sync
//   fed by a 4-stage cp.async ring with the LoRA term added to the fp32
//   fragments, split-K with a fixed-order reduction when the output has
//   few tiles), launched as the wrapper's plan says
//   (kernels/lora_tile.py::plan);
// - fp32 activations (or fp32 W): the CUDA-core tile of lora_common.cuh,
//   exact in fp32, which the fp32 train-step comparison and the 1e-4
//   backward checks need:
//     1. shrink: z = x·A in fp32, one CTA per row;
//     2. the base product x·W in fp32 FMAs, whose epilogue adds
//        alpha·z[m]·B and rounds ONCE to the output type.
//
// Bound on this card: the operations of x·W at training shapes (M = 2048
// rows, K and N in the thousands), on the tensor cores.
#include "lora_common.cuh"
#include "lora_mma.cuh"

namespace {

using lora::from_f;

template <typename XT>
__global__ void __launch_bounds__(lora::kShrinkThreads)
    single_lora_xa_kernel(const XT* __restrict__ x,
                          const float* __restrict__ a, float* __restrict__ z,
                          int K, int r) {
  __shared__ float part[lora::kShrinkThreads];
  const int m = blockIdx.x, tid = threadIdx.x;
  const float tot = lora::shrink_row(
      x + (size_t)m * K, K, r, true,
      [&](int k, int j) { return a[(size_t)k * r + j]; }, part);
  if (tid < r) z[(size_t)m * r + tid] = tot;
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(lora::kTX * lora::kTY)
    single_lora_xw_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ z, XT* __restrict__ y,
                          int M, int K, int N, int r, float alpha) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * lora::kBM, n0 = blockIdx.x * lora::kBN;
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
      for (int q = 0; q < r; ++q) delta = fmaf(zm[q], b[(size_t)q * N + n], delta);
      y[(size_t)m * N + n] = from_f<XT>(acc[i][jj] + alpha * delta);
    }
  }
}

template <typename XT, typename WT>
int launch(const void* x, const void* w, const float* a, const float* b,
           float* z, void* y, int M, int K, int N, int r, float alpha,
           cudaStream_t stream) {
  single_lora_xa_kernel<XT><<<M, lora::kShrinkThreads, 0, stream>>>(
      (const XT*)x, a, z, K, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  single_lora_xw_kernel<XT, WT><<<lora::base_grid(M, N), lora::base_block(),
                                  0, stream>>>(
      (const XT*)x, (const WT*)w, b, z, (XT*)y, M, K, N, r, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) and y (M, N): float32 or bfloat16; w (K, N): float32 or
// bfloat16; a (K, r), b (r, N): float32; z: (M, r) float32 output (x·A).
// r <= 128.  bf16 x with bf16 W runs the tensor-core tile with the plan
// (kind, split, zsplit) and the scratch of lmma::run (zpart, ypart, zl,
// bl, each used only where its plan needs it); the fp32 tile ignores
// them.  Returns the CUDA error code of the launches.
extern "C" int lora_matmul(const void* x, const void* w, const float* a,
                           const float* b, float* z, float* zpart,
                           float* ypart, void* zl, void* bl, void* y, int M,
                           int K, int N, int r, int x_bf16, int w_bf16,
                           int kind, int split, int zsplit, float alpha,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return lmma::run<float>((const lmma::bf16*)x, (const lmma::bf16*)w, a, b,
                            nullptr, nullptr, nullptr, nullptr, z, zpart,
                            ypart, (lmma::bf16*)zl, (lmma::bf16*)bl,
                            (lmma::bf16*)y, M, K, N, 1, r, alpha, kind, split,
                            zsplit, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, a, b, z, y, M, K, N, r, alpha,
                                        s);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, a, b, z, y, M, K, N, r, alpha,
                                        s);
  return launch<float, float>(x, w, a, b, z, y, M, K, N, r, alpha, s);
}
