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
// Two tiles, picked by dtype:
// - bf16 x with bf16 W: dual_lora_merge_kernel merges the pair in fp32
//   (w1·A1 + w2·A2 and w1·B1 + w2·B2, each product and the sum rounded
//   once, as the plain version merges them) into scratch, and the merged
//   pair runs lora_matmul's tensor-core tile (lora_mma.cuh: shrink, the
//   LoRA operands' prep, the mma.sync or wgmma tile, split-K reduction at
//   decode shapes) as one client.  The TPU kernel merges in VMEM so that
//   no merged factor reaches HBM; here the merged pair is (K + N)·r fp32,
//   under 1% of the bytes of x·W at evaluation shapes, and merging once
//   per call spares the shrink and the LoRA stages a second pair.
// - fp32 activations (or fp32 W): the CUDA-core tile of lora_common.cuh,
//   exact in fp32, which the tight fp32 checks need: the shrink reads A1
//   and A2 and merges them in registers as it multiplies (z = x·(w1·A1 +
//   w2·A2), fp32, one CTA per row), and the epilogue of the base product
//   merges B1 and B2 the same way before adding alpha·z[m]·B and rounding
//   ONCE to the output type.
//
// Bound on this card: the operations of x·W at evaluation shapes (M =
// 2048 rows, K and N in the thousands), on the tensor cores.
// Forward only: the evaluation takes no gradient.
#include "lora_common.cuh"
#include "lora_mma.cuh"

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

// am = w1·A1 + w2·A2 (na = K·r values), bm = w1·B1 + w2·B2 (nb = r·N):
// one thread per value, no contraction into an fma.
__global__ void dual_lora_merge_kernel(const float* __restrict__ a1,
                                       const float* __restrict__ a2,
                                       const float* __restrict__ b1,
                                       const float* __restrict__ b2,
                                       const float* __restrict__ fw,
                                       float* __restrict__ am,
                                       float* __restrict__ bm, int na,
                                       int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float w1 = fw[0], w2 = fw[1];
  if (i < na) {
    am[i] = __fadd_rn(__fmul_rn(w1, a1[i]), __fmul_rn(w2, a2[i]));
  } else if (i < na + nb) {
    const int j = i - na;
    bm[j] = __fadd_rn(__fmul_rn(w1, b1[j]), __fmul_rn(w2, b2[j]));
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
// z: (M, r) float32 scratch.  r <= 128.  bf16 x with bf16 W runs the
// tensor-core tile with the plan (kind, split, zsplit) and the scratch of
// lmma::run (zpart, ypart, zl, bl, each used only where its plan needs
// it), plus am (K, r) and bm (r, N) float32 for the merged pair; the fp32
// tile ignores them.  Returns the CUDA error code of the launches.
extern "C" int dual_lora_matmul(const void* x, const void* w, const float* a1,
                                const float* b1, const float* a2,
                                const float* b2, const float* fw, float* z,
                                float* zpart, float* ypart, void* zl,
                                void* bl, float* am, float* bm, void* y,
                                int M, int K, int N, int r, int x_bf16,
                                int w_bf16, int kind, int split, int zsplit,
                                float alpha, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16) {
    if (am == nullptr || bm == nullptr) return (int)cudaErrorInvalidValue;
    const int n = K * r + r * N;
    dual_lora_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        a1, a2, b1, b2, fw, am, bm, K * r, r * N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return lmma::run<float>((const lmma::bf16*)x, (const lmma::bf16*)w, am,
                            bm, nullptr, nullptr, nullptr, nullptr, z, zpart,
                            ypart, (lmma::bf16*)zl, (lmma::bf16*)bl,
                            (lmma::bf16*)y, M, K, N, 1, r, alpha, kind, split,
                            zsplit, s);
  }
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, a1, b1, a2, b2, fw, z, y, M, K,
                                        N, r, alpha, s);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, a1, b1, a2, b2, fw, z, y, M, K,
                                        N, r, alpha, s);
  return launch<float, float>(x, w, a1, b1, a2, b2, fw, z, y, M, K, N, r,
                              alpha, s);
}
