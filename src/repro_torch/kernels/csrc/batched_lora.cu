// Batched multi-tenant LoRA matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/batched_lora.py::
// batched_lora_matmul:
//     y[i] = x[i]·W + alpha · s[g[i]] · mask_r(x[i]·A[g[i]])·B[g[i]]
// over stacked client banks A (C, K, r), B (C, r, N), per-row client ids
// g, an optional per-client effective rank (ragged banks: rank columns
// >= ranks[g] are zeroed) and, for int8 banks, s = a_scale · b_scale.
//
// The TPU kernel routes rows with a one-hot over ALL clients so the MXU
// can do the gather as a dense product; here rows gather their own
// client's factors instead.  Two tiles, picked by dtype:
// - bf16 x with bf16 W: the tensor-core tile of lora_mma.cuh (a shrink
//   over 64-row tiles staging each client's A once per K chunk, x·W on
//   mma.sync fed by a 4-stage cp.async ring, the LoRA term added to the
//   fp32 fragments, split-K with a fixed-order reduction at decode
//   shapes), launched as the wrapper's plan says
//   (kernels/lora_tile.py::plan);
// - fp32 activations (or fp32 W): the CUDA-core tile of lora_common.cuh,
//   exact in fp32, which the tight checks hold at 1e-4:
//     1. shrink: z[i] = x[i]·A[g[i]] (fp32, rank mask applied), one CTA
//        per row reading only that row's client's A;
//     2. the base product x·W in fp32 FMAs (64x64 tiles), whose epilogue
//        adds alpha · s · z[i]·B[g[i]] and rounds ONCE to the output type.
// Both round once: the reference dense layer rounds x·W to the working
// type before adding the fp32 LoRA term, so the two differ by at most one
// rounding of the output type.
//
// Bound on this card: at decode batch sizes the bytes of W plus the
// active clients' A and B (a matrix-vector stream); at prefill chunk
// sizes the operations of x·W on the tensor cores.
#include "lora_common.cuh"
#include "lora_mma.cuh"

namespace {

using lora::from_f;
using lora::to_f;

// z[i, :r] = x[i] · A[g[i]]; one CTA per row (lora::shrink_row), rank
// columns at or past ranks[g] zeroed.
template <typename XT, typename BT>
__global__ void __launch_bounds__(lora::kShrinkThreads)
    lora_shrink_kernel(const XT* __restrict__ x, const BT* __restrict__ a,
                       const int* __restrict__ ids,
                       const int* __restrict__ ranks, float* __restrict__ z,
                       int K, int C, int r) {
  __shared__ float part[lora::kShrinkThreads];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int g = ids[m];
  const bool live = g >= 0 && g < C;
  const BT* ag = a + (size_t)(live ? g : 0) * K * r;
  const float tot = lora::shrink_row(
      x + (size_t)m * K, K, r, live,
      [&](int k, int j) { return to_f(ag[(size_t)k * r + j]); }, part);
  if (tid < r) {
    const bool on = live && (ranks == nullptr || tid < ranks[g]);
    z[(size_t)m * r + tid] = on ? tot : 0.f;
  }
}

template <typename XT, typename WT, typename BT>
__global__ void __launch_bounds__(lora::kTX * lora::kTY)
    lora_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                       const BT* __restrict__ b,
                       const float* __restrict__ a_scale,
                       const float* __restrict__ b_scale,
                       const int* __restrict__ ids,
                       const float* __restrict__ z, XT* __restrict__ y, int M,
                       int K, int N, int C, int r, float alpha) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * lora::kBM, n0 = blockIdx.x * lora::kBN;
  float acc[4][4];
  lora::base_tile(x, w, M, K, N, m0, n0, acc);

  // epilogue: + alpha · s[g] · z[m]·B[g], one rounding to the output type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + lora::kTY * i;
    if (m >= M) continue;
    const int g = ids[m];
    const bool live = g >= 0 && g < C;
    const float rs = (live && a_scale != nullptr) ? a_scale[g] * b_scale[g] : 1.f;
    const float* zm = z + (size_t)m * r;
    const BT* bg = b + (size_t)(live ? g : 0) * r * N;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + lora::kTX * jj;
      if (n >= N) continue;
      float delta = 0.f;
      if (live)
        for (int q = 0; q < r; ++q) delta = fmaf(zm[q], to_f(bg[(size_t)q * N + n]), delta);
      y[(size_t)m * N + n] = from_f<XT>(acc[i][jj] + alpha * rs * delta);
    }
  }
}

template <typename XT, typename WT, typename BT>
int launch(const void* x, const void* w, const void* a, const void* b,
           const float* a_scale, const float* b_scale, const int* ranks,
           const int* ids, float* z, void* y, int M, int K, int N, int C,
           int r, float alpha, cudaStream_t stream) {
  lora_shrink_kernel<XT, BT><<<M, lora::kShrinkThreads, 0, stream>>>(
      (const XT*)x, (const BT*)a, ids, ranks, z, K, C, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lora_matmul_kernel<XT, WT, BT><<<lora::base_grid(M, N), lora::base_block(),
                                   0, stream>>>(
      (const XT*)x, (const WT*)w, (const BT*)b, a_scale, b_scale, ids, z,
      (XT*)y, M, K, N, C, r, alpha);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int launch_bank(int bank_int8, const void* x, const void* w, const void* a,
                const void* b, const float* as, const float* bs,
                const int* ranks, const int* ids, float* z, void* y, int M,
                int K, int N, int C, int r, float alpha, cudaStream_t s) {
  if (bank_int8)
    return launch<XT, WT, int8_t>(x, w, a, b, as, bs, ranks, ids, z, y, M, K,
                                  N, C, r, alpha, s);
  return launch<XT, WT, float>(x, w, a, b, as, bs, ranks, ids, z, y, M, K, N,
                               C, r, alpha, s);
}

}  // namespace

// x (M, K) and y (M, N): float32 or bfloat16; w (K, N): float32 or
// bfloat16; a (C, K, r), b (C, r, N): float32, or int8 with a_scale and
// b_scale (C,) float32; ranks (C,) int32 or null; ids (M,) int32 (an id
// outside [0, C) gets no LoRA term); z: (M, r) float32 scratch.  r <= 128.
// bf16 x with bf16 W runs the tensor-core tile with the plan (kind, split,
// zsplit) and the scratch of lmma::run (zpart, ypart, zl, bl, each used
// only where its plan needs it); the fp32 tile ignores them.  Returns the
// CUDA error code of the launches.
extern "C" int batched_lora_matmul(const void* x, const void* w, const void* a,
                                   const void* b, const float* a_scale,
                                   const float* b_scale, const int* ranks,
                                   const int* ids, float* z, float* zpart,
                                   float* ypart, void* zl, void* bl, void* y,
                                   int M, int K, int N, int C, int r,
                                   int x_bf16, int w_bf16, int bank_int8,
                                   int kind, int split, int zsplit,
                                   float alpha, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16) {
    const lmma::bf16* xb = (const lmma::bf16*)x;
    const lmma::bf16* wb = (const lmma::bf16*)w;
    lmma::bf16 *zlb = (lmma::bf16*)zl, *blb = (lmma::bf16*)bl,
               *yb = (lmma::bf16*)y;
    if (bank_int8)
      return lmma::run<int8_t>(xb, wb, (const int8_t*)a, (const int8_t*)b,
                               a_scale, b_scale, ranks, ids, z, zpart, ypart,
                               zlb, blb, yb, M, K, N, C, r, alpha, kind,
                               split, zsplit, s);
    return lmma::run<float>(xb, wb, (const float*)a, (const float*)b, a_scale,
                            b_scale, ranks, ids, z, zpart, ypart, zlb, blb,
                            yb, M, K, N, C, r, alpha, kind, split, zsplit, s);
  }
  if (x_bf16)
    return launch_bank<__nv_bfloat16, float>(bank_int8, x, w, a, b, a_scale,
                                             b_scale, ranks, ids, z, y, M, K,
                                             N, C, r, alpha, s);
  if (w_bf16)
    return launch_bank<float, __nv_bfloat16>(bank_int8, x, w, a, b, a_scale,
                                             b_scale, ranks, ids, z, y, M, K,
                                             N, C, r, alpha, s);
  return launch_bank<float, float>(bank_int8, x, w, a, b, a_scale, b_scale,
                                   ranks, ids, z, y, M, K, N, C, r, alpha, s);
}
