// The fp32 CUDA-core tile of the LoRA kernels: shared code of
// batched_lora_matmul, lora_matmul, dual_lora_matmul and
// batched_dual_lora_matmul for fp32 activations (or fp32 W).  bf16 x with
// bf16 W runs the tensor-core tile of lora_mma.cuh instead.
//
// Every kernel on this tile computes y = x·W + alpha·(x·A)·B in two
// launches:
//   1. shrink: z[m] = x[m]·A, one CTA per row, fp32 (shrink_row);
//   2. the base product x·W, tiled through shared memory with fp32
//      accumulation (base_tile), whose epilogue adds alpha·z[m]·B and
//      rounds ONCE to the output type.
// The kernels differ only in where a row's A and B elements come from (a
// gathered client bank, one pair, or the in-register merge of two pairs),
// so the callers pass that as a device lambda and write their own
// epilogue loop.
//
// The base product runs on the CUDA cores with fp32 FMAs (64x64 output
// tiles, 4x4 outputs per thread): exact in fp32, which the tight fp32
// checks need, and far from the tensor-core bound at large M.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kShrinkThreads = 128;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTX = 16, kTY = 16;  // 256 threads, 4x4 outputs each

// One row's shrink: sum_k xr[k] · a_at(k, j) for rank column j, returned to
// thread j < r (other threads get an unspecified value).  Thread (kg, j)
// sums k = kg, kg + nkg, ... (adjacent threads read adjacent A elements),
// then the nkg partial sums reduce through ``part`` (kShrinkThreads floats
// of shared memory).  ``live`` false skips the reads (the sum is 0).
template <typename XT, typename AF>
__device__ __forceinline__ float shrink_row(const XT* __restrict__ xr, int K,
                                            int r, bool live, AF a_at,
                                            float* part) {
  const int tid = threadIdx.x;
  const int nkg = kShrinkThreads / r;
  const int j = tid % r, kg = tid / r;
  float s = 0.f;
  if (live && kg < nkg) {
    for (int k = kg; k < K; k += nkg) s = fmaf(to_f(xr[k]), a_at(k, j), s);
  }
  part[tid] = s;
  __syncthreads();
  float tot = 0.f;
  if (tid < r) {
    for (int q = 0; q < nkg; ++q) tot += part[q * r + tid];
  }
  return tot;
}

// acc[i][jj] = sum_k x[m, k] · w[k, n] for the CTA's 64x64 output tile at
// (m0, n0): thread (tx, ty) owns rows m0 + ty + 16 i and columns
// n0 + tx + 16 jj.  Out-of-range rows and columns accumulate zeros.
template <typename XT, typename WT>
__device__ __forceinline__ void base_tile(const XT* __restrict__ x,
                                          const WT* __restrict__ w, int M,
                                          int K, int N, int m0, int n0,
                                          float (&acc)[4][4]) {
  __shared__ float Xs[kBK][kBM + 1];
  __shared__ float Ws[kBK][kBN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile (kBM x kBK), k fastest in memory; stored transposed
#pragma unroll
    for (int e = 0; e < (kBM * kBK) / (kTX * kTY); ++e) {
      const int i = tid + e * kTX * kTY;
      const int row = i / kBK, kk = i % kBK;
      const int m = m0 + row, k = k0 + kk;
      Xs[kk][row] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    // W tile (kBK x kBN), n fastest
#pragma unroll
    for (int e = 0; e < (kBK * kBN) / (kTX * kTY); ++e) {
      const int i = tid + e * kTX * kTY;
      const int kk = i / kBN, col = i % kBN;
      const int k = k0 + kk, n = n0 + col;
      Ws[kk][col] = (k < K && n < N) ? to_f(w[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Xs[kk][ty + kTY * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Ws[kk][tx + kTX * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
}

// Grid and block of the base-product launch for an (M, N) output.
inline dim3 base_grid(int M, int N) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
}
inline dim3 base_block() { return dim3(kTX, kTY); }

}  // namespace lora
