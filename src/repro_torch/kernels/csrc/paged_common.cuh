// CUDA-core tile routine of chunked paged prefill with fp32 queries
// (paged_prefill.cu; bf16 prefill runs the tensor-core tile of
// attn_mma.cuh, and decode its own split-K kernel, paged_attention.cu).
//
// One CTA attends a tile of folded query rows of ONE batch row against ONE
// kv head.  Folded row f = t * G + g holds chunk position t and query head
// kv * G + g; it sits at absolute position base + t and attends
// k_pos <= base + t (and, with a sliding window W > 0, k_pos > base + t - W;
// the walk then starts at the block holding the tile's first such key).
// The CTA walks the row's block table only up to the block holding the
// tile's last query position (and never past its MB entries), so table
// entries past the row's context are never read.  Per block it stages the (bs, hd) K and V tiles in shared
// memory as fp32 (dequantizing int8 with the per-(position, kv-head)
// scale), computes the tile's scores, and folds them into a running max /
// denominator / accumulator (online softmax, fp32) kept across blocks.
// A row with nothing to attend (an empty decode slot) writes zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
// accumulators per thread: rows * hd <= kThreads * kMaxAcc
constexpr int kMaxAcc = 32;
constexpr float kNegBig = -1e30f;

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

// Shared-memory floats the tile needs.
__host__ __device__ inline size_t tile_smem_floats(int rows, int bs, int hd) {
  return (size_t)rows * hd        // Q tile
         + (size_t)bs * (hd + 1)  // K tile (padded row: no bank conflicts)
         + (size_t)bs * hd        // V tile
         + (size_t)rows * bs      // scores / probabilities
         + 3 * (size_t)rows;      // running max, denominator, rescale
}

// q, out: the batch row's (T, H, hd) slice.  table: the row's block table.
template <typename QT, typename KT, bool QUANT>
__device__ void attend_tile(const QT* __restrict__ q,
                            const KT* __restrict__ k_pool,
                            const KT* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ table, int MB, int base,
                            int T, int H, int Kv, int hd, int bs, int G, int kv,
                            int f0, int rows, int window, float scale,
                            QT* __restrict__ out, float* smem) {
  const int tid = threadIdx.x;
  float* Qs = smem;
  float* Ks = Qs + rows * hd;
  float* Vs = Ks + bs * (hd + 1);
  float* S = Vs + bs * hd;
  float* Mx = S + rows * bs;
  float* Ls = Mx + rows;
  float* As = Ls + rows;

  // last chunk position this tile holds, and the context it needs
  int t_last = (f0 + rows - 1) / G;
  if (t_last > T - 1) t_last = T - 1;
  const int max_pos = base + t_last;
  // blocks wholly below the first query's window hold no key of the tile
  const int blk_lo =
      window > 0 ? max(0, base + f0 / G - window + 1) / bs : 0;
  int nblk = max_pos >= 0 ? (max_pos + bs) / bs : 0;
  // ragged chunk tails (t >= n_new) may sit past the table; their output
  // is discarded, so the walk never leaves the row's MB entries
  if (nblk > MB) nblk = MB;

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int f = f0 + r, t = f / G, g = f % G;
    Qs[i] = t < T ? to_f(q[((size_t)t * H + kv * G + g) * hd + d]) : 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    Mx[r] = kNegBig;
    Ls[r] = 0.f;
  }
  const int nacc = (rows * hd + kThreads - 1) / kThreads;
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;

  for (int blk = blk_lo; blk < nblk; ++blk) {
    const size_t phys = (size_t)table[blk];
    __syncthreads();  // previous block's tiles fully consumed
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const size_t row = (phys * bs + j) * Kv + kv;
      float kv_k = to_f(k_pool[row * hd + d]);
      float kv_v = to_f(v_pool[row * hd + d]);
      if (QUANT) {
        kv_k *= k_scale[row];
        kv_v *= v_scale[row];
      }
      if (blk * bs + j > max_pos) {  // past every query of the tile
        kv_k = 0.f;
        kv_v = 0.f;
      }
      Ks[j * (hd + 1) + d] = kv_k;
      Vs[j * hd + d] = kv_v;
    }
    __syncthreads();
    for (int i = tid; i < rows * bs; i += kThreads) {
      const int r = i / bs, j = i % bs;
      const int t = (f0 + r) / G;
      const int pos = blk * bs + j;
      float s = kNegBig;
      if (t < T && pos <= base + t &&
          (window <= 0 || pos > base + t - window)) {
        float dot = 0.f;
        const float* qr = Qs + r * hd;
        const float* kr = Ks + j * (hd + 1);
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      S[i] = s;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float mb = kNegBig;
      for (int j = 0; j < bs; ++j) mb = fmaxf(mb, S[r * bs + j]);
      const float m_old = Mx[r];
      const float m_new = fmaxf(m_old, mb);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float sv = S[r * bs + j];
        const float p = sv <= 0.5f * kNegBig ? 0.f : expf(sv - m_new);
        S[r * bs + j] = p;
        sum += p;
      }
      Ls[r] = Ls[r] * alpha + sum;
      Mx[r] = m_new;
      As[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int i = tid + k * kThreads;
      if (k < nacc && i < rows * hd) {
        const int r = i / hd, d = i % hd;
        float o = acc[k] * As[r];
        const float* pr = S + r * bs;
        for (int j = 0; j < bs; ++j) o = fmaf(pr[j], Vs[j * hd + d], o);
        acc[k] = o;
      }
    }
  }
  __syncthreads();  // Ls final for every row
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int i = tid + k * kThreads;
    if (k < nacc && i < rows * hd) {
      const int r = i / hd, d = i % hd;
      const int f = f0 + r, t = f / G, g = f % G;
      if (t < T) {
        const float den = fmaxf(Ls[r], 1e-30f);  // empty row -> zeros
        out[((size_t)t * H + kv * G + g) * hd + d] = from_f<QT>(acc[k] / den);
      }
    }
  }
}

// Launch helper of the tile's kernel: raise the dynamic shared-memory cap
// when a tile needs more than the default 48 KB.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
