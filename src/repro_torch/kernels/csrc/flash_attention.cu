// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention: q (B, H, Sq, d) against k/v (B, Kv, Sk, d), optionally
// causal and with a sliding window, positions aligned at the end (query i
// sits at Sk - Sq + i; it attends key j when j <= Sk - Sq + i if causal and
// j > Sk - Sq + i - window if a window is set).  It runs every attention
// of a training forward (Sq == Sk, causal).
//
// Design: one CTA per (batch·head, tile of query rows).  The CTA walks KV
// tiles only from the window's start to the causal limit of its last
// query, so fully masked tiles are never read (the TPU kernel visits them
// and skips their work).  Per KV tile it stages K and V in shared memory
// as fp32, computes the tile's scores, and folds them into a running max,
// denominator and accumulator kept in fp32 across tiles (the online-softmax
// recurrence); the output is rounded once.  Unlike the TPU wrapper (Sq a
// multiple of its tile), any Sq and Sk work: the edges are masked.
//
// GQA: query head h reads kv head h / (H / Kv) directly, where the TPU
// wrapper repeats K/V in memory first.  All four tensors are passed with
// element strides for (batch, head, position) and a contiguous last axis,
// so the model's (B, S, H, d) layout needs no transpose copy.
//
// Bound on this card: the operations of the two products (4·d FLOPs per
// attended (query, key) pair) at training shapes.  This first version
// computes both with fp32 FMAs on the CUDA cores; tensor-core tiles (mma /
// wgmma over the score tile) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;      // keys per KV tile
constexpr int kMaxAcc = 32;  // accumulators per thread: rows * d <= 4096
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of (batch, head, position)
  long long b, h, s;
};

size_t smem_floats(int rows, int d) {
  return (size_t)rows * d          // Q tile
         + (size_t)kBK * (d + 1)   // K tile (padded row: no bank conflicts)
         + (size_t)kBK * d         // V tile
         + (size_t)rows * kBK      // scores / probabilities
         + 3 * (size_t)rows;       // running max, denominator, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          int H, int G, int Sq, int Sk, int d, int rows,
                          int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + rows * d;
  float* Vs = Ks + kBK * (d + 1);
  float* S = Vs + kBK * d;
  float* Mx = S + rows * kBK;
  float* Ls = Mx + rows;
  float* As = Ls + rows;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / G;
  const int i0 = blockIdx.x * rows;
  const int nr = min(rows, Sq - i0);
  const int off = Sk - Sq;  // query i sits at position off + i
  const int p_first = off + i0, p_last = off + i0 + nr - 1;
  // keys any query of the tile can attend
  const int kv_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int kv_hi = causal ? min(Sk - 1, p_last) : Sk - 1;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    Qs[e] = r < nr ? to_f(qb[(i0 + r) * qs.s + c]) : 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    Mx[r] = kNegBig;
    Ls[r] = 0.f;
  }
  const int nacc = (rows * d + kThreads - 1) / kThreads;
  float acc[kMaxAcc];
#pragma unroll
  for (int e = 0; e < kMaxAcc; ++e) acc[e] = 0.f;

  for (int j0 = kv_lo; j0 <= kv_hi; j0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int j = e / d, c = e % d;
      const int pos = j0 + j;
      float kk = 0.f, vv = 0.f;
      if (pos <= kv_hi) {
        kk = to_f(kb[pos * ks.s + c]);
        vv = to_f(vb[pos * vs.s + c]);
      }
      Ks[j * (d + 1) + c] = kk;
      Vs[j * d + c] = vv;
    }
    __syncthreads();
    for (int e = tid; e < rows * kBK; e += kThreads) {
      const int r = e / kBK, j = e % kBK;
      const int pos = j0 + j, qp = off + i0 + r;
      const bool on = r < nr && pos <= kv_hi && (!causal || pos <= qp) &&
                      (window <= 0 || pos > qp - window);
      float s = kNegBig;
      if (on) {
        const float* qr = Qs + r * d;
        const float* kr = Ks + j * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot * scale;
      }
      S[e] = s;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float mb = kNegBig;
      for (int j = 0; j < kBK; ++j) mb = fmaxf(mb, S[r * kBK + j]);
      const float m_old = Mx[r];
      const float m_new = fmaxf(m_old, mb);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float sv = S[r * kBK + j];
        const float p = sv <= 0.5f * kNegBig ? 0.f : expf(sv - m_new);
        S[r * kBK + j] = p;
        sum += p;
      }
      Ls[r] = Ls[r] * alpha + sum;
      Mx[r] = m_new;
      As[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kThreads;
      if (a < nacc && e < rows * d) {
        const int r = e / d, c = e % d;
        float acc_e = acc[a] * As[r];
        const float* pr = S + r * kBK;
        for (int j = 0; j < kBK; ++j) acc_e = fmaf(pr[j], Vs[j * d + c], acc_e);
        acc[a] = acc_e;
      }
    }
  }
  __syncthreads();  // Ls final for every row
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kThreads;
    if (a < nacc && e < rows * d) {
      const int r = e / d, c = e % d;
      if (r < nr) {
        const float den = fmaxf(Ls[r], 1e-30f);  // no key attended -> zeros
        ob[(i0 + r) * os.s + c] = from_f<T>(acc[a] / den);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int Kv, int Sq,
           int Sk, int d, int rows, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(rows, d) * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + rows - 1) / rows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, qs, ks, vs, os, H,
      H / Kv, Sq, Sk, d, rows, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, d), k/v (B, Kv, Sk, d), o (B, H, Sq, d): float32 or
// bfloat16, all one type, each given by element strides of its first three
// axes (the last axis contiguous).  rows: query rows per CTA, with
// rows * d <= 4096.  window <= 0: no window.  Returns the CUDA error code
// of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int B,
                               int H, int Kv, int Sq, int Sk, int d, int rows,
                               int causal, int window, int bf16, float scale,
                               void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk,
                                 d, rows, causal, window, scale, s);
  return launch<float>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk, d, rows,
                       causal, window, scale, s);
}
