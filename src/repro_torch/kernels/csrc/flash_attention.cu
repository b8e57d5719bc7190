// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention: q (B, H, Sq, d) against k/v (B, Kv, Sk, d), optionally
// causal and with a sliding window, positions aligned at the end (query i
// sits at Sk - Sq + i; it attends key j when j <= Sk - Sq + i if causal and
// j > Sk - Sq + i - window if a window is set).  It runs every attention
// of a training forward (Sq == Sk, causal).
//
// One CTA per (batch·head, tile of query rows) walks KV tiles only from
// the window's start to the causal limit of its last query, so fully
// masked tiles are never read (the TPU kernel visits them and skips their
// work).  Unlike the TPU wrapper (Sq a multiple of its tile), any Sq and
// Sk work: the edges are masked.  GQA: query head h reads kv head
// h / (H / Kv) directly, where the TPU wrapper repeats K/V in memory
// first.  All four tensors are passed with element strides for (batch,
// head, position) and a contiguous last axis, so the model's (B, S, H, d)
// layout needs no transpose copy.
//
// Two tiles, chosen by the dtype:
// - bf16 (every training run): the tensor-core tile of attn_mma.cuh, 64
//   query rows against 64-key tiles copied by cp.async through the strided
//   loader below (each row start 16-byte aligned; the wrapper checks).
//   Bound on this card: bytes at training shapes (B = 8, H = 32, S = 256,
//   d = 128: 67 MB of q, k, v and o, 0.020 ms, against 0.004 ms of
//   causal products at the bf16 peak); the tile keeps S and P in
//   registers and overlaps each K/V copy with the previous tile's math.
// - fp32: the CUDA-core tile below, fp32 FMAs throughout, so the fp32
//   checks stay exact to summation order.
#include "attn_mma.cuh"

namespace {

using attn::bf16;

struct Strides {  // element strides of (batch, head, position)
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile
// ---------------------------------------------------------------------------

// Pointers are at the tile's first query row (q, o) and at position 0 of
// the kv head (k, v); position strides are 32-bit (a position's stride is
// far below 2^31 elements), products 64-bit.  Few registers stay live
// through the key walk, which the tile needs at head dim 256.
template <int HD>
struct StridedLoader {
  typedef bf16 KT;
  const bf16* q;  // this (batch, head)'s first tile row, position stride qs
  const bf16* k;  // its kv head's rows
  const bf16* v;
  bf16* o;        // the output's first tile row
  int qs, ks, vs, os;
  int nr;         // rows in the tile
  int p0;         // the tile's first query sits at position p0
  int causal, window, kv_hi;

  __device__ void load_q(bf16* Qs) const {
    constexpr int kChunks = HD / 8;
    for (int e = threadIdx.x; e < attn::kRows * kChunks; e += attn::kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = r < nr;
      const bf16* src = ok ? q + (long long)r * qs + c * 8 : q;
      attn::cp_async16(Qs + r * attn::Tile<HD>::kStride + c * 8, src, ok);
    }
  }

  __device__ void load_kv(int k0, bf16* K, bf16* V, float*, float*) const {
    constexpr int kChunks = HD / 8;
    for (int e = threadIdx.x; e < attn::kKeys * kChunks; e += attn::kThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const int p = k0 + j;
      const bool ok = p <= kv_hi;
      const int dst = j * attn::Tile<HD>::kStride + c * 8;
      attn::cp_async16(K + dst, ok ? k + (long long)p * ks + c * 8 : k, ok);
      attn::cp_async16(V + dst, ok ? v + (long long)p * vs + c * 8 : v, ok);
    }
  }

  __device__ void limits(int r, int& lo, int& hi) const {
    // rows past the end: computed, not stored
    const int qp = p0 + (r < nr ? r : nr - 1);
    hi = causal ? min(qp, kv_hi) : kv_hi;
    lo = window > 0 ? max(qp - window + 1, 0) : 0;
  }

  __device__ void store(int r, int c, float x, float y) const {
    if (r < nr)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r * os + c) =
          __floats2bfloat162_rn(x, y);
  }
};

template <int HD>
__global__ void __launch_bounds__(attn::kThreads, 2)
    flash_attn_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          int H, int G, int Sq, int Sk, int causal, int window,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / G;
  StridedLoader<HD> ld;
  // query tiles last to first: under the causal mask the last tiles walk
  // the most keys, so they start in the first wave and the short ones fill
  // the tail
  const int i0 = (gridDim.y - 1 - blockIdx.y) * attn::kRows;
  ld.nr = min(attn::kRows, Sq - i0);
  ld.p0 = Sk - Sq + i0;
  const int p_first = ld.p0, p_last = p_first + ld.nr - 1;
  // keys any query of the tile attends, and keys every query attends
  const int kv_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int kv_hi = causal ? min(Sk - 1, p_last) : Sk - 1;
  const int full_lo = window > 0 ? max(0, p_last - window + 1) : 0;
  const int full_hi = causal ? min(Sk - 1, p_first) : Sk - 1;
  ld.q = q + b * qs.b + h * qs.h + i0 * qs.s;
  ld.k = k + b * ks.b + kh * ks.h;
  ld.v = v + b * vs.b + kh * vs.h;
  ld.o = o + b * os.b + h * os.h + i0 * os.s;
  ld.qs = (int)qs.s;
  ld.ks = (int)ks.s;
  ld.vs = (int)vs.s;
  ld.os = (int)os.s;
  ld.causal = causal;
  ld.window = window;
  ld.kv_hi = kv_hi;
  attn::run<HD, false>(ld, kv_lo, kv_hi + 1, full_lo, full_hi, scale, smem);
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
               int Kv, int Sq, int Sk, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = attn::smem_bytes<HD, false>();
  auto kernel = flash_attn_mma_kernel<HD>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + attn::kRows - 1) / attn::kRows);
  kernel<<<grid, attn::kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, qs, ks, vs, os,
      H, H / Kv, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core tile
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBK = 32;      // keys per KV tile
constexpr int kMaxAcc = 32;  // accumulators per thread: rows * d <= 4096
constexpr float kNegBig = -1e30f;

size_t smem_floats(int rows, int d) {
  return (size_t)rows * d          // Q tile
         + (size_t)kBK * (d + 1)   // K tile (padded row: no bank conflicts)
         + (size_t)kBK * d         // V tile
         + (size_t)rows * kBK      // scores / probabilities
         + 3 * (size_t)rows;       // running max, denominator, rescale
}

__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          int H, int G, int Sq, int Sk, int d, int rows,
                          int causal, int window, float scale) {
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    Qs[e] = r < nr ? qb[(i0 + r) * qs.s + c] : 0.f;
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
        kk = kb[pos * ks.s + c];
        vv = vb[pos * vs.s + c];
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
        ob[(i0 + r) * os.s + c] = acc[a] / den;
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
               int Kv, int Sq, int Sk, int d, int rows, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(rows, d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + rows - 1) / rows, B * H);
  flash_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, qs, ks, vs,
      os, H, H / Kv, Sq, Sk, d, rows, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, d), k/v (B, Kv, Sk, d), o (B, H, Sq, d): float32 or
// bfloat16, all one type, each given by element strides of its first three
// axes (the last axis contiguous).  bf16 runs the tensor-core tile (d 32,
// 64, 128 or 256; every row start 16-byte aligned); fp32 the CUDA-core tile
// with ``rows`` query rows per CTA, rows * d <= 4096.  window <= 0: no
// window.
// Returns the CUDA error code of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int B,
                               int H, int Kv, int Sq, int Sk, int d, int rows,
                               int causal, int window, int is_bf16, float scale,
                               void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_f32(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk, d, rows,
                      causal, window, scale, s);
  switch (d) {
    case 32:
      return launch_mma<32>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk,
                            causal, window, scale, s);
    case 64:
      return launch_mma<64>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk,
                            causal, window, scale, s);
    case 128:
      return launch_mma<128>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk,
                             causal, window, scale, s);
    case 256:
      return launch_mma<256>(q, k, v, o, qs, ks, vs, os, B, H, Kv, Sq, Sk,
                             causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
