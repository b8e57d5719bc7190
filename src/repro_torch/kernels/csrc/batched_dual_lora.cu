// Batched dual-LoRA (per-row Eq. 7) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/batched_lora.py::
// batched_dual_lora_matmul:
//     y[i] = x[i]·W + alpha · x[i]·(w1_i A1[g_i] + w2_i A2)
//                              ·(w1_i B1[g_i] + w2_i B2)
// over a personalized client bank A1 (C, K, r), B1 (C, r, N), one global
// pair A2 (K, r), B2 (r, N) shared by every row, per-row client ids g and
// per-row fusion weights (w1_i, w2_i) (M, 2), all fp32, with fp32
// accumulation.  An id outside [0, C) reads no personalized factor (A1[g],
// B1[g] count as zero), as the TPU kernel's all-zero one-hot row does.
//
// The TPU kernel routes rows with a one-hot over all clients and merges
// the two pairs per row in its accumulators, by linearity:
//     z_i = w1_i·(x_i·A1[g_i]) + w2_i·(x_i·A2),
//     LoRA_i = (w1_i·z_i)·B1[g_i] + (w2_i·z_i)·B2.
// Two tiles, picked by dtype:
// - bf16 x with bf16 W: the same route on lora_mma.cuh's tensor-core tile,
//   which is left as it is; the pair enters it as one client bank of rank
//   2·16·nq (nq = ceil(r / 16)):
//     1. lora_mma_shrink_kernel twice: z1 = x·A1[g] over the bank (rows
//        outside it: zeros), z2 = x·A2 as one client; A as bf16 hi + lo,
//        so z keeps fp32-level accuracy;
//     2. when the base product does not split K: lora_mma_dual_zprep_kernel
//        writes each row's operand [alpha·w1·z | alpha·w2·z] (hi / lo, as
//        lora_mma_zprep_kernel's layout, 2·nq chunks) and the row's slot,
//        its client or C for a row outside the bank; and
//        lora_mma_dual_bprep_kernel each slot's [B1[c]; B2] (slot C: [0;
//        B2]), so the tile's LoRA stages add both terms;
//     3. lora_mma_kernel<KIND> over C + 1 slots;
//     4. when it splits K (decode shapes): lora_mma_dual_reduce_kernel, the
//        partials in a fixed order plus alpha·z·(w1 B1[g] + w2 B2), B
//        merged per row in fp32 on the CUDA cores.
// - fp32 activations (or fp32 W): the CUDA-core tile of lora_common.cuh,
//   exact in fp32, which the tight checks hold at 1e-4:
//     1. shrink: z[i] = x[i]·(w1_i A1[g_i] + w2_i A2), one CTA per row;
//        the merged A element is formed in registers as it multiplies;
//     2. the base product x·W, whose epilogue merges each row's B elements
//        the same way, adds alpha · z[i]·B and rounds ONCE.
//
// Bound on this card: at decode batch sizes the bytes of W plus the
// factors of the active clients and the global pair; at prefill chunk
// sizes the operations of x·W on the tensor cores.  The concatenated
// operand doubles the LoRA stages of lora_matmul's route (the global B2
// is staged once per client of a tile) and the B prep writes B2 once per
// slot: r/K and C·r/(M·K) of the base product's work at prefill shapes.
// Forward only: no path takes a gradient through it.
#include "lora_common.cuh"
#include "lora_mma.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core route (bf16 x and W)
// ---------------------------------------------------------------------------

using lmma::bf16;

// zl (M, 2nq, 64): row m's chunks [hi(zs) | lo(zs) | hi(zs) | 0] of zs =
// alpha·w1·z (chunks 0 .. nq - 1) and alpha·w2·z (chunks nq .. 2nq - 1),
// z = w1·z1 + w2·z2 summed from the shrinks' partials in split order when
// they split K (zsplit > 1: zpart (2, zsplit, M, r), else z (2, M, r));
// w1 = 0 for a row outside the bank.  slot[m]: its client, C outside the
// bank.  One thread per (m, q), q < 16·nq.
__global__ void lora_mma_dual_zprep_kernel(
    const float* __restrict__ zpart, const float* __restrict__ z,
    bf16* __restrict__ zl, const int* __restrict__ ids,
    const float* __restrict__ fw, int* __restrict__ slot, int M, int C,
    int r, int nq, float alpha, int zsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * nq * 16) return;
  const int m = i / (nq * 16), q = i % (nq * 16);
  const int g = ids[m];
  const bool live = g >= 0 && g < C;
  if (q == 0) slot[m] = live ? g : C;
  float v1 = 0.f, v2 = 0.f;
  if (q < r) {
    if (zsplit > 1) {
      for (int p = 0; p < zsplit; ++p) {
        v1 += zpart[((size_t)p * M + m) * r + q];
        v2 += zpart[((size_t)(zsplit + p) * M + m) * r + q];
      }
    } else {
      v1 = z[(size_t)m * r + q];
      v2 = z[((size_t)M + m) * r + q];
    }
  }
  const float w1 = live ? fw[2 * (size_t)m] : 0.f;
  const float w2 = fw[2 * (size_t)m + 1];
  const float zv = __fadd_rn(__fmul_rn(w1, v1), __fmul_rn(w2, v2));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16 hi, lo;
    lmma::split_bf16(__fmul_rn(alpha * (h ? w2 : w1), zv), hi, lo);
    bf16* row = zl + ((size_t)m * 2 * nq + h * nq + q / 16) * 64 + q % 16;
    row[0] = hi;
    row[16] = lo;
    row[32] = hi;
    row[48] = __float2bfloat16(0.f);
  }
}

// bl (C + 1, 2nq, 32, N): slot c's chunks of B1[c] (zeros for slot C),
// then of B2, each chunk 16 hi rows then 16 lo rows as
// lora_mma_bprep_kernel writes them; one thread per element of a hi half.
__global__ void lora_mma_dual_bprep_kernel(const float* __restrict__ b1,
                                           const float* __restrict__ b2,
                                           bf16* __restrict__ bl, int C,
                                           int r, int N, int nq) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)(C + 1) * 2 * nq * 16 * N) return;
  const int n = (int)(i % N), t = (int)(i / N % 16);
  const size_t cq = i / N / 16;  // c·2nq + qc
  const int qc = (int)(cq % (2 * nq)), c = (int)(cq / (2 * nq));
  const int q = (qc % nq) * 16 + t;
  float v = 0.f;
  if (q < r) {
    if (qc >= nq)
      v = b2[(size_t)q * N + n];
    else if (c < C)
      v = b1[((size_t)c * r + q) * N + n];
  }
  bf16 hi, lo;
  lmma::split_bf16(v, hi, lo);
  bf16* out = bl + (cq * 32 + t) * N + n;
  out[0] = hi;
  out[(size_t)16 * N] = lo;
}

// y[m, n, n + 1] = sum over splits (in order) of the partials, plus
// alpha·z[m]·(w1 B1[g] + w2 B2) in fp32 (rank order, B merged per row);
// z = w1·z1 + w2·z2, each summed from the shrink's partials when it split
// K (the same fixed order in every CTA); grid (N / 256, M).
__global__ void __launch_bounds__(128)
    lora_mma_dual_reduce_kernel(const float* __restrict__ ypart,
                                const float* __restrict__ zpart,
                                const float* __restrict__ z,
                                const float* __restrict__ b1,
                                const float* __restrict__ b2,
                                const int* __restrict__ ids,
                                const float* __restrict__ fw,
                                bf16* __restrict__ y, int M, int N, int C,
                                int r, float alpha, int split, int zsplit) {
  __shared__ float zr[2][128];
  __shared__ float part[128];
  const int m = blockIdx.y, tid = threadIdx.x;
  const int g = ids[m];
  const bool live = g >= 0 && g < C;
  const float w1 = live ? fw[2 * (size_t)m] : 0.f;
  const float w2 = fw[2 * (size_t)m + 1];
  for (int h = 0; h < 2; ++h) {
    if (zsplit > 1) {
      // thread (grp, q) sums splits grp, grp + ngrp, ...; then the groups
      // are added in order
      const int ngrp = 128 / r, q = tid % r, grp = tid / r;
      float s = 0.f;
      if (grp < ngrp)
        for (int p = grp; p < zsplit; p += ngrp)
          s += zpart[((size_t)(h * zsplit + p) * M + m) * r + q];
      part[tid] = s;
      __syncthreads();
      if (tid < r) {
        float t = 0.f;
        for (int k = 0; k < ngrp; ++k) t += part[k * r + tid];
        zr[h][tid] = t;
      }
      __syncthreads();  // part is reused
    } else if (tid < r) {
      zr[h][tid] = z[((size_t)h * M + m) * r + tid];
    }
  }
  __syncthreads();
  if (tid < r) zr[0][tid] = alpha * (w1 * zr[0][tid] + w2 * zr[1][tid]);
  __syncthreads();
  const int n = (blockIdx.x * 128 + tid) * 2;
  if (n >= N) return;
  float2 acc = make_float2(0.f, 0.f);
  for (int p = 0; p < split; ++p) {
    const float2 v = *reinterpret_cast<const float2*>(
        ypart + ((size_t)p * M + m) * N + n);
    acc.x += v.x;
    acc.y += v.y;
  }
  const float* bg = b1 + (size_t)(live ? g : 0) * r * N + n;
  const float* bs = b2 + n;
#pragma unroll 4
  for (int q = 0; q < r; ++q) {
    const size_t e = (size_t)q * N;
    float bx = w2 * bs[e], by = w2 * bs[e + 1];
    if (live) {
      bx = fmaf(w1, bg[e], bx);
      by = fmaf(w1, bg[e + 1], by);
    }
    acc.x = fmaf(zr[0][q], bx, acc.x);
    acc.y = fmaf(zr[0][q], by, acc.y);
  }
  *reinterpret_cast<uint32_t*>(y + (size_t)m * N + n) =
      tc::pack_bf16(acc.x, acc.y);
}

// The whole tensor-core call.  Scratch, fp32-aligned: z (2, M, r) fp32
// (the two shrinks' z when they do not split K); zpart (2, zsplit, M, r)
// when zsplit > 1; ypart (split, M, N) when split > 1; zl (M, 2nq, 64) and
// bl (C + 1, 2nq, 32, N) bf16 and slot (M,) int32 when split == 1.
int run_mma(const bf16* x, const bf16* w, const float* a1, const float* b1,
            const float* a2, const float* b2, const int* ids, const float* fw,
            float* z, float* zpart, float* ypart, bf16* zl, bf16* bl,
            int* slot, bf16* y, int M, int K, int N, int C, int r,
            float alpha, int kind, int split, int zsplit,
            cudaStream_t stream) {
  const int nq = (r + 15) / 16;
  if (kind < 0 || kind > 2 || split < 1 || zsplit < 1 || r < 1 || r > 128 ||
      K % 8 || N % 8 || (split > 1 && ypart == nullptr) ||
      (zsplit > 1 && zpart == nullptr) ||
      (split == 1 && (zl == nullptr || bl == nullptr || slot == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 zgrid((M + lmma::kZRows - 1) / lmma::kZRows, zsplit);
  const size_t zn = (size_t)(zsplit > 1 ? zsplit : 1) * M * r;
  float* zout = zsplit > 1 ? zpart : z;
  // the personalized pair over the bank, then the global pair as one client
  lmma::lora_mma_shrink_kernel<float><<<zgrid, lmma::kZThreads, 0, stream>>>(
      x, a1, ids, nullptr, zout, M, K, C, r, zsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lmma::lora_mma_shrink_kernel<float><<<zgrid, lmma::kZThreads, 0, stream>>>(
      x, a2, nullptr, nullptr, zout + zn, M, K, 1, r, zsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (split == 1) {
    const int nz = M * nq * 16;
    lora_mma_dual_zprep_kernel<<<(nz + 255) / 256, 256, 0, stream>>>(
        zpart, z, zl, ids, fw, slot, M, C, r, nq, alpha, zsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t nb = (size_t)(C + 1) * 2 * nq * 16 * N;
    lora_mma_dual_bprep_kernel<<<(unsigned)((nb + 255) / 256), 256, 0,
                                 stream>>>(b1, b2, bl, C, r, N, nq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // with split > 1 the tile runs no LoRA stage and reads no slot
  const int* tids = split == 1 ? slot : ids;
  switch (kind) {
    case 0:
      err = lmma::launch_tile<0>(x, w, zl, bl, tids, ypart, y, M, K, N, C + 1,
                                 2 * nq, split, stream);
      break;
    case 1:
      err = lmma::launch_tile<1>(x, w, zl, bl, tids, ypart, y, M, K, N, C + 1,
                                 2 * nq, split, stream);
      break;
    default:
      err = lmma::launch_tile<2>(x, w, zl, bl, tids, ypart, y, M, K, N, C + 1,
                                 2 * nq, split, stream);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const dim3 rgrid((N / 2 + 127) / 128, M);
  lora_mma_dual_reduce_kernel<<<rgrid, 128, 0, stream>>>(
      ypart, zpart, z, b1, b2, ids, fw, y, M, N, C, r, alpha, split, zsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) and y (M, N): float32 or bfloat16; w (K, N): float32 or
// bfloat16; a1 (C, K, r), b1 (C, r, N), a2 (K, r), b2 (r, N) and the
// fusion weights fw (M, 2): float32; ids (M,) int32; z: (2, M, r) float32
// scratch.  r <= 128.  bf16 x with bf16 W runs the tensor-core tile with
// the plan (kind, split, zsplit) and the scratch of run_mma (zpart, ypart,
// zl, bl, slot, each used only where its plan needs it); the fp32 tile
// uses z[0] only.  Returns the CUDA error code of the launches.
extern "C" int batched_dual_lora_matmul(
    const void* x, const void* w, const float* a1, const float* b1,
    const float* a2, const float* b2, const int* ids, const float* fw,
    float* z, float* zpart, float* ypart, void* zl, void* bl, int* slot,
    void* y, int M, int K, int N, int C, int r, int x_bf16, int w_bf16,
    int kind, int split, int zsplit, float alpha, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return run_mma((const lmma::bf16*)x, (const lmma::bf16*)w, a1, b1, a2,
                   b2, ids, fw, z, zpart, ypart, (lmma::bf16*)zl,
                   (lmma::bf16*)bl, slot, (lmma::bf16*)y, M, K, N, C, r,
                   alpha, kind, split, zsplit, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, a1, b1, a2, b2, ids, fw, z, y,
                                        M, K, N, C, r, alpha, s);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, a1, b1, a2, b2, ids, fw, z, y,
                                        M, K, N, C, r, alpha, s);
  return launch<float, float>(x, w, a1, b1, a2, b2, ids, fw, z, y, M, K, N,
                              C, r, alpha, s);
}
