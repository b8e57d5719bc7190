// Tensor-core LoRA tile for Hopper (sm_90a): the bf16 path of
// batched_lora_matmul (batched_lora.cu) and lora_matmul (lora_matmul.cu),
// and of the two dual-LoRA kernels, which feed it their own operands
// (dual_lora.cu: the merged pair through run(); batched_dual_lora.cu: the
// two pairs as one bank of concatenated rank, with their own preps and
// split-K reduction around this file's shrink and tile).
//
// It computes what the Pallas kernels repro/kernels/batched_lora.py::
// batched_lora_matmul and repro/kernels/lora_matmul.py::lora_matmul
// compute, for bf16 x (M, K) and bf16 W (K, N, n fastest):
//     y[m] = x[m]·W + alpha · s[g] · mask_r(x[m]·A[g]) · B[g]
// with per-row clients g (lora_matmul: one client, s = 1, no mask), fp32
// accumulation and ONE rounding to bf16.  z = x·A stays an fp32 tensor
// (A and B are fp32, or int8 with s = a_scale·b_scale).  A, z and B enter
// the tensor cores as two bf16 terms each, whose sum is within 2^-16 of
// the fp32 value: where the TPU kernels round A, z and B to bf16, z here
// stays within ~1e-5 (relative) of the plain version's fp32 z, which
// lora_matmul's backward reuses (dB = alpha·zᵀ·dy), and the LoRA term
// within ~3·2^-16 of its fp32 value.
//
// A call is three or four launches, planned in the Python wrapper by shape
// (kernels/lora_tile.py::plan, a pure function of M, N and K):
//   1. lora_mma_shrink_kernel: z = x·A over tiles of 64 rows and a range
//      of K, on mma.sync: x chunks and the A of up to 4 of the tile's
//      clients at a time (rows of one request are contiguous and share a
//      client, so a prefill tile has one) are staged once per 64-deep K
//      chunk, A split into two bf16 terms (hi + lo, within 2^-16 of A), so
//      z keeps fp32-level accuracy; a client's A is read once per tile,
//      never once per row.  The rank mask applies here.
//   2. When the base product does not split K (prefill, training):
//      lora_mma_zprep_kernel writes z (the sum of the shrink's partials, in
//      split order, when it split K) and the rows' alpha·s·z as bf16
//      hi / lo rows, and lora_mma_bprep_kernel the bank's B as bf16 hi /
//      lo rows, so that the tile adds the LoRA term as one more 64-deep
//      stage per client of the tile, copied and multiplied like an x·W
//      stage: z_hi·B_hi + z_lo·B_hi + z_hi·B_lo (the TPU kernel's one-hot
//      expand, here within ~3·2^-16 of fp32 where the TPU kernel rounds z
//      and B to bf16).  No staging registers are held beside the
//      accumulators.
//   3. lora_mma_kernel<KIND>: the LoRA stages, then x·W onto them on the
//      tensor cores (the primitives of mma_common.cuh), in one of three
//      CTA tiles (KIND):
//      - 128 x 256 for M > 64 (prefill, training): two warpgroups, each
//        wgmma.m64n256k16 on operands read from shared memory.  x and W
//        stream through a 4-stage cp.async ring of 64-deep stages stored
//        128-byte swizzled (x K-major, W N-major, in 1024-byte atoms);
//        copies run 2 stages ahead and one stage's products stay in
//        flight, one barrier per stage;
//      - 16 x 64 (4 warps) for M <= 16 (decode: rows padded to the mma's
//        16, narrow columns) and 64 x 128 (8 warps) for M <= 64:
//        mma.sync.m16n8k16 from a 3-stage ring of 64-deep stages whose
//        rows are padded by 16 bytes, so every 8-row ldmatrix phase (x as
//        A fragments, W through ldmatrix.trans as B fragments) hits 8
//        distinct 16-byte bank groups.
//      Edges are zero-filled (cp.async src-size 0), so M, N and K need not
//      be tile multiples; bf16 rows must start 16-byte aligned (K % 8 ==
//      0, N % 8 == 0, checked by the wrapper).  CTAs walk groups of 16 M
//      tiles per N tile, so those in flight share x and W in L2.  The fp32
//      sum is rounded once to bf16.  When the plan splits K (the decode
//      tiles, when they are fewer than the SMs), each CTA covers one K
//      range of x·W alone and writes fp32 partials.
//   4. lora_mma_reduce_kernel (only when the base product splits K): the
//      partials summed in a fixed order (no float atomics: a row's result
//      does not depend on scheduling), then the LoRA term in fp32 on the
//      CUDA cores (a few rows); it sums the shrink's partials too, in a
//      fixed order.
//
// Bound on this card: at the prefill and training shapes (M = 2048, K and
// N in the thousands) the operations of x·W on the tensor cores; at decode
// shapes (M = 8) the bytes of W, which split-K spreads over at least 132
// CTAs.  The shrink and the LoRA term are r/N and r/K of the base
// product's operations.  TMA copies and a warp-specialised producer (no
// thread instructions per copy, deeper pipelines) are the option for a
// later change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

// Everything has internal linkage: the four LoRA sources that include it
// are built into four libraries loaded into one process, and template
// statics (the shared-memory attribute below) must not be unified across
// them.
namespace lmma {
namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

constexpr int kBK = 64;      // K depth of one pipeline stage
constexpr int kStages = 3;   // cp.async ring of the mma.sync tiles
constexpr int kPad = 8;      // bf16 padding per shared row (16 bytes)

// One CTA tile: WARPS_M x WARPS_N warps, each WM m16 tiles by WN n16
// tiles (2 mma n8 tiles each).
template <int WM, int WN, int WARPS_M, int WARPS_N>
struct Cfg {
  static constexpr int kWM = WM, kWN = WN;
  static constexpr int kWarpsM = WARPS_M, kWarpsN = WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = 16 * WM * WARPS_M;
  static constexpr int BN = 16 * WN * WARPS_N;
  static constexpr int kXStride = kBK + kPad;  // bf16 elements
  static constexpr int kWStride = BN + kPad;
  static constexpr int kStageEl = BM * kXStride + kBK * kWStride;
  static constexpr size_t kRingBytes = (size_t)kStages * kStageEl * 2;
  static constexpr size_t kSmem = kRingBytes + 16 * BM;  // + tile_clients
  static constexpr int kMinBlocks = 2;
};

// The wgmma tile: 2 warpgroups, each 64 rows x 256 columns; its
// accumulators are laid out as 8 warps of 16 x 256 m16n8 fragments, as a
// Cfg's are.  A stage holds 128 x rows of 128 bytes and 4 blocks of 64 W
// columns x 64 k rows of 128 bytes, all 128-byte swizzled in 1024-byte
// atoms.
struct WgCfg {
  static constexpr int kWM = 1, kWN = 16;
  static constexpr int kWarpsM = 8, kWarpsN = 1;
  static constexpr int kThreads = 256;
  static constexpr int BM = 128, BN = 256;
  static constexpr int kStages = 4;
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kBK * BN * 2;
  // the ring, 1024-byte aligned inside the dynamic shared memory
  static constexpr size_t kRingBytes = (size_t)kStages * kStageBytes + 1024;
  static constexpr size_t kSmem = kRingBytes + 16 * BM;  // + tile_clients
  static constexpr int kMinBlocks = 1;
};

// the three tiles a plan picks (kernels/lora_tile.py: TILES)
template <int KIND> struct CfgOf { typedef WgCfg T; };           // 128 x 256
template <> struct CfgOf<0> { typedef Cfg<1, 1, 1, 4> T; };      // 16 x 64
template <> struct CfgOf<1> { typedef Cfg<2, 2, 2, 4> T; };      // 64 x 128
constexpr int kGroupM = 16;  // M tiles walked together (L2 reuse of W)

// The K tiles [lo, hi) of split s of n: the same formula as
// kernels/lora_tile.py::split_ranges.
__device__ __forceinline__ void split_range(int n, int s, int splits, int& lo,
                                            int& hi) {
  lo = (int)((long long)s * n / splits);
  hi = (int)((long long)(s + 1) * n / splits);
}

// The distinct clients of a tile's rows, in row order, into grp_s; returns
// their count (the same in every thread).  Row i's client is ids_s[i]
// (negative: no client), for ROWS <= blockDim.x rows; slot_s[i] receives
// the index of row i's client in grp_s (-1 for no client).  A tile whose
// live rows share one client (every prefill tile) needs no scan.  Every
// thread of the CTA must call it: it holds barriers.
template <int ROWS>
__device__ __forceinline__ int tile_clients(const int* ids_s, int* lead_s,
                                            int* grp_s, int* slot_s) {
  const int tid = threadIdx.x;
  const int g = tid < ROWS ? ids_s[tid] : -1;
  if (tid == 0) grp_s[0] = -1;
  __syncthreads();
  if (g >= 0) grp_s[0] = g;  // any live row's client
  __syncthreads();
  const int u = grp_s[0];
  if (!__syncthreads_or(g >= 0 && g != u)) {
    if (tid < ROWS) slot_s[tid] = g >= 0 ? 0 : -1;
    return __syncthreads_count(tid == 0 && u >= 0);
  }
  bool lead = g >= 0;
  for (int j = 0; j < tid && j < ROWS && lead; ++j) lead = ids_s[j] != g;
  if (tid < ROWS) lead_s[tid] = lead;
  __syncthreads();
  if (lead) {
    int pos = 0;
    for (int j = 0; j < tid; ++j) pos += lead_s[j];
    grp_s[pos] = g;
  }
  const int n = __syncthreads_count(lead);
  if (tid < ROWS) {
    int slot = -1;
    for (int k = 0; k < n && g >= 0 && slot < 0; ++k)
      if (grp_s[k] == g) slot = k;
    slot_s[tid] = slot;
  }
  __syncthreads();
  return n;
}

// x -> (hi, lo): two bf16 terms whose sum is within 2^-16 of x
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

// ---------------------------------------------------------------------------
// 1. shrink: z = x·A (fp32), rank-masked
// ---------------------------------------------------------------------------

constexpr int kZRows = 64;     // rows per shrink CTA, 16 per warp
constexpr int kZK = 64;        // K per staged chunk
constexpr int kZJ = 16;        // rank columns per client and pass
constexpr int kZG = 4;         // clients per pass
constexpr int kZThreads = 128;
constexpr int kZXStride = kZK + kPad;        // bf16 per staged x row
constexpr int kZAStride = kZG * kZJ + kPad;  // bf16 per staged A row
constexpr int kZALoads = kZK * kZJ / kZThreads;  // A values a thread, a client

// Writes rows [m0, m0 + 64) of ``out`` (M x r): the partial x·A over the K
// chunks of split blockIdx.y (the whole z when zsplit == 1).  Rows whose
// id lies outside [0, C) get zeros; rank columns at or past ranks[g] too.
//
// On the tensor cores, per pass over up to kZG of the tile's clients (a
// prefill tile has one; decode rows and request boundaries more): x
// chunks double-buffered by cp.async as mma A fragments (rows of other
// clients zeroed), and the pass's clients' A (fp32, or int8 with its scale
// left for the LoRA term) side by side as mma B operands, each split into
// two bf16 terms, A = hi + lo with |A - hi - lo| <= 2^-16 |A| (int8:
// exact, lo = 0), so z = x·hi + x·lo keeps fp32-level accuracy.  Each
// client's A is read once per tile, never once per row; a row keeps the
// columns of its own client.
template <typename BT>
__global__ void __launch_bounds__(kZThreads, 1)
    lora_mma_shrink_kernel(const bf16* __restrict__ x,
                           const BT* __restrict__ a,
                           const int* __restrict__ ids,
                           const int* __restrict__ ranks,
                           float* __restrict__ zout, int M, int K, int C,
                           int r, int zsplit) {
  __shared__ __align__(16) bf16 xs[2][kZRows * kZXStride];
  __shared__ __align__(16) bf16 ahi[kZK * kZAStride];
  __shared__ __align__(16) bf16 alo[kZK * kZAStride];
  __shared__ int ids_s[kZRows], lead_s[kZRows], grp_s[kZRows],
      slot_s[kZRows];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kZRows;
  int c_lo, c_hi;
  split_range((K + kZK - 1) / kZK, blockIdx.y, zsplit, c_lo, c_hi);
  float* out = zout + (size_t)blockIdx.y * M * r;

  if (tid < kZRows) {
    int g = -2;  // -1: a dead row, -2: past M
    if (m0 + tid < M) {
      g = ids ? ids[m0 + tid] : 0;
      if (g < 0 || g >= C) g = -1;
    }
    ids_s[tid] = g;
  }
  const int n = tile_clients<kZRows>(ids_s, lead_s, grp_s, slot_s);
  {  // dead rows: zeros (two threads a row)
    const int i = tid % kZRows;
    if (ids_s[i] == -1)
      for (int j = tid / kZRows; j < r; j += kZThreads / kZRows)
        out[(size_t)(m0 + i) * r + j] = 0.f;
  }

  float ar[kZG][kZALoads];
  for (int p0 = 0; p0 < n; p0 += kZG) {
    const int cnt = min(kZG, n - p0);
    for (int j0 = 0; j0 < r; j0 += kZJ) {
      // x chunk c (64 rows, 8 chunks of 16 bytes each) into buffer b; rows
      // of no client of the pass, past M or past K are zero-filled
      auto load_x = [&](int c, int b) {
#pragma unroll
        for (int t = 0; t < kZRows * (kZK / 8) / kZThreads; ++t) {
          const int e = tid + t * kZThreads;
          const int row = e / (kZK / 8), kc = e % (kZK / 8);
          const int k = c * kZK + kc * 8, sl = slot_s[row] - p0;
          const bool ok = sl >= 0 && sl < cnt && k < K;
          tc::cp_async16(&xs[b][row * kZXStride + kc * 8],
                         ok ? x + (size_t)(m0 + row) * K + k : x, ok);
        }
      };
      // chunk c of the pass's clients' A, columns j0 .. j0 + 15 each:
      // thread t takes rows (t + 128 i) / 16, column t % 16 of each client
      auto fetch_a = [&](int c) {
        const int jj = tid % kZJ, j = j0 + jj;
#pragma unroll
        for (int ci = 0; ci < kZG; ++ci) {
          const BT* ac = a + (size_t)grp_s[p0 + min(ci, cnt - 1)] * K * r;
#pragma unroll
          for (int t = 0; t < kZALoads; ++t) {
            const int k = c * kZK + (tid + t * kZThreads) / kZJ;
            ar[ci][t] = (ci < cnt && k < K && j < r)
                            ? to_f(ac[(size_t)k * r + j])
                            : 0.f;
          }
        }
      };
      auto stash_a = [&]() {
#pragma unroll
        for (int ci = 0; ci < kZG; ++ci) {
          if (ci >= cnt) continue;
#pragma unroll
          for (int t = 0; t < kZALoads; ++t) {
            const int e = tid + t * kZThreads;
            const int at = (e / kZJ) * kZAStride + ci * kZJ + e % kZJ;
            split_bf16(ar[ci][t], ahi[at], alo[at]);
          }
        }
      };
      float acc[kZG][2][4];
#pragma unroll
      for (int ci = 0; ci < kZG; ++ci)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[ci][e / 4][e % 4] = 0.f;
      if (c_lo < c_hi) {
        load_x(c_lo, 0);
        fetch_a(c_lo);
      }
      tc::cp_async_commit();
      for (int c = c_lo; c < c_hi; ++c) {
        const int b = (c - c_lo) & 1;
        tc::cp_async_wait_all();
        __syncthreads();  // every warp is done with chunk c - 1
        stash_a();
        if (c + 1 < c_hi) {
          load_x(c + 1, b ^ 1);
          fetch_a(c + 1);  // in flight while this chunk multiplies
        }
        tc::cp_async_commit();
        __syncthreads();  // chunk c staged
#pragma unroll
        for (int kk = 0; kk < kZK; kk += 16) {
          uint32_t af[4];
          tc::ldsm_x4(tc::smem_addr(&xs[b][(warp * 16 + lane % 16) *
                                               kZXStride +
                                           kk + (lane / 16) * 8]),
                      af[0], af[1], af[2], af[3]);
          const int at = (kk + ((lane / 8) & 1) * 8 + lane % 8) * kZAStride +
                         (lane / 16) * 8;
#pragma unroll
          for (int ci = 0; ci < kZG; ++ci) {
            if (ci < cnt) {
              uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
              tc::ldsm_x4_trans(tc::smem_addr(&ahi[at + ci * kZJ]), h0, h1,
                                h2, h3);
              tc::ldsm_x4_trans(tc::smem_addr(&alo[at + ci * kZJ]), l0, l1,
                                l2, l3);
              tc::mma_bf16(acc[ci][0], af, h0, h1);
              tc::mma_bf16(acc[ci][1], af, h2, h3);
              tc::mma_bf16(acc[ci][0], af, l0, l1);
              tc::mma_bf16(acc[ci][1], af, l2, l3);
            }
          }
        }
      }
      tc::cp_async_wait_all();
      __syncthreads();  // the buffers are free for the next pass
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + lane / 4 + 8 * h;
        const int sl = slot_s[row] - p0;
        if (sl < 0 || sl >= cnt) continue;
        const int rank = ranks ? ranks[grp_s[slot_s[row]]] : r;
#pragma unroll
        for (int ci = 0; ci < kZG; ++ci) {
          if (ci != sl) continue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + 8 * nt + 2 * (lane % 4) + e;
              if (j < r)
                out[(size_t)(m0 + row) * r + j] =
                    j < rank ? acc[ci][nt][2 * h + e] : 0.f;
            }
        }
      }
    }
  }
}

// 2. The LoRA term's operands for the tile, as bf16 rows it copies like x
// and W (kernels lora_mma_zprep_kernel and lora_mma_bprep_kernel):
//   zl[m][qc] = 64 bf16: [hi(zs) | lo(zs) | hi(zs) | 0] of the 16 values
//               zs = alpha·s[g]·z[m][16qc .. 16qc + 15] (zeros past r and
//               for rows with no client);
//   bl[c][qc] = 32 rows of N bf16: hi(B[c][16qc + t]) for t < 16, then
//               lo(B[c][16qc + t]) (zeros past r);
// so one 64-deep stage [zl rows] x [hi ; hi ; lo ; 0 rows of bl] adds
// zs_hi·B_hi + zs_lo·B_hi + zs_hi·B_lo (hi + lo within 2^-16 of a value).
constexpr int kLK = 3 * 16;  // live depth of a LoRA stage (the rest is 0)

// z (the sum of the shrink's partials, in split order, when it split K)
// and zl; one thread per (m, q), q < 16·nq.
__global__ void lora_mma_zprep_kernel(const float* __restrict__ zpart,
                                      float* __restrict__ z,
                                      bf16* __restrict__ zl,
                                      const int* __restrict__ ids,
                                      const float* __restrict__ a_scale,
                                      const float* __restrict__ b_scale,
                                      int M, int nclients, int r, int nq,
                                      float alpha, int zsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * nq * 16) return;
  const int m = i / (nq * 16), q = i % (nq * 16);
  float v = 0.f;
  if (q < r) {
    if (zsplit > 1) {
      for (int p = 0; p < zsplit; ++p) v += zpart[((size_t)p * M + m) * r + q];
      z[(size_t)m * r + q] = v;
    } else {
      v = z[(size_t)m * r + q];
    }
  }
  const int g = ids ? ids[m] : 0;
  const bool live = g >= 0 && g < nclients;
  bf16 hi, lo;
  split_bf16(
      live ? alpha * (a_scale ? a_scale[g] * b_scale[g] : 1.f) * v : 0.f,
      hi, lo);
  bf16* row = zl + ((size_t)m * nq + q / 16) * 64 + q % 16;
  row[0] = hi;
  row[16] = lo;
  row[32] = hi;
  row[48] = __float2bfloat16(0.f);
}

// bl for every client; one thread per element of bl's hi half.
template <typename BT>
__global__ void lora_mma_bprep_kernel(const BT* __restrict__ b,
                                      bf16* __restrict__ bl, int C, int r,
                                      int N, int nq) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)C * nq * 16 * N) return;
  const int n = (int)(i % N), t = (int)(i / N % 16);
  const size_t cq = i / N / 16;  // c·nq + qc
  const int q = (int)(cq % nq) * 16 + t, c = (int)(cq / nq);
  bf16 hi, lo;
  split_bf16(q < r ? to_f(b[((size_t)c * r + q) * N + n]) : 0.f, hi, lo);
  bf16* out = bl + (cq * 32 + t) * N + n;
  out[0] = hi;
  out[(size_t)16 * N] = lo;
}

// The source row in bl of row kk of a LoRA stage (hi, hi, lo, then none).
__device__ __forceinline__ int lora_brow(int kk) {
  return kk < 32 ? (kk & 15) : 16 + (kk & 15);
}

// One LoRA stage of client u, rank chunk qc, into the mma.sync tile's
// padded layout: x rows from zl (rows of other clients zero-filled), W
// rows from bl (lora_brow; rows kLK .. 63 zero-filled).
template <class C>
__device__ __forceinline__ void load_lora_stage(
    bf16* __restrict__ st, const bf16* __restrict__ zl,
    const bf16* __restrict__ bl, const int* ids_s, int u, int qc, int nq,
    int M, int N, int m0, int n0) {
  bf16* Ws = st + C::BM * C::kXStride;
  for (int e = threadIdx.x; e < C::BM * (kBK / 8); e += C::kThreads) {
    const int row = e / (kBK / 8), c = e % (kBK / 8);
    const bool ok = m0 + row < M && ids_s[row] == u;
    tc::cp_async16(st + row * C::kXStride + c * 8,
                   ok ? zl + ((size_t)(m0 + row) * nq + qc) * 64 + c * 8 : zl,
                   ok);
  }
  for (int e = threadIdx.x; e < kBK * (C::BN / 8); e += C::kThreads) {
    const int kk = e / (C::BN / 8), n = n0 + e % (C::BN / 8) * 8;
    const bool ok = kk < kLK && n < N;
    tc::cp_async16(
        Ws + kk * C::kWStride + (n - n0),
        ok ? bl + ((size_t)(u * nq + qc) * 32 + lora_brow(kk)) * N + n : bl,
        ok);
  }
}

// The same into the wgmma tile's 128-byte-swizzled layout.
template <class C>
__device__ __forceinline__ void load_lora_stage_wg(
    unsigned char* __restrict__ st, const bf16* __restrict__ zl,
    const bf16* __restrict__ bl, const int* ids_s, int u, int qc, int nq,
    int M, int N, int m0, int n0) {
  for (int e = threadIdx.x; e < C::BM * 8; e += C::kThreads) {
    const int row = e / 8, c = e % 8;
    const bool ok = m0 + row < M && ids_s[row] == u;
    tc::cp_async16(st + row * 128 + ((c ^ (row & 7)) << 4),
                   ok ? zl + ((size_t)(m0 + row) * nq + qc) * 64 + c * 8 : zl,
                   ok);
  }
  unsigned char* ws = st + C::kXBytes;
  for (int e = threadIdx.x; e < kBK * (C::BN / 8); e += C::kThreads) {
    const int kk = e / (C::BN / 8), c = e % (C::BN / 8), n = n0 + c * 8;
    const bool ok = kk < kLK && n < N;
    tc::cp_async16(
        ws + (c / 8) * (kBK * 128) + kk * 128 + (((c % 8) ^ (kk & 7)) << 4),
        ok ? bl + ((size_t)(u * nq + qc) * 32 + lora_brow(kk)) * N + n : bl,
        ok);
  }
}

// ---------------------------------------------------------------------------
// 3. the base product on the tensor cores
// ---------------------------------------------------------------------------

// Copy K tile [k0, k0 + kBK) of the x rows and W columns of the CTA's
// tile into one ring stage; out-of-range 16-byte chunks are zero-filled.
// Thread t copies the same chunk column of rows t / chunks-per-row + a
// fixed stride each pass, so the addresses step by a constant.
template <class C>
__device__ __forceinline__ void load_stage(bf16* __restrict__ st,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int M,
                                           int K, int N, int m0, int n0,
                                           int k0) {
  bf16* Xs = st;
  bf16* Ws = st + C::BM * C::kXStride;
  constexpr int kXC = kBK / 8;                 // chunks per x row
  constexpr int kXRows = C::kThreads / kXC;    // x rows per pass
  static_assert(C::BM % kXRows == 0 || C::BM < kXRows, "x passes");
  const int xc = threadIdx.x % kXC, xr = threadIdx.x / kXC;
  const int kx = k0 + xc * 8;
  const bf16* xs = x + (size_t)(m0 + xr) * K + kx;
#pragma unroll
  for (int t = 0; t < (C::BM + kXRows - 1) / kXRows; ++t) {
    const int row = xr + t * kXRows;
    if (row < C::BM) {
      const bool ok = m0 + row < M && kx < K;
      tc::cp_async16(Xs + row * C::kXStride + xc * 8,
                     ok ? xs + (size_t)t * kXRows * K : x, ok);
    }
  }
  constexpr int kWC = C::BN / 8;               // chunks per W row
  constexpr int kWRows = C::kThreads / kWC;    // W rows per pass
  static_assert(kBK % kWRows == 0, "W passes");
  const int wc = threadIdx.x % kWC, wr = threadIdx.x / kWC;
  const int n = n0 + wc * 8;
  const bf16* ws = w + (size_t)(k0 + wr) * N + n;
#pragma unroll
  for (int t = 0; t < kBK / kWRows; ++t) {
    const int kk = wr + t * kWRows;
    const bool ok = k0 + kk < K && n < N;
    tc::cp_async16(Ws + kk * C::kWStride + wc * 8,
                   ok ? ws + (size_t)t * kWRows * N : w, ok);
  }
}

// The warp's A fragments (x rows, ldmatrix) and B fragments (W columns,
// ldmatrix.trans) of the k16 step at column kk of a stage.
template <class C>
__device__ __forceinline__ void load_frags(const bf16* Xs, const bf16* Ws,
                                           int kk, int wm, int wn, int lane,
                                           uint32_t (&af)[C::kWM][4],
                                           uint32_t (&bfr)[C::kWN][4]) {
#pragma unroll
  for (int i = 0; i < C::kWM; ++i) {
    const int row = wm * 16 * C::kWM + 16 * i + (lane % 16);
    tc::ldsm_x4(tc::smem_addr(Xs + row * C::kXStride + kk + (lane / 16) * 8),
                af[i][0], af[i][1], af[i][2], af[i][3]);
  }
#pragma unroll
  for (int j = 0; j < C::kWN; ++j) {
    const int krow = kk + ((lane / 8) & 1) * 8 + (lane % 8);
    const int col = wn * 16 * C::kWN + 16 * j + (lane / 16) * 8;
    tc::ldsm_x4_trans(tc::smem_addr(Ws + krow * C::kWStride + col), bfr[j][0],
                      bfr[j][1], bfr[j][2], bfr[j][3]);
  }
}

// acc += the first STEPS k16 steps of one staged x tile (Xs) by W tile
// (Ws) on mma.sync.  Fragments of step kk + 1 are loaded before the mmas
// of step kk, so the ldmatrix latency hides behind the mma queue.
template <class C, int STEPS>
__device__ __forceinline__ void stage_mma(const bf16* Xs, const bf16* Ws,
                                          float (&acc)[C::kWM][2 * C::kWN][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  uint32_t af[2][C::kWM][4], bfr[2][C::kWN][4];
  load_frags<C>(Xs, Ws, 0, wm, wn, lane, af[0], bfr[0]);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    if (kk + 1 < STEPS)
      load_frags<C>(Xs, Ws, 16 * (kk + 1), wm, wn, lane, af[(kk + 1) & 1],
                    bfr[(kk + 1) & 1]);
#pragma unroll
    for (int i = 0; i < C::kWM; ++i)
#pragma unroll
      for (int j = 0; j < C::kWN; ++j) {
        tc::mma_bf16(acc[i][2 * j], af[kk & 1][i], bfr[kk & 1][j][0],
                     bfr[kk & 1][j][1]);
        tc::mma_bf16(acc[i][2 * j + 1], af[kk & 1][i], bfr[kk & 1][j][2],
                     bfr[kk & 1][j][3]);
      }
  }
}

// The LoRA stages of a CTA (lora_setup): stage s < stages multiplies the
// zl rows of client grp_s[s / nq], rank chunk s % nq, by its bl rows.
struct LoraStages {
  const bf16* zl;
  const bf16* bl;
  const int* ids_s;  // the tile's rows' clients (-1: none)
  const int* grp_s;  // the tile's clients, in row order
  int nq, stages;
};

// acc += the LoRA stages, then x·W over K tiles [kt_lo, kt_hi), for the
// CTA's (m0, n0) tile.  The LoRA stages run one by one in the ring slot
// that the x·W prologue leaves free, their copies issued after the
// prologue's, so both are in flight together.  Warp (wm, wn) owns rows
// wm·16·WM + 16i + {g, g + 8} and columns wn·16·WN + 8j + 2t + {0, 1} of
// acc[i][j] (g = lane / 4, t = lane % 4).
template <class C>
__device__ __forceinline__ void mainloop(
    const bf16* __restrict__ x, const bf16* __restrict__ w, int M, int K,
    int N, int m0, int n0, int kt_lo, int kt_hi, const LoraStages& lo,
    bf16* smem, float (&acc)[C::kWM][2 * C::kWN][4]) {
  const int nk = kt_hi - kt_lo;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<C>(smem + s * C::kStageEl, x, w, M, K, N, m0, n0,
                    (kt_lo + s) * kBK);
    tc::cp_async_commit();
  }
  bf16* spare = smem + (kStages - 1) * C::kStageEl;
  for (int s = 0; s < lo.stages; ++s) {
    load_lora_stage<C>(spare, lo.zl, lo.bl, lo.ids_s, lo.grp_s[s / lo.nq],
                       s % lo.nq, lo.nq, M, N, m0, n0);
    tc::cp_async_commit();
    tc::cp_async_wait_all();
    __syncthreads();
    stage_mma<C, kLK / 16>(spare, spare + C::BM * C::kXStride, acc);
    __syncthreads();  // the slot is free again
  }
  for (int it = 0; it < nk; ++it) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    const int nxt = it + kStages - 1;
    if (nxt < nk)
      load_stage<C>(smem + (nxt % kStages) * C::kStageEl, x, w, M, K, N, m0,
                    n0, (kt_lo + nxt) * kBK);
    tc::cp_async_commit();
    const bf16* Xs = smem + (it % kStages) * C::kStageEl;
    stage_mma<C, kBK / 16>(Xs, Xs + C::BM * C::kXStride, acc);
  }
  tc::cp_async_wait_all();
}

// One ring stage of the wgmma tile: K tile [k0, k0 + 64) of the CTA's x
// rows and W columns, each 16-byte chunk at its 128-byte-swizzled place
// (chunk c of row r of a 1024-byte atom at chunk c ^ r); out-of-range
// chunks are zero-filled.
template <class C>
__device__ __forceinline__ void load_stage_wg(unsigned char* __restrict__ st,
                                              const bf16* __restrict__ x,
                                              const bf16* __restrict__ w,
                                              int M, int K, int N, int m0,
                                              int n0, int k0) {
  static_assert(kBK == 64, "a stage row is 128 bytes");
  const int tid = threadIdx.x;
  const int xc = tid % 8, xr = tid / 8;  // x: 8 chunks a row, 32 rows a pass
  const int kx = k0 + xc * 8;
#pragma unroll
  for (int t = 0; t < C::BM / 32; ++t) {
    const int row = xr + 32 * t;
    const bool ok = m0 + row < M && kx < K;
    tc::cp_async16(st + row * 128 + ((xc ^ (row & 7)) << 4),
                   ok ? x + (size_t)(m0 + row) * K + kx : x, ok);
  }
  // W: BN / 8 chunks a k row, in blocks of 64 columns (8 chunks)
  constexpr int kWC = C::BN / 8, kWRows = C::kThreads / kWC;
  unsigned char* ws = st + C::kXBytes;
  const int c = tid % kWC, wr = tid / kWC;
  const int n = n0 + c * 8;
#pragma unroll
  for (int t = 0; t < kBK / kWRows; ++t) {
    const int kk = wr + kWRows * t;
    const bool ok = k0 + kk < K && n < N;
    tc::cp_async16(ws + (c / 8) * (kBK * 128) + kk * 128 +
                       (((c % 8) ^ (kk & 7)) << 4),
                   ok ? w + (size_t)(k0 + kk) * N + n : w, ok);
  }
}

// Issue acc += the first STEPS k16 steps of staged tile st on wgmma, as
// one committed group: warpgroup wg multiplies x rows wg·64 .. wg·64 + 63
// by the stage's 256 W columns (A descriptors step 32 bytes along the
// swizzled x rows, B descriptors 16 k rows; B's leading offset is the
// stride between its 64-column blocks).
template <class C, int STEPS>
__device__ __forceinline__ void stage_wg(unsigned char* st,
                                         float (&acc)[C::BN / 2]) {
  const uint32_t xa = tc::smem_addr(st) + (threadIdx.x / 128) * 64 * 128;
  const uint32_t wa = tc::smem_addr(st + C::kXBytes);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    tc::wgmma_m64n256k16(acc, tc::wgmma_desc(xa + 32 * kk, 16, 1024),
                         tc::wgmma_desc(wa + 2048 * kk, kBK * 128, 1024));
  tc::wgmma_commit();
}

// The same on wgmma, 4 m64n256k16 products per 64-deep stage.  Copies run
// 2 stages ahead of the products and one stage's products stay in flight,
// so a ring slot is refilled only after the products that read it (2
// stages back) have completed.
template <class C>
__device__ __forceinline__ void mainloop_wg(const bf16* __restrict__ x,
                                            const bf16* __restrict__ w,
                                            int M, int K, int N, int m0,
                                            int n0, int kt_lo, int kt_hi,
                                            const LoraStages& lo,
                                            unsigned char* smem_raw,
                                            float (&acc)[C::BN / 2]) {
  constexpr int S = C::kStages;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nk = kt_hi - kt_lo;
#pragma unroll
  for (int s = 0; s < S - 2; ++s) {
    if (s < nk)
      load_stage_wg<C>(smem + s * C::kStageBytes, x, w, M, K, N, m0, n0,
                       (kt_lo + s) * kBK);
    tc::cp_async_commit();
  }
  unsigned char* spare = smem + (S - 1) * C::kStageBytes;
  for (int s = 0; s < lo.stages; ++s) {
    load_lora_stage_wg<C>(spare, lo.zl, lo.bl, lo.ids_s, lo.grp_s[s / lo.nq],
                          s % lo.nq, lo.nq, M, N, m0, n0);
    tc::cp_async_commit();
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();
    stage_wg<C, kLK / 16>(spare, acc);
    tc::wgmma_wait<0>();
    __syncthreads();  // the slot is free again
  }
  for (int it = 0; it < nk; ++it) {
    tc::cp_async_wait<S - 3>();
    tc::fence_proxy_async();
    __syncthreads();  // stage it landed; stage it - 2's products are done
    const int nxt = it + S - 2;
    if (nxt < nk)
      load_stage_wg<C>(smem + (nxt % S) * C::kStageBytes, x, w, M, K, N, m0,
                       n0, (kt_lo + nxt) * kBK);
    tc::cp_async_commit();
    stage_wg<C, kBK / 16>(smem + (it % S) * C::kStageBytes, acc);
    tc::wgmma_wait<1>();
  }
  tc::wgmma_wait<0>();
  tc::cp_async_wait_all();
}

// The LoRA stages of the CTA's tile: one per (client of the tile, 16 rank
// columns), so a client's B is read once per tile.  A prefill tile has
// one client; a tile of decode rows or a request boundary more.  With no
// zl (the plan splits K) there are none.
template <class C>
__device__ __forceinline__ LoraStages lora_setup(const bf16* zl,
                                                 const bf16* bl,
                                                 const int* __restrict__ ids,
                                                 int nclients, int M, int nq,
                                                 int m0,
                                                 unsigned char* smem_raw) {
  static_assert(C::BM <= C::kThreads, "a thread per row");
  int* ids_s = reinterpret_cast<int*>(smem_raw + C::kRingBytes);
  int* lead_s = ids_s + C::BM;
  int* grp_s = lead_s + C::BM;
  int* slot_s = grp_s + C::BM;
  if (zl == nullptr) return LoraStages{zl, bl, ids_s, grp_s, nq, 0};
  const int tid = threadIdx.x;
  if (tid < C::BM) {
    int g = -1;
    if (m0 + tid < M) {
      g = ids ? ids[m0 + tid] : 0;
      if (g >= nclients) g = -1;
    }
    ids_s[tid] = g < 0 ? -1 : g;
  }
  const int n = tile_clients<C::BM>(ids_s, lead_s, grp_s, slot_s);
  return LoraStages{zl, bl, ids_s, grp_s, nq, n * nq};
}

// Grid (M tiles x N tiles, 1, split), walked in groups of kGroupM M tiles
// per N tile, so that the CTAs in flight share their x rows and W columns
// in L2.  split == 1: the LoRA stages (from zl and bl) and the whole K of
// x·W, and one rounding to bf16 into y.  split > 1: the K tiles of split
// blockIdx.z into fp32 partials ypart[split][M][N].
template <int KIND>
__global__ void __launch_bounds__(CfgOf<KIND>::T::kThreads,
                                  CfgOf<KIND>::T::kMinBlocks)
    lora_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ zl, const bf16* __restrict__ bl,
                    const int* __restrict__ ids, float* __restrict__ ypart,
                    bf16* __restrict__ y, int M, int K, int N, int nclients,
                    int nq, int split) {
  typedef typename CfgOf<KIND>::T C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m_tiles = (M + C::BM - 1) / C::BM;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  const int group = blockIdx.x / (kGroupM * n_tiles);
  const int first = group * kGroupM;
  const int gm = min(m_tiles - first, kGroupM);
  const int in_group = blockIdx.x % (kGroupM * n_tiles);
  const int m0 = (first + in_group % gm) * C::BM;
  const int n0 = (in_group / gm) * C::BN;
  int kt_lo, kt_hi;
  split_range((K + kBK - 1) / kBK, blockIdx.z, split, kt_lo, kt_hi);
  float acc[C::kWM][2 * C::kWN][4];
#pragma unroll
  for (int i = 0; i < C::kWM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * C::kWN; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const LoraStages lo = lora_setup<C>(split == 1 ? zl : nullptr, bl, ids,
                                      nclients, M, nq, m0, smem_raw);
  if constexpr (KIND == 2)
    mainloop_wg<C>(x, w, M, K, N, m0, n0, kt_lo, kt_hi, lo, smem_raw,
                   reinterpret_cast<float(&)[C::BN / 2]>(acc));
  else
    mainloop<C>(x, w, M, K, N, m0, n0, kt_lo, kt_hi, lo,
                reinterpret_cast<bf16*>(smem_raw), acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
#pragma unroll
  for (int i = 0; i < C::kWM; ++i) {
    const int r0 = m0 + wm * 16 * C::kWM + 16 * i + lane / 4;
#pragma unroll
    for (int j = 0; j < 2 * C::kWN; ++j) {
      const int c = n0 + wn * 16 * C::kWN + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;  // N is even, so c + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m >= M) continue;
        if (split == 1) {
          *reinterpret_cast<uint32_t*>(y + (size_t)m * N + c) =
              tc::pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(
              ypart + ((size_t)blockIdx.z * M + m) * N + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// 4. y[m, n, n + 1] = sum over splits (in order) of the partials, plus
// alpha·s[g]·z[m]·B[g] in fp32 (rank order); grid (N / 256, M).  With
// zsplit > 1 the CTA first sums row m's shrink partials itself (the same
// fixed order in every CTA), and the CTAs of blockIdx.x == 0 write z.
template <typename BT>
__global__ void __launch_bounds__(128)
    lora_mma_reduce_kernel(const float* __restrict__ ypart,
                           const float* __restrict__ zpart,
                           const BT* __restrict__ b,
                           const float* __restrict__ a_scale,
                           const float* __restrict__ b_scale,
                           const int* __restrict__ ids, float* __restrict__ z,
                           bf16* __restrict__ y, int M, int N, int nclients,
                           int r, float alpha, int split, int zsplit) {
  __shared__ float zr[128];
  __shared__ float part[128];
  const int m = blockIdx.y, tid = threadIdx.x;
  const int g = ids ? ids[m] : 0;
  const bool live = g >= 0 && g < nclients;
  const float scl =
      live ? alpha * (a_scale ? a_scale[g] * b_scale[g] : 1.f) : 0.f;
  if (zsplit > 1) {
    // thread (grp, q) sums splits grp, grp + ngrp, ...; then the groups
    // are added in order
    const int ngrp = 128 / r, q = tid % r, grp = tid / r;
    float s = 0.f;
    if (grp < ngrp)
      for (int p = grp; p < zsplit; p += ngrp)
        s += zpart[((size_t)p * M + m) * r + q];
    part[tid] = s;
    __syncthreads();
    if (tid < r) {
      float t = 0.f;
      for (int k = 0; k < ngrp; ++k) t += part[k * r + tid];
      zr[tid] = scl * t;
      if (blockIdx.x == 0) z[(size_t)m * r + tid] = t;
    }
  } else {
    for (int q = tid; q < r; q += 128) zr[q] = scl * z[(size_t)m * r + q];
  }
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
  if (live) {
    const BT* bg = b + (size_t)g * r * N + n;
#pragma unroll 8
    for (int q = 0; q < r; ++q) {
      const float zq = zr[q];
      acc.x = fmaf(zq, to_f(bg[(size_t)q * N]), acc.x);
      acc.y = fmaf(zq, to_f(bg[(size_t)q * N + 1]), acc.y);
    }
  }
  *reinterpret_cast<uint32_t*>(y + (size_t)m * N + n) =
      tc::pack_bf16(acc.x, acc.y);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int KIND>
cudaError_t launch_tile(const bf16* x, const bf16* w, const bf16* zl,
                        const bf16* bl, const int* ids, float* ypart, bf16* y,
                        int M, int K, int N, int nclients, int nq, int split,
                        cudaStream_t stream) {
  typedef typename CfgOf<KIND>::T C;
  static const cudaError_t attr =
      tc::allow_smem(lora_mma_kernel<KIND>, C::kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN), 1,
            split);
  lora_mma_kernel<KIND><<<grid, C::kThreads, C::kSmem, stream>>>(
      x, w, zl, bl, ids, ypart, y, M, K, N, nclients, nq, split);
  return cudaGetLastError();
}

// The whole call: shrink, then either (split == 1) the LoRA operands and
// the tile, or (split > 1) the tile's partials and the reduction.  a (C,
// K, r), b (C, r, N) fp32 or int8 (with a_scale, b_scale); ids null means
// every row is client 0; ranks may be null.  z (M, r) receives x·A
// (rank-masked).  Scratch, fp32-aligned: zpart (zsplit, M, r) fp32 when
// zsplit > 1; ypart (split, M, N) fp32 when split > 1; zl (M, nq, 64) and
// bl (C, nq, 32, N) bf16 when split == 1, nq = ceil(r / 16).
template <typename BT>
int run(const bf16* x, const bf16* w, const BT* a, const BT* b,
        const float* a_scale, const float* b_scale, const int* ranks,
        const int* ids, float* z, float* zpart, float* ypart, bf16* zl,
        bf16* bl, bf16* y, int M, int K, int N, int nclients, int r,
        float alpha, int kind, int split, int zsplit, cudaStream_t stream) {
  const int nq = (r + 15) / 16;
  if (kind < 0 || kind > 2 || split < 1 || zsplit < 1 || r < 1 || r > 128 ||
      K % 8 || N % 8 || (split > 1 && ypart == nullptr) ||
      (zsplit > 1 && zpart == nullptr) ||
      (split == 1 && (zl == nullptr || bl == nullptr)))
    return (int)cudaErrorInvalidValue;
  dim3 zgrid((M + kZRows - 1) / kZRows, zsplit);
  lora_mma_shrink_kernel<BT><<<zgrid, kZThreads, 0, stream>>>(
      x, a, ids, ranks, zsplit > 1 ? zpart : z, M, K, nclients, r, zsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (split == 1) {
    const int nz = M * nq * 16;
    lora_mma_zprep_kernel<<<(nz + 255) / 256, 256, 0, stream>>>(
        zpart, z, zl, ids, a_scale, b_scale, M, nclients, r, nq, alpha,
        zsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t nb = (size_t)nclients * nq * 16 * N;
    lora_mma_bprep_kernel<BT><<<(unsigned)((nb + 255) / 256), 256, 0,
                                stream>>>(b, bl, nclients, r, N, nq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (kind) {
    case 0:
      err = launch_tile<0>(x, w, zl, bl, ids, ypart, y, M, K, N, nclients,
                           nq, split, stream);
      break;
    case 1:
      err = launch_tile<1>(x, w, zl, bl, ids, ypart, y, M, K, N, nclients,
                           nq, split, stream);
      break;
    default:
      err = launch_tile<2>(x, w, zl, bl, ids, ypart, y, M, K, N, nclients,
                           nq, split, stream);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  dim3 rgrid((N / 2 + 127) / 128, M);
  lora_mma_reduce_kernel<BT><<<rgrid, 128, 0, stream>>>(
      ypart, zpart, b, a_scale, b_scale, ids, z, y, M, N, nclients, r, alpha,
      split, zsplit);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lmma
