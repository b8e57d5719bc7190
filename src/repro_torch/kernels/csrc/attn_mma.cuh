// Tensor-core attention tile for Hopper (sm_90a), shared by the bf16 paths
// of the chunked paged-prefill kernel (paged_prefill.cu) and the flash
// attention kernel (flash_attention.cu).
//
// It computes what the Pallas kernels repro/kernels/paged_prefill.py::
// paged_prefill_attention and repro/kernels/flash_attention.py::
// flash_attention compute: fp32 scores Q·Kᵀ·scale under a per-row key
// range, an online softmax kept in fp32 across key tiles, and P·V with P
// rounded to the value dtype (bf16) before the product, as both TPU
// kernels round it; the output is normalised and rounded once.
//
// Design (FlashAttention-2 style):
// - One CTA of 4 warps owns a tile of 64 query rows, 16 rows per warp.  The
//   Q tile is copied once into shared memory; up to head dim 128 it is
//   held in registers as mma A fragments (ldmatrix).  At head dim 256 the
//   registers go to the output: a thread's share of O is 128 fp32 values
//   and of S 32 more, so Q's 64 fragment registers would push it past the
//   255-register limit into spills.  There each key tile reloads Q's
//   fragments from the shared copy, one 16-column slice at a time (4
//   registers live), as FlashAttention-2 does at that width.
// - K and V come in tiles of 64 keys, double-buffered in shared memory by
//   cp.async 16-byte copies: the copy of tile i+1 is issued right after
//   the barrier that opens tile i, so it overlaps tile i's math, and one
//   barrier per tile suffices.  Rows are padded by 16 bytes, so the 8 row
//   addresses of every ldmatrix phase fall in 8 distinct 16-byte bank
//   groups (no conflicts, for ldmatrix and ldmatrix.trans alike).  At hd
//   128 that is 17 KB for Q plus 2 stages x (K + V) x 17 KB = 85 KB, so two
//   CTAs fit on an SM; at hd 256, 165 KB (int8: 164 KB), so one does.
// - S = Q·Kᵀ and O += P·V run on mma.sync.m16n8k16 bf16 -> fp32 (the
//   primitives are mma_common.cuh's, shared with the LoRA tile); S and O
//   stay in registers.  The softmax works on the accumulator fragments:
//   each row lives in a quad of lanes, so its max needs two shuffles, and
//   the denominator is summed per lane and reduced once at the end.
//   log2(e) is folded into the scale and exponentials are exp2f.  P is
//   rounded to bf16 in registers and reused directly as the A fragment of
//   the P·V mma (the m16n8 C layout of two adjacent key tiles is the
//   m16k16 A layout).
// - Masks (a per-row key range [lo, hi]) are applied only on tiles that
//   reach past the range every row of the tile attends.
// - int8 K/V: the tile is copied as int8 (half the bytes) and widened to
//   bf16 in shared memory (exact: |x| <= 127), so ldmatrix stays usable;
//   k_scale[p] multiplies score column p after the mma, and v_scale[p]
//   multiplies P before its bf16 rounding while the denominator sums the
//   unscaled P.  No fp32 K/V tile is ever staged.
//
// Bound on this card: at the paths' shapes the bytes of K/V (and Q, O) set
// the bound, not the operations: a 64 x 64 tile does 4·64·64·hd FLOPs for
// 2·64·hd·2 bytes of K/V, and mma.sync at half of the bf16 peak already
// sits near the byte bound.  What the design does about the bytes is to
// move each K/V tile once per 64 query rows (all G heads of a kv head in
// prefill), asynchronously and in half the bytes for int8 pools.  wgmma
// and TMA (a warpgroup-wide product, copies without thread instructions)
// are the option for a later change if the tile turns out to be bound by
// issue rather than by bytes.
//
// A Loader feeds the tile; it is where the two kernels differ:
//   void load_q(bf16* Qs) const       cp.async the 64 x HD query tile (row
//                                     stride kStride), zero rows past the end
//   void load_kv(int k0, KT* K, KT* V, float* ks, float* vs) const
//                                     cp.async keys k0 .. k0+63, row stride
//                                     kStride (bf16) or HD (int8), and for
//                                     int8 their scales; every key at or
//                                     past the walk's end zero-filled
//                                     (cp.async src-size 0)
//   void limits(int r, int& lo, int& hi) const
//                                     keys row r attends: lo <= k <= hi
//   void store(int r, int c, float x, float y) const
//                                     output row r, columns c and c + 1
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per CTA, 16 per warp
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kPad = 8;        // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kStride = HD + kPad;                 // bf16 row stride
  static constexpr int kBytes = kKeys * kStride * 2;        // one bf16 tile
  static constexpr int kQBytes = kRows * kStride * 2;
  static constexpr int kI8Bytes = kKeys * HD;               // one int8 tile
};

// Shared memory of one CTA.  bf16 pools: Q, then 2 stages of (K, V).
// int8 pools: Q, the widened (K, V), then 2 stages of int8 (K, V), then 2
// stages of (k_scale, v_scale).
template <int HD, bool QUANT>
constexpr size_t smem_bytes() {
  return QUANT ? (size_t)Tile<HD>::kQBytes + 2 * Tile<HD>::kBytes +
                     4 * Tile<HD>::kI8Bytes + 4 * kKeys * sizeof(float)
               : (size_t)Tile<HD>::kQBytes + 4 * Tile<HD>::kBytes;
}

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;
using tc::allow_smem;

// Widen one int8 tile (row stride HD) into a bf16 tile (row stride kStride).
template <int HD>
__device__ __forceinline__ void widen(const int8_t* __restrict__ src,
                                      bf16* __restrict__ dst) {
  constexpr int kChunks = HD / 16;  // 16-byte int8 chunks per row
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i % kChunks;
    const int4 raw = *reinterpret_cast<const int4*>(src + j * HD + c * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = pack_bf16((float)x[2 * e], (float)x[2 * e + 1]);
    uint4* out = reinterpret_cast<uint4*>(dst + j * Tile<HD>::kStride + c * 16);
    out[0] = make_uint4(w[0], w[1], w[2], w[3]);
    out[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Attend the CTA's 64 query rows to keys [k_begin, k_end) in tiles of 64.
// Every row of the tile attends every key in [full_lo, full_hi]; a key
// tile inside that range skips the mask.  KT is the pools' element type
// (bf16, or int8 with QUANT).
template <int HD, bool QUANT, class Loader>
__device__ __forceinline__ void run(const Loader& ld, int k_begin, int k_end,
                                    int full_lo, int full_hi, float scale,
                                    unsigned char* smem) {
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  // Q's A fragments stay in registers up to hd 128; past that they are
  // reloaded from Qs per key tile (see the header)
  constexpr bool kHoldQ = HD <= 128;
  typedef typename Loader::KT KT;
  constexpr int kStride = Tile<HD>::kStride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* rest = smem + Tile<HD>::kQBytes;
  // bf16 tiles the mma reads (per stage unless QUANT), int8 stages, scales
  bf16* Kb[2];
  bf16* Vb[2];
  KT* Kst[2];
  KT* Vst[2];
  float* ks_s[2] = {nullptr, nullptr};
  float* vs_s[2] = {nullptr, nullptr};
  if (QUANT) {
    Kb[0] = Kb[1] = reinterpret_cast<bf16*>(rest);
    Vb[0] = Vb[1] = reinterpret_cast<bf16*>(rest + Tile<HD>::kBytes);
    unsigned char* i8 = rest + 2 * Tile<HD>::kBytes;
    float* sc = reinterpret_cast<float*>(i8 + 4 * Tile<HD>::kI8Bytes);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      Kst[s] = reinterpret_cast<KT*>(i8 + (2 * s) * Tile<HD>::kI8Bytes);
      Vst[s] = reinterpret_cast<KT*>(i8 + (2 * s + 1) * Tile<HD>::kI8Bytes);
      ks_s[s] = sc + (2 * s) * kKeys;
      vs_s[s] = sc + (2 * s + 1) * kKeys;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      Kb[s] = reinterpret_cast<bf16*>(rest + (2 * s) * Tile<HD>::kBytes);
      Vb[s] = reinterpret_cast<bf16*>(rest + (2 * s + 1) * Tile<HD>::kBytes);
      Kst[s] = reinterpret_cast<KT*>(Kb[s]);
      Vst[s] = reinterpret_cast<KT*>(Vb[s]);
    }
  }

  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;
  ld.load_q(Qs);
  if (n_tiles > 0) ld.load_kv(k_begin, Kst[0], Vst[0], ks_s[0], vs_s[0]);
  cp_async_commit();

  // this lane's two rows of the warp's 16
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  int lo0, hi0, lo1, hi1;
  ld.limits(r0, lo0, hi0);
  ld.limits(r1, lo1, hi1);

  const float sl2 = scale * kLog2e;
  uint32_t qf[kHoldQ ? HD / 16 : 1][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kKeys;
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it-1
    if (it + 1 < n_tiles)
      ld.load_kv(k0 + kKeys, Kst[st ^ 1], Vst[st ^ 1], ks_s[st ^ 1],
                 vs_s[st ^ 1]);
    cp_async_commit();
    // this warp's 16 query rows in Qs, this lane's ldmatrix row
    const uint32_t q_addr = smem_addr(
        Qs + (warp * 16 + (lane % 16)) * kStride + (lane / 16) * 8);
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int c = 0; c < HD / 16; ++c)
          ldsm_x4(q_addr + c * 32, qf[c][0], qf[c][1], qf[c][2], qf[c][3]);
      }
    }
    if (QUANT) {
      widen<HD>(reinterpret_cast<const int8_t*>(Kst[st]), Kb[st]);
      widen<HD>(reinterpret_cast<const int8_t*>(Vst[st]), Vb[st]);
      __syncthreads();
    }
    const bf16* Kt = Kb[st];
    const bf16* Vt = Vb[st];

    // S = Q·Kᵀ: 8 key columns of 8 per warp, 16 rows
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      uint32_t qa[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[c][e];
      } else {
        ldsm_x4(q_addr + c * 32, qa[0], qa[1], qa[2], qa[3]);
      }
#pragma unroll
      for (int jp = 0; jp < kKeys / 16; ++jp) {
        uint32_t b0, b1, b2, b3;
        const int key = 16 * jp + (lane / 16) * 8 + (lane % 8);
        ldsm_x4(smem_addr(Kt + key * kStride + c * 16 + ((lane / 8) & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qa, b0, b1);
        mma_bf16(s[2 * jp + 1], qa, b2, b3);
      }
    }

    // scale (and int8 key scales), then the mask where the tile needs one
    const bool masked = !(k0 >= full_lo && k0 + kKeys - 1 <= full_hi);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * sl2;
        if (QUANT) x *= ks_s[st][col];
        if (masked) {
          const int key = k0 + col;
          const int lo = e < 2 ? lo0 : lo1, hi = e < 2 ? hi0 : hi1;
          if (key < lo || key > hi) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax: rows r0 (e = 0, 1) and r1 (e = 2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with nothing attended yet keeps m = -inf; exponentiate against 0
    const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
    const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - (e < 2 ? mu0 : mu1));
        if (e < 2)
          l0 += p;
        else
          l1 += p;
        s[j][e] = QUANT ? p * vs_s[st][8 * j + 2 * t + (e & 1)] : p;
      }
    }

    // O += P·V, P rounded to bf16 as the A fragment, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = 16 * kk + ((lane / 8) & 1) * 8 + (lane % 8);
        ldsm_x4_trans(
            smem_addr(Vt + key * kStride + 16 * np + (lane / 16) * 8), b0, b1,
            b2, b3);
        mma_bf16(o[2 * np], pa, b0, b1);
        mma_bf16(o[2 * np + 1], pa, b2, b3);
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight (no key tile at all)

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // no key attended -> zeros
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    ld.store(r0, 8 * n + 2 * t, o[n][0] * inv0, o[n][1] * inv0);
    ld.store(r1, 8 * n + 2 * t, o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace attn
