// Paged decode attention for Hopper (sm_90a): split-K flash decoding.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention: one query token per serving row against that row's
// block-table K/V, exclusive lengths (row b attends [0, lengths[b])),
// zeros for an empty row, GQA folding G = H / Kv query heads per kv head.
// With a sliding window W > 0 (starcoder2) row b attends only
// [lengths[b] - W, lengths[b]), as the reference's jnp paged branch masks
// it (its Pallas kernel takes no window).
//
// Bound on this card: the bytes of K/V read.  Each context position of
// each kv head is read once per step, for G * hd multiply-adds per head
// dim element, far below the ~295 FLOP/byte at which a bf16 H100 turns
// compute bound.  So the design is about keeping the memory busy:
//
// - The context is cut by position into splits of kSplit positions.  The
//   grid is (splits, Kv * head groups, B); a CTA whose split starts at or
//   past its row's length exits at once, and so does one whose split ends
//   at or below its row's window start.  The one split that holds the
//   window start masks the positions below it (and copies none of them).
//   The split boundaries depend on kSplit, the row's own length and the
//   window only, so a row's output is bitwise the same whatever the batch,
//   the other rows and the table width.
// - A CTA holds all G query heads of its kv head (up to GH heads; past
//   that, head groups of their own CTAs), so each K/V byte is read once.
//   Its eight warps take interleaved chunks of the split, each through its
//   own cp.async ring of kStages chunks in shared memory: 16-byte copies,
//   neighbouring lanes on neighbouring addresses, issued kStages - 1
//   chunks ahead of their use.  A warp waits only for its own copies
//   (cp.async.wait_group and __syncwarp): no CTA barrier sits between a
//   load and its use.
// - Inside a warp, groups of L lanes take one position each (a lane owns
//   VEC elements of the head dim); scores come from shuffle reductions
//   inside the group, NB positions at a time so that their reductions
//   overlap, and each group keeps its own running max, denominator and
//   accumulator per head in registers, in fp32 (base-2 exponentials).
//   int8 K/V are dequantized in registers with the per-(position, kv
//   head) scale.  P stays fp32.
// - Sizes: 8 warps, so that each walks 16 positions of a split (a CTA's
//   serial path bounds the small calls: few rows, G >= 4); rings of 3
//   chunks of at most 1 KB of K (and of V) each, about 48 KB a CTA; kSplit 128,
//   so a serving row of a few hundred positions spans several CTAs.
// - At the end of the split the lane groups merge by shuffles, the warps
//   through shared memory, in a fixed order.  A row whose context fits in
//   one split writes its output; otherwise each split writes (m, l, acc)
//   in fp32 to a scratch buffer and paged_decode_combine_kernel merges the
//   live splits of each (row, head) in split order.  No atomics: two launches
//   at most, and every sum in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kSplit = 128;       // positions per split
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCombineThreads = 128;
constexpr int kStages = 3;        // chunks in each warp's cp.async ring
constexpr int kChunkBytes = 1024; // K (and V) bytes of a chunk, at most
constexpr float kNegBig = -1e30f;

// Compile-time shape of a CTA: int8 or bf16 pools, head dim HD, up to GH
// query heads.
template <bool QUANT, int HD, int GH>
struct Shape {
  static constexpr int kElt = QUANT ? 1 : 2;       // bytes of a pool value
  static constexpr int VEC = GH <= 8 ? 8 : 4;      // head-dim values a lane owns
  static constexpr int L = HD / VEC;               // lanes per position
  static constexpr int P = 32 / L;                 // positions a warp takes at once
  static constexpr int TP0 = kChunkBytes / (HD * kElt);
  static constexpr int TP = TP0 < 16 ? TP0 : 16;   // positions of a chunk
  static constexpr int NP = TP / P;                // ... of a lane group
  // positions a lane group scores before one softmax update: their
  // shuffle reductions overlap; past 4 heads the registers are spent
  static constexpr int NB0 = GH <= 4 ? 16 / GH : 1;
  static constexpr int NB = NB0 < NP ? NB0 : NP;
  static constexpr int ROW16 = HD * kElt / 16;     // 16-byte pieces of a row
  static constexpr int kKV = TP * HD * kElt;       // K (or V) bytes of a chunk
  // a chunk in shared memory: K [TP][HD], V [TP][HD], then for int8 the
  // scales ks [TP], vs [TP]
  static constexpr int kChunk = 2 * kKV + (QUANT ? 2 * TP * 4 : 0);
  static constexpr int kRing = kStages * kChunk;   // bytes of a warp's ring
  // after the loop the rings hold the warps' states: [warp][GH][HD + 2]
  static constexpr int kMerge = kWarps * GH * (HD + 2) * 4;
  static constexpr size_t kSmem =
      kWarps * kRing > kMerge ? kWarps * kRing : kMerge;
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "lanes per position");
  static_assert(TP % P == 0 && kSplit % TP == 0, "chunk shape");
  static_assert(NP % NB == 0, "position batches");
  static_assert(ROW16 * 16 == HD * kElt, "rows of whole 16-byte pieces");
};

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// four int8 values as fp32 without the quarter-rate I2F: bias each byte
// to unsigned, place it in the mantissa of 2^23, subtract 2^23 + 128
__device__ __forceinline__ void i8x4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
             8388736.f;
}

// VEC pool values at p (shared memory), as fp32.
template <bool QUANT, int VEC>
__device__ __forceinline__ void load_vec(const unsigned char* p, float* out) {
  if constexpr (QUANT) {
    if constexpr (VEC == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      i8x4(w.x, out);
      i8x4(w.y, out + 4);
    } else {
      i8x4(*reinterpret_cast<const uint32_t*>(p), out);
    }
  } else {
    if constexpr (VEC == 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[2 * k] = bf_lo(ws[k]);
        out[2 * k + 1] = bf_hi(ws[k]);
      }
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      out[0] = bf_lo(w.x);
      out[1] = bf_hi(w.x);
      out[2] = bf_lo(w.y);
      out[3] = bf_hi(w.y);
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int q_bf16) {
  return q_bf16 ? __bfloat162float(((const __nv_bfloat16*)q)[i])
                : ((const float*)q)[i];
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int q_bf16) {
  if (q_bf16)
    ((__nv_bfloat16*)out)[i] = __float2bfloat16(v);
  else
    ((float*)out)[i] = v;
}

// Arguments of both kernels.  q, out: (B, H, hd) fp32 or bf16 (q_bf16);
// pools (NB, bs, Kv, hd), int8 with (NB, bs, Kv) scales; part: (B, H, NS,
// hd) accumulators, then (B, H, NS, 2) (m, l); G = H / Kv query heads per
// kv head in HG head groups; window <= 0: no sliding window.  scale2 is
// the softmax scale times log2(e): scores and maxima are in base 2, so
// each exponential is one exp2f.
struct DecodeArgs {
  const void* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* lengths;
  void* out;
  float* part;
  int B, H, Kv, G, HG, hd, bs, MB, NS, q_bf16, window;
  float scale2;
};

// Row b's positions [lo, len) and its live splits [s_lo, s_hi): those
// that hold a position it attends.
struct RowSpan {
  int len, lo, s_lo, s_hi;
  __device__ RowSpan(const DecodeArgs& a, int b) {
    len = max(0, min(a.lengths[b], a.MB * a.bs));
    lo = a.window > 0 ? max(0, len - a.window) : 0;
    s_lo = lo / kSplit;
    s_hi = (len + kSplit - 1) / kSplit;
  }
};

// One CTA: split blockIdx.x of row blockIdx.z, kv head blockIdx.y / HG,
// head group blockIdx.y % HG (min 1 block an SM: without it ptxas
// squeezes some instantiations to an occupancy tier and spills a few
// bytes).
template <bool QUANT, int HD, int GH>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_split_kernel(const DecodeArgs a) {
  const void* __restrict__ q = a.q;
  const unsigned char* __restrict__ k_pool = a.k_pool;
  const unsigned char* __restrict__ v_pool = a.v_pool;
  const float* __restrict__ k_scale = a.k_scale;
  const float* __restrict__ v_scale = a.v_scale;
  const int Kv = a.Kv, G = a.G, HG = a.HG, bs = a.bs, MB = a.MB, NS = a.NS;
  const int H = a.H, q_bf16 = a.q_bf16;
  const float scale2 = a.scale2;
  void* __restrict__ out = a.out;
  float* __restrict__ part = a.part;
  using S = Shape<QUANT, HD, GH>;
  constexpr int VEC = S::VEC, L = S::L, P = S::P, TP = S::TP;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tbl[kSplit + 1];

  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / HG, hg = blockIdx.y % HG;
  const int per = (G + HG - 1) / HG;             // heads of a group
  const int h0 = kv * G + hg * per;              // this CTA's first head
  const int ng = min(per, G - hg * per);         // its heads (<= GH)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const RowSpan row(a, b);
  const int len = row.len, lo = row.lo;
  const int s0 = split * kSplit;
  const size_t orow = (size_t)b * H;

  if (len == 0) {                                // empty row: exact zeros
    if (split == 0)
      for (int e = tid; e < ng * HD; e += kThreads)
        store_out(out, (orow + h0 + e / HD) * HD + e % HD, 0.f, q_bf16);
    return;
  }
  // a split past the row's end, or wholly below its window
  if (split < row.s_lo || split >= row.s_hi) return;
  const int n = min(kSplit, len - s0);           // positions of this split
  const int nlive = row.s_hi - row.s_lo;

  // the split's block-table entries
  const int blk0 = s0 / bs;
  const int nblk = (s0 + n - 1) / bs - blk0 + 1;
  for (int i = tid; i < nblk; i += kThreads)
    tbl[i] = a.block_tables[(size_t)b * MB + blk0 + i];

  __syncthreads();                               // tbl ready

  unsigned char* ring = smem + warp * S::kRing;
  const int nchunk = (n + TP - 1) / TP;
  const int mine = warp < nchunk ? (nchunk - warp + kWarps - 1) / kWarps : 0;
  const size_t row_bytes = (size_t)HD * S::kElt;

  // cp.async the i-th chunk of this warp into its ring slot; always
  // commits a group, so the wait count below holds at the tail
  auto issue = [&](int i) {
    if (i < mine) {
      unsigned char* st = ring + (i % kStages) * S::kChunk;
      const int p0 = (warp + i * kWarps) * TP;
#pragma unroll
      for (int j = lane; j < TP * S::ROW16; j += 32) {
        const int pp = j / S::ROW16, w = j % S::ROW16;
        const int pos = s0 + p0 + pp;
        if (p0 + pp < n && pos >= lo) {
          const int phys = tbl[pos / bs - blk0];
          const size_t r = ((size_t)phys * bs + pos % bs) * Kv + kv;
          tc::cp_async16(st + pp * row_bytes + w * 16,
                         k_pool + r * row_bytes + w * 16, true);
          tc::cp_async16(st + S::kKV + pp * row_bytes + w * 16,
                         v_pool + r * row_bytes + w * 16, true);
        }
      }
      if constexpr (QUANT) {
        float* sc = reinterpret_cast<float*>(st + 2 * S::kKV);
        for (int pp = lane; pp < TP; pp += 32) {
          const int pos = s0 + p0 + pp;
          if (p0 + pp < n && pos >= lo) {
            const int phys = tbl[pos / bs - blk0];
            const size_t r = ((size_t)phys * bs + pos % bs) * Kv + kv;
            tc::cp_async4(sc + pp, k_scale + r, true);
            tc::cp_async4(sc + TP + pp, v_scale + r, true);
          }
        }
      }
    }
    tc::cp_async_commit();
  };

  float m[GH], l[GH], acc[GH][VEC];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = kNegBig;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[g][v] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  // this lane's slice of every query head, loaded while the first chunks
  // are in flight
  const int grp = lane / L, d0 = (lane % L) * VEC;
  float qr[GH][VEC];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      qr[g][v] = g < ng ? load_q(q, (orow + h0 + g) * HD + d0 + v, q_bf16)
                        : 0.f;
  for (int i = 0; i < mine; ++i) {
    issue(i + kStages - 1);
    tc::cp_async_wait<kStages - 1>();            // chunk i has landed
    __syncwarp();                                // ... for every lane
    const unsigned char* st = ring + (i % kStages) * S::kChunk;
    const int p0 = (warp + i * kWarps) * TP;
    // NB positions of this lane group at a time: scores, one softmax
    // update per head, then their values
#pragma unroll 1
    for (int sb = 0; sb < S::NP / S::NB; ++sb) {
      float sc[S::NB][GH];
      bool valid[S::NB];
#pragma unroll
      for (int j = 0; j < S::NB; ++j) {
        const int pp = (sb * S::NB + j) * P + grp;
        valid[j] = p0 + pp < n && s0 + p0 + pp >= lo;
        float kf[VEC];
        load_vec<QUANT, VEC>(st + pp * row_bytes + d0 * S::kElt, kf);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot = fmaf(qr[g][v], kf[v], dot);
          sc[j][g] = dot;
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < S::NB; ++j)
#pragma unroll
          for (int g = 0; g < GH; ++g)
            sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], off);
      const float* scl = reinterpret_cast<const float*>(st + 2 * S::kKV);
#pragma unroll
      for (int j = 0; j < S::NB; ++j) {
        const int pp = (sb * S::NB + j) * P + grp;
        const float ks = QUANT ? scl[pp] * scale2 : scale2;
#pragma unroll
        for (int g = 0; g < GH; ++g) sc[j][g] *= ks;
      }
      // softmax update: sc becomes p (0 at positions past the split or
      // below the window)
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float mc = kNegBig;
#pragma unroll
        for (int j = 0; j < S::NB; ++j)
          if (valid[j]) mc = fmaxf(mc, sc[j][g]);
        const float mn = fmaxf(m[g], mc);
        const float a = exp2f(m[g] - mn);
        m[g] = mn;
        l[g] *= a;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[g][v] *= a;
#pragma unroll
        for (int j = 0; j < S::NB; ++j) {
          sc[j][g] = valid[j] ? exp2f(sc[j][g] - mn) : 0.f;
          l[g] += sc[j][g];
        }
      }
#pragma unroll
      for (int j = 0; j < S::NB; ++j) {
        if (!valid[j]) continue;                 // stale slot: never read
        const int pp = (sb * S::NB + j) * P + grp;
        float vf[VEC];
        load_vec<QUANT, VEC>(st + S::kKV + pp * row_bytes + d0 * S::kElt, vf);
        const float vs = QUANT ? scl[TP + pp] : 1.f;
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float pv = sc[j][g] * vs;
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[g][v] = fmaf(pv, vf[v], acc[g][v]);
        }
      }
    }
    __syncwarp();                                // slot free for a refill
  }
  tc::cp_async_wait_all();
  __syncwarp();

  // merge the lane groups (groups with nothing seen weigh 2^-1e30 = 0)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float wa = exp2f(m[g] - mn), wb = exp2f(mo - mn);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][v], off);
        acc[g][v] = acc[g][v] * wa + ao * wb;
      }
      m[g] = mn;
    }
  }
  // lane group 0 holds the warp's state: into shared memory, once every
  // warp is done with its ring
  __syncthreads();
  float* mb = reinterpret_cast<float*>(smem) + warp * GH * (HD + 2);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) mb[g * (HD + 2) + d0 + v] = acc[g][v];
      if (d0 == 0) {
        mb[g * (HD + 2) + HD] = m[g];
        mb[g * (HD + 2) + HD + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps, in warp order
  for (int e = tid; e < ng * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wb = reinterpret_cast<const float*>(smem) + w * GH * (HD + 2);
      mx = fmaxf(mx, wb[g * (HD + 2) + HD]);
    }
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wb = reinterpret_cast<const float*>(smem) + w * GH * (HD + 2);
      const float c = exp2f(wb[g * (HD + 2) + HD] - mx);
      o += wb[g * (HD + 2) + d] * c;
      den += wb[g * (HD + 2) + HD + 1] * c;
    }
    const size_t h = orow + h0 + g;
    if (nlive == 1) {
      store_out(out, h * HD + d, o / den, q_bf16);
    } else {
      const size_t slot = h * NS + split;
      part[slot * HD + d] = o;
      if (d == 0) {
        float* ml = part + (size_t)a.B * H * NS * HD;
        ml[2 * slot] = mx;
        ml[2 * slot + 1] = den;
      }
    }
  }
}

// Merge the live splits of each (row, head) of a row with more than one,
// in split order, and round once to q's dtype.  Grid (H, B).
__global__ void __launch_bounds__(kCombineThreads)
    paged_decode_combine_kernel(const DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, HD = a.hd, NS = a.NS;
  const RowSpan row(a, b);
  if (row.s_hi - row.s_lo <= 1) return;          // written by the split
  const size_t slot0 = ((size_t)b * a.H + h) * NS;
  const float* part = a.part;
  const float* ml = part + (size_t)a.B * a.H * NS * HD + 2 * slot0;
  float mx = kNegBig;
  for (int s = row.s_lo; s < row.s_hi; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float o = 0.f, den = 0.f;
    for (int s = row.s_lo; s < row.s_hi; ++s) {
      const float c = exp2f(ml[2 * s] - mx);
      o += part[(slot0 + s) * HD + d] * c;
      den += ml[2 * s + 1] * c;
    }
    store_out(a.out, ((size_t)b * a.H + h) * HD + d, o / den, a.q_bf16);
  }
}

template <bool QUANT, int HD, int GH>
int launch_split(const DecodeArgs& a, cudaStream_t stream) {
  using S = Shape<QUANT, HD, GH>;
  auto kernel = paged_decode_split_kernel<QUANT, HD, GH>;
  // the opt-in above 48 KB counts the static block table too
  if (S::kSmem + sizeof(int) * (kSplit + 1) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.NS, a.Kv * a.HG, a.B), kThreads, S::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// heads a CTA holds at most: VEC = 4 past 8 heads needs HD / 4 <= 32 lanes
constexpr int max_heads(int hd) { return hd <= 128 ? 12 : 8; }

// the instantiation for head dim HD and per heads a CTA (a CTA may hold
// fewer heads than its instantiation: 2 or 3 run on the 4-head one)
template <bool QUANT, int HD>
int launch_hd(int per, const DecodeArgs& a, cudaStream_t s) {
  if (per <= 1) return launch_split<QUANT, HD, 1>(a, s);
  if (per <= 4) return launch_split<QUANT, HD, 4>(a, s);
  if (per <= 8) return launch_split<QUANT, HD, 8>(a, s);
  if constexpr (max_heads(HD) >= 12) {
    if (per <= 12) return launch_split<QUANT, HD, 12>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool QUANT>
int launch_all(int per, const DecodeArgs& a, cudaStream_t s) {
  switch (a.hd) {
    case 32: return launch_hd<QUANT, 32>(per, a, s);
    case 64: return launch_hd<QUANT, 64>(per, a, s);
    case 128: return launch_hd<QUANT, 128>(per, a, s);
    case 256: return launch_hd<QUANT, 256>(per, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, H, hd) float32 or bfloat16 (q_bf16); pools: (NB, bs, Kv, hd)
// bfloat16 or int8 (kv_int8) with (NB, bs, Kv) float32 scales, 16-byte
// aligned; block_tables (B, MB) and lengths (B,) int32.  hd is 32, 64, 128
// or 256; split must equal the kernel's kSplit; window <= 0: no sliding
// window.  With NS = max(1, ceil(MB
// * bs / split)) > 1, part holds B * H * NS * (hd + 2) floats and a second
// launch merges the splits.  Returns the CUDA error code of the launches.
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const float* k_scale,
                                      const float* v_scale,
                                      const int* block_tables,
                                      const int* lengths, void* out,
                                      float* part, int B, int H, int Kv,
                                      int hd, int bs, int MB, int split,
                                      int window, int q_bf16, int kv_int8,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (split != kSplit || H % Kv) return (int)cudaErrorInvalidValue;
  const int G = H / Kv;
  const int HG = (G + max_heads(hd) - 1) / max_heads(hd);  // head groups
  const int per = (G + HG - 1) / HG;
  const int NS = MB * bs > kSplit ? (MB * bs + kSplit - 1) / kSplit : 1;
  const DecodeArgs a{q, (const unsigned char*)k_pool,
                     (const unsigned char*)v_pool, k_scale, v_scale,
                     block_tables, lengths, out, part, B, H, Kv, G, HG, hd,
                     bs, MB, NS, q_bf16, window,
                     scale * 1.4426950408889634f};  // times log2(e)
  const int err = kv_int8 ? launch_all<true>(per, a, s)
                          : launch_all<false>(per, a, s);
  if (err != 0 || NS <= 1) return err;
  paged_decode_combine_kernel<<<dim3(H, B), kCombineThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
