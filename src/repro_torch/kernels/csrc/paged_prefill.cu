// Chunked paged-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_prefill.py::
// paged_prefill_attention: T chunk queries per serving row, query t of
// row b at position lengths[b] + t attending [0, lengths[b] + t] (prior
// context plus the causal mask inside the chunk), against pools that
// already hold the chunk's K/V.  lengths is the context BEFORE the chunk.
// With a sliding window W > 0 (starcoder2), query t attends only
// (lengths[b] + t - W, lengths[b] + t], as the reference's jnp paged
// branch masks it (its Pallas kernel takes no window).
// Tail rows t >= n_new[b] stay finite; the scheduler discards them.
//
// Two tiles, chosen by the query dtype:
// - bf16 queries (every serving run): the tensor-core tile of attn_mma.cuh.
//   One CTA per (row, kv head, 64 folded rows f = t * G + g), so one K/V
//   tile serves all G heads of its kv head.  The paged loader below copies
//   key p from ((table[p / bs] * bs + p % bs) * Kv + kv) * hd, one row per
//   key (256 bytes at hd 128 in bf16, 128 in int8), for any block size.
//   Bound on this card: bytes.  The score and value products are 4 * hd
//   FLOPs per (query, position), 15 GFLOP at the serving chunk (0.015 ms
//   at the bf16 peak) against about 0.036 ms of K/V, Q and O bytes; each
//   tile re-reads its row's context, from L2 after the first of the 4
//   query tiles.  The design moves the bytes asynchronously (cp.async,
//   double-buffered) and int8 pools as int8.
// - fp32 queries (fp32 checks and fp32 models): the CUDA-core tile of
//   paged_common.cuh, fp32 FMAs throughout, so fp32 stays exact to
//   summation order.
//
// The walk stops at the tile's last query position (lengths[b] + t_last)
// and never leaves the row's MB table entries (ragged chunk tails may sit
// past the table; their output is discarded).  With a window it starts at
// the first key the tile's first query attends, so keys below every
// query's window are never read.  Keys past that end are
// zero-filled in shared memory, never read: a pool slot past a row's last
// query may hold anything, and 0 * NaN would poison P·V.
#include "attn_mma.cuh"
#include "paged_common.cuh"

namespace {

using attn::bf16;

// ---------------------------------------------------------------------------
// bf16 queries: the tensor-core tile
// ---------------------------------------------------------------------------

template <int HD, typename KTy>
struct PagedLoader {
  typedef KTy KT;
  static constexpr bool kQuant = sizeof(KTy) == 1;
  const bf16* q;  // the batch row's (T, H, HD) slice
  const KTy* kp;
  const KTy* vp;
  const float* ks;
  const float* vs;
  const int* table;  // the row's MB entries
  bf16* out;         // the batch row's (T, H, HD) slice
  int T, H, Kv, G, kv, bs, f0, base, kv_end, window;

  __device__ void q_row(int r, int& t, int& g) const {
    const int f = f0 + r;
    t = f / G;
    g = f % G;
  }

  __device__ void load_q(bf16* Qs) const {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < attn::kRows * kChunks; i += attn::kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      int t, g;
      q_row(r, t, g);
      const bool ok = t < T;
      const bf16* src = ok ? q + ((size_t)t * H + kv * G + g) * HD + c * 8 : q;
      attn::cp_async16(Qs + r * attn::Tile<HD>::kStride + c * 8, src, ok);
    }
  }

  __device__ void load_kv(int k0, KTy* K, KTy* V, float* ksd,
                          float* vsd) const {
    // 16-byte chunks per key row; a shared row is padded for bf16 (the mma
    // reads it) and dense for int8 (widened first)
    constexpr int kChunks = HD * (int)sizeof(KTy) / 16;
    constexpr int kRowEl = kQuant ? HD : attn::Tile<HD>::kStride;
    constexpr int kChunkEl = 16 / (int)sizeof(KTy);
    for (int i = threadIdx.x; i < attn::kKeys * kChunks; i += attn::kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int p = k0 + j;
      const bool ok = p < kv_end;
      const size_t row =
          ok ? ((size_t)table[p / bs] * bs + p % bs) * Kv + kv : 0;
      const size_t off = row * HD + c * kChunkEl;
      attn::cp_async16(K + j * kRowEl + c * kChunkEl, kp + off, ok);
      attn::cp_async16(V + j * kRowEl + c * kChunkEl, vp + off, ok);
    }
    if (kQuant) {
      for (int j = threadIdx.x; j < attn::kKeys; j += attn::kThreads) {
        const int p = k0 + j;
        const bool ok = p < kv_end;
        const size_t row =
            ok ? ((size_t)table[p / bs] * bs + p % bs) * Kv + kv : 0;
        attn::cp_async4(ksd + j, ks + row, ok);
        attn::cp_async4(vsd + j, vs + row, ok);
      }
    }
  }

  __device__ void limits(int r, int& lo, int& hi) const {
    int t, g;
    q_row(r, t, g);
    if (t > T - 1) t = T - 1;  // rows past the chunk: computed, not stored
    lo = window > 0 ? max(0, base + t - window + 1) : 0;
    hi = min(base + t, kv_end - 1);
  }

  __device__ void store(int r, int c, float x, float y) const {
    int t, g;
    q_row(r, t, g);
    if (t < T)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)t * H + kv * G + g) * HD + c) =
          __floats2bfloat162_rn(x, y);
  }
};

template <int HD, typename KT>
__global__ void __launch_bounds__(attn::kThreads, 2)
    paged_prefill_mma_kernel(const bf16* __restrict__ q,
                             const KT* __restrict__ k_pool,
                             const KT* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ lengths,
                             bf16* __restrict__ out, int T, int H, int Kv,
                             int bs, int MB, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / Kv;
  // folded-row tiles last to first: the last tiles walk the most context,
  // so they start in the first wave and the short ones fill the tail
  const int f0 = (gridDim.z - 1 - blockIdx.z) * attn::kRows;
  const int base = lengths[b];
  int t_last = (f0 + attn::kRows - 1) / G;
  if (t_last > T - 1) t_last = T - 1;
  // keys [kv_lo, kv_end): from the first query's window start up to the
  // tile's last query, inside the row's table
  const int t_first = f0 / G;
  const int kv_lo = window > 0 ? max(0, base + t_first - window + 1) : 0;
  const int kv_end = min(base + t_last + 1, MB * bs);
  PagedLoader<HD, KT> ld;
  const size_t row_off = (size_t)b * T * H * HD;
  ld.q = q + row_off;
  ld.kp = k_pool;
  ld.vp = v_pool;
  ld.ks = k_scale;
  ld.vs = v_scale;
  ld.table = block_tables + (size_t)b * MB;
  ld.out = out + row_off;
  ld.T = T;
  ld.H = H;
  ld.Kv = Kv;
  ld.G = G;
  ld.kv = kv;
  ld.bs = bs;
  ld.f0 = f0;
  ld.base = base;
  ld.kv_end = kv_end;
  ld.window = window;
  // every row of the tile attends [full_lo, full_hi]: from its last
  // query's window start to its first query
  const int full_lo = window > 0 ? max(0, base + t_last - window + 1) : 0;
  const int full_hi = min(base + t_first, kv_end - 1);
  attn::run<HD, PagedLoader<HD, KT>::kQuant>(ld, kv_lo, kv_end, full_lo,
                                             full_hi, scale, smem);
}

template <int HD, typename KT>
int launch_mma(const void* q, const void* kp, const void* vp, const float* ks,
               const float* vs, const int* bt, const int* lens, void* out,
               int B, int T, int H, int Kv, int bs, int MB, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = attn::smem_bytes<HD, sizeof(KT) == 1>();
  auto kernel = paged_prefill_mma_kernel<HD, KT>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Kv;
  dim3 grid(Kv, B, (T * G + attn::kRows - 1) / attn::kRows);
  kernel<<<grid, attn::kThreads, smem, stream>>>(
      (const bf16*)q, (const KT*)kp, (const KT*)vp, ks, vs, bt, lens,
      (bf16*)out, T, H, Kv, bs, MB, window, scale);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_mma_hd(const void* q, const void* kp, const void* vp,
                  const float* ks, const float* vs, const int* bt,
                  const int* lens, void* out, int B, int T, int H, int Kv,
                  int hd, int bs, int MB, int window, float scale,
                  cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_mma<32, KT>(q, kp, vp, ks, vs, bt, lens, out, B, T, H, Kv,
                                bs, MB, window, scale, s);
    case 64:
      return launch_mma<64, KT>(q, kp, vp, ks, vs, bt, lens, out, B, T, H, Kv,
                                bs, MB, window, scale, s);
    case 128:
      return launch_mma<128, KT>(q, kp, vp, ks, vs, bt, lens, out, B, T, H,
                                 Kv, bs, MB, window, scale, s);
    case 256:
      return launch_mma<256, KT>(q, kp, vp, ks, vs, bt, lens, out, B, T, H,
                                 Kv, bs, MB, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32 queries: the CUDA-core tile
// ---------------------------------------------------------------------------

template <typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const float* __restrict__ q,
                         const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, int T, int H, int Kv, int hd,
                         int bs, int MB, int rows, int window, float scale) {
  extern __shared__ float smem_f[];
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int f0 = tile * rows;
  int n_rows = T * G - f0;
  if (n_rows > rows) n_rows = rows;
  const size_t row_off = (size_t)b * T * H * hd;
  paged::attend_tile<float, KT, QUANT>(
      q + row_off, k_pool, v_pool, k_scale, v_scale,
      block_tables + (size_t)b * MB, MB, lengths[b], T, H, Kv, hd, bs, G, kv,
      f0, n_rows, window, scale, out + row_off, smem_f);
}

template <typename KT, bool QUANT>
int launch_f32(const void* q, const void* kp, const void* vp, const float* ks,
               const float* vs, const int* bt, const int* lens, void* out,
               int B, int T, int H, int Kv, int hd, int bs, int MB, int rows,
               int window, float scale, cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem = paged::tile_smem_floats(rows, bs, hd) * sizeof(float);
  auto kernel = paged_prefill_kernel<KT, QUANT>;
  cudaError_t err = paged::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T * G + rows - 1) / rows, Kv, B);
  kernel<<<grid, paged::kThreads, smem, stream>>>(
      (const float*)q, (const KT*)kp, (const KT*)vp, ks, vs, bt, lens,
      (float*)out, T, H, Kv, hd, bs, MB, rows, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, T, H, hd) float32 or bfloat16; pools: (NB, bs, Kv, hd)
// bfloat16 or int8 with (NB, bs, Kv) float32 scales; block_tables (B, MB)
// and lengths (B,) int32.  bf16 queries run the tensor-core tile (hd 32,
// 64, 128 or 256; every pointer 16-byte aligned); fp32 queries the
// CUDA-core tile with ``rows`` folded query rows per CTA.  window <= 0: no
// sliding window.  Returns the CUDA error code of the launch.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const float* k_scale,
                                       const float* v_scale,
                                       const int* block_tables,
                                       const int* lengths, void* out, int B,
                                       int T, int H, int Kv, int hd, int bs,
                                       int MB, int rows, int window,
                                       int q_bf16, int kv_int8, float scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16) {
    if (kv_int8)
      return launch_mma_hd<int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, lengths, out, B, T, H, Kv,
                                   hd, bs, MB, window, scale, s);
    return launch_mma_hd<bf16>(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, lengths, out, B, T, H, Kv, hd,
                               bs, MB, window, scale, s);
  }
  if (kv_int8)
    return launch_f32<int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                    block_tables, lengths, out, B, T, H, Kv,
                                    hd, bs, MB, rows, window, scale, s);
  return launch_f32<bf16, false>(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, lengths, out, B, T, H, Kv, hd,
                                 bs, MB, rows, window, scale, s);
}
