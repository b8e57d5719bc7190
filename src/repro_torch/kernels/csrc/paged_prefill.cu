// Chunked paged-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_prefill.py::
// paged_prefill_attention: T chunk queries per serving row, query t of
// row b at position lengths[b] + t attending [0, lengths[b] + t] (prior
// context plus the causal mask inside the chunk), against pools that
// already hold the chunk's K/V.  lengths is the context BEFORE the chunk.
// Tail rows t >= n_new[b] stay finite; the scheduler discards them.
//
// Bound on this card: bytes of K/V read while the folded tile is small
// (each tile re-reads its row's context), operations once T * G grows:
// the score and value products are 4 * hd FLOPs per (query, position).
// Design: one CTA per (row, kv head, tile of folded T * G query rows), so
// chunks of any length spread over many SMs and each K/V tile staged in
// shared memory is reused by every query row of the tile; the block walk
// stops at the block holding the tile's last query position
// (lengths[b] + t_last), so no tile reads context it cannot attend.  The
// products are fp32 FMAs on the CUDA cores; moving them onto the tensor
// cores (mma / wgmma over the (rows, bs) score tile) is the next step.
#include "paged_common.cuh"

namespace {

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths, QT* __restrict__ out,
                         int T, int H, int Kv, int hd, int bs, int MB,
                         int rows, float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int f0 = tile * rows;
  int n_rows = T * G - f0;
  if (n_rows > rows) n_rows = rows;
  const size_t row_off = (size_t)b * T * H * hd;
  paged::attend_tile<QT, KT, QUANT>(
      q + row_off, k_pool, v_pool, k_scale, v_scale,
      block_tables + (size_t)b * MB, MB, lengths[b], T, H, Kv, hd, bs, G, kv, f0,
      n_rows, scale, out + row_off, smem);
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* lens, void* out, int B,
           int T, int H, int Kv, int hd, int bs, int MB, int rows, float scale,
           cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem = paged::tile_smem_floats(rows, bs, hd) * sizeof(float);
  auto kernel = paged_prefill_kernel<QT, KT, QUANT>;
  cudaError_t err = paged::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T * G + rows - 1) / rows, Kv, B);
  kernel<<<grid, paged::kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)kp, (const KT*)vp, ks, vs, bt, lens, (QT*)out,
      T, H, Kv, hd, bs, MB, rows, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, T, H, hd) float32 or bfloat16; pools: (NB, bs, Kv, hd)
// bfloat16 or int8 with (NB, bs, Kv) float32 scales; block_tables (B, MB)
// and lengths (B,) int32; rows: folded query rows per CTA.  Returns the
// CUDA error code of the launch.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const float* k_scale,
                                       const float* v_scale,
                                       const int* block_tables,
                                       const int* lengths, void* out, int B,
                                       int T, int H, int Kv, int hd, int bs,
                                       int MB, int rows, int q_bf16,
                                       int kv_int8, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t, true>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B,
          T, H, Kv, hd, bs, MB, rows, scale, s);
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B, T,
        H, Kv, hd, bs, MB, rows, scale, s);
  }
  if (kv_int8)
    return launch<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, lengths, out, B, T, H,
                                       Kv, hd, bs, MB, rows, scale, s);
  return launch<float, __nv_bfloat16, false>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B, T, H,
      Kv, hd, bs, MB, rows, scale, s);
}
