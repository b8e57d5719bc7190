// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention: one query token per serving row against that row's
// block-table K/V, online softmax over blocks, exclusive lengths (row b
// attends [0, lengths[b])), zeros for an empty row.
//
// Bound on this card: the bytes of K/V read (every context position of
// every kv head is read once per step; the arithmetic is G * hd FMAs per
// position, far below the ~295 FLOP/byte a bf16 H100 needs to be compute
// bound).  Design: one CTA per (row, kv head) holds all G query heads of
// the group, so each K/V tile is read from device memory once and reused
// by the whole group; the walk stops at ceil(lengths / bs) blocks, so the
// bytes read are the row's context and no more.  Tiles are staged through
// shared memory with coalesced loads along the head dim.  No TMA or
// wgmma yet: at G = 1 (llama2-7b) there is no matrix product to speed up,
// and the loads are the first thing a later change should pipeline.
#include "paged_common.cuh"

namespace {

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                        const KT* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, QT* __restrict__ out,
                        int H, int Kv, int hd, int bs, int MB, float scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const size_t row_off = (size_t)b * H * hd;
  // exclusive length L: the query sits at L - 1 and attends [0, L)
  paged::attend_tile<QT, KT, QUANT>(
      q + row_off, k_pool, v_pool, k_scale, v_scale,
      block_tables + (size_t)b * MB, MB, lengths[b] - 1, /*T=*/1, H, Kv, hd, bs,
      G, kv, /*f0=*/0, /*rows=*/G, scale, out + row_off, smem);
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* lens, void* out, int B,
           int H, int Kv, int hd, int bs, int MB, float scale,
           cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem = paged::tile_smem_floats(G, bs, hd) * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KT, QUANT>;
  cudaError_t err = paged::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(1, Kv, B);
  kernel<<<grid, paged::kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)kp, (const KT*)vp, ks, vs, bt, lens, (QT*)out,
      H, Kv, hd, bs, MB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, hd) float32 or bfloat16; pools: (NB, bs, Kv, hd) bfloat16
// or int8 with (NB, bs, Kv) float32 scales; block_tables (B, MB) and
// lengths (B,) int32.  Returns the CUDA error code of the launch.
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const float* k_scale,
                                      const float* v_scale,
                                      const int* block_tables,
                                      const int* lengths, void* out, int B,
                                      int H, int Kv, int hd, int bs, int MB,
                                      int q_bf16, int kv_int8, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t, true>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B,
          H, Kv, hd, bs, MB, scale, s);
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B, H,
        Kv, hd, bs, MB, scale, s);
  }
  if (kv_int8)
    return launch<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, lengths, out, B, H, Kv,
                                       hd, bs, MB, scale, s);
  return launch<float, __nv_bfloat16, false>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, B, H,
      Kv, hd, bs, MB, scale, s);
}
