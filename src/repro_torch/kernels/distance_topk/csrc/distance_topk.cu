// Fused squared-L2 distance + top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/distance_topk/kernel.py:87
// distance_topk_pallas (pl.pallas_call at :101; body _kernel, running-best
// merge _merge_topk_scratch).  For f32 queries (B, D) against an f32
// database (N, D) it returns, per query, the k rows below n_valid with the
// smallest q2 + x2 - 2 q.x, ascending by (distance, id) -- the Pallas merge
// takes the first occurrence of the argmin with the running best ahead of
// the tile, so the lower id wins ties -- with inf/-1 where fewer than k rows
// are valid.  Inputs of other float types are cast to f32 by the wrapper
// (ops.py), as the reference wrapper casts them, so there is no bf16 load
// path here.
//
// Bound: operations.  At the flat f32 shape (B = 2000, ~100k valid rows,
// D = 128) the product is 2*B*N*D ~ 51 GFLOP against the 67 TFLOP/s f32
// (non-tensor-core) peak, ~0.76 ms, while the inputs are ~52 MB, ~16 us of
// memory time.  At the throughput benchmark's shape (B = 128, N = 4096)
// the bound is ~2 us: one launch's latency, the chunk merge and the few
// CTAs such a call fills dominate.
//
// Design: the f32 twin of quant_topk.cu without the dequant; both are the
// one launch of ../../csrc/topk_tile.cuh (a register-tiled f32 product over
// a cp.async ring of query and row slices, a threshold-filtered top-k, the
// merge across chunks in the last CTA).  The
// Pallas grid carries its top-k in VMEM across a sequential N axis; CTAs on
// 132 SMs run in no order, hence the merge in the last CTA to arrive.
// For k > 128 the lists do not fit beside the tiles: f32_distances.cu and
// ../../quant_topk/csrc/topk_select.cu serve those.
#include "../../csrc/topk_tile.cuh"
#include "f32_rows.cuh"

// q (B, D) and x (N, D) f32, contiguous, both aligned to ``vec`` (16, 8 or
// 4 bytes, dividing 4 * D); part_d / part_i (B, S, k) scratch; arrivals
// (ceil(B / tile),) uint32, all 0 before the launch and left 0 after it;
// out_d / out_i (B, k); tile 128 or 64.
extern "C" int distance_topk_launch(const void* q, const void* x,
                                    void* part_d, void* part_i,
                                    void* arrivals, void* out_d, void* out_i,
                                    int B, int D, int n_valid, int k, int S,
                                    int tile, int vec, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || (4 * D) % vec) return (int)cudaErrorInvalidValue;
  const F32Rows rows{static_cast<const float*>(x)};
  return topk_tile::launch(
      static_cast<const float*>(q), rows, static_cast<float*>(part_d),
      static_cast<int*>(part_i), static_cast<unsigned*>(arrivals),
      static_cast<float*>(out_d), static_cast<int*>(out_i), B, D, n_valid, k,
      S, tile, vec, static_cast<cudaStream_t>(stream));
}
