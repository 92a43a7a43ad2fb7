// The large-k route of quant_topk (k > 128, where the per-query lists of
// ../../csrc/topk_tile.cuh do not fit in shared memory), first half: the
// same register-tiled int8 dequant + f32 product as quant_topk.cu, in its
// kDump instantiation, writing every distance q2 + x2 - 2 q.x of the rows
// below n_valid into a (B, ld) matrix.  topk_select.cu then picks each
// query's k smallest.  A file of its own so that nvcc builds it beside
// quant_topk.cu.
//
// Bound: operations, as quant_topk.cu's product, plus writing B x n_valid
// f32 distances once (at B = 2000 x 100k rows, 0.8 GB: ~0.24 ms).
#include "../../csrc/topk_tile.cuh"
#include "quant_rows.cuh"

// q (B, D) f32, 16-byte aligned; codes / scales as quant_topk_launch
// takes them; dist (B, ld) f32, ld >= n_valid; S chunks of rows at the
// 128 x 128 tile.
extern "C" int quant_distances_launch(const void* q, const void* codes,
                                      const void* scales, void* dist,
                                      long long ld, int B, int D, int group,
                                      int n_groups, int n_valid, int S,
                                      int vec, void* stream) {
  if (B <= 0) return 0;
  DequantRows rows;
  if (!dequant_rows(codes, scales, D, group, n_groups, vec, &rows))
    return (int)cudaErrorInvalidValue;
  return topk_tile::launch_distances(
      static_cast<const float*>(q), rows, static_cast<float*>(dist), ld, B,
      D, n_valid, S, vec, static_cast<cudaStream_t>(stream));
}
