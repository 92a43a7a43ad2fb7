// The large-k route of distance_topk (k > 128, where the per-query lists
// of ../../csrc/topk_tile.cuh do not fit in shared memory), first half:
// the same register-tiled f32 product as distance_topk.cu, in its kDump
// instantiation, writing every distance q2 + x2 - 2 q.x of the rows below
// n_valid into a (B, ld) matrix; ../../quant_topk/csrc/topk_select.cu
// then picks each query's k smallest.  A file of its own so that nvcc
// builds it beside distance_topk.cu.
//
// Bound: operations, as distance_topk.cu's product, plus writing B x
// n_valid f32 distances once.
#include "../../csrc/topk_tile.cuh"
#include "f32_rows.cuh"

// q (B, D) and x (N, D) f32, contiguous, both aligned to ``vec`` (16, 8 or
// 4 bytes, dividing 4 * D); dist (B, ld) f32, ld >= n_valid; S chunks of
// rows at the 128 x 128 tile.
extern "C" int f32_distances_launch(const void* q, const void* x, void* dist,
                                    long long ld, int B, int D, int n_valid,
                                    int S, int vec, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || (4 * D) % vec) return (int)cudaErrorInvalidValue;
  const F32Rows rows{static_cast<const float*>(x)};
  return topk_tile::launch_distances(
      static_cast<const float*>(q), rows, static_cast<float*>(dist), ld, B,
      D, n_valid, S, vec, static_cast<cudaStream_t>(stream));
}
