// Fused int8 dequant + squared-L2 distance + top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_topk/kernel.py quant_topk_pallas
// (body _kernel, running-best merge _merge_topk_scratch in
// kernels/distance_topk/kernel.py).  For queries (B, D) f32 against codes
// (N, D) int8 x scales (N, D/group) f32 it returns, per query, the k rows
// below n_valid with the smallest q2 + x2 - 2 q.x on the dequantized rows,
// ascending by (distance, id), with inf/-1 where fewer than k rows are
// valid.
//
// Bound: operations.  At the flat stage-1 shape (B = 2000, ~100k valid
// rows, D = 128) the product is 2*B*N*D ~ 51 GFLOP against the 67 TFLOP/s
// f32 (non-tensor-core) peak, ~0.77 ms, while the inputs are ~16 MB,
// ~5 us of memory time.
//
// Design: the two passes of ../../csrc/topk_tile.cuh (N split across SMs,
// 4x4-register-tile f32 FMAs, a sorted per-query list in shared memory,
// then a merge of the per-chunk lists).  What this file adds is the load:
// each 32-wide column slice of the codes is dequantized into shared memory
// (code times its group's scale, in f32), so the codes never exist in f32
// in device memory.
#include "../../csrc/topk_tile.cuh"

namespace {

struct DequantRows {
  const int8_t* codes;
  const float* scales;
  int D, group, n_groups;

  __device__ __forceinline__ float operator()(long long row, int col) const {
    return (float)codes[row * D + col] *
           scales[row * n_groups + col / group];
  }
};

}  // namespace

extern "C" int quant_topk_launch(const void* q, const void* codes,
                                 const void* scales, void* part_d,
                                 void* part_i, void* out_d, void* out_i,
                                 int B, int D, int group, int n_valid, int k,
                                 int S, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || group <= 0 || D % group != 0)
    return (int)cudaErrorInvalidValue;
  const DequantRows load{static_cast<const int8_t*>(codes),
                         static_cast<const float*>(scales), D, group,
                         D / group};
  return topk_tile::launch(static_cast<const float*>(q), load,
                           static_cast<float*>(part_d),
                           static_cast<int*>(part_i),
                           static_cast<float*>(out_d), static_cast<int*>(out_i),
                           B, D, n_valid, k, S,
                           static_cast<cudaStream_t>(stream));
}
