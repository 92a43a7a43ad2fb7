// Fused squared-L2 distance + top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/distance_topk/kernel.py distance_topk_pallas
// (body _kernel, running-best merge _merge_topk_scratch).  For f32 queries
// (B, D) against an f32 database (N, D) it returns, per query, the k rows
// below n_valid with the smallest q2 + x2 - 2 q.x, ascending by (distance,
// id) -- the Pallas merge takes the first occurrence of the argmin with the
// running best ahead of the tile, so the lower id wins ties -- with inf/-1
// where fewer than k rows are valid.  Inputs of other float types are cast
// to f32 by the wrapper (ops.py), as the reference wrapper casts them, so
// there is no bf16 load path here.
//
// Bound: operations.  At the flat f32 shape (B = 2000, ~100k valid rows,
// D = 128) the product is 2*B*N*D ~ 51 GFLOP against the 67 TFLOP/s f32
// (non-tensor-core) peak, ~0.76 ms, while the inputs are ~52 MB, ~16 us of
// memory time.  At the throughput benchmark's shape (B = 128, N = 4096)
// the bound is ~2 us and one launch's latency dominates.
//
// Design: the f32 twin of quant_topk.cu without the dequant; both are the
// two passes of ../../csrc/topk_tile.cuh (N split across SMs over a (query
// tile x database chunk) grid, 4x4-register-tile f32 FMAs, a sorted
// per-query list in shared memory, then a merge of the per-chunk lists).
// The Pallas grid carries its top-k in VMEM across a sequential N axis;
// CTAs on 132 SMs run in no order, hence the second pass.
#include "../../csrc/topk_tile.cuh"

namespace {

struct F32Rows {
  const float* x;
  int D;

  __device__ __forceinline__ float operator()(long long row, int col) const {
    return x[row * D + col];
  }
};

}  // namespace

extern "C" int distance_topk_launch(const void* q, const void* x,
                                    void* part_d, void* part_i, void* out_d,
                                    void* out_i, int B, int D, int n_valid,
                                    int k, int S, void* stream) {
  const F32Rows load{static_cast<const float*>(x), D};
  return topk_tile::launch(static_cast<const float*>(q), load,
                           static_cast<float*>(part_d),
                           static_cast<int*>(part_i),
                           static_cast<float*>(out_d), static_cast<int*>(out_i),
                           B, D, n_valid, k, S,
                           static_cast<cudaStream_t>(stream));
}
