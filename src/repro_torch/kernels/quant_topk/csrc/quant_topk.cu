// Fused int8 dequant + squared-L2 distance + top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_topk/kernel.py:72 quant_topk_pallas
// (pl.pallas_call at :87; body _kernel, running-best merge
// _merge_topk_scratch in kernels/distance_topk/kernel.py).  For queries
// (B, D) f32 against codes (N, D) int8 x scales (N, D/group) f32 it
// returns, per query, the k rows below n_valid with the smallest
// q2 + x2 - 2 q.x on the dequantized rows, ascending by (distance, id),
// with inf/-1 where fewer than k rows are valid.
//
// Bound: operations.  At the flat stage-1 shape (B = 2000, ~100k valid
// rows, D = 128) the product is 2*B*N*D ~ 51 GFLOP against the 67 TFLOP/s
// f32 (non-tensor-core) peak, ~0.76 ms, while the inputs are ~16 MB,
// ~5 us of memory time.
//
// Design: the one launch of ../../csrc/topk_tile.cuh (a register-tiled f32
// product over a cp.async ring, a threshold-filtered top-k, the merge
// across chunks in the last CTA) for k <= kMaxK (128).  What this file
// adds is the rows: each 64-wide slice of the codes is staged as bytes
// with the scales of the groups it touches (one copy per (row, group)),
// then dequantized once per element into an f32 slice in shared memory
// (code x scale in f32), so the codes never exist in f32 in device memory.
// Groups that are not a multiple of 4 read each code's scale instead.
// Larger k take quant_distances.cu and topk_select.cu.
#include "../../csrc/topk_tile.cuh"
#include "quant_rows.cuh"

// q (B, D) f32, 16-byte aligned; codes (N, D) int8 and scales (N,
// n_groups) contiguous, codes aligned to ``vec`` (16, 8 or 4 bytes,
// dividing D); D is the codes' row length, a multiple of 4: a row the
// wrapper zero-padded holds n_groups * group < D codes; part_d / part_i
// (B, S, k) scratch; arrivals (ceil(B / tile),) uint32, all 0 before the
// launch and left 0 after it; out_d / out_i (B, k); tile 128 or 64.
extern "C" int quant_topk_launch(const void* q, const void* codes,
                                 const void* scales, void* part_d,
                                 void* part_i, void* arrivals, void* out_d,
                                 void* out_i, int B, int D, int group,
                                 int n_groups, int n_valid, int k, int S,
                                 int tile, int vec, void* stream) {
  if (B <= 0) return 0;
  DequantRows rows;
  if (!dequant_rows(codes, scales, D, group, n_groups, vec, &rows))
    return (int)cudaErrorInvalidValue;
  return topk_tile::launch(
      static_cast<const float*>(q), rows, static_cast<float*>(part_d),
      static_cast<int*>(part_i), static_cast<unsigned*>(arrivals),
      static_cast<float*>(out_d), static_cast<int*>(out_i), B, D, n_valid, k,
      S, tile, vec, static_cast<cudaStream_t>(stream));
}
