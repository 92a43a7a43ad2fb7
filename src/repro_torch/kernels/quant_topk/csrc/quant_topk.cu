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
// across chunks in the last CTA).  What this file adds is the
// rows: each 32-wide slice of the codes is staged as bytes with the scales
// of the groups it touches (one copy per (row, group)), then dequantized
// once per element into an f32 slice in shared memory (code x scale in
// f32), so the codes never exist in f32 in device memory.
#include "../../csrc/topk_tile.cuh"

namespace {

struct DequantRows {
  static constexpr bool kQuant = true;
  const int8_t* codes;   // (N, D)
  const float* scales;   // (N, D / group)
  int group;             // a multiple of 4 dividing D
};

}  // namespace

// q (B, D) f32, 16-byte aligned; codes (N, D) int8 and scales contiguous,
// codes aligned to ``vec`` (16, 8 or 4 bytes, dividing D); part_d / part_i
// (B, S, k) scratch; arrivals (ceil(B / tile),) uint32, all 0 before the
// launch and left 0 after it; out_d / out_i (B, k); tile 128 or 64.
extern "C" int quant_topk_launch(const void* q, const void* codes,
                                 const void* scales, void* part_d,
                                 void* part_i, void* arrivals, void* out_d,
                                 void* out_i, int B, int D, int group,
                                 int n_valid, int k, int S, int tile, int vec,
                                 void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || group <= 0 || group % 4 || D % group || D % vec)
    return (int)cudaErrorInvalidValue;
  const DequantRows rows{static_cast<const int8_t*>(codes),
                         static_cast<const float*>(scales), group};
  return topk_tile::launch(
      static_cast<const float*>(q), rows, static_cast<float*>(part_d),
      static_cast<int*>(part_i), static_cast<unsigned*>(arrivals),
      static_cast<float*>(out_d), static_cast<int*>(out_i), B, D, n_valid, k,
      S, tile, vec, static_cast<cudaStream_t>(stream));
}
