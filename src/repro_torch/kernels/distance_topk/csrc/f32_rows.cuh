// The f32 rows of the top-k product (../../csrc/topk_tile.cuh), shared by
// distance_topk.cu (the one-launch top-k) and f32_distances.cu (the
// large-k route's product).
#pragma once

namespace {

struct F32Rows {
  static constexpr bool kQuant = false;
  const float* x;   // (N, D)
};

}  // namespace
