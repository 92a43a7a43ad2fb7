// The int8 rows of the top-k product (../../csrc/topk_tile.cuh): codes
// with per-group f32 scales, shared by quant_topk.cu (the one-launch
// top-k) and quant_distances.cu (the large-k route's product).
#pragma once

#include <stdint.h>

namespace {

struct DequantRows {
  static constexpr bool kQuant = true;
  const int8_t* codes;   // (N, D), D a multiple of 4
  const float* scales;   // (N, n_groups)
  int group;             // codes per scale
  int n_groups;          // scales a row: n_groups * group <= D
};

// The rows, if the layout is one the kernel reads: groups that are a
// multiple of 4 tile D exactly; others may leave fewer than 4 columns of
// zero padding at the end of a row.
inline bool dequant_rows(const void* codes, const void* scales, int D,
                         int group, int n_groups, int vec,
                         DequantRows* rows) {
  const int used = group * n_groups;
  if (D <= 0 || D % 4 || group <= 0 || n_groups <= 0 || used > D ||
      D - used >= 4 || (group % 4 == 0 && used != D) || vec <= 0 ||
      D % vec)
    return false;
  *rows = DequantRows{static_cast<const int8_t*>(codes),
                      static_cast<const float*>(scales), group, n_groups};
  return true;
}

}  // namespace
