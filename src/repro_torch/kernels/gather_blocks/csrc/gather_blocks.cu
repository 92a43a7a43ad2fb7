// Doorbell span gather for Hopper (sm_90a): one launch per span read.
//
// Replaces: src/repro/kernels/gather_blocks/kernel.py:31
// gather_blocks_pallas (body _kernel; pallas_call at :39).  One span read
// of the pool fetches the same block ids from up to three staged buffers
// (graph blocks and vector blocks on the exact paths; graph blocks, int8
// codes and f32 scales on the int8 per-pair path): one launch copies rows
// ids[0..m) of every buffer bufs[j] (n_rows_j, row_bytes_j) into its own
// contiguous (m, row_bytes_j) output.  Ids may repeat.
//
// Bound: bytes.  The copy moves 2 * m * sum_j row_bytes_j bytes (each
// source row read once, each output row written once) plus the ids, and
// does no arithmetic, so its floor is that over the card's 3.35 TB/s.
//
// Design.  A launch per buffer gave each buffer its own ramp and tail,
// and a (column chunk x descriptor) grid filled a CTA only as far as one
// row reached: a quarter for a 4 KB graph row, far less for a scale row.
// Here the work of all the buffers is one space of fixed-size units: a
// unit is one warp's 32 lanes x kWords words of one row of one buffer
// (4 KB of 16-byte words).  A grid of kCtasPerSm CTAs per SM (16, twice
// what fits at once) walks the units warp by warp in a grid-stride loop,
// so large vector rows and small graph or scale rows all give full units
// and the card sees one ramp and one tail per span read.  Each lane
// issues all the loads of its unit before any store (kWords 16-byte loads
// in flight per lane).  The copy is dtype-blind: each buffer moves in the
// widest word (16, 8, 4 or 1 bytes) that divides its row_bytes and both
// its base pointers, so an odd-sized row takes narrower words in the same
// kernel.
// Bound reached on the H100: see PERF.md (python3 chip_smoke.py --sweep
// times a contiguous copy of the same bytes beside it).  An id outside
// [0, n_rows_j) is never read: its unit is zeroed and the kernel sets
// *bad, which the wrapper turns into an IndexError, as the plain version
// (index_select) raises on the same ids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBufs = 3;
constexpr int kThreads = 256;
constexpr int kWords = 8;            // words a lane moves per unit
constexpr int kUnitWords = 32 * kWords;
constexpr int kCtasPerSm = 16;       // the persistent grid's size

struct Buf {
  const char* src;
  char* dst;
  long long row_words;   // words of `word` bytes per row
  long long n_rows;
  long long units;       // m * units per row
  int word;              // 16, 8, 4 or 1
  int units_per_row;
};

struct Table {
  Buf buf[kMaxBufs];
  int n;
};

template <typename W>
__device__ __forceinline__ void copy_unit(const Buf& t, long long id,
                                          bool ok, long long row, long long w0,
                                          int lane) {
  const W* src = reinterpret_cast<const W*>(t.src) + id * t.row_words;
  W* dst = reinterpret_cast<W*>(t.dst) + row * t.row_words;
  W v[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long w = w0 + u * 32 + lane;
    v[u] = (ok && w < t.row_words) ? __ldg(src + w) : W{};
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long w = w0 + u * 32 + lane;
    if (w < t.row_words) dst[w] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_spans_kernel(const Table table, const int32_t* __restrict__ ids,
                    long long total_units, int* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long unit = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
       unit < total_units; unit += warps) {
    // the unit's buffer (static indices only: the table stays in the
    // kernel's parameter space)
    long long u = unit;
    int j = 0;
#pragma unroll
    for (int jj = 0; jj + 1 < kMaxBufs; ++jj) {
      if (j == jj && jj + 1 < table.n && u >= table.buf[jj].units) {
        u -= table.buf[jj].units;
        j = jj + 1;
      }
    }
    const Buf t = j == 0 ? table.buf[0] : j == 1 ? table.buf[1] : table.buf[2];
    const long long row = u / t.units_per_row;
    const long long w0 = (u - row * t.units_per_row) * kUnitWords;
    const long long id = ids[row];
    const bool ok = id >= 0 && id < t.n_rows;
    if (!ok && lane == 0) *bad = 1;
    switch (t.word) {
      case 16: copy_unit<uint4>(t, ok ? id : 0, ok, row, w0, lane); break;
      case 8: copy_unit<uint2>(t, ok ? id : 0, ok, row, w0, lane); break;
      case 4: copy_unit<uint32_t>(t, ok ? id : 0, ok, row, w0, lane); break;
      default: copy_unit<uint8_t>(t, ok ? id : 0, ok, row, w0, lane); break;
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

}  // namespace

// bufs: n_bufs (1..3) rows of 4 long longs (source pointer, destination
// pointer, row_bytes, n_rows), read on the host.  ids (m,) int32 on the
// card; each destination (m, row_bytes) contiguous.  bad: one int32 on the
// card, set to 1 if an id is outside a buffer (and left as it was
// otherwise).
extern "C" int gather_spans_launch(const long long* bufs, int n_bufs,
                                   const void* ids, long long m, void* bad,
                                   void* stream) {
  if (n_bufs < 1 || n_bufs > kMaxBufs) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  Table table{};
  table.n = n_bufs;
  long long total = 0;
  for (int j = 0; j < n_bufs; ++j) {
    const long long* e = bufs + 4 * j;
    const long long row_bytes = e[2];
    if (row_bytes < 0 || e[3] < 0) return (int)cudaErrorInvalidValue;
    const uintptr_t align = (uintptr_t)e[0] | (uintptr_t)e[1] |
                            (uintptr_t)row_bytes;
    const int word = align % 16 == 0 ? 16 : align % 8 == 0 ? 8
                   : align % 4 == 0 ? 4 : 1;
    Buf& t = table.buf[j];
    t.src = reinterpret_cast<const char*>(e[0]);
    t.dst = reinterpret_cast<char*>(e[1]);
    t.word = word;
    t.row_words = row_bytes / word;
    t.n_rows = e[3];
    t.units_per_row = (int)((t.row_words + kUnitWords - 1) / kUnitWords);
    t.units = m * t.units_per_row;
    total += t.units;
  }
  if (total == 0) return 0;
  const long long want = (total + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = (long long)sm_count() * kCtasPerSm;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  gather_spans_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int32_t*>(ids), total, static_cast<int*>(bad));
  return (int)cudaGetLastError();
}
