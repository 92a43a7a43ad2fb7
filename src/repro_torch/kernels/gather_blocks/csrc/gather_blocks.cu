// Doorbell block gather for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gather_blocks/kernel.py gather_blocks_pallas
// (body _kernel).  One launch copies rows ids[0..m) of buf (n_rows,
// row_bytes) into a contiguous (m, row_bytes) output -- the compute-side
// landing buffer of one doorbell batch.  Ids may repeat.
//
// Bound: memory.  The copy moves 2 * m * row_bytes bytes (each source row
// read once, each output row written once) and does no arithmetic, so
// its floor is that over the card's 3.35 TB/s.
//
// Design: the copy is dtype-blind (int32 graph blocks, f32 vector blocks,
// int8 codes and f32 scales all go through it).  The grid is (column
// chunk, descriptor): every block loads its own id, like a NIC resolving
// one descriptor, and copies one chunk of that row with neighbouring
// threads on neighbouring addresses.  The launcher picks the widest word
// (16, 8, 4 or 1 bytes) that divides row_bytes and both base pointers, so
// the usual rows (32 KB vector blocks, 4 KB graph blocks) move as
// 16-byte loads and stores and an odd-sized row falls back to scalars.
// An id outside [0, n_rows) is never read: its row is zeroed and the
// kernel sets *bad, which the wrapper turns into an IndexError, as the
// plain version (index_select) raises on the same ids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;

template <typename Word>
__global__ void gather_rows_kernel(const Word* __restrict__ buf,
                                   const int32_t* __restrict__ ids,
                                   Word* __restrict__ out,
                                   long long row_words, long long n_rows,
                                   int* __restrict__ bad) {
  const long long row = blockIdx.y;
  const int32_t id = ids[row];
  const bool ok = id >= 0 && id < n_rows;
  if (!ok && blockIdx.x == 0 && threadIdx.x == 0) *bad = 1;
  const Word* src = buf + (long long)id * row_words;
  Word* dst = out + row * row_words;
  const long long chunk = (long long)kThreads * kWordsPerThread;
  const long long start = (long long)blockIdx.x * chunk + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const long long w = start + (long long)u * kThreads;
    if (w < row_words) {
      Word v;
      if (ok) {
        v = src[w];
      } else {
        v = Word{};
      }
      dst[w] = v;
    }
  }
}

template <typename Word>
cudaError_t launch(const void* buf, const int32_t* ids, void* out,
                   long long m, long long row_bytes, long long n_rows,
                   int* bad, cudaStream_t stream) {
  const long long row_words = row_bytes / (long long)sizeof(Word);
  const long long chunk = (long long)kThreads * kWordsPerThread;
  const unsigned gx = (unsigned)((row_words + chunk - 1) / chunk);
  // grid.y holds at most 65535 descriptors: larger batches launch in runs
  for (long long r0 = 0; r0 < m; r0 += 65535) {
    const long long rows = m - r0 < 65535 ? m - r0 : 65535;
    gather_rows_kernel<Word><<<dim3(gx, (unsigned)rows), kThreads, 0,
                               stream>>>(
        static_cast<const Word*>(buf), ids + r0,
        static_cast<Word*>(out) + r0 * row_words, row_words, n_rows, bad);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int gather_blocks_launch(const void* buf, const void* ids,
                                    void* out, long long m,
                                    long long row_bytes, long long n_rows,
                                    void* bad, void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  const uintptr_t align = (uintptr_t)buf | (uintptr_t)out |
                          (uintptr_t)row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  int* badp = static_cast<int*>(bad);
  cudaError_t err;
  if (align % 16 == 0) {
    err = launch<uint4>(buf, idp, out, m, row_bytes, n_rows, badp, s);
  } else if (align % 8 == 0) {
    err = launch<uint2>(buf, idp, out, m, row_bytes, n_rows, badp, s);
  } else if (align % 4 == 0) {
    err = launch<uint32_t>(buf, idp, out, m, row_bytes, n_rows, badp, s);
  } else {
    err = launch<uint8_t>(buf, idp, out, m, row_bytes, n_rows, badp, s);
  }
  return (int)err;
}
