// Per-query top-k selection from a distance matrix, for Hopper (sm_90a):
// the second half of the large-k route of quant_topk and distance_topk
// (k > 128, where the lists of ../../csrc/topk_tile.cuh do not fit in
// shared memory).  quant_distances.cu / ../../distance_topk/csrc/
// f32_distances.cu write the distances; this picks, per query, the k
// smallest entries of its row of n, ascending by (distance, column) --
// ties go to the lower column, as lax.top_k orders them -- with inf/-1
// where k > n or a distance is not finite.
//
// Bound: bytes.  The row is read five times (four radix passes and the
// gather), about 5 x 4 x n bytes a query.
//
// Design: one CTA a query.  A distance becomes an unsigned key whose
// order is the float order (-0 is first made +0, so it ties with +0 as
// the float compare does).  Four passes of 8-bit digits (a shared
// histogram, one atomic per distinct digit of a warp) find the key of the
// k-th smallest entry, T, how many entries lie below it, and how many
// equal it.  The gather pass writes (key << 32 | column) of every entry
// below T and of the first entries equal to T, by column, until k are
// taken: when every entry equal to T is taken (the common case) in any
// order, else in column order through a block scan.  A bitonic sort of
// the k 64-bit words (in shared memory up to kSortSmem of them, else in
// the caller's scratch) orders them by (distance, column): the words are
// distinct, so the order is total.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 512;                // threads a CTA
constexpr int kW = kT / 32;            // warps a CTA
constexpr int kSortSmem = 16384;       // words sorted in shared memory
constexpr int kSmemOptIn = kSortSmem * 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned key_of(float d) {
  const unsigned u = __float_as_uint(d + 0.0f);   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float dist_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The exclusive prefix of v over the CTA's threads (every thread calls);
// the CTA's total in ``total``.  ws holds kW + 1 ints.
__device__ int block_exclusive(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kW ? ws[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kW) ws[lane] = wi - w;
    if (lane == kW - 1) ws[kW] = wi;
  }
  __syncthreads();
  const int out = ws[warp] + incl - v;
  total = ws[kW];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kT)
topk_select(const float* __restrict__ dist, long long ld, int n, int k,
            unsigned long long* scratch, int P, int in_smem,
            float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned long long sbuf[];
  __shared__ unsigned hist[256];
  __shared__ int ws[kW + 1];
  __shared__ unsigned s_digit;
  __shared__ int s_below, s_count, s_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = dist + (long long)blockIdx.x * ld;
  const int take = min(k, n);

  // ---- the key T of the take-th smallest entry: entries with key < T
  // are all taken, and the first ``rem`` of those equal to T
  unsigned prefix = 0xffffffffu;
  int rem = take, n_eq = take;   // take == n: everything, in any order
  if (take < n) {
    unsigned mask = 0;
    prefix = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += kT) hist[b] = 0u;
      __syncthreads();
      for (int e0 = 0; e0 < n; e0 += kT) {
        const int e = e0 + tid;
        unsigned key = 0;
        bool act = false;
        if (e < n) {
          key = key_of(row[e]);
          act = (key & mask) == prefix;
        }
        const unsigned dig = (key >> shift) & 255u;
        const unsigned live = __ballot_sync(kFull, act);
        if (act) {
          const unsigned peers = __match_any_sync(live, dig);
          if (lane == __ffs(peers) - 1)
            atomicAdd(hist + dig, (unsigned)__popc(peers));
        }
      }
      __syncthreads();
      if (warp == 0) {   // lane l owns digits 8 l .. 8 l + 7
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[8 * lane + j];
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        const unsigned excl = incl - sum;
        if (excl < (unsigned)rem && (unsigned)rem <= incl) {
          unsigned below = excl;
          int j = 0;
          while (below + c[j] < (unsigned)rem) below += c[j++];
          s_digit = 8 * lane + j;
          s_below = (int)below;
          s_count = (int)c[j];
        }
      }
      __syncthreads();
      prefix |= s_digit << shift;
      mask |= 255u << shift;
      rem -= s_below;
      n_eq = s_count;
    }
  }

  // ---- the gather: the taken entries as (key << 32 | column)
  unsigned long long* buf =
      in_smem ? sbuf : scratch + (long long)blockIdx.x * P;
  if (n_eq == rem) {   // every entry equal to T is taken: any order
    if (tid == 0) s_out = 0;
    __syncthreads();
    for (int e0 = 0; e0 < n; e0 += kT) {
      const int e = e0 + tid;
      unsigned key = 0;
      bool tk = false;
      if (e < n) {
        key = key_of(row[e]);
        tk = key <= prefix;
      }
      const unsigned m = __ballot_sync(kFull, tk);
      if (m) {
        const int leader = __ffs(m) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&s_out, __popc(m));
        base = __shfl_sync(kFull, base, leader);
        if (tk)
          buf[base + __popc(m & ((1u << lane) - 1u))] =
              ((unsigned long long)key << 32) | (unsigned)e;
      }
    }
  } else {             // ties at T: the lowest columns, by a block scan
    int eq_seen = 0, out = 0;
    for (int e0 = 0; e0 < n; e0 += kT) {
      const int e = e0 + tid;
      unsigned key = 0xffffffffu;
      bool lt = false, eq = false;
      if (e < n) {
        key = key_of(row[e]);
        lt = key < prefix;
        eq = key == prefix;
      }
      int tot_eq, tot_tk;
      const int rank = eq_seen + block_exclusive(eq, ws, tot_eq);
      const bool tk = lt || (eq && rank < rem);
      const int pos = out + block_exclusive(tk, ws, tot_tk);
      if (tk) buf[pos] = ((unsigned long long)key << 32) | (unsigned)e;
      eq_seen += tot_eq;
      out += tot_tk;
    }
  }
  for (int e = take + tid; e < P; e += kT) buf[e] = ~0ull;
  __syncthreads();

  // ---- bitonic sort of the P words, ascending
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += kT) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }

  const long long o = (long long)blockIdx.x * k;
  for (int j = tid; j < k; j += kT) {
    float d = INFINITY;
    int id = -1;
    if (j < take) {
      const unsigned long long v = buf[j];
      d = dist_of((unsigned)(v >> 32));
      id = (int)(unsigned)(v & 0xffffffffull);
      if (!isfinite(d)) {
        d = INFINITY;
        id = -1;
      }
    }
    out_d[o + j] = d;
    out_i[o + j] = id;
  }
}

}  // namespace

// dist (B, ld) f32, ld >= n; out_d / out_i (B, k); scratch: B x P words
// (P the power of two at or above min(k, n)) when P > kSortSmem (16384),
// else unused (may be null).  One CTA a query.
extern "C" int topk_select_launch(const void* dist, long long ld, int B,
                                  int n, int k, void* scratch, void* out_d,
                                  void* out_i, void* stream) {
  if (B <= 0) return 0;
  if (k <= 0 || n < 0 || ld < n) return (int)cudaErrorInvalidValue;
  const int take = k < n ? k : n;
  int P = 1;
  while (P < take) P <<= 1;
  const int in_smem = P <= kSortSmem;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // the opt-in to 128 KB of shared memory, once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&topk_select),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemOptIn);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted |= 1ull << dev;
  }
  const size_t smem = in_smem ? (size_t)P * 8 : 0;
  topk_select<<<B, kT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), ld, n, k,
      static_cast<unsigned long long*>(scratch), P, in_smem,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
