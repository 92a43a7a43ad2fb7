// Sub-HNSW beam walk for Hopper (sm_90a): one launch a pair chunk.
//
// Replaces no Pallas kernel.  It replaces the JAX package's walk, the
// lax.while_loop of src/repro/core/search.py:70 beam_search (:114),
// vmapped over the pairs, which the port ran as a host loop (core/search.py
// batched_beam_search): ~50 small launches and one host sync a step, ~53
// steps a round, so the card idled while the host issued.  One launch
// runs every lane's layer-0 walk from its entry to its stop rule.
//
// Bound: latency.  A step of one lane reads one adjacency row (deg int32)
// and then up to deg vector rows (deg x D floats: 8 KB at deg 16, D 128),
// two loads that depend on each other, then merges in shared memory.  Over
// a chunk of 256 lanes a step moves ~2 MB, about 1 us of HBM time, while
// the two dependent loads take ~1-2 us: the step's chain of latencies, not
// the bytes, bounds it.  On the H100 a step of the sift path takes ~4.8 us
// (PERF.md): the three barriers and the merge add to the two loads.
//
// Design.  One block of kThreads threads a lane, so lanes that stop early
// free their SM.  Shared memory holds the query, the lane's beam (ef
// distances, ids and expanded flags, kept sorted, double buffered), the
// step's new candidates and the visited bitmap of n + 1 bits, all sized
// at launch from n, D, deg and ef.  A step: the first unexpanded live
// entry and the last live one, found by the previous merge, give the stop
// rule and the node to expand; deg threads load its adjacency row and
// test every neighbour against the bitmap before any is marked; each warp
// then loads kGroup neighbour rows at once (16-, 8- or 4-byte words, the
// widest that D, the strides and the base divide) and reduces each
// distance with warp shuffles; the merge places each element at its rank
// in the other list (a count over the new candidates for a beam entry, a
// binary search of the sorted beam for a candidate), so the stable order
// of [beam, new] comes out in one pass with no sort.  Three block barriers
// a step; the host waits for nothing.
//
// Kept from the plain walk, exactly: the stop rule (a lane runs while its
// best unexpanded finite distance <= its worst live one, at most
// max_iters steps), node 0 marked whenever a neighbour is not fresh, an
// id >= n read at row and bit n - 1 and marked in the dump bit n with its
// raw id kept in the beam, ties to the beam and then to the earlier
// neighbour, NaN after every number as torch.sort orders it.  Only the
// order of each distance's sum differs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;            // neighbour rows a warp loads at once
constexpr int kMaxDeg = 64;
constexpr int kMaxEf = 512;
constexpr int kNone = 0x7fffffff;

struct Walk {
  const float* vectors;
  long long v_lane, v_row;           // strides in floats
  const int32_t* adjacency;
  long long a_lane, a_row;           // strides in int32
  const float* queries;
  long long q_row;
  const long long* entry;
  float* out_d;
  long long* out_i;
  int32_t* steps;
  int n, dim, deg, ef, max_iters;
};

// torch.sort's order: NaN after every number, inf included
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

template <int W> struct Word;
template <> struct Word<4> {
  using T = float4;
  static __device__ __forceinline__ float sq(T v, T q) {
    const float x = v.x - q.x, y = v.y - q.y, z = v.z - q.z, w = v.w - q.w;
    return fmaf(x, x, fmaf(y, y, fmaf(z, z, w * w)));
  }
};
template <> struct Word<2> {
  using T = float2;
  static __device__ __forceinline__ float sq(T v, T q) {
    const float x = v.x - q.x, y = v.y - q.y;
    return fmaf(x, x, y * y);
  }
};
template <> struct Word<1> {
  using T = float;
  static __device__ __forceinline__ float sq(T v, T q) {
    const float x = v - q;
    return x * x;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Squared L2 of kGroup rows (null: skipped) from the query, each summed
// over the warp; every lane returns the sums.
template <int W>
__device__ __forceinline__ void rows_dist(const float* const* rows,
                                          const float* q, int dim, int lane,
                                          float* acc) {
  using T = typename Word<W>::T;
  const int words = dim / W;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) acc[g] = 0.f;
  for (int c = lane; c < words; c += 32) {
    const T qv = reinterpret_cast<const T*>(q)[c];
    T v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (rows[g]) v[g] = __ldg(reinterpret_cast<const T*>(rows[g]) + c);
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (rows[g]) acc[g] += Word<W>::sq(v[g], qv);
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) acc[g] = warp_sum(acc[g]);
}

// A block's shared memory as the device grants it on opting in (0 when
// the device cannot be read), cached per device.
int smem_limit() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

// Shared memory of one lane's block: the query, two beams, the step's new
// candidates, the visited bitmap of n + 1 bits, four control words and
// the expanded flags; -1 past what the device grants a block.
int smem_bytes(int n, int dim, int deg, int ef) {
  const long long words = (n + 1 + 31) / 32;
  const long long four = ((dim + 3) & ~3) + 4LL * ef + 2LL * deg + words + 4;
  const long long b = 4 * four + 2LL * ef;
  return b > smem_limit() ? -1 : (int)b;
}

template <int W>
__global__ void __launch_bounds__(kThreads) beam_walk_kernel(const Walk w) {
  extern __shared__ float4 smem4[];
  const int ef = w.ef, deg = w.deg, n = w.n, dim = w.dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;
  float* q = reinterpret_cast<float*>(smem4);
  float* bd = q + ((dim + 3) & ~3);  // two beams of ef
  float* nd = bd + 2 * ef;           // the step's new distances
  int* bi = reinterpret_cast<int*>(nd + deg);
  int* ni = bi + 2 * ef;             // the new ids, -1 where not fresh
  unsigned* vis = reinterpret_cast<unsigned*>(ni + deg);
  const int words = (n + 1 + 31) >> 5;
  // ctl[s]: first unexpanded live entry, ctl[2 + s]: last live entry, of
  // the beam a merge wrote; s alternates with the step
  int* ctl = reinterpret_cast<int*>(vis + words);
  unsigned char* be = reinterpret_cast<unsigned char*>(ctl + 4);

  const float* V = w.vectors + b * w.v_lane;
  const int32_t* A = w.adjacency + b * w.a_lane;
  const float* Q = w.queries + b * w.q_row;
  for (int i = tid; i < dim; i += kThreads) q[i] = Q[i];
  for (int i = tid; i < words; i += kThreads) vis[i] = 0u;
  for (int i = tid; i < ef; i += kThreads) {
    bd[i] = INFINITY;
    bi[i] = -1;
    be[i] = 0;
  }
  __syncthreads();
  const long long ep = w.entry[b];
  if (warp == 0) {
    const long long row = ep < 0 ? 0 : ep < n ? ep : n - 1;
    const float* rows[kGroup] = {V + row * w.v_row, nullptr, nullptr,
                                 nullptr};
    float acc[kGroup];
    rows_dist<W>(rows, q, dim, lane, acc);
    if (lane == 0) {
      bd[0] = acc[0];
      bi[0] = (int)ep;
      const bool live = ep >= 0;
      if (live) {
        const int m = ep < n ? (int)ep : n;
        vis[m >> 5] |= 1u << (m & 31);
      }
      ctl[0] = live ? 0 : kNone;
      ctl[2] = live ? 0 : -1;
    }
  }
  __syncthreads();

  int cur = 0, it = 0;
  for (; it < w.max_iters; ++it) {
    const int s = it & 1;
    float* cd = bd + cur * ef;
    int* ci = bi + cur * ef;
    unsigned char* ce = be + cur * ef;
    const int pos = ctl[s], last = ctl[2 + s];
    // the beam is sorted, so its first unexpanded live entry is the best
    // one and its last live entry the worst
    if (pos == kNone || !isfinite(cd[pos]) || !(cd[pos] <= cd[last])) break;
    if (tid == 0) {
      ctl[s ^ 1] = kNone;
      ctl[2 + (s ^ 1)] = -1;
      ce[pos] = 1;
    }
    const int u = min(max(ci[pos], 0), n - 1);
    int nb = -1;
    bool fresh = false;
    if (tid < deg) {
      nb = A[(long long)u * w.a_row + tid];
      const int rb = nb >= 0 ? min(nb, n - 1) : 0;
      fresh = nb >= 0 && !((vis[rb >> 5] >> (rb & 31)) & 1u);
      ni[tid] = fresh ? nb : -1;
    }
    __syncthreads();  // every bit is read before any is marked
    if (tid < deg) {
      const int m = fresh ? min(nb, n) : 0;
      atomicOr(&vis[m >> 5], 1u << (m & 31));
    }
    for (int j0 = warp; j0 < deg; j0 += kWarps * kGroup) {
      const float* rows[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = j0 + g * kWarps;
        const int id = j < deg ? ni[j] : -1;
        rows[g] = id >= 0 ? V + (long long)min(id, n - 1) * w.v_row : nullptr;
      }
      float acc[kGroup];
      rows_dist<W>(rows, q, dim, lane, acc);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int j = j0 + g * kWarps;
          if (j < deg) nd[j] = rows[g] ? acc[g] : INFINITY;
        }
      }
    }
    __syncthreads();  // the new candidates are ready

    float* od = bd + (cur ^ 1) * ef;
    int* oi = bi + (cur ^ 1) * ef;
    unsigned char* oe = be + (cur ^ 1) * ef;
    int first = kNone, lastl = -1;
    for (int i = tid; i < ef; i += kThreads) {
      const float x = cd[i];
      int p = i;
      for (int j = 0; j < deg; ++j) p += before(nd[j], x);
      if (p < ef) {
        const int id = ci[i];
        od[p] = x;
        oi[p] = id;
        oe[p] = ce[i];
        if (id >= 0) {
          lastl = max(lastl, p);
          if (!ce[i]) first = min(first, p);
        }
      }
    }
    if (tid < deg) {
      const float x = nd[tid];
      int p = 0;
      for (int k = 0; k < deg; ++k)
        p += before(nd[k], x) || (k < tid && !before(x, nd[k]));
      int lo = 0, hi = ef;               // beam entries not after x
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(x, cd[mid])) hi = mid; else lo = mid + 1;
      }
      p += lo;
      if (p < ef) {
        const int id = ni[tid];
        od[p] = x;
        oi[p] = id;
        oe[p] = 0;
        if (id >= 0) {
          lastl = max(lastl, p);
          first = min(first, p);
        }
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    lastl = __reduce_max_sync(0xffffffffu, lastl);
    if (lane == 0) {
      if (first != kNone) atomicMin(&ctl[s ^ 1], first);
      if (lastl >= 0) atomicMax(&ctl[2 + (s ^ 1)], lastl);
    }
    cur ^= 1;
    __syncthreads();  // the merged beam and its ends are ready
  }

  const float* cd = bd + cur * ef;
  const int* ci = bi + cur * ef;
  for (int i = tid; i < ef; i += kThreads) {
    w.out_d[b * ef + i] = cd[i];
    w.out_i[b * ef + i] = ci[i];
  }
  if (tid == 0) w.steps[b] = it;
}

template <int W>
int launch(const Walk& w, int lanes, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&beam_walk_kernel<W>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_walk_kernel<W><<<lanes, kThreads, smem, stream>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// vectors (lanes, n, dim) f32, adjacency (lanes, n, deg) int32 and
// queries (lanes, dim) f32, each with unit stride along its last axis and
// the strides given (in elements) elsewhere; entry (lanes,) int64.
// Writes out_d (lanes, ef) f32 and out_i (lanes, ef) int64, ascending,
// inf / -1 padded, and steps (lanes,) int32, each lane's beam steps.
// Returns cudaErrorInvalidValue, launching nothing, for a shape it does
// not take: deg past kMaxDeg, ef past kMaxEf, or a lane's shared memory
// past what the device grants a block.  These are the only checks of the
// shape limits.
extern "C" int beam_walk_launch(
    const void* vectors, long long v_lane, long long v_row,
    const void* adjacency, long long a_lane, long long a_row,
    const void* queries, long long q_row, const void* entry, void* out_d,
    void* out_i, void* steps, int lanes, int n, int dim, int deg, int ef,
    int max_iters, void* stream) {
  if (lanes <= 0) return 0;
  if (n < 1 || dim < 1 || deg < 1 || deg > kMaxDeg || ef < 1 ||
      ef > kMaxEf || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n, dim, deg, ef);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  Walk w{static_cast<const float*>(vectors), v_lane, v_row,
         static_cast<const int32_t*>(adjacency), a_lane, a_row,
         static_cast<const float*>(queries), q_row,
         static_cast<const long long*>(entry), static_cast<float*>(out_d),
         static_cast<long long*>(out_i), static_cast<int32_t*>(steps),
         n, dim, deg, ef, max_iters};
  const uintptr_t align = (uintptr_t)vectors | (uintptr_t)(v_lane * 4) |
                          (uintptr_t)(v_row * 4) | (uintptr_t)(dim * 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return launch<4>(w, lanes, smem, s);
  if (align % 8 == 0) return launch<2>(w, lanes, smem, s);
  return launch<1>(w, lanes, smem, s);
}
