// Squared-L2 distance + per-query top-k over a row database, for Hopper
// (sm_90a): the two passes that kernels/quant_topk and kernels/distance_topk
// share.  Each kernel supplies only how one database element is loaded
// (``Load``: int8 codes times their group scale, or a plain f32 row).
//
// For queries (B, D) f32 against rows (N, D) it returns, per query, the k
// rows below n_valid with the smallest q2 + x2 - 2 q.x, ascending by
// (distance, id) -- ties go to the lower id, as lax.top_k orders them --
// with inf/-1 where fewer than k rows are valid.
//
// Bound: operations.  The product is 2*B*N*D f32 FMAs against the 67
// TFLOP/s f32 (non-tensor-core) peak, while the inputs are read once.  The
// arithmetic stays f32 FMA (no TF32, no tensor cores) so the ids match the
// plain versions' up to ties.
//
// Design: the TPU kernels walk N in order on one core with a running top-k
// in VMEM; here N is split across SMs instead.
//   Pass 1 (grid: query tile x database chunk): a CTA owns 64 queries and
//   one chunk of rows.  Per 64-row tile it loads a 32-wide column slice of
//   the rows into shared memory as f32 (int8 codes are dequantized on the
//   way and never exist in f32 in device memory), accumulates a 64x64
//   block of dot products with 4x4 register tiles per thread, forms the
//   distances, and folds each query's row of the tile into that query's
//   sorted top-k list kept in shared memory.  Tiles at or past n_valid are
//   never visited.  It writes one partial list per (query, chunk):
//   (B, S, k).
//   Pass 2 (one thread per query): merges the S sorted partial lists by
//   (distance, id).
// What is left for later: wgmma/mma tiles, TMA loads, and a merge fused
// into pass 1.
//
// Everything here has internal linkage (an unnamed namespace), so each
// kernel's translation unit carries its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace topk_tile {

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBN = 64;        // database rows per tile
constexpr int kDK = 32;        // dimensions per shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kQP = kBQ + 1;   // padded strides: conflict-free stores
constexpr int kNP = kBN + 1;

// (d1, i1) before (d2, i2): by distance, then by id; id -1 (empty) last
__device__ __forceinline__ bool before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && (unsigned)i1 < (unsigned)i2);
}

inline size_t pass1_smem_bytes(int k) {
  return sizeof(float) * (kDK * kQP + kDK * kNP + kBQ * kNP + kBQ + kBN) +
         (sizeof(float) + sizeof(int)) * (size_t)kBQ * k;
}

// Load: __device__ float operator()(long long row, int col) const, the f32
// value of database element (row, col)
template <class Load>
__global__ void __launch_bounds__(kThreads)
pass1(const float* __restrict__ q, Load load, float* __restrict__ part_d,
      int* __restrict__ part_i, int B, int D, int n_valid, int k, int S) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kDK][kQP] query slice, k-major
  float* xs = qs + kDK * kQP;        // [kDK][kNP] database slice (f32)
  float* dist = xs + kDK * kNP;      // [kBQ][kNP] distance tile
  float* q2s = dist + kBQ * kNP;     // [kBQ]
  float* x2s = q2s + kBQ;            // [kBN]
  float* top_d = x2s + kBN;          // [k][kBQ] sorted lists, query-minor
  int* top_i = reinterpret_cast<int*>(top_d + kBQ * k);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int s = blockIdx.y;
  const int n_tiles = (n_valid + kBN - 1) / kBN;
  const int per_chunk = (n_tiles + S - 1) / S;
  const int row_begin = s * per_chunk * kBN;
  const int row_end = min(n_valid, (s + 1) * per_chunk * kBN);

  for (int e = tid; e < kBQ * k; e += kThreads) {
    top_d[e] = INFINITY;
    top_i[e] = -1;
  }
  if (tid < kBQ) {
    float acc = 0.f;
    if (q0 + tid < B) {
      const float* row = q + (long long)(q0 + tid) * D;
      for (int d = 0; d < D; ++d) acc += row[d] * row[d];
    }
    q2s[tid] = acc;
  }
  __syncthreads();

  for (int n0 = row_begin; n0 < row_end; n0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    float x2 = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDK) {
      for (int e = tid; e < kBQ * kDK; e += kThreads) {
        const int i = e / kDK, kk = e % kDK;
        const int qi = q0 + i, dd = d0 + kk;
        qs[kk * kQP + i] =
            (qi < B && dd < D) ? q[(long long)qi * D + dd] : 0.f;
      }
      for (int e = tid; e < kBN * kDK; e += kThreads) {
        const int j = e / kDK, kk = e % kDK;
        const int nj = n0 + j, dd = d0 + kk;
        xs[kk * kNP + j] = (nj < row_end && dd < D) ? load(nj, dd) : 0.f;
      }
      __syncthreads();
      if (tid < kBN) {
#pragma unroll 8
        for (int kk = 0; kk < kDK; ++kk) {
          const float v = xs[kk * kNP + tid];
          x2 += v * v;
        }
      }
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[kk * kQP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = xs[kk * kNP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }

    if (tid < kBN) x2s[tid] = x2;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        dist[i * kNP + j] = q2s[i] + x2s[j] - 2.f * acc[r][c];
      }
    __syncthreads();

    // fold this tile into each query's running list (one thread a query;
    // the other warps go on to load the next tile)
    if (tid < kBQ && q0 + tid < B) {
      const int n_rows = min(kBN, row_end - n0);
      float wd = top_d[(k - 1) * kBQ + tid];
      int wi = top_i[(k - 1) * kBQ + tid];
      for (int j = 0; j < n_rows; ++j) {
        const float d = dist[tid * kNP + j];
        const int id = n0 + j;
        if (!before(d, id, wd, wi)) continue;
        int pos = k - 1;
        while (pos > 0 && before(d, id, top_d[(pos - 1) * kBQ + tid],
                                 top_i[(pos - 1) * kBQ + tid])) {
          top_d[pos * kBQ + tid] = top_d[(pos - 1) * kBQ + tid];
          top_i[pos * kBQ + tid] = top_i[(pos - 1) * kBQ + tid];
          --pos;
        }
        top_d[pos * kBQ + tid] = d;
        top_i[pos * kBQ + tid] = id;
        wd = top_d[(k - 1) * kBQ + tid];
        wi = top_i[(k - 1) * kBQ + tid];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < kBQ * k; e += kThreads) {
    const int i = e % kBQ, pos = e / kBQ;
    if (q0 + i < B) {
      const long long o = ((long long)(q0 + i) * S + s) * k + pos;
      part_d[o] = top_d[pos * kBQ + i];
      part_i[o] = top_i[pos * kBQ + i];
    }
  }
}

__global__ void pass2(const float* __restrict__ part_d,
                      const int* __restrict__ part_i, float* __restrict__ out_d,
                      int* __restrict__ out_i, int B, int S, int k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  float* od = out_d + (long long)q * k;
  int* oi = out_i + (long long)q * k;
  for (int p = 0; p < k; ++p) {
    od[p] = INFINITY;
    oi[p] = -1;
  }
  float wd = INFINITY;
  int wi = -1;
  for (int s = 0; s < S; ++s) {
    const long long base = ((long long)q * S + s) * k;
    for (int j = 0; j < k; ++j) {
      const float d = part_d[base + j];
      const int id = part_i[base + j];
      // each partial list is sorted: the first miss ends it
      if (id < 0 || !before(d, id, wd, wi)) break;
      int pos = k - 1;
      while (pos > 0 && before(d, id, od[pos - 1], oi[pos - 1])) {
        od[pos] = od[pos - 1];
        oi[pos] = oi[pos - 1];
        --pos;
      }
      od[pos] = d;
      oi[pos] = id;
      wd = od[k - 1];
      wi = oi[k - 1];
    }
  }
}

// Both passes on ``st``; returns cudaGetLastError() after each launch.
template <class Load>
int launch(const float* q, Load load, float* part_d, int* part_i,
           float* out_d, int* out_i, int B, int D, int n_valid, int k, int S,
           cudaStream_t st) {
  if (B <= 0) return 0;
  if (D <= 0 || k <= 0 || S <= 0 || n_valid < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pass1_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&pass1<Load>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid1((B + kBQ - 1) / kBQ, S);
  pass1<Load><<<grid1, kThreads, smem, st>>>(q, load, part_d, part_i, B, D,
                                             n_valid, k, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass2<<<(B + 127) / 128, 128, 0, st>>>(part_d, part_i, out_d, out_i, B, S,
                                         k);
  return (int)cudaGetLastError();
}

}  // namespace topk_tile
}  // namespace
