// Squared-L2 distance + per-query top-k over a row database, for Hopper
// (sm_90a): the one kernel that kernels/quant_topk and kernels/distance_topk
// share.  Each of them supplies only its rows (``Rows``: int8 codes with
// per-group f32 scales, or plain f32 rows).
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
// Design: one launch.  The TPU kernels walk N in order on one core with a
// running top-k in VMEM; here N is split into S chunks across SMs, over a
// (query tile x chunk) grid, and the last CTA of each query tile to finish
// merges the chunks' lists.
//   The product: a BQ x BN output tile a CTA -- 128 x 128 with 512 threads
//   of 8 x 4 outputs, or 64 x 64 with 256 threads of 4 x 4 for small calls
//   -- from column slices of kDK (64) dimensions in shared memory, read as
//   16-byte words (rows padded by 4 floats; a warp is 4 x 8 threads, so a
//   fragment load is one conflict-free wavefront).  D streams through a
//   cp.async ring of kRing stages (2, or 3 at 64 x 64): the next slices
//   (queries and rows, or codes and their scales) are in flight while the
//   current one is multiplied.  The copy width (16, 8 or 4 bytes) is a
//   template parameter the wrapper picks from the rows' stride and
//   alignment.  int8 codes are dequantized once per element per CTA from
//   the staged slice (code x scale in f32, the scale copied once per (row,
//   group)); x2 and q2 are summed from the f32 slices by all threads and
//   reduced by shuffles.
//   The top-k: each query's sorted list lives in shared memory; its k-th
//   entry is the threshold.  After a tile each thread tests its distances
//   against its queries' thresholds (the strict (distance, id) order) and
//   the 8 threads of a query row in a warp append their survivors to the
//   query's candidate buffer with one atomicAdd.  A buffer past its fill
//   mark is merged into the list by one warp -- for k <= 32 a bitonic sort
//   of the candidates in registers, a lane-wise min with the list and a
//   bitonic merge, two queries at a time; for larger k by rank (each
//   entry's place is its index plus its rank in the other list) -- which
//   raises the threshold; entries that found their buffer full retry after
//   the merge.  Past the first tile of a chunk few rows survive, and a tile
//   with no buffer past its mark pays one barrier.  The order is total, so
//   the result does not depend on arrival order.
//   The merge across chunks: every CTA writes its list to the scratch
//   (B, S, k), fences and takes a ticket from its query tile's arrival
//   counter; the last one copies the other lists into its slice buffers
//   (cp.async, all in flight), streams them through the same filter and
//   merges, writes the result and resets the counter to 0.
// Two more routes share this product:
//   Small groups: when the codec group is not a multiple of 4 (2, 6, or
//   a row the wrapper zero-padded to a multiple of 4 dimensions), four
//   consecutive codes may span two groups.  No scales are staged then; the
//   dequantize reads each code's own scale (``__ldg``, L1-resident: a
//   row's scales are D / group floats) -- kMaxSG assumes group >= 4.
//   Large k (k > kMaxK): the lists do not fit beside the tiles.  A kDump
//   instantiation of the same product writes every distance of the chunk
//   to a (B, ld) matrix instead of filtering it, and topk_select.cu picks
//   each query's k smallest from its row by radix select.
// What is left for later (PERF.md §6): the inner loop issues FMAs at two
// thirds of the rate a register-only FMA loop reaches on this card, and
// ptxas spills a few words at 512 threads (128 registers); the candidates
// and their merges cost a fifth of the time, most of it between barriers
// while the FMA units idle; one CTA an SM leaves nothing to cover a
// barrier.  An exact tensor-core
// product (int8 codes are exact in bf16, q split into three bf16 terms)
// would need a new bound and a precision rule of its own.
//
// Everything here has internal linkage (an unnamed namespace), so each
// kernel's translation unit carries its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace topk_tile {

constexpr int kDK = 64;        // dimensions per slice
constexpr int kLd = kDK + 4;   // padded row stride of an f32 slice (floats)
constexpr int kMaxSG = kDK / 4;  // scale groups a slice touches (group >= 4)
constexpr int kRing128 = 2;    // stages of the copy ring at 128 x 128
constexpr int kRing64 = 3;     // and at 64 x 64
constexpr int kC = 32;         // candidate slots per query
constexpr int kMark = kC / 2;  // fill mark: merge a buffer past it
constexpr int kMaxK = 128;     // longest list (4 entries a lane)
constexpr int kThreads128 = 512;  // threads of a 128 x 128 CTA
constexpr int kSmemMax = 232448;  // shared memory a CTA may opt in to
constexpr unsigned kFull = 0xffffffffu;

// copy-ring stages and threads of a CTA at tile BQ (a 3-stage ring is
// faster at 64 x 64; at 128 x 128 it does not fit beside the lists)
__host__ __device__ constexpr int stages_for(int BQ) {
  return BQ == 128 ? kRing128 : kRing64;
}
__host__ __device__ constexpr int threads_for(int BQ) {
  return BQ == 128 ? kThreads128 : 256;
}

// (d1, i1) before (d2, i2): by distance, then by id; id -1 (empty) last
__device__ __forceinline__ bool before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && (unsigned)i1 < (unsigned)i2);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? N : 0;   // 0: fill the destination with zeros
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of the latest copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one CTA, in bytes (the wrappers' launch_shape repeats
// this sum).  Stages: queries and f32 rows, or queries, int8 codes, their
// scales and one dequantized f32 slice.
template <bool kQuant>
constexpr size_t smem_bytes(int BQ, int BN, int k) {
  const int R = stages_for(BQ);
  return sizeof(float) * (R * BQ * kLd + BQ + BN) +
         (kQuant ? R * BN * kDK + sizeof(float) * (BN * kLd + R * BN * kMaxSG)
                 : sizeof(float) * R * BN * kLd) +
         (sizeof(float) + sizeof(int)) * (size_t)BQ * (k + kC) +
         sizeof(int) * (BQ + 1);
}

// (d, id) and lane ``lane ^ stride``'s: keep the one ``keep_min`` asks for
__device__ __forceinline__ void exchange(float& d, int& id, int stride,
                                         bool keep_min) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, id, stride);
  if (before(od, oi, d, id) == keep_min) {
    d = od;
    id = oi;
  }
}

// One warp, k <= 32: merge the n (<= 32) candidates cd/ci, in no order,
// into the sorted list ld/li of k.  The candidates are sorted descending
// (bitonic, in registers); lane l keeps the smaller of list entry l and
// candidate l, which leaves the 32 smallest of both as a bitonic sequence;
// five more steps sort it.
__device__ void merge_small(float* ld, int* li, int k, const float* cd,
                            const int* ci, int n, int lane) {
  static_assert(kC == 32, "one candidate a lane");
  float d = lane < n ? cd[lane] : INFINITY;
  int id = lane < n ? ci[lane] : -1;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(d, id, stride,
               ((lane & size) == 0) != ((lane & stride) == 0));
  const float md = lane < k ? ld[lane] : INFINITY;
  const int mi = lane < k ? li[lane] : -1;
  if (before(md, mi, d, id)) {
    d = md;
    id = mi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(d, id, stride, (lane & stride) == 0);
  __syncwarp();
  if (lane < k) {
    ld[lane] = d;
    li[lane] = id;
  }
  __syncwarp();
}

// One warp, any k: merge the n (<= 32) candidates cd/ci, in no order, into
// the sorted list ld/li of k, keeping the first k.  Every key is distinct (a
// row id appears once), except the list's empty tail, whose entries differ
// in index: an entry's place is its index in its own list plus the number
// of entries of the other list before it, so the places are a permutation.
// Both counts come from broadcast reads of one entry at a time, with no
// dependent chain of loads.
__device__ void merge_ranked(float* ld, int* li, int k, const float* cd,
                             const int* ci, int n, int lane) {
  constexpr int L = kMaxK / 32;     // list entries a lane
  const bool live = lane < n;
  const float d = live ? cd[lane] : INFINITY;
  const int id = live ? ci[lane] : -1;
  int place = 0;
  for (int j = 0; j < n; ++j) place += before(cd[j], ci[j], d, id);
  float vd[L];
  int vi[L], vp[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    vp[m] = k;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int a = 32 * m + j;
      if (a >= k) break;
      const float da = ld[a];
      const int ia = li[a];
      place += live && before(da, ia, d, id);
      const int ahead =
          __popc(__ballot_sync(kFull, live && before(d, id, da, ia)));
      if (j == lane) {
        vd[m] = da;
        vi[m] = ia;
        vp[m] = a + ahead;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < L; ++m)
    if (vp[m] < k) {
      ld[vp[m]] = vd[m];
      li[vp[m]] = vi[m];
    }
  if (live && place < k) {
    ld[place] = d;
    li[place] = id;
  }
  __syncwarp();
}

// whether a slice's scales are staged: the codec group is a multiple of 4
template <class Rows>
__device__ __forceinline__ bool stages_scales(const Rows& rows) {
  if constexpr (Rows::kQuant) return rows.group % 4 == 0;
  else return true;
}

template <int K>
__device__ __forceinline__ float part(const float4& v) {
  return K == 0 ? v.x : K == 1 ? v.y : K == 2 ? v.z : v.w;
}

// acc += a[:, K] b[:, K]^T, the outer product of one k of the fragments
template <int TM, int TN, int K>
__device__ __forceinline__ void outer(float (&acc)[TM][TN],
                                      const float4 (&a)[TM],
                                      const float4 (&b)[TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c)
      acc[r][c] = fmaf(part<K>(a[r]), part<K>(b[c]), acc[r][c]);
}

// Rows: kQuant, and for the quantized rows codes / scales / group, for the
// f32 rows x; see quant_topk.cu and distance_topk.cu.
// kDump: out_d is a (B, ld) distance matrix that receives every
// distance of the rows below n_valid; there are no lists (k is 0).
template <int BQ, int BN, int kVec, class Rows, bool kDump = false>
__global__ void __launch_bounds__(threads_for(BQ), 1)
topk(const float* __restrict__ q, Rows rows, float* __restrict__ part_d,
     int* __restrict__ part_i, unsigned* __restrict__ arrivals,
     float* __restrict__ out_d, int* __restrict__ out_i, int B, int D,
     int n_valid, int k, int S, long long ld) {
  constexpr bool kQuant = Rows::kQuant;
  constexpr int kThreads = threads_for(BQ);
  constexpr int kRing = stages_for(BQ);
  constexpr int kWC = kThreads / 128;        // warps across the columns
  constexpr int kCS = 8 * kWC;               // column stride of a thread
  constexpr int TM = BQ / 16, TN = BN / kCS;
  constexpr int kVecQ = kQuant ? 16 : kVec;  // quant: D % 4 == 0
  extern __shared__ __align__(16) float smem[];
  float* qa = smem;                          // [kRing][BQ][kLd] query slices
  float* xf;                                 // [BN][kLd] f32 row slice(s)
  int8_t* xc = nullptr;                      // [kRing][BN][kDK] staged codes
  float* sc = nullptr;                       // [kRing][BN][kMaxSG] scales
  float* rest;
  if constexpr (kQuant) {
    xf = qa + kRing * BQ * kLd;
    sc = xf + BN * kLd;
    xc = reinterpret_cast<int8_t*>(sc + kRing * BN * kMaxSG);
    rest = reinterpret_cast<float*>(xc + kRing * BN * kDK);
  } else {
    xf = qa + kRing * BQ * kLd;              // [kRing][BN][kLd]
    rest = xf + kRing * BN * kLd;
  }
  float* q2s = rest;                         // [BQ]
  float* x2s = q2s + BQ;                     // [BN]
  float* top_d = x2s + BN;                   // [BQ][k] sorted lists
  int* top_i = reinterpret_cast<int*>(top_d + BQ * k);
  float* cand_d = reinterpret_cast<float*>(top_i + BQ * k);  // [BQ][kC]
  int* cand_i = reinterpret_cast<int*>(cand_d + BQ * kC);
  int* cnt = cand_i + BQ * kC;               // [BQ]
  int* s_last = cnt + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // output (rb + 16 r, cb + kCS c): a warp is 4 rows x 8 columns of
  // threads (one shared-memory wavefront per fragment load), the warps
  // 4 x kWC
  const int rb = (warp & 3) * 4 + (lane >> 3);
  const int cb = (warp >> 2) * 8 + (lane & 7);
  const int q0 = blockIdx.x * BQ;
  const int s = blockIdx.y;
  const int n_tiles = (n_valid + BN - 1) / BN;
  const int per_chunk = (n_tiles + S - 1) / S;
  const int row_begin = min(n_valid, s * per_chunk * BN);
  const int row_end = min(n_valid, (s + 1) * per_chunk * BN);
  const int my_tiles = (row_end - row_begin + BN - 1) / BN;
  const int n_slices = (D + kDK - 1) / kDK;
  // the codec group is a multiple of 4: the scales of a slice are staged
  // and four codes share one (else each code reads its own, see above)
  const bool staged_scales = stages_scales(rows);

  for (int e = tid; e < BQ * k; e += kThreads) {
    top_d[e] = INFINITY;
    top_i[e] = -1;
  }
  for (int i = tid; i < BQ; i += kThreads) cnt[i] = 0;

  // ---- slice loads: slice t is (row tile t / n_slices, column slice
  // t % n_slices) of this chunk, into stage t % kRing
  auto issue = [&](int t) {
    const int n0 = row_begin + (t / n_slices) * BN;
    const int d0 = (t % n_slices) * kDK;
    const int st = t % kRing;
    constexpr int qpr = kDK * 4 / kVecQ;     // copies per query row
    for (int e = tid; e < BQ * qpr; e += kThreads) {
      const int r = e / qpr, c = (e % qpr) * (kVecQ / 4);
      const bool ok = q0 + r < B && d0 + c < D;
      cp_async<kVecQ>(qa + (st * BQ + r) * kLd + c,
                      ok ? q + (long long)(q0 + r) * D + d0 + c : q, ok);
    }
    if constexpr (kQuant) {
      constexpr int cpr = kDK / kVec;        // copies per code row
      for (int e = tid; e < BN * cpr; e += kThreads) {
        const int r = e / cpr, c = (e % cpr) * kVec;
        const bool ok = n0 + r < row_end && d0 + c < D;
        cp_async<kVec>(xc + (st * BN + r) * kDK + c,
                       ok ? rows.codes + (long long)(n0 + r) * D + d0 + c
                          : rows.codes, ok);
      }
      const int g0 = d0 / rows.group;
      const int ng = staged_scales
                         ? (min(d0 + kDK, D) - 1) / rows.group - g0 + 1
                         : 0;
      const int n_groups = rows.n_groups;
      for (int e = tid; e < BN * ng; e += kThreads) {
        const int r = e / ng, g = e % ng;
        const bool ok = n0 + r < row_end;
        cp_async<4>(sc + (st * BN + r) * kMaxSG + g,
                    ok ? rows.scales + (long long)(n0 + r) * n_groups + g0 + g
                       : rows.scales, ok);
      }
    } else {
      constexpr int xpr = kDK * 4 / kVec;    // copies per f32 row
      for (int e = tid; e < BN * xpr; e += kThreads) {
        const int r = e / xpr, c = (e % xpr) * (kVec / 4);
        const bool ok = n0 + r < row_end && d0 + c < D;
        cp_async<kVec>(xf + (st * BN + r) * kLd + c,
                       ok ? rows.x + (long long)(n0 + r) * D + d0 + c
                          : rows.x, ok);
      }
    }
    cp_commit();
  };

  // x2 and q2: thread owns rows xr + kRows m and columns 4 xc4 .. 4 xc4 + 3
  // of a slice (q2 from the query slices of the chunk's first tile)
  constexpr int kCG = kDK / 4, kRows = kThreads / kCG;
  constexpr int XR = BN / kRows, QR = BQ / kRows;
  const int xc4 = tid % kCG, xr = tid / kCG;
  float x2p[XR], q2p[QR];
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < XR; ++m) x2p[m] = 0.f;
#pragma unroll
  for (int m = 0; m < QR; ++m) q2p[m] = 0.f;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  constexpr int kW = kThreads / 32;
  // merge query i's cnt[i] candidates into its list, and zero cnt[i] (one
  // warp)
  auto merge_one = [&](int i) {
    const int n = min(cnt[i], kC);
    if (k <= 32)
      merge_small(top_d + i * k, top_i + i * k, k, cand_d + i * kC,
                  cand_i + i * kC, n, lane);
    else
      merge_ranked(top_d + i * k, top_i + i * k, k, cand_d + i * kC,
                   cand_i + i * kC, n, lane);
    if (lane == 0) cnt[i] = 0;
    __syncwarp();
  };
  // merge every query of this warp (warp + kW m) whose buffer holds at
  // least ``mark`` candidates
  auto merge_full = [&](int mark) {
    for (int i = warp; i < BQ; i += kW)
      if (min(cnt[i], kC) >= max(mark, 1)) merge_one(i);
  };

  const int total = my_tiles * n_slices;
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t)
    if (t < total) issue(t);
    else cp_commit();
  __syncthreads();   // lists, counts

  for (int t = 0; t < total; ++t) {
    const int st = t % kRing, sl = t % n_slices;
    const int n0 = row_begin + (t / n_slices) * BN;
    cp_wait<kRing - 2>();
    __syncthreads();   // slice t landed; slice t - 1's readers are done
    if (t + kRing - 1 < total) issue(t + kRing - 1);
    else cp_commit();   // an empty group keeps the count of the wait
    const float* xs;
    if constexpr (kQuant) {
      const int d0 = sl * kDK, c = 4 * xc4;
      const int gl = (d0 + c) / rows.group - d0 / rows.group;
#pragma unroll
      for (int m = 0; m < XR; ++m) {
        const int j = xr + kRows * m;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d0 + c < D) {
          const char4 b =
              *reinterpret_cast<const char4*>(xc + (st * BN + j) * kDK + c);
          if (staged_scales) {
            const float scale = sc[(st * BN + j) * kMaxSG + gl];
            v = make_float4((float)b.x * scale, (float)b.y * scale,
                            (float)b.z * scale, (float)b.w * scale);
          } else if (n0 + j < row_end) {
            // each code its own scale; columns past the row's groups are
            // the wrapper's zero padding (code 0), given the last scale
            const float* srow =
                rows.scales + (long long)(n0 + j) * rows.n_groups;
            const int last = rows.n_groups - 1;
            const int c0 = d0 + c;
            v = make_float4(
                (float)b.x * __ldg(srow + min(c0 / rows.group, last)),
                (float)b.y * __ldg(srow + min((c0 + 1) / rows.group, last)),
                (float)b.z * __ldg(srow + min((c0 + 2) / rows.group, last)),
                (float)b.w * __ldg(srow + min((c0 + 3) / rows.group, last)));
          }
        }
        *reinterpret_cast<float4*>(xf + j * kLd + c) = v;
        x2p[m] = fmaf(v.x, v.x, x2p[m]);
        x2p[m] = fmaf(v.y, v.y, x2p[m]);
        x2p[m] = fmaf(v.z, v.z, x2p[m]);
        x2p[m] = fmaf(v.w, v.w, x2p[m]);
      }
      xs = xf;
      __syncthreads();
    } else {
      xs = xf + st * BN * kLd;
#pragma unroll
      for (int m = 0; m < XR; ++m) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + (xr + kRows * m) * kLd +
                                             4 * xc4);
        x2p[m] = fmaf(v.x, v.x, x2p[m]);
        x2p[m] = fmaf(v.y, v.y, x2p[m]);
        x2p[m] = fmaf(v.z, v.z, x2p[m]);
        x2p[m] = fmaf(v.w, v.w, x2p[m]);
      }
    }
    const float* as = qa + st * BQ * kLd;
    if (t < n_slices)
#pragma unroll
      for (int m = 0; m < QR; ++m) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + (xr + kRows * m) * kLd +
                                             4 * xc4);
        q2p[m] = fmaf(v.x, v.x, q2p[m]);
        q2p[m] = fmaf(v.y, v.y, q2p[m]);
        q2p[m] = fmaf(v.z, v.z, q2p[m]);
        q2p[m] = fmaf(v.w, v.w, q2p[m]);
      }
#pragma unroll
    for (int k4 = 0; k4 < kDK; k4 += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        a[r] = *reinterpret_cast<const float4*>(as + (rb + 16 * r) * kLd +
                                                k4);
#pragma unroll
      for (int c = 0; c < TN; ++c)
        b[c] = *reinterpret_cast<const float4*>(xs + (cb + kCS * c) * kLd +
                                                k4);
      // one k at a time: TM x TN independent FMAs between two that share
      // an accumulator
      outer<TM, TN, 0>(acc, a, b);
      outer<TM, TN, 1>(acc, a, b);
      outer<TM, TN, 2>(acc, a, b);
      outer<TM, TN, 3>(acc, a, b);
    }
    if (sl != n_slices - 1) continue;

    // ---- the tile is done: x2, distances, filter, candidates
#pragma unroll
    for (int m = 0; m < XR; ++m) {
      float v = x2p[m];
#pragma unroll
      for (int o = 1; o < kCG; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
      if (xc4 == 0) x2s[xr + kRows * m] = v;
      x2p[m] = 0.f;
    }
    if (t < n_slices)
#pragma unroll
      for (int m = 0; m < QR; ++m) {
        float v = q2p[m];
#pragma unroll
        for (int o = 1; o < kCG; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        if (xc4 == 0) q2s[xr + kRows * m] = v;
      }
    __syncthreads();
    if constexpr (kDump) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int i = rb + 16 * r, j = cb + kCS * c;
          if (q0 + i < B && n0 + j < row_end)
            out_d[(long long)(q0 + i) * ld + n0 + j] =
                (q2s[i] - 2.f * acc[r][c]) + x2s[j];
          acc[r][c] = 0.f;
        }
      continue;
    }
    uint64_t pending = 0;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int i = rb + 16 * r, j = cb + kCS * c;
        acc[r][c] = (q2s[i] - 2.f * acc[r][c]) + x2s[j];
        if (q0 + i < B && n0 + j < row_end)
          pending |= 1ull << (r * TN + c);
      }
    for (;;) {
      bool crossed = false;
      // the 8 threads of a query row in a warp take their slots with one
      // atomicAdd: a scan of their survivor counts
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = rb + 16 * r;
        const float wd = top_d[i * k + k - 1];
        const int wi = top_i[i * k + k - 1];
        unsigned pass = 0;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const uint64_t bit = 1ull << (r * TN + c);
          if (!(pending & bit)) continue;
          if (before(acc[r][c], n0 + cb + kCS * c, wd, wi)) pass |= 1u << c;
          else pending &= ~bit;
        }
        if (!__any_sync(kFull, pass)) continue;   // most, past a few tiles
        const int mine = __popc(pass);
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o, 8);
          if ((lane & 7) >= o) incl += v;
        }
        int base = 0;
        if ((lane & 7) == 7 && incl) {
          base = atomicAdd(cnt + i, incl);
          crossed |= base + incl >= kMark;
        }
        int slot = __shfl_sync(kFull, base, 7, 8) + incl - mine;
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (pass & (1u << c)) {
            if (slot < kC) {
              cand_d[i * kC + slot] = acc[r][c];
              cand_i[i * kC + slot] = n0 + cb + kCS * c;
              pending &= ~(1ull << (r * TN + c));
            }
            ++slot;
          }
      }
      // a buffer past its fill mark (every overflow is one) is merged;
      // most tiles have none, and pay one barrier
      if (!__syncthreads_or(crossed)) break;
      merge_full(kMark);
      if (!__syncthreads_or(pending != 0)) break;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  }
  if constexpr (kDump) return;
  merge_full(1);
  __syncthreads();

  // ---- the merge across chunks, in the last CTA of this query tile
  if (S > 1) {
    for (int e = tid; e < BQ * k; e += kThreads) {
      const int i = e / k, p = e % k;
      if (q0 + i < B) {
        const long long o = ((long long)(q0 + i) * S + s) * k + p;
        part_d[o] = top_d[e];
        part_i[o] = top_i[e];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      *s_last = atomicAdd(arrivals + blockIdx.x, 1u) == (unsigned)(S - 1);
    __syncthreads();
    if (!*s_last) return;
    __threadfence();
    if (tid == 0) arrivals[blockIdx.x] = 0u;   // ready for the next launch
    // the other chunks' lists, a group of queries at a time, are copied
    // by all threads into the slice buffers (free now); then each warp
    // streams its queries' entries through the filter into the query's
    // candidate buffer, merging it whenever it would overflow
    const int len = S * k, nq = min(BQ, B - q0);
    const int cap = (int)((reinterpret_cast<char*>(rest) -
                           reinterpret_cast<char*>(smem)) / 8);
    const bool staged = len <= cap;        // else read them where they lie
    const int G = staged ? min(nq, cap / len) : nq;
    float* sd = smem;                      // [G][S][k]
    int* si = reinterpret_cast<int*>(smem + cap);
    for (int g0 = 0; g0 < nq; g0 += G) {
      const int tot = min(G, nq - g0) * len;
      const long long gbase = (long long)(q0 + g0) * len;
      if (staged) {   // every copy in flight at once
        for (int e = tid; e < tot; e += kThreads) {
          cp_async<4>(sd + e, part_d + gbase + e, true);
          cp_async<4>(si + e, part_i + gbase + e, true);
        }
        cp_commit();
        cp_wait<0>();
        __syncthreads();
      }
      for (int ii = warp; ii < tot / len; ii += kW) {
        const int i = g0 + ii;
        int n = 0;                         // this query's candidates
        for (int e0 = 0; e0 < len; e0 += 32) {
          const int e = e0 + lane;
          const long long o = (long long)ii * len + e;
          const bool in = e < len && e / k != s;
          const float d = !in ? INFINITY
                        : staged ? sd[o] : __ldcg(part_d + gbase + o);
          const int id = !in ? -1
                       : staged ? si[o] : __ldcg(part_i + gbase + o);
          bool pass = id >= 0 && before(d, id, top_d[i * k + k - 1],
                                        top_i[i * k + k - 1]);
          unsigned m = __ballot_sync(kFull, pass);
          if (n + __popc(m) > kC) {
            cnt[i] = n;                    // one warp owns query i here
            __syncwarp();
            merge_one(i);
            n = 0;
            pass = pass && before(d, id, top_d[i * k + k - 1],
                                  top_i[i * k + k - 1]);
            m = __ballot_sync(kFull, pass);
          }
          if (pass) {
            const int slot = n + __popc(m & ((1u << lane) - 1u));
            cand_d[i * kC + slot] = d;
            cand_i[i * kC + slot] = id;
          }
          n += __popc(m);
          __syncwarp();
        }
        if (n) {
          cnt[i] = n;
          __syncwarp();
          merge_one(i);
        }
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < BQ * k; e += kThreads) {
    const int i = e / k;
    if (q0 + i < B) {
      out_d[(long long)q0 * k + e] = top_d[e];
      out_i[(long long)q0 * k + e] = top_i[e];
    }
  }
}

// One launch on ``st`` for the tile (64 or 128) and copy width (16, 8 or 4
// bytes) the wrapper chose; returns cudaGetLastError().
template <class Rows, int BQ, int kVec, bool kDump = false>
int launch_tile(const float* q, Rows rows, float* part_d, int* part_i,
                unsigned* arrivals, float* out_d, int* out_i, int B, int D,
                int n_valid, int k, int S, cudaStream_t st,
                long long ld = 0) {
  const size_t smem = smem_bytes<Rows::kQuant>(BQ, BQ, k);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto* fn = &topk<BQ, BQ, kVec, Rows, kDump>;
  // the opt-in to the full 227 KB, once per device: setting it before every
  // launch waits for the kernels in flight
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted |= 1ull << dev;
  }
  dim3 grid((B + BQ - 1) / BQ, S);
  fn<<<grid, threads_for(BQ), smem, st>>>(q, rows, part_d, part_i, arrivals,
                                          out_d, out_i, B, D, n_valid, k, S,
                                          ld);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch(const float* q, Rows rows, float* part_d, int* part_i,
           unsigned* arrivals, float* out_d, int* out_i, int B, int D,
           int n_valid, int k, int S, int tile, int vec, cudaStream_t st) {
  if (B <= 0) return 0;
  if (D <= 0 || k <= 0 || k > kMaxK || S <= 0 || S > 65535 || n_valid < 0)
    return (int)cudaErrorInvalidValue;
#define TOPK_TILE_LAUNCH(BQ, V)                                             \
  if (tile == BQ && vec == V)                                               \
    return launch_tile<Rows, BQ, V>(q, rows, part_d, part_i, arrivals,      \
                                    out_d, out_i, B, D, n_valid, k, S, st);
  TOPK_TILE_LAUNCH(128, 16)
  TOPK_TILE_LAUNCH(128, 8)
  TOPK_TILE_LAUNCH(128, 4)
  TOPK_TILE_LAUNCH(64, 16)
  TOPK_TILE_LAUNCH(64, 8)
  TOPK_TILE_LAUNCH(64, 4)
#undef TOPK_TILE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The large-k route's product: every distance of the rows below n_valid
// into dist (B, ld), at the 128 x 128 tile, S chunks of rows.
template <class Rows>
int launch_distances(const float* q, Rows rows, float* dist, long long ld,
                     int B, int D, int n_valid, int S, int vec,
                     cudaStream_t st) {
  if (B <= 0 || n_valid <= 0) return 0;
  if (D <= 0 || S <= 0 || S > 65535 || ld < n_valid)
    return (int)cudaErrorInvalidValue;
#define TOPK_DIST_LAUNCH(V)                                                 \
  if (vec == V)                                                             \
    return launch_tile<Rows, 128, V, true>(q, rows, nullptr, nullptr,       \
                                           nullptr, dist, nullptr, B, D,    \
                                           n_valid, 0, S, st, ld);
  TOPK_DIST_LAUNCH(16)
  TOPK_DIST_LAUNCH(8)
  TOPK_DIST_LAUNCH(4)
#undef TOPK_DIST_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace topk_tile
}  // namespace
