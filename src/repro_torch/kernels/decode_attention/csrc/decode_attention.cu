// GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:77
// decode_attention_pallas (body _kernel).  One new query token per
// sequence against its KV cache: out[b, h] is the softmax over the first
// pos[b] cache entries of (q[b, h] . k[b, s, h / G]) * hd^-0.5, applied to
// v[b, s, h / G], for H = K * G query heads over K kv heads.  Scores,
// softmax and the accumulator are f32; the output has q's dtype (f32 or
// bf16, the same as the cache's).
//
// Bound: bytes.  Every valid K and V row (hd elements of the cache dtype
// per (b, s, kv head), up to pos) is read once, and q and out are small.
// The arithmetic is about 4 * G flops per cache element (G = 4 for the
// GQA models), far below the ~295 flops per byte at which the card's
// compute, not its memory, would be the limit.  So the design is about
// streaming the cache at full bandwidth and reading it once.
//
// Design.  The TPU kernel walks one sequence's cache blocks in order on
// one core, carrying (max, sum, acc) in scratch across the grid.  Hopper's
// blocks run in parallel and in no order, so this is flash-decoding in two
// passes.
//   Pass 1, grid (B * K) x n_split.  Each CTA takes one (sequence, kv
//   head) and one contiguous range of the cache.  It loads its group's G
//   query rows once, so every K/V row it reads serves all G heads, and
//   streams its range in tiles of 64 keys with 16-byte loads: a score
//   phase (one half-warp per key, dot products reduced by shuffles), an
//   online-softmax update per query row, and a P.V phase (each thread owns
//   one 16-byte column chunk of V over a strided subset of the tile's
//   keys).  Tiles and whole ranges at or past pos are never read, as the
//   Pallas kernel skips the blocks past pos.  It writes its partial
//   (m, l, acc[G, hd]) in f32.
//   Pass 2, grid B * H.  It combines the n_split partials of each query
//   row, each rescaled by exp(m_i - max m), and divides by max(l, 1e-30).
// The wrapper picks n_split so that the CTAs fill the card even when B * K
// is small (64 pairs at batch 8 for 132 SMs).  Every reduction runs in a
// fixed order, so the result is the same from run to run.
//
// pos = 0 (every entry masked) gives l = 0 and a zero row, as the Pallas
// kernel gives (its oracle returns the mean of v there).  A pos above S is
// read as S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // keys per tile: two per lane in the softmax
constexpr int kLanesPerKey = 16;     // score phase: a half-warp per key
constexpr int kKeySlots = kThreads / kLanesPerKey;  // keys scored at once
constexpr float kNeg = -1e30f;       // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T, read through the read-only path, as floats
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Pass 1: one (sequence, kv head, cache range) per CTA.  GM is G rounded
// up to a power of two (the size of the per-thread accumulators).
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int K, int G, int hd, int split_len, float scale) {
  constexpr int VN = Vec16<T>::N;
  extern __shared__ float smem[];
  float* qs = smem;                // [G][hd] the group's query rows
  float* ps = qs + G * hd;         // [G][kTile] scores, then probabilities
  float* acc_s = ps + G * kTile;   // [G][hd] the CTA's summed accumulator
  float* m_s = acc_s + G * hd;     // [G] running max
  float* l_s = m_s + GM;           // [G] running sum
  float* corr_s = l_s + GM;        // [G] this tile's rescale

  const int tid = threadIdx.x;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int H = K * G;
  const int n_valid = min(max(pos[b], 0), S);
  const int s_begin = blockIdx.y * split_len;
  const int s_end = min(s_begin + split_len, n_valid);
  const int nvec = hd / VN;        // 16-byte chunks per row

  const T* qb = q + ((long long)b * H + (long long)kh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = to_float(qb[i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const long long row = (long long)K * hd;  // elements from key s to s + 1
  const T* kb = k + (long long)b * S * row + (long long)kh * hd;
  const T* vb = v + (long long)b * S * row + (long long)kh * hd;

  // score phase: lane16 of the half-warp at `slot` scores keys slot,
  // slot + kKeySlots, ... of the tile
  const int lane16 = tid % kLanesPerKey, slot = tid / kLanesPerKey;
  // P.V phase: column chunk c of keys kg, kg + kgroups, ... of the tile
  const int kgroups = kThreads / nvec;
  const int c = tid % nvec, kg = tid / nvec;
  const bool pv_active = kg < kgroups;
  float acc[GM][VN];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    // scores of the tile's keys, masked past pos
#pragma unroll 2
    for (int tt = slot; tt < kTile; tt += kKeySlots) {
      const int s = t0 + tt;
      const bool live = s < s_end;
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
      if (live) {
        for (int cc = lane16; cc < nvec; cc += kLanesPerKey) {
          float kv[VN];
          Vec16<T>::load(kb + s * row + cc * VN, kv);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float* qg = qs + g * hd + cc * VN;
#pragma unroll
              for (int e = 0; e < VN; ++e) dot[g] = fmaf(qg[e], kv[e], dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      }
      if (lane16 == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) ps[g * kTile + tt] = live ? dot[g] * scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * kTile;
      const float x0 = pg[lane], x1 = pg[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      pg[lane] = p0;
      pg[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V over the tile
    if (pv_active) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float cr = corr_s[g];
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[g][e] *= cr;
        }
      }
#pragma unroll 4
      for (int tt = kg; tt < kTile; tt += kgroups) {
        const int s = t0 + tt;
        if (s < s_end) {
          float vv[VN];
          Vec16<T>::load(vb + s * row + c * VN, vv);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float p = ps[g * kTile + tt];
#pragma unroll
              for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the key groups' accumulators, one group at a time (a fixed order)
  for (int r = 0; r < kgroups; ++r) {
    if (kg == r) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VN; ++e) acc_s[g * hd + c * VN + e] += acc[g][e];
        }
      }
    }
    __syncthreads();
  }

  const long long n_split = gridDim.y;
  const long long row0 = (long long)b * H + (long long)kh * G;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    part_acc[((row0 + g) * n_split + blockIdx.y) * hd + (i - g * hd)] =
        acc_s[i];
  }
  if (tid < G) {
    float* ml = part_ml + ((row0 + tid) * n_split + blockIdx.y) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// Pass 2: one query row per CTA, the n_split partials combined in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_split, int hd) {
  const long long qrow = blockIdx.x;
  const float* ml = part_ml + qrow * n_split * 2;
  float m = kNeg;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < n_split; ++i) l += expf(ml[2 * i] - m) * ml[2 * i + 1];
  const float denom = fmaxf(l, 1e-30f);
  const float* acc = part_acc + qrow * n_split * hd;
  for (int e = threadIdx.x; e < hd; e += kThreads) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i)
      a += expf(ml[2 * i] - m) * acc[(long long)i * hd + e];
    out[qrow * hd + e] = from_float<T>(a / denom);
  }
}

template <typename T, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, float* part_ml, float* part_acc, void* out,
                   int B, int S, int K, int G, int hd, int n_split,
                   int split_len, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));
  // at most 2 * 16 * 256 + 16 * 64 + 48 floats (37 KB): under the 48 KB
  // a launch may ask for without opting in
  const size_t smem = (size_t)(2 * G * hd + G * kTile + 3 * GM) * sizeof(float);
  decode_split_kernel<T, GM>
      <<<dim3((unsigned)(B * K), (unsigned)n_split), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pos, part_ml, part_acc, S, K, G, hd,
          split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<(unsigned)(B * K * G), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), n_split, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* pos, float* part_ml, float* part_acc,
                     void* out, int B, int S, int K, int G, int hd,
                     int n_split, int split_len, cudaStream_t stream) {
  if (G <= 1)
    return launch<T, 1>(q, k, v, pos, part_ml, part_acc, out, B, S, K, G, hd,
                        n_split, split_len, stream);
  if (G <= 2)
    return launch<T, 2>(q, k, v, pos, part_ml, part_acc, out, B, S, K, G, hd,
                        n_split, split_len, stream);
  if (G <= 4)
    return launch<T, 4>(q, k, v, pos, part_ml, part_acc, out, B, S, K, G, hd,
                        n_split, split_len, stream);
  if (G <= 8)
    return launch<T, 8>(q, k, v, pos, part_ml, part_acc, out, B, S, K, G, hd,
                        n_split, split_len, stream);
  return launch<T, 16>(q, k, v, pos, part_ml, part_acc, out, B, S, K, G, hd,
                       n_split, split_len, stream);
}

}  // namespace

// q (B, K * G, hd), k/v (B, S, K, hd) contiguous, 16-byte aligned, of one
// dtype (bf16 != 0: bf16, else f32); pos (B,) int32.  part_ml
// (B * K * G, n_split, 2) and part_acc (B * K * G, n_split, hd) f32 scratch;
// out like q.  split_len is a multiple of the 64-key tile and n_split *
// split_len >= S.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* part_ml, void* part_acc,
                                       void* out, int B, int S, int K, int G,
                                       int hd, int n_split, int split_len,
                                       int bf16, void* stream) {
  if (B <= 0) return 0;
  if (hd <= 0 || hd % 8 || hd > 256 || G < 1 || G > 16 || S < 1 ||
      n_split < 1 || split_len % kTile || (long long)n_split * split_len < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaError_t err =
      bf16 ? launch_g<__nv_bfloat16>(q, k, v, p, ml, acc, out, B, S, K, G, hd,
                                     n_split, split_len, s)
           : launch_g<float>(q, k, v, p, ml, acc, out, B, S, K, G, hd,
                             n_split, split_len, s);
  return (int)err;
}
