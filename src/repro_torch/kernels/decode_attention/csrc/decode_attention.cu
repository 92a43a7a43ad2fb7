// GQA flash-decode attention for Hopper (sm_90a): one launch per call.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:77
// decode_attention_pallas (body _kernel; pallas_call at :85).  One new
// query token per sequence against its KV cache: out[b, h] is the softmax
// over the first pos[b] cache entries of (q[b, h] . k[b, s, h / G]) *
// hd^-0.5, applied to v[b, s, h / G], for H = K * G query heads over K kv
// heads.  Scores, softmax and the accumulator are f32 (f32 FMAs); the
// output has q's dtype (f32 or bf16, the same as the cache's).
//
// Bound: bytes.  Every valid K and V row (hd elements of the cache dtype
// per (b, s, kv head), up to pos) is read once, and q and out are small.
// The arithmetic is about 4 * G flops per cache element (G = 4 for the
// GQA models), far below the ~295 flops per byte at which the card's
// compute, not its memory, would be the limit.  So the design is about
// keeping K and V bytes in flight without pause, reading whole cache rows
// together, and the fixed cost of a launch at short caches.
//
// Design (flash-decoding without barriers in the loop, one launch).
//   - The grid is (sequence x group of kv heads) x n_split ranges of the
//     cache.  Warp w of a CTA serves kv head w / wph of its group, and the
//     head's wph warps take turns over the range's steps.  With wph = 1 a
//     CTA's 8 warps stream 8 neighbouring heads of the same keys, so
//     together they read whole 2 KB cache rows (qwen3-8b: 8 heads of 256
//     bytes); with wph = 8 all warps share one head, for short caches.
//   - Inside a warp, a group of `lpk` lanes (hd / 8 rounded up to a power
//     of two) takes one key at a time, each lane 8 columns: one 16-byte
//     chunk of a bf16 row, two of an f32 row.  Each lane holds its columns
//     of the G query rows (scaled by hd^-0.5 * log2 e, so the softmax runs
//     in exp2), its own running max and sum per query row, and its columns
//     of the G accumulators, all in registers: every K/V row read serves
//     all G heads.
//   - K and V of U keys per lane group come through a two-stage cp.async
//     ring in shared memory: step i + 1's copies are in flight while step
//     i is scored.  Each lane copies and reads back only its own chunks, so
//     no barrier and no mbarrier guards the ring.  Per step the lane group
//     reduces U x G dot products with shuffles, updates its softmax state
//     once, and accumulates V.
//   - After the loop the lane groups merge by shuffles (a fixed tree), a
//     head's wph warps merge in shared memory in warp order, and the CTA
//     writes each head's partial (m, l, acc[G, hd]) of its range in f32.
//   - The combine is folded into the launch: each CTA fences its partials
//     and takes a ticket from its (sequence, head group) arrival counter;
//     the last CTA to arrive combines the live splits in split-index order
//     (so the bits do not depend on which CTA came last), writes the
//     output rows and resets the counter to 0 for the next launch.  The
//     counters live with the wrapper, zeroed once; there is no second
//     launch and no memset per call.
// Splits and keys at or past pos are never read (the Pallas kernel skips
// the blocks past pos); a CTA whose whole range is past pos only takes
// its ticket.  Every reduction runs in a fixed order, so a call gives the
// same bits every time.
//
// pos = 0 (every entry masked) gives l = 0 and a zero row, as the Pallas
// kernel gives (its oracle returns the mean of v there).  A pos above S is
// read as S.
//
// Partial mode (lse != null), for a cache sharded by sequence over
// ranks: the combine writes each row in f32 (out is then float) and its
// log-sum-exp ln(l) + m ln 2 (natural units; -inf where l = 0) to
// lse[b, h], so that the ranks' rows merge by exp(lse - max lse)
// weights.  The per-split (m, l) it already keeps are all it needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kStages = 2;           // cp.async ring: one step in flight ahead
constexpr int kSplitTile = 64;       // split ranges are whole 64-key tiles
constexpr float kNeg = -1e30f;       // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 8 consecutive elements of T: one lane's columns of a row, as raw
// registers (from global memory, or from the lane's chunks in the ring)
// and as f32 values.
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> {
  struct Raw { uint4 a; };
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  }
  // one 16-byte chunk
  __device__ __forceinline__ static Raw from_chunks(const uint4* c) {
    return {*c};
  }
  __device__ __forceinline__ static void to_float(const Raw& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};
template <> struct Row8<float> {
  struct Raw { float4 a, b; };
  __device__ __forceinline__ static Raw load(const float* p) {
    const float4* v = reinterpret_cast<const float4*>(p);
    return {__ldg(v), __ldg(v + 1)};
  }
  // two 16-byte chunks, a thread-stride apart
  __device__ __forceinline__ static Raw from_chunks(const uint4* c) {
    return {*reinterpret_cast<const float4*>(c),
            *reinterpret_cast<const float4*>(c + blockDim.x)};
  }
  __device__ __forceinline__ static void to_float(const Raw& r, float* out) {
    out[0] = r.a.x; out[1] = r.a.y; out[2] = r.a.z; out[3] = r.a.w;
    out[4] = r.b.x; out[5] = r.b.y; out[6] = r.b.z; out[7] = r.b.w;
  }
  __device__ __forceinline__ static void store(float* p, float x) { *p = x; }
};

// keys a lane group takes per step: fewer as the G accumulators grow
template <int GM> constexpr int kUnroll = GM <= 4 ? 4 : (GM == 8 ? 2 : 1);

// 16 bytes from global to shared memory, asynchronously (zeros when
// src_bytes is 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of dynamic shared memory a launch needs: the ring, the warps'
// merge buffer (wph > 1) and the combine's weights, which reuse it.
template <typename T, int GM>
size_t smem_bytes(int warps, int wph, int G, int hd, int n_split) {
  const size_t ring =
      (size_t)kStages * kUnroll<GM> * 2 * (sizeof(T) / 2) * warps * 32 * 16;
  const size_t merge =
      wph > 1 ? (size_t)warps * G * (hd + 2) * sizeof(float) : 0;
  const size_t weights =
      (size_t)(warps / wph) * G * (n_split + 1) * sizeof(float);
  size_t out = ring > merge ? ring : merge;
  return out > weights ? out : weights;
}

// CTA (sequence, group of W / wph kv heads, cache range): warp w serves kv
// head w / wph of the group, and the head's wph warps take turns over its
// range.  GM is G rounded up to a power of two (the size of the per-lane
// state).
template <typename T, int GM>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc,
                        unsigned* __restrict__ arrivals, T* __restrict__ out,
                        float* __restrict__ lse, int S, int K, int G, int hd,
                        int lpk, int split_len, int wph, float qscale) {
  constexpr int U = kUnroll<GM>;
  constexpr int CH = sizeof(T) / 2;     // 16-byte chunks of a lane's 8 columns
  using R = Row8<T>;
  extern __shared__ uint4 smem4[];      // the ring: [kStages][U][K, V][CH][threads]
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_last;

  const int nt = blockDim.x, W = nt >> 5, hw = W / wph;   // heads per CTA
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hs = warp / wph, sub = warp % wph;
  const int groups = (K + hw - 1) / hw;   // CTAs per sequence and range
  const int b = blockIdx.x / groups, kh0 = (blockIdx.x % groups) * hw;
  const int kh = kh0 + hs;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int H = K * G;
  const int n_valid = min(max(pos[b], 0), S);
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, n_valid);
  const int kpw = 32 / lpk;                 // keys a warp takes per step
  const int grp = lane / lpk, c = lane % lpk;
  const bool col_live = c * 8 < hd;

  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  if (kh < K && s_begin < s_end) {
    const long long row = (long long)K * hd;  // elements from key s to s + 1
    const long long base = (long long)b * S * row + (long long)kh * hd + c * 8;
    const T* kb = k + base;
    const T* vb = v + base;

    float qr[GM][8];
    const T* qb = q + ((long long)b * H + (long long)kh * G) * hd + c * 8;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G && col_live) {
        R::to_float(R::load(qb + (long long)g * hd), qr[g]);
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][e] *= qscale;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
      }
    }
    // the head's wph warps take turns over steps of `step` keys: this
    // warp's step i covers keys s_begin + (i * wph + sub) * step + [0,
    // step), key u * kpw + grp of it for this lane's group
    const int step = U * kpw;
    const int len = s_end - s_begin - sub * step;
    const int n_steps = len > 0 ? (len + wph * step - 1) / (wph * step) : 0;
    auto chunk = [&](int slot, int u, int kv, int ch) {
      return smem4 + (((slot * U + u) * 2 + kv) * CH + ch) * nt + threadIdx.x;
    };
    // step i's copies into slot i % kStages as one group (an empty group
    // past the last step, so that the groups stay kStages - 1 ahead); keys
    // past the range and idle columns are zero-filled, not read.  Each
    // lane reads back only what it copied, so no barrier guards a slot.
    auto issue = [&](int i) {
      if (i < n_steps) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = s_begin + (i * wph + sub) * step + u * kpw + grp;
          const bool ld = s < s_end && col_live;
          const long long off = ld ? s * row : 0;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            cp_async16(chunk(i % kStages, u, 0, ch), kb + off + ch * (8 / CH),
                       ld ? 16 : 0);
            cp_async16(chunk(i % kStages, u, 1, ch), vb + off + ch * (8 / CH),
                       ld ? 16 : 0);
          }
        }
      }
      cp_async_commit();
    };
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < n_steps; ++i) {
      const int s0 = s_begin + (i * wph + sub) * step;
      issue(i + kStages - 1);
      cp_async_wait<kStages - 1>();
      typename R::Raw kr[U], vr[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        live[u] = s0 + u * kpw + grp < s_end;
        kr[u] = R::from_chunks(chunk(i % kStages, u, 0, 0));
        vr[u] = R::from_chunks(chunk(i % kStages, u, 1, 0));
      }
      float sc[U][GM];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        R::to_float(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
          sc[u][g] = d;
        }
      }
      for (int off = lpk >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) mx = fmaxf(mx, sc[u][g]);
        const float corr = exp2f(m[g] - mx);
        m[g] = mx;
        float sum = l[g] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u][g] = live[u] ? exp2f(sc[u][g] - mx) : 0.f;
          sum += sc[u][g];
        }
        l[g] = sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        R::to_float(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(sc[u][g], vf[e], acc[g][e]);
        }
      }
    }
    cp_async_wait<0>();

    // merge the warp's lane groups (a fixed tree): lanes of group 0 then
    // hold the warp's state
    for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float a = exp2f(m[g] - mx), bo = exp2f(mo - mx);
        m[g] = mx;
        l[g] = l[g] * a + lo * bo;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * a + ao * bo;
        }
      }
    }
  }

  // this split's partial (m, l, acc) per head: straight from the registers
  // when one warp took the head, else the head's warps merged from shared
  // memory in warp order by the whole CTA
  const bool live_range = s_begin < s_end;
  if (wph == 1) {
    if (kh < K && live_range) {
      const long long slot = ((long long)b * K + kh) * n_split + split;
      if (grp == 0 && col_live) {
        float* pacc = part_acc + slot * G * hd + c * 8;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            float4* dst = reinterpret_cast<float4*>(pacc + g * hd);
            dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
            dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
          }
        }
      }
      if (lane == 0) {
        float* pml = part_ml + slot * G * 2;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            pml[2 * g] = m[g];
            pml[2 * g + 1] = l[g];
          }
        }
      }
    }
  } else if (live_range) {
    float* s_acc = smem;                   // [W][G][hd]
    float* s_m = s_acc + W * G * hd;       // [W][G]
    float* s_l = s_m + W * G;              // [W][G]
    __syncthreads();                       // every warp is done with the ring
    if (grp == 0 && col_live) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float4* dst = reinterpret_cast<float4*>(s_acc + (warp * G + g) * hd + c * 8);
          dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
          dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          s_m[warp * G + g] = m[g];
          s_l[warp * G + g] = l[g];
        }
      }
    }
    __syncthreads();
    const int n_heads = min(hw, K - kh0);
    for (int i = threadIdx.x; i < n_heads * G * hd; i += nt) {
      const int h = i / (G * hd), r = i - h * G * hd, g = r / hd;
      const int w0 = h * wph;
      float mx = kNeg;
      for (int w = w0; w < w0 + wph; ++w) mx = fmaxf(mx, s_m[w * G + g]);
      float a = 0.f;
      for (int w = w0; w < w0 + wph; ++w)
        a += exp2f(s_m[w * G + g] - mx) * s_acc[w * G * hd + r];
      const long long slot = ((long long)b * K + kh0 + h) * n_split + split;
      part_acc[slot * G * hd + r] = a;
    }
    for (int i = threadIdx.x; i < n_heads * G; i += nt) {
      const int h = i / G, g = i - h * G, w0 = h * wph;
      float mx = kNeg;
      for (int w = w0; w < w0 + wph; ++w) mx = fmaxf(mx, s_m[w * G + g]);
      float sum = 0.f;
      for (int w = w0; w < w0 + wph; ++w)
        sum += exp2f(s_m[w * G + g] - mx) * s_l[w * G + g];
      const long long slot = ((long long)b * K + kh0 + h) * n_split + split;
      part_ml[(slot * G + g) * 2] = mx;
      part_ml[(slot * G + g) * 2 + 1] = sum;
    }
  }

  // arrival: the last CTA of this (sequence, head group) combines
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(arrivals + blockIdx.x, 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) arrivals[blockIdx.x] = 0u;   // ready for the next launch

  // the combine over the live splits, in split-index order: first each
  // (head, query row)'s weights exp2(m_j - max m) and sum, then the rows
  const int n_live = (n_valid + split_len - 1) / split_len;
  const int n_heads = min(hw, K - kh0);
  float* s_w = smem;                         // [n_heads * G][n_live + 1]
  for (int t = threadIdx.x; t < n_heads * G; t += nt) {
    const int h = t / G, g = t - h * G;
    const float* ml = part_ml + ((long long)(b * K + kh0 + h) * n_split * G + g) * 2;
    float mx = kNeg;
    for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, __ldcg(ml + j * G * 2));
    float sum = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float w = exp2f(__ldcg(ml + j * G * 2) - mx);
      s_w[t * (n_live + 1) + j] = w;
      sum += w * __ldcg(ml + j * G * 2 + 1);
    }
    s_w[t * (n_live + 1) + n_live] = fmaxf(sum, 1e-30f);
    if (lse)
      lse[(long long)b * H + (kh0 + h) * G + g] =
          sum > 0.f ? (mx + log2f(sum)) * kLn2 : -INFINITY;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_heads * G * hd; i += nt) {
    const int h = i / (G * hd), r = i - h * G * hd, t = h * G + r / hd;
    const float* pa = part_acc + (long long)(b * K + kh0 + h) * n_split * G * hd + r;
    const float* w = s_w + t * (n_live + 1);
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_live; ++j) a += w[j] * __ldcg(pa + (long long)j * G * hd);
    const long long o = ((long long)b * H + (long long)(kh0 + h) * G) * hd + r;
    if (lse)
      reinterpret_cast<float*>(out)[o] = a / w[n_live];
    else
      R::store(out + o, a / w[n_live]);
  }
}

template <typename T, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, float* part_ml, float* part_acc,
                   unsigned* arrivals, void* out, float* lse, int B, int S,
                   int K, int G, int hd, int n_split, int split_len,
                   int warps, int wph, cudaStream_t stream) {
  const float qscale = (float)(1.0 / sqrt((double)hd)) * kLog2e;
  int lpk = 1;
  while (lpk * 8 < hd) lpk <<= 1;
  // above 48 KB only after opting in (64 KB for 8 bf16 warps at G <= 4),
  // once per device and size
  const size_t smem = smem_bytes<T, GM>(warps, wph, G, hd, n_split);
  auto kern = decode_attention_kernel<T, GM>;
  static size_t opted[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 32 * 1024 && (dev >= 64 || smem > opted[dev])) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = smem;
  }
  const int groups = (K + warps / wph - 1) / (warps / wph);
  kern<<<dim3((unsigned)(B * groups), (unsigned)n_split), warps * 32, smem,
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, part_ml, part_acc, arrivals,
      static_cast<T*>(out), lse, S, K, G, hd, lpk, split_len, wph, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* pos, float* part_ml, float* part_acc,
                     unsigned* arrivals, void* out, float* lse, int B,
                     int S, int K, int G, int hd, int n_split, int split_len,
                     int warps, int wph, cudaStream_t stream) {
#define DA_LAUNCH(GM)                                                     \
  return launch<T, GM>(q, k, v, pos, part_ml, part_acc, arrivals, out,    \
                       lse, B, S, K, G, hd, n_split, split_len, warps, wph, \
                       stream)
  if (G <= 1) DA_LAUNCH(1);
  if (G <= 2) DA_LAUNCH(2);
  if (G <= 4) DA_LAUNCH(4);
  if (G <= 8) DA_LAUNCH(8);
  DA_LAUNCH(16);
#undef DA_LAUNCH
}

}  // namespace

// q (B, K * G, hd), k/v (B, S, K, hd) contiguous, 16-byte aligned, of one
// dtype (bf16 != 0: bf16, else f32); pos (B,) int32.  part_ml
// (B * K, n_split, G, 2) and part_acc (B * K, n_split, G, hd) f32 scratch;
// arrivals (B * ceil(K / (warps / wph)),) uint32, all 0 before the launch
// and left 0 after it; out like q.  split_len is a multiple of the 64-key
// tile and n_split * split_len >= S; warps (1..8) is the CTA's width and
// wph (a power of two dividing warps) the warps that share a kv head.
// lse: null, or (B, K * G) f32 for the partial mode (out is then f32).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* part_ml, void* part_acc,
                                       void* arrivals, void* out, int B,
                                       int S, int K, int G, int hd,
                                       int n_split, int split_len, int warps,
                                       int wph, int bf16, void* stream,
                                       void* lse) {
  if (B <= 0) return 0;
  if (hd <= 0 || hd % 8 || hd > 256 || G < 1 || G > 16 || S < 1 ||
      n_split < 1 || n_split > 65535 || split_len < kSplitTile ||
      split_len % kSplitTile || (long long)n_split * split_len < S ||
      warps < 1 || warps > kMaxWarps || wph < 1 || warps % wph ||
      (wph & (wph - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  float* ls = static_cast<float*>(lse);
  cudaError_t err =
      bf16 ? launch_g<__nv_bfloat16>(q, k, v, p, ml, acc, arr, out, ls, B, S,
                                     K, G, hd, n_split, split_len, warps, wph,
                                     s)
           : launch_g<float>(q, k, v, p, ml, acc, arr, out, ls, B, S, K, G,
                             hd, n_split, split_len, warps, wph, s);
  return (int)err;
}
