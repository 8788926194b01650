// Split-sequence decode attention: the two passes shared by both decode
// kernels (flash_decode.cu over a slot cache, flash_decode_paged.cu over a
// paged pool).  One query token per row attends to that row's first
// `length` positions of a K/V store; G = Hq / Hkv query heads share each KV
// head.
//
// Bound on the H100: bytes.  Each resident K/V token is read once
// (2 * Hkv * D * itemsize per token); the arithmetic is ~1 FLOP per byte,
// far below the ~295 FLOP/byte ridge.  A decode batch of 8 rows x 4 KV
// heads is only 32 (row, KV head) pairs, so the design spreads each row's
// sequence over many blocks to put those bytes in flight on all 132 SMs at
// once, and merges the blocks' partials in a second launch.
//
// Split pass (split_kernel): grid (B * Hkv, n_split).  A block owns one KV
// head of one row and a span of `chunks_per_split` chunks of kChunk
// positions; it holds all G query heads, so each K/V byte is read once.  A
// block whose span starts at or past the row's length returns at once.
// Per chunk, the K and V rows of the valid positions are copied to shared
// memory in the store's dtype with 16-byte cp.async (positions >= length
// are never loaded); each score is one lane's dot product over a whole K
// row (a lane per position, the warps of a position group splitting the
// heads), with q read from shared memory as a broadcast and K rows padded by
// 16 bytes so that the lanes' row reads fall on different banks; one warp
// per head updates the f32 online softmax (m, l) over the chunk; then each
// thread accumulates P.V for one head, one 16-byte slice of D and a share
// of the positions, and the shares are summed in shared memory.  The block
// writes an f32 partial (acc[D], m, l) per (row, query head, split).
//
// Merge pass (merge_kernel): grid (B * Hq).  Only the partials of spans that
// start before the row's length are read:
//   out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-20),
// M = max_i m_i, so a row of length 0 reads no partial and is exactly 0
// (never e^(-inf - -inf)).
//
// The split pass is a template over the q type and the store type (an
// int8 row of D = 128 is eight 16-byte copies, widened to f32 by byte
// permutes rather than I2F conversions); over `Rows`, which maps (row, KV
// head, position) to the element offset of that position's K/V row
// (SlotRows: contiguous slots; PagedRows: through the row's block table,
// each position through its own page, so a chunk may span pages of any
// size); and over `Scales`, the per-position dequantisation scales of an
// int8 store (NoScales costs nothing; PageScales looks up the position's
// page scales once per chunk, as its copy is issued).  The K scale
// multiplies the position's score before the softcap; the V scale
// multiplies its probability in the P.V weights only, never in l.
#pragma once

#include "common.cuh"

namespace rt {
namespace split {

constexpr int kChunk = 32;    // positions per chunk (kernels/flash_decode.py CHUNK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScLd = kChunk + 1;  // score row stride (floats): heads on other banks
constexpr int kPosGroups = kChunk / 32;  // warps that cover one chunk, a lane a position
constexpr int kMergeThreads = 128;

// Contiguous slot store: k, v (B, S, Hkv, D).
struct SlotRows {
  int s_max, hkv, d;
  __device__ __forceinline__ size_t operator()(int b, int h, int pos) const {
    return ((static_cast<size_t>(b) * s_max + pos) * hkv + h) * d;
  }
};

// A block table: tables (B, NB) int32, the physical page of each logical
// block of BS positions.
struct BlockTable {
  const int* tables;
  int nb, bs;
  __device__ __forceinline__ int page(int b, int pos) const {
    return __ldg(tables + static_cast<size_t>(b) * nb + pos / bs);
  }
};

// Paged pool: k, v (P, BS, Hkv, D), a position's row in its own page.
struct PagedRows {
  BlockTable bt;
  int hkv, d;
  __device__ __forceinline__ size_t operator()(int b, int h, int pos) const {
    const size_t slot = static_cast<size_t>(bt.page(b, pos)) * bt.bs + pos % bt.bs;
    return (slot * hkv + h) * d;
  }
};

// A store in q's dtype: no scales (the kernel's scale code is discarded).
struct NoScales {
  static constexpr bool kOn = false;
};

// Int8 pages: the f32 (k, v) scales (P,) of the position's page.
struct PageScales {
  static constexpr bool kOn = true;
  BlockTable bt;
  const float* k;
  const float* v;
  __device__ __forceinline__ float2 operator()(int b, int pos) const {
    const int p = bt.page(b, pos);
    return make_float2(__ldg(k + p), __ldg(v + p));
  }
};

// Shared memory of the split pass: K (rows padded by 16 bytes) and V chunks
// in the store's dtype, then f32 q (G x D), scores (G x kScLd), acc (G x D),
// m, l, alpha (G each), the P.V shares (kThreads x VEC) and, for a scaled
// store, the chunk's K and V scales (kChunk each).
__host__ __device__ inline int smem_bytes(int d, int g, int itemsize, bool scaled = false) {
  return kChunk * (2 * d * itemsize + 16) + 4 * (2 * g * d + g * kScLd + 3 * g)
         + 4 * kThreads * (16 / itemsize) + (scaled ? 8 * kChunk : 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}

// VEC elements of T (16 bytes) from shared memory, widened to f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&out)[VEC], const T* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
}

// int8 widened exactly without the quarter-rate I2F: x + 128 as a byte
// placed under 2^23's exponent (PRMT), then 2^23 + 128 subtracted (FADD).
template <>
__device__ __forceinline__ void load_vec<int8_t, 16>(float (&out)[16], const int8_t* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// part: (B, Hq, n_split, D + 2) f32 — acc[D], m, l.  D must be a multiple
// of VEC (16-byte rows; the wrapper checks).  q is (B, Hq, D) in QT; K and
// V are read as KT at the offsets `rows` gives.
template <typename QT, typename KT, class Rows, class Scales>
__global__ void __launch_bounds__(kThreads)
split_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
             const int* __restrict__ lengths, float* __restrict__ part, Rows rows,
             Scales scales, int s_max, int hkv, int d, int g, int n_split,
             int chunks_per_split, float scale, float softcap) {
  constexpr int VEC = 16 / sizeof(KT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv, split = blockIdx.y;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > s_max ? s_max : length);
  const int start = split * chunks_per_split * kChunk;
  if (start >= length) return;
  const int stop = min(start + chunks_per_split * kChunk, length);

  const int kld = d + VEC;                  // padded K row (elements)
  KT* ks = reinterpret_cast<KT*>(smem);     // kChunk x kld
  KT* vs = ks + kChunk * kld;               // kChunk x d
  float* qs = reinterpret_cast<float*>(vs + kChunk * d);  // g x d
  float* sc = qs + g * d;                   // g x kScLd: scores, then probabilities
  float* acc = sc + g * kScLd;              // g x d
  float* m = acc + g * d;                   // g
  float* l = m + g;                         // g
  float* alpha = l + g;                     // g
  float* shares = alpha + g;                // VEC x kThreads: P.V shares
  float* kscl = shares + VEC * kThreads;    // kChunk: K scales (scaled stores only)
  float* vscl = kscl + kChunk;              // kChunk: V scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int vpr = d / VEC;                  // 16-byte vectors per row

  // copy the valid K and V rows of the chunk at t0 (and stage their
  // scales); positions >= n are never loaded.  A thread's items are
  // kThreads apart, so each looks up a different position's row.
  auto issue = [&](int t0, int n) {
    for (int i = tid; i < n * vpr; i += kThreads) {
      const int s = i / vpr, c = (i % vpr) * VEC;
      const size_t off = rows(b, h, t0 + s) + c;
      cp_async16(ks + s * kld + c, k + off);
      cp_async16(vs + s * d + c, v + off);
      if constexpr (Scales::kOn) {
        if (c == 0) {
          const float2 sv = scales(b, t0 + s);
          kscl[s] = sv.x;
          vscl[s] = sv.y;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(start, min(kChunk, stop - start));  // in flight while q is read
  const size_t qbase = (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    qs[i] = to_f32(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int t0 = start; t0 < stop; t0 += kChunk) {
    const int n = min(kChunk, stop - t0);
    if (t0 != start) issue(t0, n);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // scores: a lane per position; the kPosGroups warps of one head group
    // cover the chunk, and the head groups split the G heads
    {
      const int s = (warp % kPosGroups) * 32 + lane;
      const bool live = s < n;
      for (int gi = warp / kPosGroups; gi < g; gi += kWarps / kPosGroups) {
        float pd[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) pd[j] = 0.f;
        if (live) {
          const KT* kr = ks + s * kld;
          const float* qr = qs + gi * d;
          for (int c = 0; c < d; c += VEC) {
            float kf[VEC];
            load_vec<KT, VEC>(kf, kr + c);
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + c + j);
              pd[j] += qv.x * kf[j];
              pd[j + 1] += qv.y * kf[j + 1];
              pd[j + 2] += qv.z * kf[j + 2];
              pd[j + 3] += qv.w * kf[j + 3];
            }
          }
        }
        float x = kNegInf;                  // masked: exp(-2^30 - m) == 0
        if (live) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot += pd[j];
          if constexpr (Scales::kOn) dot *= kscl[s];   // dequantised K row
          x = dot * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        }
        sc[gi * kScLd + s] = x;
      }
    }
    __syncthreads();

    // online softmax over the chunk, one warp per head
    for (int gi = warp; gi < g; gi += kWarps) {
      float* r = sc + gi * kScLd;
      float mx = kNegInf;
      for (int s = lane; s < kChunk; s += 32) mx = fmaxf(mx, r[s]);
      const float m_prev = m[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int s = lane; s < kChunk; s += 32) {
        const float p = expf(r[s] - m_new);
        sum += p;                           // l sums the unscaled probabilities
        if constexpr (Scales::kOn) r[s] = s < n ? p * vscl[s] : 0.f;   // P.V weight
        else r[s] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[gi] = a;
        l[gi] = l[gi] * a + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over the n valid positions.  A work item is
    // one head and one 16-byte slice of D; when there are fewer items than
    // threads, `parts` threads share an item's positions (a warp takes one
    // share, so its V reads are one row) and the shares meet in `shares`.
    const int items = g * vpr;
    const int parts = items < kThreads ? kThreads / items : 1;
    for (int i = tid; i < (parts > 1 ? parts * items : items); i += kThreads) {
      const int item = i % items, part = i / items;
      const int gi = item / vpr, c = (item % vpr) * VEC;
      const float* p = sc + gi * kScLd;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = 0.f;
      for (int s = part; s < n; s += parts) {
        float vf[VEC];
        load_vec<KT, VEC>(vf, vs + s * d + c);
        const float ps = p[s];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] += ps * vf[j];
      }
      if (parts > 1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) shares[j * kThreads + i] = o[j];
      } else {
        float* ar = acc + gi * d + c;
        const float a = alpha[gi];
#pragma unroll
        for (int j = 0; j < VEC; ++j) ar[j] = ar[j] * a + o[j];
      }
    }
    if (parts > 1) {
      __syncthreads();
      if (tid < items) {
        const int gi = tid / vpr, c = (tid % vpr) * VEC;
        float* ar = acc + gi * d + c;
        const float a = alpha[gi];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float o = 0.f;
          for (int q = 0; q < parts; ++q) o += shares[j * kThreads + q * items + tid];
          ar[j] = ar[j] * a + o;
        }
      }
    }
    __syncthreads();
  }

  const size_t pbase = static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g;
  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, di = i - gi * d;
    part[((pbase + gi) * n_split + split) * (d + 2) + di] = acc[i];
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    float* pr = part + ((pbase + gi) * n_split + split) * (d + 2) + d;
    pr[0] = m[gi];
    pr[1] = l[gi];
  }
}

// out (B, Hq, D) from the partials of the spans that start before length.
// The block first reads every partial's (m, l) at once into shared memory
// (3 * n_split floats of dynamic shared memory), so that the weights
// e^(m_i - M) are known before the acc reads, which are then independent.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
             T* __restrict__ out, int s_max, int hq, int d, int n_split, int span) {
  extern __shared__ float mlw[];            // m, l, w: n_split each
  float* ms = mlw;
  float* ls = ms + n_split;
  float* ws = ls + n_split;
  const int row = blockIdx.x, b = row / hq;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > s_max ? s_max : length);
  const int n_valid = (length + span - 1) / span;
  const float* p = part + static_cast<size_t>(row) * n_split * (d + 2);
  for (int i = threadIdx.x; i < n_valid; i += blockDim.x) {
    ms[i] = p[i * (d + 2) + d];
    ls[i] = p[i * (d + 2) + d + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int i = 0; i < n_valid; ++i) mx = fmaxf(mx, ms[i]);
  for (int i = threadIdx.x; i < n_valid; i += blockDim.x) ws[i] = expf(ms[i] - mx);
  __syncthreads();
  float den = 0.f;
  for (int i = 0; i < n_valid; ++i) den += ws[i] * ls[i];
  const float inv = 1.f / fmaxf(den, 1e-20f);   // a length-0 row: 0 * inv == 0
  for (int di = threadIdx.x; di < d; di += blockDim.x) {
    float num = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_valid; ++i) num += ws[i] * p[i * (d + 2) + di];
    out[static_cast<size_t>(row) * d + di] = from_f32<T>(num * inv);
  }
}

// Both passes on `st`: the split pass (opting in, once per instantiation,
// to more than the default 48 KB of dynamic shared memory and to the SM's
// whole 228 KB as shared memory so that several blocks fit on each SM),
// then the merge.  part: the caller's f32 scratch of
// B * Hq * n_split * (D + 2) floats.  Returns the first CUDA error.
template <typename QT, typename KT, class Rows, class Scales>
int launch(const void* q, const void* k, const void* v, const int* lengths, float* part,
           void* out, Rows rows, Scales scales, int b, int s_max, int hkv, int d, int g,
           int n_split, int chunks_per_split, float scale, float softcap, cudaStream_t st) {
  const int smem = smem_bytes(d, g, static_cast<int>(sizeof(KT)), Scales::kOn);
  static int smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(split_kernel<QT, KT, Rows, Scales>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(split_kernel<QT, KT, Rows, Scales>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  split_kernel<QT, KT, Rows, Scales><<<dim3(b * hkv, n_split), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      lengths, part, rows, scales, s_max, hkv, d, g, n_split, chunks_per_split, scale,
      softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t merge_smem = 3 * static_cast<size_t>(n_split) * sizeof(float);
  merge_kernel<QT><<<b * hkv * g, kMergeThreads, merge_smem, st>>>(
      part, lengths, static_cast<QT*>(out), s_max, hkv * g, d, n_split,
      chunks_per_split * kChunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split
}  // namespace rt
