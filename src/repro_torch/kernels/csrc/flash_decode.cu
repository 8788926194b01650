// Flash-decode over a contiguous slot cache: one-token GQA attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (_kernel).  Same contract: q (B, Hq, D), k and v (B, S, Hkv, D), lengths
// (B,); online softmax in f32, positions >= length masked, optional tanh
// softcap, tiles past `length` skipped, and a row with length == 0 gives
// exactly zero (acc / max(l, 1e-20) with l == 0).
//
// Bound on the H100: bytes.  Each resident K/V token is read once
// (2 * Hkv * D * itemsize per token); the arithmetic is ~1 FLOP per byte,
// far below the ~295 FLOP/byte ridge.
//
// Design: one block per (row, KV head) holds all G = Hq / Hkv query heads,
// so every K/V tile is read from device memory once per group.  The
// sequence loop runs inside the block (on the TPU it was the sequential grid
// axis); each 32-position tile of K and V is staged in shared memory as f32
// (K rows padded by one float so the score loop is free of bank conflicts),
// positions past the row's length inside the last tile are masked and never
// loaded, and (m, l, acc[G x D]) stay in shared memory in f32.  Only B * Hkv
// blocks are in flight (32 at B = 8 on 132 SMs): that, not the arithmetic,
// holds it back; splitting a row's sequence over blocks is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // positions per shared-memory tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
slot_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            T* __restrict__ out, int s_max, int hkv, int d, int g, float scale,
            float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hq = hkv * g;
  const int kstride = d + 1;
  float* qs = smem;                   // g * d
  float* ks = qs + g * d;             // kTile * (d + 1)
  float* vs = ks + kTile * kstride;   // kTile * d
  float* sc = vs + kTile * d;         // g * kTile: scores, then probabilities
  float* acc = sc + g * kTile;        // g * d
  float* m = acc + g * d;             // g
  float* l = m + g;                   // g
  float* alpha = l + g;               // g

  int length = lengths[b];
  length = length < 0 ? 0 : (length > s_max ? s_max : length);
  const size_t qbase = (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  for (int i = tid; i < g * d; i += nt) {
    qs[i] = rt::to_f32(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += nt) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(b) * s_max;
  for (int t0 = 0; t0 < length; t0 += kTile) {
    const int n = length - t0 < kTile ? length - t0 : kTile;
    for (int i = tid; i < kTile * d; i += nt) {
      const int s = i / d, di = i - s * d;
      float kx = 0.f, vx = 0.f;
      if (s < n) {
        const size_t off = ((row + t0 + s) * hkv + h) * d + di;
        kx = rt::to_f32(k[off]);
        vx = rt::to_f32(v[off]);
      }
      ks[s * kstride + di] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    for (int i = tid; i < g * kTile; i += nt) {
      const int gi = i / kTile, s = i - gi * kTile;
      float x = rt::kNegInf;
      if (s < n) {
        const float* qr = qs + gi * d;
        const float* kr = ks + s * kstride;
        float dot = 0.f;
        for (int di = 0; di < d; ++di) dot += qr[di] * kr[di];
        x = dot * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      }
      sc[i] = x;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += nt) {
      float* r = sc + gi * kTile;
      const float m_prev = m[gi];
      float m_new = m_prev;
      for (int s = 0; s < kTile; ++s) m_new = fmaxf(m_new, r[s]);
      float sum = 0.f;
      for (int s = 0; s < kTile; ++s) {
        const float p = expf(r[s] - m_new);  // masked: exp(-2^30 - m) == 0
        r[s] = p;
        sum += p;
      }
      const float a = expf(m_prev - m_new);
      alpha[gi] = a;
      l[gi] = l[gi] * a + sum;
      m[gi] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += nt) {
      const int gi = i / d, di = i - gi * d;
      const float* p = sc + gi * kTile;
      float o = 0.f;
      for (int s = 0; s < kTile; ++s) o += p[s] * vs[s * d + di];
      acc[i] = acc[i] * alpha[gi] + o;
    }
    __syncthreads();
  }
  for (int i = tid; i < g * d; i += nt) {
    const int gi = i / d;
    out[qbase + i] = rt::from_f32<T>(acc[i] / fmaxf(l[gi], 1e-20f));
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, int b, int s_max, int hkv, int d, int g, float scale,
            float softcap, size_t smem, cudaStream_t stream) {
  slot_kernel<T><<<dim3(b, hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), s_max, hkv, d, g, scale, softcap);
}

}  // namespace

extern "C" int flash_decode_smem_bytes(int d, int g) {
  return static_cast<int>(sizeof(float)) *
         (g * d + kTile * (d + 1) + kTile * d + g * kTile + g * d + 3 * g);
}

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int b, int s_max,
                                   int hkv, int d, int g, float scale, float softcap,
                                   int dtype, void* stream) {
  const size_t smem = static_cast<size_t>(flash_decode_smem_bytes(d, g));
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The slot cache holds the model's dtype, which is q's (SlotKVCache).
  if (dtype == rt::kF32)
    launch<float>(q, k, v, ln, out, b, s_max, hkv, d, g, scale, softcap, smem, st);
  else if (dtype == rt::kBF16)
    launch<__nv_bfloat16>(q, k, v, ln, out, b, s_max, hkv, d, g, scale, softcap, smem, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
