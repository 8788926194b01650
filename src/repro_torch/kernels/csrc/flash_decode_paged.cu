// Paged flash-decode: one-token GQA attention over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode_paged
// (_paged_kernel).  Same contract: walk each row's block table, online
// softmax in f32, mask positions >= length, optional tanh softcap, int8 pages
// dequantised by their per-page scale, pages past `length` skipped, and a
// row with length == 0 gives exactly zero (acc / max(l, 1e-20) with l == 0).
//
// Bound on the H100: bytes.  Each resident K/V token is read once
// (2 * Hkv * D * itemsize per token and layer); the arithmetic is ~1 FLOP
// per byte, far below the ~295 FLOP/byte ridge.
//
// Design: one block per (row, KV head) holds all G = Hq / Hkv query heads,
// so every K/V page tile is read from device memory once per group.  The
// page loop runs inside the block (on the TPU it was the sequential grid
// axis); each page's K and V tiles are staged in shared memory as f32
// (K rows padded by one float so the score loop is free of bank
// conflicts), and (m, l, acc[G x D]) stay in shared memory in f32.  Only
// B * Hkv blocks are in flight (32 at B = 8 on 132 SMs): that, not the
// arithmetic, holds it back; splitting a row's pages over blocks is later
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
             const KT* __restrict__ vp, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ tables,
             const int* __restrict__ lengths, QT* __restrict__ out, int nb,
             int bs, int hkv, int d, int g, float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hq = hkv * g;
  const int kstride = d + 1;
  float* qs = smem;                   // g * d
  float* ks = qs + g * d;             // bs * (d + 1)
  float* vs = ks + bs * kstride;      // bs * d
  float* sc = vs + bs * d;            // g * bs: scores, then probabilities
  float* acc = sc + g * bs;           // g * d
  float* m = acc + g * d;             // g
  float* l = m + g;                   // g
  float* alpha = l + g;               // g

  const int length = lengths[b];
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

  int npages = (length + bs - 1) / bs;
  if (npages > nb) npages = nb;
  for (int si = 0; si < npages; ++si) {
    const int page = tables[static_cast<size_t>(b) * nb + si];
    const float kscl = k_scale ? k_scale[page] : 1.f;
    const float vscl = v_scale ? v_scale[page] : 1.f;
    for (int i = tid; i < bs * d; i += nt) {
      const int s = i / d, di = i - s * d;
      const size_t off = ((static_cast<size_t>(page) * bs + s) * hkv + h) * d + di;
      ks[s * kstride + di] = rt::to_f32(kp[off]) * kscl;
      vs[i] = rt::to_f32(vp[off]) * vscl;
    }
    __syncthreads();
    for (int i = tid; i < g * bs; i += nt) {
      const int gi = i / bs, s = i - gi * bs;
      const float* qr = qs + gi * d;
      const float* kr = ks + s * kstride;
      float dot = 0.f;
      for (int di = 0; di < d; ++di) dot += qr[di] * kr[di];
      float v = dot * scale;
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      sc[i] = (si * bs + s < length) ? v : rt::kNegInf;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += nt) {
      float* row = sc + gi * bs;
      const float m_prev = m[gi];
      float m_new = m_prev;
      for (int s = 0; s < bs; ++s) m_new = fmaxf(m_new, row[s]);
      float sum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const float p = expf(row[s] - m_new);
        row[s] = p;
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
      const float* p = sc + gi * bs;
      float o = 0.f;
      for (int s = 0; s < bs; ++s) o += p[s] * vs[s * d + di];
      acc[i] = acc[i] * alpha[gi] + o;
    }
    __syncthreads();
  }
  for (int i = tid; i < g * d; i += nt) {
    const int gi = i / d;
    out[qbase + i] = rt::from_f32<QT>(acc[i] / fmaxf(l[gi], 1e-20f));
  }
}

template <typename QT, typename KT>
void launch(const void* q, const void* kp, const void* vp, const float* ks,
            const float* vs, const int* tables, const int* lengths, void* out,
            int b, int nb, int bs, int hkv, int d, int g, float scale,
            float softcap, size_t smem, cudaStream_t stream) {
  paged_kernel<QT, KT><<<dim3(b, hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ks, vs, tables, lengths, static_cast<QT*>(out),
      nb, bs, hkv, d, g, scale, softcap);
}

}  // namespace

extern "C" int flash_decode_paged_smem_bytes(int bs, int d, int g) {
  return static_cast<int>(sizeof(float)) *
         (g * d + bs * (d + 1) + bs * d + g * bs + g * d + 3 * g);
}

extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out,
    int b, int nb, int bs, int hkv, int d, int g, float scale, float softcap,
    int q_dtype, int kv_dtype, void* stream) {
  const size_t smem = static_cast<size_t>(flash_decode_paged_smem_bytes(bs, d, g));
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(QT, KT)                                                      \
  launch<QT, KT>(q, k_pages, v_pages, ks, vs, bt, ln, out, b, nb, bs, hkv, d, \
                 g, scale, softcap, smem, st)
  // Pages are in the model's dtype or int8 (PagedKVCache), so q's dtype is
  // the pages' unless they are int8.
  if (q_dtype == rt::kF32 && kv_dtype == rt::kF32) RT_LAUNCH(float, float);
  else if (q_dtype == rt::kF32 && kv_dtype == rt::kI8) RT_LAUNCH(float, int8_t);
  else if (q_dtype == rt::kBF16 && kv_dtype == rt::kBF16) RT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (q_dtype == rt::kBF16 && kv_dtype == rt::kI8) RT_LAUNCH(__nv_bfloat16, int8_t);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
