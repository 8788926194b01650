// Grouped expert GEMM: (E, C, D) x (E, D, F) -> (E, C, F), f32 accumulate,
// output in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_gemm (_kernel).
//
// Bound on the H100: at decode (C = 8) bytes — every expert's weights are
// read once, 128 x 2048 x 768 x 2 B = 403 MB per GEMM at qwen3 width,
// about 120 us at 3.35 TB/s; at a 512-token prefill bucket (C = 48) still
// bytes (~40 FLOP per weight byte, below the ~295 ridge).
//
// Design: grid (ceil(F / 64), ceil(C / 32), E); each block stages a
// 32 x 32 tile of x and a 32 x 64 tile of w in shared memory as f32 and
// loops over D, each of its 256 threads accumulating 8 outputs of one
// column in registers.  Ragged C and F edges are masked (C = 8 at decode).
// The C-tiles of one expert are neighbours in the grid, so their re-reads
// of the weight tile hit L2.  CUDA cores, no tensor cores: wgmma, TMA and
// split-K are later work.
#include "common.cuh"

namespace {

constexpr int kBC = 32, kBF = 64, kBK = 32, kThreads = 256;
constexpr int kRows = kBC / (kThreads / kBF);  // outputs per thread (8)

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
            int c, int d, int f) {
  __shared__ float xs[kBC][kBK];
  __shared__ float ws[kBK][kBF];
  const int e = blockIdx.z, c0 = blockIdx.y * kBC, f0 = blockIdx.x * kBF;
  const int tid = threadIdx.x, tx = tid % kBF, ty = tid / kBF;
  const T* xe = x + static_cast<size_t>(e) * c * d;
  const T* we = w + static_cast<size_t>(e) * d * f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int i = tid; i < kBC * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      const int gr = c0 + r, gk = k0 + cc;
      xs[r][cc] = (gr < c && gk < d) ? rt::to_f32(xe[static_cast<size_t>(gr) * d + gk]) : 0.f;
    }
    for (int i = tid; i < kBK * kBF; i += kThreads) {
      const int r = i / kBF, cc = i % kBF;
      const int gk = k0 + r, gf = f0 + cc;
      ws[r][cc] = (gk < d && gf < f) ? rt::to_f32(we[static_cast<size_t>(gk) * f + gf]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float wv = ws[kk][tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += xs[ty + r * (kThreads / kBF)][kk] * wv;
    }
    __syncthreads();
  }
  const int gf = f0 + tx;
  if (gf >= f) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gr = c0 + ty + r * (kThreads / kBF);
    if (gr < c) out[(static_cast<size_t>(e) * c + gr) * f + gf] = rt::from_f32<T>(acc[r]);
  }
}

}  // namespace

extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int e,
                               int c, int d, int f, int dtype, void* stream) {
  const dim3 grid((f + kBF - 1) / kBF, (c + kBC - 1) / kBC, e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) {
    gemm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), c, d, f);
  } else if (dtype == rt::kBF16) {
    gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), c, d, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
