// Grouped expert GEMM: (E, C, D) x (E, D, F) -> (E, C, F), f32 accumulate,
// output in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_gemm (_kernel).
//
// Bound on the H100: bytes.  At decode (C = 8) every expert's weights are
// read once, 128 x 2048 x 768 x 2 B = 403 MB per GEMM at qwen3 width, about
// 120 us at 3.35 TB/s; at a 512-token prefill bucket (C = 48) still bytes
// (~48 FLOP per weight byte, below the ~295 ridge).  So the kernel has to
// keep the memory system full and touch each weight byte once; the
// arithmetic (19 GFLOP at C = 48, ~20 us of tensor-core time) hides under
// the copies.
//
// bf16 design (tc_gemm_kernel): A and B are swapped so that the small C is
// the MMA's N dimension: out^T (F x C) = w^T (F x D) . x^T (D x C), on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  C = 8 is exactly one N
// tile; a block takes up to 8 N tiles (kBC <= 64), so the accumulators stay
// in registers at any C.  Each block owns kBF = 128 output features of one
// expert and streams its (D x 128) weight panel through a 4-stage ring of
// 64-deep tiles in shared memory with 16-byte cp.async: three tiles are in
// flight while the warps multiply the fourth, one barrier per tile.  The
// weight tile is F-contiguous and reaches the A operand through
// ldmatrix.trans; x (D-contiguous) is already the column-major B operand and
// rides in the same stage.  Rows are padded by 16 bytes so that ldmatrix and
// the B loads are free of bank conflicts.  Ragged C, D and F edges are
// zero-filled by cp.async (src-size 0 reads nothing), so padded rows of x
// give exactly zero; D and F must be multiples of 8 (16-byte rows), which
// the wrapper checks.  Grid (F / 128, C-tiles, E): the C-tiles and F-tiles
// of one expert are neighbours, so a second C-tile's weight reads and every
// F-tile's x reads hit L2.
//
// f32 keeps the CUDA-core kernel (gemm_kernel): TF32 tensor cores would miss
// the f32 gate of 2e-4 and are off on purpose (repro_torch/device.py).  The
// dtype decides which kernel runs.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- f32, CUDA cores
// grid (ceil(F / 64), ceil(C / 32), E); each block stages a 32 x 32 tile of x
// and a 32 x 64 tile of w in shared memory and loops over D, each of its 256
// threads accumulating 8 outputs of one column in registers.
constexpr int kBC = 32, kBF = 64, kBK = 32, kThreads = 256;
constexpr int kRows = kBC / (kThreads / kBF);  // outputs per thread (8)

__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int c, int d, int f) {
  __shared__ float xs[kBC][kBK];
  __shared__ float ws[kBK][kBF];
  const int e = blockIdx.z, c0 = blockIdx.y * kBC, f0 = blockIdx.x * kBF;
  const int tid = threadIdx.x, tx = tid % kBF, ty = tid / kBF;
  const float* xe = x + static_cast<size_t>(e) * c * d;
  const float* we = w + static_cast<size_t>(e) * d * f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int i = tid; i < kBC * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      const int gr = c0 + r, gk = k0 + cc;
      xs[r][cc] = (gr < c && gk < d) ? xe[static_cast<size_t>(gr) * d + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBF; i += kThreads) {
      const int r = i / kBF, cc = i % kBF;
      const int gk = k0 + r, gf = f0 + cc;
      ws[r][cc] = (gk < d && gf < f) ? we[static_cast<size_t>(gk) * f + gf] : 0.f;
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
    if (gr < c) out[(static_cast<size_t>(e) * c + gr) * f + gf] = acc[r];
  }
}

// ---------------------------------------------------------------- bf16, tensor cores
// Must match kernels/moe_gemm.py (BF16_BLOCK_F, BF16_BLOCK_K, BF16_STAGES, _PAD).
constexpr int kTcBF = 128;          // output features per block (MMA M)
constexpr int kTcBK = 64;           // depth of one pipeline stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128;     // 4 warps, 32 features each
constexpr int kPad = 8;             // bf16 elements of row padding (16 bytes)
constexpr int kWLd = kTcBF + kPad;  // weight tile row stride (elements)
constexpr int kXLd = kTcBK + kPad;  // x tile row stride (elements)

using bf16 = __nv_bfloat16;

constexpr int tc_smem_bytes(int n_tiles) {
  return kTcStages * (kTcBK * kWLd + 8 * n_tiles * kXLd) * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = ok ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: N tiles of 8 rows of C per block (block C = 8 * NT).
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
tc_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ out, int c, int d, int f) {
  constexpr int kBCt = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);        // [stage][kTcBK][kWLd]
  bf16* xs = ws + kTcStages * kTcBK * kWLd;        // [stage][kBCt][kXLd]
  const int e = blockIdx.z, c0 = blockIdx.y * kBCt, f0 = blockIdx.x * kTcBF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xe = x + static_cast<size_t>(e) * c * d;
  const bf16* we = w + static_cast<size_t>(e) * d * f;
  const int nk = (d + kTcBK - 1) / kTcBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kTcBK;
    bf16* wst = ws + stage * kTcBK * kWLd;
#pragma unroll
    for (int j = 0; j < kTcBK * kTcBF / 8 / kTcThreads; ++j) {   // 8 copies a thread
      const int i = tid + j * kTcThreads;
      const int r = i / (kTcBF / 8), cc = (i % (kTcBF / 8)) * 8;
      const int gk = k0 + r, gf = f0 + cc;
      const bool ok = gk < d && gf < f;
      cp_async16(wst + r * kWLd + cc, ok ? we + static_cast<size_t>(gk) * f + gf : we, ok);
    }
    bf16* xst = xs + stage * kBCt * kXLd;
    for (int i = tid; i < kBCt * kTcBK / 8; i += kTcThreads) {
      const int r = i / (kTcBK / 8), cc = (i % (kTcBK / 8)) * 8;
      const int gr = c0 + r, gk = k0 + cc;
      const bool ok = gr < c && gk < d;
      cp_async16(xst + r * kXLd + cc, ok ? xe + static_cast<size_t>(gr) * d + gk : xe, ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;          // MMA fragment coordinates
  const int lm = lane >> 3, lr = lane & 7;        // ldmatrix: matrix, row
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();               // tile kt has landed
    __syncthreads();                              // ... for every thread; slot kt-1 is free
    if (kt + kTcStages - 1 < nk) load((kt + kTcStages - 1) % kTcStages, kt + kTcStages - 1);
    cp_async_commit();
    const bf16* wst = ws + (kt % kTcStages) * kTcBK * kWLd;
    const bf16* xst = xs + (kt % kTcStages) * kBCt * kXLd;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // matrices 0..3 = (rows 0-7 | 8-15 of M) x (k 0-7 | 8-15), stored k-major
        const int m0 = warp * 32 + mt * 16 + (lm & 1) * 8;
        ldmatrix_x4_trans(a[mt], wst + (kk + lr + (lm >> 1) * 8) * kWLd + m0);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* xr = xst + (nt * 8 + g) * kXLd + kk + 2 * t;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (M = feature, N = row of C): c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, ...)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gf = f0 + warp * 32 + mt * 16 + g + (i >> 1) * 8;
        const int gr = c0 + nt * 8 + 2 * t + (i & 1);
        if (gr < c && gf < f)
          out[(static_cast<size_t>(e) * c + gr) * f + gf] = __float2bfloat16_rn(acc[mt][nt][i]);
      }
    }
  }
}

template <int NT>
int launch_tc(const void* x, const void* w, void* out, int e, int c, int d, int f,
              cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(NT);
  static bool attr_set = false;                   // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_gemm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((f + kTcBF - 1) / kTcBF, (c + 8 * NT - 1) / (8 * NT), e);
  tc_gemm_kernel<NT><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out),
      c, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of the bf16 kernel with `n_tiles` N tiles; the
// wrapper holds its own launch plan against it.
extern "C" int moe_gemm_bf16_smem_bytes(int n_tiles) { return tc_smem_bytes(n_tiles); }

// n_tiles: N tiles of 8 rows of C per bf16 block, 1..8 (ignored for f32).
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int e,
                               int c, int d, int f, int n_tiles, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) {
    const dim3 grid((f + kBF - 1) / kBF, (c + kBC - 1) / kBC, e);
    gemm_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w),
                                           static_cast<float*>(out), c, d, f);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != rt::kBF16 || (d % 8) != 0 || (f % 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n_tiles) {
    case 1: return launch_tc<1>(x, w, out, e, c, d, f, st);
    case 2: return launch_tc<2>(x, w, out, e, c, d, f, st);
    case 3: return launch_tc<3>(x, w, out, e, c, d, f, st);
    case 4: return launch_tc<4>(x, w, out, e, c, d, f, st);
    case 5: return launch_tc<5>(x, w, out, e, c, d, f, st);
    case 6: return launch_tc<6>(x, w, out, e, c, d, f, st);
    case 7: return launch_tc<7>(x, w, out, e, c, d, f, st);
    case 8: return launch_tc<8>(x, w, out, e, c, d, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
