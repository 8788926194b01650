// Flash-decode over a contiguous slot cache: one-token GQA attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (_kernel).  Same contract: q (B, Hq, D), k and v (B, S, Hkv, D), lengths
// (B,); online softmax in f32, positions >= length masked and never loaded,
// optional tanh softcap, and a row with length == 0 gives exactly zero.
//
// Bound on the H100: bytes.  Each resident K/V token is read once
// (2 * Hkv * D * itemsize per token); the arithmetic is ~1 FLOP per byte,
// far below the ~295 FLOP/byte ridge.  At the slot path's shape (B = 8,
// S = 1024, 4 KV heads x 128) that is ~7.5 MB, ~2.3 us at 3.35 TB/s, so the
// kernel has to spread those bytes over the whole card at once: one block
// per (row, KV head), as the TPU kernel's grid had it, is 32 blocks on 132
// SMs.
//
// Design: split the sequence over blocks, then merge (split_decode.cuh).
// The split pass runs (B * Hkv, n_split) blocks of 32-position chunks, each
// holding all G query heads of its KV head so that each K/V byte is read
// once, K and V copied with 16-byte cp.async and kept in their own dtype;
// it writes an f32 partial (acc, m, l) per (row, query head, split) to
// scratch that the wrapper allocates.  The merge pass rescales the partials
// by e^(m_i - M) and divides once.  The wrapper picks n_split so that the
// split pass fills the card (1024 blocks at the path shape; measured on the
// card, 32-position chunks beat 64-position ones: a block's chain of copy,
// scores, softmax and P.V is latency-bound, so shorter chains in more
// blocks finish sooner, and the merge reads its partials in one pass).
#include "split_decode.cuh"

namespace {

namespace sp = rt::split;

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths, float* part,
           void* out, int b, int s_max, int hkv, int d, int g, int n_split,
           int chunks_per_split, float scale, float softcap, cudaStream_t st) {
  const int smem = sp::smem_bytes(d, g, static_cast<int>(sizeof(T)));
  static int smem_allowed = 0;                    // set once per dtype (and head shape)
  if (smem > smem_allowed) {
    // above the default 48 KB, and all of the SM's 228 KB as shared memory
    // so that several blocks fit on each SM
    cudaError_t err = cudaFuncSetAttribute(sp::split_kernel<T, sp::SlotRows>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sp::split_kernel<T, sp::SlotRows>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const sp::SlotRows rows{s_max, hkv, d};
  sp::split_kernel<T, sp::SlotRows><<<dim3(b * hkv, n_split), sp::kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, part, rows, s_max, hkv, d, g, n_split, chunks_per_split, scale, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t merge_smem = 3 * static_cast<size_t>(n_split) * sizeof(float);
  sp::merge_kernel<T><<<b * hkv * g, sp::kMergeThreads, merge_smem, st>>>(
      part, lengths, static_cast<T*>(out), s_max, hkv * g, d, n_split,
      chunks_per_split * sp::kChunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_decode_smem_bytes(int d, int g, int itemsize) {
  return sp::smem_bytes(d, g, itemsize);
}

extern "C" int flash_decode_chunk() { return sp::kChunk; }

// part: the wrapper's f32 scratch of B * Hq * n_split * (D + 2) floats.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* part, void* out, int b,
                                   int s_max, int hkv, int d, int g, int n_split,
                                   int chunks_per_split, float scale, float softcap,
                                   int dtype, void* stream) {
  const int* ln = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The slot cache holds the model's dtype, which is q's (SlotKVCache).
  if (dtype == rt::kF32)
    return launch<float>(q, k, v, ln, pt, out, b, s_max, hkv, d, g, n_split,
                         chunks_per_split, scale, softcap, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(q, k, v, ln, pt, out, b, s_max, hkv, d, g, n_split,
                                 chunks_per_split, scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
