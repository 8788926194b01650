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

namespace sp = rt::split;

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
  const sp::SlotRows rows{s_max, hkv, d};
  // The slot cache holds the model's dtype, which is q's (SlotKVCache).
  if (dtype == rt::kF32)
    return sp::launch<float, float>(q, k, v, ln, pt, out, rows, sp::NoScales{}, b, s_max,
                                    hkv, d, g, n_split, chunks_per_split, scale, softcap, st);
  if (dtype == rt::kBF16)
    return sp::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, ln, pt, out, rows, sp::NoScales{}, b, s_max, hkv, d, g, n_split,
        chunks_per_split, scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
