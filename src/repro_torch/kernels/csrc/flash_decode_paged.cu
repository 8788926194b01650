// Paged flash-decode: one-token GQA attention over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode_paged
// (_paged_kernel).  Same contract: q (B, Hq, D), pages (P, BS, Hkv, D),
// block_tables (B, NB) int32, lengths (B,) int32 clamped to NB * BS; online
// softmax in f32, positions >= length masked and never loaded, optional
// tanh softcap, int8 pages dequantised by their page's k_scale / v_scale,
// and a row with length == 0 gives exactly zero.
//
// Bound on the H100: bytes.  Each resident K/V token is read once
// (2 * Hkv * D * itemsize per token and layer, plus its page's table entry
// and, for int8 pages, two f32 scales); the arithmetic is ~1 FLOP per byte.
// At the paged path's shape (B = 8, NB = 64 pages of 16 positions, 4 KV
// heads x 128, bf16) that is ~7.7 MB, ~2.3 us at 3.35 TB/s: one block per
// (row, KV head), as the TPU kernel's grid had it, would be 32 blocks on
// 132 SMs with the page loop serial inside each.
//
// Design: the slot kernel's split-sequence passes (split_decode.cuh) with a
// block-table map.  The split pass runs (B * Hkv, n_split) blocks of
// 32-position chunks, each holding all G query heads of its KV head; every
// position's K/V row is found through its own page's table entry
// (PagedRows), so a chunk may span several pages and the page size need
// not divide the chunk or be divided by it.  Rows are copied with 16-byte
// cp.async in the pages' dtype (an int8 row of D = 128 is 8 copies); for
// int8 pages the page scales of each position are staged in shared memory
// as its copy is issued (PageScales): the K scale multiplies the score
// before the softcap, the V scale the probability in the P.V weights only.
// The merge pass combines the f32 partials (acc, m, l) that the wrapper's
// scratch holds.  The wrapper plans n_split from shapes alone (never from
// the lengths, which stay on the card).
#include "split_decode.cuh"

namespace sp = rt::split;

namespace {

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* tables, const int* lengths, float* part, void* out, int b, int nb,
           int bs, int hkv, int d, int g, int n_split, int chunks_per_split, float scale,
           float softcap, cudaStream_t st) {
  const sp::BlockTable bt{tables, nb, bs};
  const sp::PagedRows rows{bt, hkv, d};
  if constexpr (sizeof(KT) == 1)
    return sp::launch<QT, KT>(q, k, v, lengths, part, out, rows, sp::PageScales{bt, ks, vs},
                              b, nb * bs, hkv, d, g, n_split, chunks_per_split, scale,
                              softcap, st);
  else
    return sp::launch<QT, KT>(q, k, v, lengths, part, out, rows, sp::NoScales{}, b, nb * bs,
                              hkv, d, g, n_split, chunks_per_split, scale, softcap, st);
}

}  // namespace

extern "C" int flash_decode_paged_smem_bytes(int d, int g, int itemsize) {
  return sp::smem_bytes(d, g, itemsize, itemsize == 1);
}

extern "C" int flash_decode_paged_chunk() { return sp::kChunk; }

// part: the wrapper's f32 scratch of B * Hq * n_split * (D + 2) floats;
// k_scale / v_scale: (P,) f32 for int8 pages, else null.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* part, void* out,
    int b, int nb, int bs, int hkv, int d, int g, int n_split, int chunks_per_split,
    float scale, float softcap, int q_dtype, int kv_dtype, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(QT, KT)                                                               \
  return launch<QT, KT>(q, k_pages, v_pages, ks, vs, bt, ln, pt, out, b, nb, bs, hkv, d, \
                        g, n_split, chunks_per_split, scale, softcap, st)
  // Pages are in the model's dtype or int8 (PagedKVCache), so q's dtype is
  // the pages' unless they are int8.
  if (q_dtype == rt::kF32 && kv_dtype == rt::kF32) RT_LAUNCH(float, float);
  if (q_dtype == rt::kF32 && kv_dtype == rt::kI8) RT_LAUNCH(float, int8_t);
  if (q_dtype == rt::kBF16 && kv_dtype == rt::kBF16) RT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == rt::kBF16 && kv_dtype == rt::kI8) RT_LAUNCH(__nv_bfloat16, int8_t);
#undef RT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
