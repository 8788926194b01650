// Replica-aware fused MoE router: softmax, top-k, renormalised gates,
// logical -> physical slot, and per-slot capacity positions.
//
// Replaces the TPU kernels src/repro/kernels/topk_router.py::
// topk_router_replicated (_call / _kernel) and topk_router (the same _call
// with identity tables, which the Python wrapper passes).  Same contract: top-k by
// iterative argmax over the PROBABILITIES with ties to the lowest index
// (as the Pallas argmax and lax.top_k), gates / max(sum, 1e-9), slot =
// replica_slots[e, (t*k + j) mod max(count, 1)], and positions counted per
// physical slot in token-major, then selection, order across all T tokens.
//
// Bound on the H100: bytes (T x E f32 logits in, four T x k arrays out);
// at decode (T = 8) it is a launch-latency-sized kernel.
//
// Design: two launches.  (1) One warp per token: f32 softmax with expf,
// then k rounds of a warp argmax ordered by (value desc, index asc).
// (2) One block per physical slot scans the T*k slot array in token-major
// order and numbers the selections that landed in its slot (ballot +
// popc per warp, a running count across chunks).  The Pallas kernel carried
// its counter across token blocks in VMEM; here no state depends on the
// order in which blocks run.  Pass 2 reads O(S * T * k) ints and is exact; a
// count + prefix-sum design is later work.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kRouteWarps = 4;
constexpr int kPosThreads = 256;

__global__ void __launch_bounds__(kRouteWarps * 32)
route_kernel(const float* __restrict__ logits, const int* __restrict__ rslots,
             const int* __restrict__ rcount, float* __restrict__ gates,
             int* __restrict__ ids, int* __restrict__ slots, int t, int e,
             int k, int max_rep) {
  extern __shared__ float probs_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kRouteWarps + warp;
  if (tok >= t) return;  // the whole warp leaves together; no block barrier below
  float* pr = probs_smem + warp * e;
  const float* x = logits + static_cast<size_t>(tok) * e;

  float mx = -INFINITY;
  for (int i = lane; i < e; i += 32) mx = fmaxf(mx, x[i]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int i = lane; i < e; i += 32) {
    const float p = expf(x[i] - mx);
    pr[i] = p;
    sum += p;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  for (int i = lane; i < e; i += 32) pr[i] = pr[i] / sum;
  __syncwarp();

  float gsel[kMaxK];
  int isel[kMaxK];
  float gsum = 0.f;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = lane; i < e; i += 32) {  // ascending i: strict > keeps the lowest
      const float v = pr[i];
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi >= e) bi = 0;  // only NaN logits get here; keep every index in range
    gsel[j] = bv;
    isel[j] = bi;
    gsum += bv;
    __syncwarp();
    if (lane == 0) pr[bi] = rt::kNegInf;  // probabilities are >= 0
    __syncwarp();
  }
  if (lane == 0) {
    const float denom = fmaxf(gsum, 1e-9f);
    for (int j = 0; j < k; ++j) {
      const int id = isel[j];
      const int sel = tok * k + j;
      int c = rcount[id];
      if (c < 1) c = 1;
      const size_t o = static_cast<size_t>(tok) * k + j;
      gates[o] = gsel[j] / denom;
      ids[o] = id;
      slots[o] = rslots[static_cast<size_t>(id) * max_rep + sel % c];
    }
  }
}

__global__ void __launch_bounds__(kPosThreads)
position_kernel(const int* __restrict__ slots, int* __restrict__ pos, int n) {
  __shared__ int warp_counts[kPosThreads / 32];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int running = 0;
  for (int base = 0; base < n; base += kPosThreads) {  // uniform over the block
    const int i = base + threadIdx.x;
    const bool match = i < n && slots[i] == s;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kPosThreads / 32; ++w) {
      const int c = warp_counts[w];
      if (w < warp) before += c;
      total += c;
    }
    if (match) pos[i] = running + before + __popc(ballot & ((1u << lane) - 1u));
    running += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int topk_router_launch(const void* logits, const void* replica_slots,
                                  const void* replica_count, void* gates, void* ids,
                                  void* slots, void* pos, int t, int e, int k,
                                  int max_rep, int num_slots, void* stream) {
  if (k < 1 || k > kMaxK || k > e) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (t + kRouteWarps - 1) / kRouteWarps;
  const size_t smem = sizeof(float) * kRouteWarps * static_cast<size_t>(e);
  route_kernel<<<blocks, kRouteWarps * 32, smem, st>>>(
      static_cast<const float*>(logits), static_cast<const int*>(replica_slots),
      static_cast<const int*>(replica_count), static_cast<float*>(gates),
      static_cast<int*>(ids), static_cast<int*>(slots), t, e, k, max_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  position_kernel<<<num_slots, kPosThreads, 0, st>>>(
      static_cast<const int*>(slots), static_cast<int*>(pos), t * k);
  return static_cast<int>(cudaGetLastError());
}
