// Replica-aware fused MoE router: softmax, top-k, renormalised gates,
// logical -> physical slot, and per-slot capacity positions, in ONE launch.
//
// Replaces the TPU kernels src/repro/kernels/topk_router.py:155
// topk_router_replicated and :145 topk_router (both _call / _kernel; the
// second with identity tables).  Same contract: softmax in f32; top-k by
// iterative argmax over the PROBABILITIES with ties to the lowest index
// (as the Pallas argmax and lax.top_k); gates / max(sum, 1e-9); slot =
// replica_slots[e, (t*k + j) mod max(count, 1)]; positions counted per
// physical slot in token-major, then selection, order across all T tokens;
// integers exact.
//
// Bound on the H100: bytes in theory (T x E f32 logits in, T x k outputs
// out: ~2 ns at T = 8, ~0.2 us at T = 1024); in practice at decode it is
// one launch's latency, so the design spends exactly one launch a call.
//
// Design.  The Pallas kernel carried its per-slot counter across a
// sequential grid in VMEM.  Here one thread-block cluster of n <= 8 CTAs
// does that job inside one launch, with no atomics, no device workspace and
// no flags in global memory; the result does not depend on the order in
// which CTAs run, and nothing persists between calls, so a CUDA graph can
// capture the call.  The launch plan (kernels/topk_router.py route_plan)
// lays token i out in round i / (n W m), then CTA, then warp, then one of
// m consecutive tokens a warp, each contiguous, so CTA order, warp order
// and token order together are token-major order.
//  1. One warp per token: each lane holds ceil(E / 32) probabilities in
//     registers (kPer, rounded up to 1, 2, 4 or 8); softmax with expf (no
//     fast math), the row max by one __reduce_max_sync over
//     order-preserving integer bits.  Top-k: each lane sorts its values by
//     (value desc, index asc) once; each of the k rounds takes the best
//     head over the warp by __reduce_max_sync on the probability's bits
//     (non-negative floats order as unsigned ints) and the lowest index
//     among equal heads by __reduce_min_sync, and the winner pops its head.
//     Lane j keeps selection j.  The next token's logits load while this
//     one runs; the replica tables are staged in shared memory by cp.async
//     under the first load.
//  2. Each warp ranks its own m*k selections per slot, one token's k at a
//     time: __match_any_sync groups equal slots, popc over lower lanes
//     ranks inside the group, a per-warp count in shared memory carries
//     across the warp's tokens.
//  3. Each CTA takes an exclusive prefix over its warps per slot and
//     writes its S-wide histogram; cluster.sync(); each CTA sums the
//     histograms of the lower-ranked CTAs through distributed shared memory
//     (map_shared_rank) and adds a per-slot carry of the earlier rounds.
//     pos = carry + lower CTAs + lower warps + rank in warp.  With rounds >
//     1 every CTA adds all n histograms to its carry; the histograms are
//     double-buffered by round parity, so one cluster barrier a round
//     suffices.  A cluster of one CTA skips the cluster barrier and the
//     distributed reads.
// No warp or CTA leaves before a barrier: a warp with no token takes part
// with zero selections, and a last cluster.sync() keeps every CTA's shared
// memory alive until its peers have read it.
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace rt {
namespace router {

constexpr int kMaxK = 16;
constexpr int kMaxPerLane = 8;     // E <= 256 probabilities over a warp's 32 lanes
constexpr int kMaxWarps = 32;
constexpr int kMaxCluster = 8;     // portable cluster size

// Lane's share of one token's logits: x[lane + 32 p], -inf past e (all of
// them for e = 0, which reads nothing).
template <int kPer>
__device__ __forceinline__ void load_row(float (&v)[kPer], const float* x, int lane, int e) {
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int i = lane + 32 * p;
    v[p] = i < e ? x[i] : -INFINITY;
  }
}

// f32 <-> int with the same order (for a max by __reduce_max_sync).
__device__ __forceinline__ int to_ordered(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_ordered(int b) {
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}

// 4 bytes global -> shared without a register round trip (cp.async).
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// kReplicated: slot from the replica tables, staged in shared memory; the
// identity router: slot = expert id, and no table is read.  kPer: values a
// lane holds, ceil(E / 32) rounded up to 1, 2, 4 or 8.
template <bool kReplicated, int kPer>
__global__ void __launch_bounds__(kMaxWarps * 32)
route_kernel(const float* __restrict__ logits, const int* __restrict__ rslots,
             const int* __restrict__ rcount, float* __restrict__ gates,
             int* __restrict__ ids, int* __restrict__ slots, int* __restrict__ pos, int t,
             int e, int k, int max_rep, int num_slots, int per_warp, int rounds) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int cta = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ns = num_slots;
  // shared memory, as kernels/topk_router.py smem_bytes counts it
  int2* sel = reinterpret_cast<int2*>(smem);            // [warps][per_warp * k] (slot, rank)
  int* wcnt = smem + 2 * warps * per_warp * k;          // [warps][S] counts, then prefixes
  int* hist = wcnt + warps * ns;                        // [2][S] this CTA's totals
  int* off = hist + 2 * ns;                             // [S] carry + lower CTAs
  int* carry = off + ns;                                // [S] earlier rounds
  int* count_s = carry + ns;                            // [E] replica counts (replicated)
  int* slots_s = count_s + e;                           // [E][max_rep] replica slots
  int2* my_sel = sel + warp * per_warp * k;
  int* my_cnt = wcnt + warp * ns;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const bool act = lane < k;

  // the first round's logits are in flight while the tables are staged
  const int first = (cta * warps + warp) * per_warp;
  float cur[kPer];
  load_row(cur, logits + static_cast<size_t>(first) * e, lane, first < t ? e : 0);
  if (kReplicated) {  // asynchronous copies, all in flight at once
    for (int i = threadIdx.x; i < e; i += blockDim.x) copy_async(count_s + i, rcount + i);
    for (int i = threadIdx.x; i < e * max_rep; i += blockDim.x)
      copy_async(slots_s + i, rslots + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  for (int s = threadIdx.x; s < ns; s += blockDim.x) carry[s] = 0;  // owner thread only

  for (int r = 0; r < rounds; ++r) {
    const int tok0 = (r * n + cta) * warps * per_warp + warp * per_warp;
    const int n_tok = min(per_warp, t - tok0);          // <= 0: no token, still at barriers
    __syncwarp();
    for (int s = lane; s < ns; s += 32) my_cnt[s] = 0;
    __syncwarp();
    if (r > 0) load_row(cur, logits + static_cast<size_t>(tok0) * e, lane, n_tok > 0 ? e : 0);

    for (int i = 0; i < n_tok; ++i) {
      const int tok = tok0 + i;
      float nxt[kPer];  // the next token's logits, or all -inf after the last
      load_row(nxt, logits + static_cast<size_t>(tok + 1) * e, lane, i + 1 < n_tok ? e : 0);

      // 1. softmax in f32: the row max by one warp reduction over
      //    order-preserving integer bits, then expf (0 past E, adding
      //    nothing) and the sum in the same order as ever
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < kPer; ++p) mx = fmaxf(mx, cur[p]);
      mx = from_ordered(__reduce_max_sync(0xffffffffu, to_ordered(mx)));
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        cur[p] = expf(cur[p] - mx);
        sum += cur[p];
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      int idx[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        idx[p] = lane + 32 * p;
        cur[p] = idx[p] < e ? cur[p] / sum : -INFINITY;   // past E: never chosen
      }

      // 2. top-k: each lane sorts its values by (value desc, index asc) once;
      //    a round takes the best head over the warp (probabilities are >= 0,
      //    so their bits order as unsigned ints; key 0: nothing left) and the
      //    lowest index among equal heads, and the winner pops its head
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
#pragma unroll
        for (int b = a + 1; b < kPer; ++b) {
          if (cur[b] > cur[a] || (cur[b] == cur[a] && idx[b] < idx[a])) {
            const float tv = cur[a];
            cur[a] = cur[b];
            cur[b] = tv;
            const int ti = idx[a];
            idx[a] = idx[b];
            idx[b] = ti;
          }
        }
      }
      float gv = 0.f, gsum = 0.f;
      int gi = 0;
      for (int j = 0; j < k; ++j) {
        const unsigned key = cur[0] >= 0.f ? __float_as_uint(cur[0]) + 1u : 0u;
        const unsigned best = __reduce_max_sync(0xffffffffu, key);
        int bi = static_cast<int>(__reduce_min_sync(
            0xffffffffu, key == best && best != 0u ? static_cast<unsigned>(idx[0]) : INT_MAX));
        const float bv = best != 0u ? __uint_as_float(best - 1u) : -INFINITY;
        if (best != 0u && idx[0] == bi) {
#pragma unroll
          for (int p = 0; p + 1 < kPer; ++p) {
            cur[p] = cur[p + 1];
            idx[p] = idx[p + 1];
          }
          cur[kPer - 1] = -INFINITY;
        }
        if (bi >= e) bi = 0;  // only NaN logits get here; keep every index in range
        if (lane == j) {
          gv = bv;
          gi = bi;
        }
        gsum += bv;
      }

      // lane j < k: selection j of this token
      int slot = gi;
      if (kReplicated && act)
        slot = slots_s[gi * max_rep + (tok * k + lane) % min(max(count_s[gi], 1), max_rep)];
      const size_t o = static_cast<size_t>(tok) * k + lane;
      if (act) {
        gates[o] = gv / fmaxf(gsum, 1e-9f);
        ids[o] = gi;
        if (kReplicated) slots[o] = slot;
      }

      // 3. rank among this warp's selections of the same slot, token-major
      const bool counted = act && static_cast<unsigned>(slot) < static_cast<unsigned>(ns);
      const unsigned same = __match_any_sync(0xffffffffu, counted ? slot : -1);
      const int before = counted ? my_cnt[slot] : 0;
      __syncwarp();
      if (counted && (same & lower_lanes) == 0) my_cnt[slot] = before + __popc(same);
      __syncwarp();
      if (act) my_sel[i * k + lane] = make_int2(counted ? slot : -1,
                                               before + __popc(same & lower_lanes));
#pragma unroll
      for (int p = 0; p < kPer; ++p) cur[p] = nxt[p];
    }
    __syncthreads();

    // 4. lower warps: exclusive prefix over this CTA's warps per slot;
    //    this CTA's total into the histogram of this round's parity (one
    //    CTA: straight into the offsets and the carry, by the same thread)
    int* h = hist + (r & 1) * ns;
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      int acc = 0;
      for (int w = 0; w < warps; ++w) {
        const int c = wcnt[w * ns + s];
        wcnt[w * ns + s] = acc;
        acc += c;
      }
      if (n > 1) {
        h[s] = acc;
      } else {
        off[s] = carry[s];
        carry[s] += acc;
      }
    }
    if (n > 1) {
      cluster.sync();
      //  lower CTAs through distributed shared memory, and the carry
      for (int s = threadIdx.x; s < ns; s += blockDim.x) {
        int lower = 0, total = 0;
        for (int q = 0; q < n; ++q) {
          const int c = cluster.map_shared_rank(h, q)[s];
          if (q < cta) lower += c;
          total += c;
        }
        off[s] = carry[s] + lower;
        carry[s] += total;
      }
    }
    __syncthreads();

    // 5. positions of this warp's selections
    for (int x = lane; x < n_tok * k; x += 32) {
      const int2 sr = my_sel[x];
      pos[static_cast<size_t>(tok0) * k + x] = sr.x < 0 ? -1 : off[sr.x] + my_cnt[sr.x] + sr.y;
    }
  }
  if (n > 1) cluster.sync();  // no CTA's shared memory goes while a peer may read it
}

template <bool kReplicated, int kPer>
cudaError_t launch(const float* logits, const int* rslots, const int* rcount, float* gates,
                   int* ids, int* slots, int* pos, int t, int e, int k, int max_rep,
                   int num_slots, int ctas, int warps, int per_warp, int rounds, int smem,
                   cudaStream_t st) {
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        route_kernel<kReplicated, kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, route_kernel<kReplicated, kPer>, logits,
                                             rslots, rcount, gates, ids, slots, pos, t, e, k,
                                             max_rep, num_slots, per_warp, rounds);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kReplicated>
cudaError_t launch_per(int per, const float* logits, const int* rslots, const int* rcount,
                       float* gates, int* ids, int* slots, int* pos, int t, int e, int k,
                       int max_rep, int num_slots, int ctas, int warps, int per_warp,
                       int rounds, int smem, cudaStream_t st) {
#define RT_ROUTE(P)                                                                      \
  return launch<kReplicated, P>(logits, rslots, rcount, gates, ids, slots, pos, t, e, k, \
                                max_rep, num_slots, ctas, warps, per_warp, rounds, smem, st)
  if (per <= 1) RT_ROUTE(1);
  if (per <= 2) RT_ROUTE(2);
  if (per <= 4) RT_ROUTE(4);
  RT_ROUTE(8);
#undef RT_ROUTE
}

}  // namespace router
}  // namespace rt

// One launch over one cluster of `ctas` CTAs, with the plan's integers as
// given (kernels/topk_router.py route_plan); they are checked, not
// recomputed.  replica_slots == nullptr: the identity router (slot = id,
// num_slots = E, no slots output).  Returns the first CUDA error.
extern "C" int topk_router_launch(const void* logits, const void* replica_slots,
                                  const void* replica_count, void* gates, void* ids,
                                  void* slots, void* pos, int t, int e, int k, int max_rep,
                                  int num_slots, int ctas, int warps, int per_warp,
                                  int rounds, int smem, void* stream) {
  using namespace rt::router;
  const bool replicated = replica_slots != nullptr;
  const long long covered = static_cast<long long>(rounds) * ctas * warps * per_warp;
  const long long need = 8LL * warps * per_warp * k + 4LL * (warps + 4) * num_slots +
                         (replicated ? 4LL * e * (max_rep + 1) : 0);
  if (k < 1 || k > kMaxK || k > e || e > 32 * kMaxPerLane || num_slots < e ||
      max_rep < 1 || ctas < 1 || ctas > kMaxCluster || warps < 1 || warps > kMaxWarps ||
      per_warp < 1 || rounds < 1 || covered < t || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const int per = (e + 31) / 32;
  cudaError_t err;
  if (replicated)
    err = launch_per<true>(per, x, static_cast<const int*>(replica_slots),
                           static_cast<const int*>(replica_count), static_cast<float*>(gates),
                           static_cast<int*>(ids), static_cast<int*>(slots),
                           static_cast<int*>(pos), t, e, k, max_rep, num_slots, ctas, warps,
                           per_warp, rounds, smem, st);
  else
    err = launch_per<false>(per, x, nullptr, nullptr, static_cast<float*>(gates),
                            static_cast<int*>(ids), nullptr, static_cast<int*>(pos), t, e, k,
                            1, num_slots, ctas, warps, per_warp, rounds, smem, st);
  return static_cast<int>(err);
}
