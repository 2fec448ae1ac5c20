// InterPodAffinity's domain view from node-local term counts, for sm_90a.
//
// Replaces ksim_tpu/engine/replay.py _derive_interpod (replay.py:459-489):
// the churn replay keeps, per node, the summed term rows of the pods bound
// there (loc cnt / eat / vw, [N, T2]), because a domain-aggregated view
// cannot absorb deletes.  Each step re-derives the view the InterPodAffinity
// chain reads (plugin_chain.cuh ipa_cnt / ipa_ecnt / ipa_ew / ipa_total):
//
//   view[n, t] = sum over nodes n' in n's domain for key term_tk[t] of
//                loc[n', t]     (0 where n misses the key)
//   total[t]   = sum over nodes keyed for term t of loc_cnt[n, t]
//
// A key whose every domain holds one node (hostname) is a singleton key:
// a domain's sum is the node's own value, so it needs no domain array.
// Other keys sum into a per-block domain scratch with integer atomicAdd
// (order-independent, so the sums are exact) over compact per-key domain
// indices (ldom, [0, DK)): [3, T2, DK] ints, in shared memory when they fit
// and in a global buffer beyond that.  The caller runs this with the whole
// block and orders it against readers of the view with a barrier.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ksim {

constexpr int MAX_TKI = 16;  // inter-pod topology keys
// Domain scratch up to this many bytes lives in shared memory.
constexpr long long DERIVE_SMEM_BYTES = 32768;

// Every field is 8 bytes wide: the ctypes mirror (kernels/replay_segment.py)
// has no padding to agree on.
struct DeriveParams {
  const int32_t* loc_cnt;  // [N, T2] node-local counts
  const int32_t* loc_eat;  // [N, T2]
  const int32_t* loc_vw;  // [N, T2]
  const int32_t* node_dom;  // [N, TKI] domain id per key, -1 = key missing
  const int32_t* dom_t;  // [N, T2] domain per term, -1 = key missing
  const int32_t* term_tk;  // [T2] topology key per term
  const int32_t* ldom;  // [N, TKI] compact domain of a non-singleton key, -1 = key missing
  int32_t* cnt;  // [N, T2] out
  int32_t* ecnt;  // [N, T2] out
  int32_t* ew;  // [N, T2] out
  int32_t* total;  // [T2] out
  int32_t* scratch;  // [3 * T2 * DK] when not in shared memory
  long long N, T2, TKI, DK, dsmem;
  long long singleton[MAX_TKI];  // per key: every domain is one node
};

__host__ __device__ inline long long derive_scratch_ints(const DeriveParams& D) { return 3 * D.T2 * D.DK; }

__host__ __device__ inline long long derive_smem_bytes(const DeriveParams& D) {
  return D.dsmem ? 4 * derive_scratch_ints(D) : 0;
}

// The term's key when it is a key of the vocabulary, else -1 (the term
// then derives to 0, as in the reference).
__device__ inline int derive_key(const DeriveParams& D, long long t) {
  const int k = D.term_tk[t];
  return (k >= 0 && k < D.TKI) ? k : -1;
}

// smem: the block's dynamic shared memory for the scratch (used when dsmem).
__device__ inline void derive_interpod(const DeriveParams& D, int32_t* smem) {
  int32_t* scr = D.dsmem ? smem : D.scratch;
  const long long T2 = D.T2, DK = D.DK;
  // 1. zero the scratch of non-singleton terms, and the totals.
  for (long long i = threadIdx.x; i < T2 * DK; i += blockDim.x) {
    const long long t = i / DK;
    const int k = derive_key(D, t);
    if (k < 0 || D.singleton[k]) continue;
    scr[i] = 0;
    scr[T2 * DK + i] = 0;
    scr[2 * T2 * DK + i] = 0;
  }
  for (long long t = threadIdx.x; t < T2; t += blockDim.x) D.total[t] = 0;
  __syncthreads();
  // 2. per-domain sums (non-singleton keys) and the keyed-node totals.
  for (long long n = threadIdx.x; n < D.N; n += blockDim.x) {
    for (long long t = 0; t < T2; ++t) {
      const long long nt = n * T2 + t;
      if (D.dom_t[nt] >= 0 && D.loc_cnt[nt] != 0) atomicAdd(&D.total[t], D.loc_cnt[nt]);
      const int k = derive_key(D, t);
      if (k < 0 || D.singleton[k]) continue;
      const int l = D.ldom[n * D.TKI + k];
      if (l < 0) continue;
      const long long at = t * DK + l;
      if (D.loc_cnt[nt] != 0) atomicAdd(&scr[at], D.loc_cnt[nt]);
      if (D.loc_eat[nt] != 0) atomicAdd(&scr[T2 * DK + at], D.loc_eat[nt]);
      if (D.loc_vw[nt] != 0) atomicAdd(&scr[2 * T2 * DK + at], D.loc_vw[nt]);
    }
  }
  __syncthreads();
  // 3. the view, each node's row by its owner.
  for (long long n = threadIdx.x; n < D.N; n += blockDim.x) {
    for (long long t = 0; t < T2; ++t) {
      const long long nt = n * T2 + t;
      const int k = derive_key(D, t);
      int c = 0, e = 0, w = 0;
      if (k >= 0 && D.node_dom[n * D.TKI + k] >= 0) {
        if (D.singleton[k]) {
          c = D.loc_cnt[nt];
          e = D.loc_eat[nt];
          w = D.loc_vw[nt];
        } else {
          const long long at = t * DK + D.ldom[n * D.TKI + k];
          c = scr[at];
          e = scr[T2 * DK + at];
          w = scr[2 * T2 * DK + at];
        }
      }
      D.cnt[nt] = c;
      D.ecnt[nt] = e;
      D.ew[nt] = w;
    }
  }
  __syncthreads();
}

}  // namespace ksim
