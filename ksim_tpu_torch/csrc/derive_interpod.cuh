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
// Other keys sum over compact per-key domain indices (ldom, [0, DK)).
//
// On a thread-block cluster (kernel D's team, cluster_scan.cuh): each
// block sums the nodes it holds into its own partial scratch, [3, T2, DK]
// domain sums then [T2] totals, with integer atomicAdd (order-independent,
// so the sums are exact); after one cluster barrier every block adds all
// Cs partials into its own combined copy (through distributed shared
// memory, or past L1 from the ranks' rows of a global buffer when the
// scratch is too large for shared memory), then writes the view rows of
// the nodes it holds and its copy of the totals.  A closing cluster
// barrier lets the next run overwrite a partial that other blocks read.
// The scratch is in shared memory when both copies fit
// kernels/replay_segment.py DERIVE_SMEM_BYTES (dsmem).  The standalone
// entry runs the same code on one block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace ksim {

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
  const uint8_t* singleton;  // [TKI] per key: every domain is one node
  int32_t* cnt;  // [N, T2] out
  int32_t* ecnt;  // [N, T2] out
  int32_t* ew;  // [N, T2] out
  int32_t* total;  // [T2] out (written by rank 0)
  int32_t* scratch;  // [MAX_CLUSTER, 2 * derive_scratch_ints] when not in shared memory
  long long N, T2, TKI, DK, dsmem;
};

// One block's partial: [3, T2, DK] domain sums, then [T2] totals.
__host__ __device__ inline long long derive_scratch_ints(const DeriveParams& D) { return 3 * D.T2 * D.DK + D.T2; }

__host__ __device__ inline long long derive_smem_bytes(const DeriveParams& D) {
  return D.dsmem ? 2 * 4 * derive_scratch_ints(D) : 0;
}

// The term's key when it is a key of the vocabulary, else -1 (the term
// then derives to 0, as in the reference).
__device__ inline int derive_key(const DeriveParams& D, long long t) {
  const int k = D.term_tk[t];
  return (k >= 0 && k < D.TKI) ? k : -1;
}

// Run by every block of the team's cluster.  smem: the block's dynamic
// shared memory for the scratch (used when dsmem); tot [T2]: the block's
// copy of the totals (shared memory).
__device__ inline void derive_interpod(const DeriveParams& D, ClusterTeam& team, int32_t* smem, int32_t* tot) {
  const long long T2 = D.T2, DK = D.DK, n3 = 3 * T2 * DK, ni = n3 + T2;
  int32_t* part = D.dsmem ? smem : D.scratch + team.rank * 2 * ni;
  int32_t* comb = part + ni;
  // 1. this block's partial sums over the nodes it holds.
  for (long long i = threadIdx.x; i < ni; i += blockDim.x) part[i] = 0;
  __syncthreads();
  for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= D.N) continue;
    for (long long t = 0; t < T2; ++t) {
      const long long nt = n * T2 + t;
      const int c = D.loc_cnt[nt];
      if (D.dom_t[nt] >= 0 && c != 0) atomicAdd(&part[n3 + t], c);
      const int k = derive_key(D, t);
      if (k < 0 || D.singleton[k]) continue;
      const int l = D.ldom[n * D.TKI + k];
      if (l < 0) continue;
      const long long at = t * DK + l;
      const int e = D.loc_eat[nt], w = D.loc_vw[nt];
      if (c != 0) atomicAdd(&part[at], c);
      if (e != 0) atomicAdd(&part[T2 * DK + at], e);
      if (w != 0) atomicAdd(&part[2 * T2 * DK + at], w);
    }
  }
  team.sync();
  // 2. every block's partials into this block's combined copy.  The global
  // rows were written on other SMs: read past L1.
  cg::cluster_group cl = cg::this_cluster();
  for (long long i = threadIdx.x; i < ni; i += blockDim.x) {
    int acc = 0;
    for (unsigned q = 0; q < team.size; ++q)
      acc = wrap_add(acc, D.dsmem ? cl.map_shared_rank(part, q)[i] : __ldcg(D.scratch + q * 2 * ni + i));
    comb[i] = acc;
  }
  __syncthreads();
  for (long long t = threadIdx.x; t < T2; t += blockDim.x) {
    tot[t] = comb[n3 + t];
    if (team.rank == 0) D.total[t] = comb[n3 + t];
  }
  // 3. the view rows of the nodes this block holds, each by its owner.
  for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= D.N) continue;
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
          c = comb[at];
          e = comb[T2 * DK + at];
          w = comb[2 * T2 * DK + at];
        }
      }
      D.cnt[nt] = c;
      D.ecnt[nt] = e;
      D.ew[nt] = w;
    }
  }
  team.sync();  // every block has read every partial, and tot is the block's
}

}  // namespace ksim
