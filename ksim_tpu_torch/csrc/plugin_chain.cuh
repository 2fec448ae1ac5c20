// The default profile's plugin chain, one pod against every node, for sm_90a.
//
// Shared by batch_eval.cu (kernel B, batch evaluation), replay_segment.cu
// (kernel D), chain_stages.cu (kernel E, the chain in stages for hooked
// and kernel-less profiles) and, through cluster_scan.cuh, schedule_scan.cu
// (kernel A, the sequential-commit scan) and schedule_sampled.cu (kernel C,
// the scan with percentageOfNodesToScore sampling).  A "team" evaluates one pod at a
// time, and its type says how the node axis is owned and reduced:
//  - BatchTeam (B; batch_eval.cu): one thread block; thread t owns nodes
//    t, t + blockDim.x, ..., the reductions run in-block, and the
//    predicates read B's per-launch node summary (its own evaluation,
//    eval_pod_batch, over the helpers here);
//  - ClusterTeam (A, C, D; cluster_scan.cuh): a thread-block cluster,
//    each block owning a share of the node axis, its reductions crossing
//    the cluster through distributed shared memory (eval_pod_team).
// A team's node slots li = threadIdx.x, threadIdx.x + blockDim.x, ... map
// to nodes through team.node(li); the per-node shared-memory arrays are
// indexed by slot.  The profile's tables (Fit's resources and shape,
// Balanced's resources, the NodeVolumeLimits instances, the spread keys)
// are device arrays sized by the profile, and the pod's spread
// constraints are staged in shared memory (SpreadCon): no width is fixed.
//
// Plugins (ids below) and the reference functions they translate:
//   NodeUnschedulable  ksim_tpu/plugins/nodeunschedulable.py  filter
//   NodeName           ksim_tpu/plugins/nodename.py           filter
//   TaintToleration    ksim_tpu/plugins/tainttoleration.py    filter, score, normalize
//   NodeAffinity       ksim_tpu/plugins/nodeaffinity.py       filter, score, normalize
//   NodePorts          ksim_tpu/plugins/nodeports.py          filter (+ carry)
//   NodeResourcesFit   ksim_tpu/plugins/noderesources.py      filter, 3 score strategies
//   BalancedAllocation ksim_tpu/plugins/noderesources.py      score (int64 / f32)
//   ImageLocality      ksim_tpu/plugins/imagelocality.py      score (f64 / f32)
//   VolumeRestrictions ksim_tpu/plugins/volumes.py:198        filter (+ 3 additive carries)
//   NodeVolumeLimits   ksim_tpu/plugins/volumes.py:133        filter (+ saturating carry)
//   VolumeBinding      ksim_tpu/plugins/volumes.py:57         filter
//   VolumeZone         ksim_tpu/plugins/volumes.py:106        filter
//   PodTopologySpread  ksim_tpu/plugins/podtopologyspread.py  filter, score, normalize (+ carry)
//   InterPodAffinity   ksim_tpu/plugins/interpodaffinity.py   filter, score, normalize (+ carries)
// plus the weight (core.py _final_from_raw) and _select's tie rule.
//
// Per pod, in phases separated by barriers:
//   0. setup: image weights, the pod's spread constraints staged, its
//      per-domain scratch zeroed;
//   1. PodTopologySpread's filter statistics: per DoNotSchedule constraint,
//      per-domain sums of the carried counts over eligible nodes (integer
//      atomics) and, reduced over the block, the present-domain count and
//      the least domain sum;
//   2. every filter, per node: the feasible mask and the reason codes;
//   (kernel C: the visit window from the rotating start, by prefix
//      counts over the cluster; the feasible mask becomes the sampled
//      mask; under record="selection" the filters run only on the nodes
//      the window visits;)
//   3. PodTopologySpread's score statistics: the domains registered among
//      the feasible (sampled) nodes, then the contributions of eligible
//      nodes in registered domains, and the registered-domain count;
//   4. every score, per node, and the normalize extrema (block reduce);
//   5. the normalizes (PodTopologySpread's and InterPodAffinity's raw
//      scores are recomputed here rather than kept per node), the total
//      and selectHost's block argmax.
// A domain sum of a singleton key (every domain one node: hostname) is
// the node's own value, so such keys need no domain array.  Under
// record="selection" a cluster team does no work the record never holds:
// no filter on an invalid node, no score on an infeasible one (only
// InterPodAffinity's "any nonzero raw", which runs over every node).
//
// Numerics, each flagged where it is handled:
//  - DIVISION: the reference's `//` floors, C++ `/` truncates.  Integer
//    divisions here are reached only with a non-negative numerator and a
//    positive denominator, where the two agree, or go through floordiv.
//  - WRAP: the reference's int32 arithmetic wraps; where a value could
//    leave int32 it is computed in unsigned 32-bit arithmetic, which wraps
//    the same way, instead of in signed arithmetic, where overflow is
//    undefined.
//  - FLOAT: correctly rounded __f*_rn / __d*_rn intrinsics throughout
//    (and the build passes --fmad=false), so no a*b+c is contracted into
//    an FMA that the reference rounds twice; rounding to an integer is
//    half to even (__double2int_rn / __float2int_rn), as jnp.round.
//  - ORDER: float sums run in the reference's order (resource order for
//    BalancedAllocation, image-index order for ImageLocality, constraint
//    order for PodTopologySpread).
//  - TIES: selectHost takes the max total, ties to the LOWEST node index;
//    padding nodes (valid == false) are never feasible and never enter a
//    normalize extremum.  The replay kernel (D) breaks ties by the minimal
//    canonical rank instead (eval_pod_team's RANKED).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace ksim {

enum Plugin : int {
  UNSCHED = 0,
  NODENAME = 1,
  TAINT = 2,
  AFFINITY = 3,
  PORTS = 4,
  FIT = 5,
  BALANCED = 6,
  IMAGE = 7,
  VOLRESTR = 8,
  VOLLIMITS = 9,
  VOLBIND = 10,
  VOLZONE = 11,
  SPREAD = 12,
  INTERPOD = 13,
  // The score samples (plugins/samples/nodenumber.py).  DataProviderScore
  // may be enabled under several names: its instances are the dp_* table,
  // and its s_row / weight entries stay unset.
  NODENUMBER = 14,
  DATAPROVIDER = 15,
  NPLUGINS = 16,
};

enum FitStrategy : int { LEAST = 0, MOST = 1, RTCR = 2 };

constexpr int MAX_NODE_SCORE = 100;
constexpr int IPA_IN_RANGE = INT_MAX / MAX_NODE_SCORE;
constexpr double MB = 1024.0 * 1024.0;
constexpr double MIN_THRESHOLD = 23.0 * MB;
constexpr double MAX_CONTAINER_THRESHOLD = 1000.0 * MB;

// Every field is 8 bytes wide (a pointer or a long long), so the ctypes
// mirror in kernels/chain.py has no padding to agree on.
struct ChainParams {
  // Node state [N] / [N, R].  requested, nz_requested, pod_count and the
  // plugin carries below are written by the scan kernels' commit (the
  // wrappers pass fresh copies).
  const int32_t* alloc;
  const int32_t* allowed;
  const uint8_t* nvalid;
  const uint8_t* unsched;
  int32_t* requested;
  int32_t* nz_requested;
  int32_t* pod_count;
  // The pod chunk, [Pc] / [Pc, R]; pindex rows the per-pod aux tensors.
  const int32_t* preq;
  const int32_t* pnz;
  const uint8_t* pvalid;
  const uint8_t* ptol;
  const uint8_t* phas;
  const int32_t* pindex;
  // NodeName
  const int32_t* pod_req_node;  // [P]
  // TaintToleration
  const int32_t* taint_order;  // [N, W] position + 1, 0 = absent
  const uint8_t* forbidding;  // [W]
  const uint8_t* prefer;  // [W]
  const uint8_t* pod_tolerated;  // [P, W]
  const uint8_t* pod_tolerated_prefer;  // [P, W]
  // NodeAffinity
  const uint8_t* term_ok;  // [N, T]
  const int32_t* selector_term;  // [P]
  const uint8_t* has_required;  // [P]
  const uint8_t* required_terms;  // [P, T]
  const int32_t* preferred_weights;  // [P, T]
  const uint8_t* added_terms;  // [T]
  const uint8_t* has_added;  // [1]
  const int32_t* added_pref;  // [T]
  // NodePorts
  int32_t* port_counts;  // [N, V] carry
  const uint8_t* pod_wants;  // [P, V]
  const int32_t* pod_adds;  // [P, V]
  // ImageLocality
  const uint8_t* node_has_image;  // [N, I]
  const double* image_size;  // [I]
  const int32_t* image_num_nodes;  // [I]
  const double* total_nodes_f;  // scalar
  const int32_t* pod_image_count;  // [P, I]
  const int32_t* pod_num_containers;  // [P]
  // VolumeBinding, VolumeZone
  const uint8_t* pv_node_ok;  // [NPV, N]
  const uint8_t* pv_zone_ok;  // [NPV, N]
  const uint8_t* pvc_cand_ok;  // [NC, N]
  const uint8_t* pvc_provisionable;  // [NC]
  const uint8_t* pod_pv;  // [P, NPV]
  const uint8_t* pod_wffc;  // [P, NC]
  const int32_t* pod_fail;  // [P]
  // NodeVolumeLimits
  int32_t* attached;  // [N, VV] carry
  const int32_t* vol_limits;  // [N, NK], -1 = unlimited
  const int32_t* vol_key;  // [VV] pool id
  const uint8_t* pod_vol;  // [P, VV]
  // VolumeRestrictions
  int32_t* rwop;  // [N, RW] carry
  int32_t* disk_any;  // [N, DD] carry
  int32_t* disk_rw;  // [N, DD] carry
  const uint8_t* pod_rwop;  // [P, RW]
  const uint8_t* pod_disk_any;  // [P, DD]
  const uint8_t* pod_disk_rw;  // [P, DD]
  const uint8_t* disk_shareable;  // [DD]
  // PodTopologySpread
  const int32_t* sp_ldom;  // [N, TK] local domain id, -1 = key missing
  int32_t* sp_counts;  // [N, SS] carry
  const uint8_t* sp_sel_match;  // [P, SS]
  const uint8_t* con_valid;  // [P, MC]
  const int32_t* con_mode;  // [P, MC] 0 DoNotSchedule, 1 ScheduleAnyway
  const int32_t* con_sel;  // [P, MC]
  const int32_t* con_tk;  // [P, MC]
  const int32_t* con_max_skew;  // [P, MC]
  const int32_t* con_min_domains;  // [P, MC]
  const uint8_t* con_self;  // [P, MC]
  const uint8_t* con_honor_aff;  // [P, MC]
  const uint8_t* con_honor_taints;  // [P, MC]
  const uint8_t* has_score_con;  // [P]
  const void* sp_logw;  // [N + 1] log(k + 2): double (exact) or float
  int32_t* sp_scratch;  // [grid, 4 * MC * DMAX] when not in shared memory
  // InterPodAffinity
  const int32_t* ipa_dom;  // [N, T2] domain per term, -1 = key missing
  int32_t* ipa_cnt;  // [N, T2] carry
  int32_t* ipa_ecnt;  // [N, T2] carry
  int32_t* ipa_ew;  // [N, T2] carry
  int32_t* ipa_total;  // [T2] carry
  const int32_t* ipa_term_tk;  // [T2]
  const uint8_t* ipa_qm;  // [P, T2]
  const uint8_t* ipa_raff;  // [P, T2]
  const uint8_t* ipa_ranti;  // [P, T2]
  const uint8_t* ipa_self_aff;  // [P]
  const int32_t* ipa_pref_w;  // [P, T2]
  const int32_t* ipa_vw;  // [P, T2]
  const int32_t* ipa_eat;  // [P, T2]
  // Sampling (kernel C): the rotating start [1] (in/out), visited [Pc, N].
  int32_t* samp_start;
  uint8_t* visited_out;
  // Outputs: selected [Pc]; by record mode total [Pc, N] i32,
  // final [Pc, S, N], bits [Pc, F, N], raw [Pc, S, N] in the element
  // sizes below.
  int32_t* selected;
  int32_t* total;
  void* final_out;
  void* bits_out;
  void* raw_out;
  // NodeNumber: the trailing digits (-1 = no digit suffix).
  const int32_t* nn_node;  // [N]
  const int32_t* nn_pod;  // [P]
  // DataProviderScore: each instance's provided score, in dp_row order.
  const int32_t* dp_score;  // [dp_n, N]
  // Shapes.
  long long N, R, W, T, V, I, Pc, F, S;
  long long record;  // 0 = selection, 1 = final, 2 = full
  long long bits_size, final_size, raw_size;  // bytes per element
  long long exact;  // 1: int64 BalancedAllocation, f64 ImageLocality / spread weight
  long long NPV, NC, VV, NK, RW, DD;
  long long TK, SS, MC, DMAX, sp_smem;
  long long T2, TKI;
  long long n_real, samp_k;
  long long nn_reverse, dp_n;
  // Per plugin id: its row in bits (-1 = filter off; NodeVolumeLimits'
  // instances have theirs in nvl_row), its row in raw/final (-1 = score
  // off), its weight.
  long long f_row[NPLUGINS];
  long long s_row[NPLUGINS];
  long long weight[NPLUGINS];
  // The profile's tables, device arrays sized by the profile
  // (kernels/chain.py profile_tables).
  // NodeResourcesFit: score resources and weights, the shape points.
  const int32_t* fit_spec_idx;  // [fit_nspec]
  const int32_t* fit_spec_w;  // [fit_nspec]
  const int32_t* shape_u;  // [fit_nshape]
  const int32_t* shape_s;  // [fit_nshape]
  // NodeResourcesBalancedAllocation's resources.
  const int32_t* bal_spec;  // [bal_nspec]
  // NodeVolumeLimits instances in filter order (NodeVolumeLimits itself
  // and the legacy per-pool EBSLimits, GCEPDLimits, ...): each one's row
  // in bits and its pools, nvl_pools[nvl_pool_off[q], nvl_pool_off[q + 1]).
  const int32_t* nvl_row;  // [nvl_ninst]
  const int32_t* nvl_pool_off;  // [nvl_ninst + 1]
  const int32_t* nvl_pools;
  // PodTopologySpread: per topology key, singleton or not, domain count.
  const int32_t* tk_singleton;  // [sp_ntk]
  const int32_t* tk_size;  // [sp_ntk]
  // DataProviderScore instances in score order: each one's row in
  // raw/final and its weight.
  const int32_t* dp_row;  // [dp_n]
  const int32_t* dp_w;  // [dp_n]
  long long fit_base_count, fit_strategy, fit_nspec, fit_nshape, bal_nspec, nvl_ninst, sp_ntk;
};

// Per-node flag bits kept in shared memory between phases.
constexpr uint8_t FL_OK = 1;  // feasible (kernel C: feasible and visited)
constexpr uint8_t FL_AFF = 2;  // pod's nodeSelector + required node affinity match
constexpr uint8_t FL_TNT = 4;  // no untolerated NoSchedule/NoExecute taint
constexpr uint8_t FL_VIS = 8;  // kernel C, record="selection": filtered (FL_AFF / FL_TNT hold)

// Block-reduction slots (see block_reduce) and the prefix-count scratch.
constexpr int RED_MAX = 24;
constexpr int SCAN_INTS = 64;

// SpreadCon::flags.
constexpr unsigned CF_F = 1;  // a valid DoNotSchedule constraint
constexpr unsigned CF_S = 2;  // a valid ScheduleAnyway constraint
constexpr unsigned CF_SINGLE = 4;  // a singleton key (or one outside the key vocabulary)
constexpr unsigned CF_SELF = 8;  // the pod matches its own selector
constexpr unsigned CF_HAFF = 16;  // nodeAffinityPolicy Honor
constexpr unsigned CF_HTNT = 32;  // nodeTaintsPolicy Honor

// One PodTopologySpread constraint of the pod under evaluation, in shared
// memory (stage_spread), with the statistics phases 1 and 3 give it.
struct SpreadCon {
  int key;  // topology key
  int sel;  // selector context
  int max_skew, min_domains;
  int dsize;  // the key's domain count (0: singleton)
  unsigned flags;  // CF_*
  int min_match;  // phase 1
  int dom_num;  // phase 3
};

// Dynamic shared memory: per-node values carried from one phase to the
// next (one per node slot), the pod's image weights and spread
// constraints, the reduction scratch and, when it fits, the pod's
// per-domain scratch.
struct Smem {
  int32_t* raw_taint;  // [slots]
  int32_t* raw_aff;  // [slots]
  int32_t* partial;  // [slots] sum of the unnormalized finals
  uint8_t* flags;  // [slots] FL_* bits
  double* imgw;  // [I] (float in f32 mode, in the same slots)
  unsigned long long* red64;  // [33]
  int* red;  // [33 * RED_MAX]
  int* scan;  // [SCAN_INTS]
  SpreadCon* con;  // [MC]
  // [4 * MC * DMAX] each (DomPart): `dom` takes this block's atomics,
  // `domc` is what the chain reads.  The block layout has one array (domc
  // == dom); a cluster sums every block's dom into its own domc.
  int* dom;
  int* domc;
  // Cluster only (null in the block layout): this block's reduction
  // partials and prefix-count words, two of each (by parity), and its copy
  // of InterPodAffinity's term totals.
  int* cred;  // [2 * RED_MAX]
  unsigned long long* cred64;  // [2]
  int* wcnt;  // [2 * 32]
  unsigned* wmask;  // [2 * 32]
  int32_t* ipa_tot;  // [T2]
};

__host__ __device__ inline long long align8(long long x) { return (x + 7) & ~7LL; }

__host__ __device__ inline long long domain_ints(const ChainParams& P) { return 4 * P.MC * P.DMAX; }

// Narrowing store: the value wraps to the element size, as the
// reference's astype to the recorded dtype does.
__device__ inline void store_int(void* base, long long idx, long long v, long long size) {
  switch (size) {
    case 1: static_cast<int8_t*>(base)[idx] = static_cast<int8_t>(v); break;
    case 2: static_cast<int16_t*>(base)[idx] = static_cast<int16_t>(v); break;
    case 4: static_cast<int32_t*>(base)[idx] = static_cast<int32_t>(v); break;
    default: static_cast<int64_t*>(base)[idx] = static_cast<int64_t>(v); break;
  }
}

// WRAP: int32 arithmetic with the reference's wrap-around.
__device__ inline int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ inline int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ inline int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// The score samples of node n for pod row j (ksim_tpu/plugins/samples/
// nodenumber.py): NodeNumber scores 10 when the pod's and the node's
// trailing digits match (-1, no digit, never matches), 0 otherwise,
// swapped under reverse; a DataProviderScore instance scores its provided
// value.  Neither normalizes (ksim_tpu/engine/core.py _final_from_raw):
// final = raw x weight in int32 with the reference's wrap-around.  Stores
// their records and returns the sum of their finals.  The callers skip
// the call, once per pod, for a profile without them (use_samples).
__device__ inline int sample_scores(const ChainParams& P, long long j, long long n, long long rowS, bool full,
                                    bool finals) {
  const long long N = P.N;
  int partial = 0;
  if (P.s_row[NODENUMBER] >= 0) {
    const int pd = P.nn_pod[j], nd = P.nn_node[n];
    const bool match = pd >= 0 && nd >= 0 && pd == nd;
    const int raw = (match != (P.nn_reverse != 0)) ? 10 : 0;
    const int fin = wrap_mul(raw, static_cast<int>(P.weight[NODENUMBER]));
    partial = wrap_add(partial, fin);
    if (full) store_int(P.raw_out, rowS + P.s_row[NODENUMBER] * N + n, raw, P.raw_size);
    if (finals) store_int(P.final_out, rowS + P.s_row[NODENUMBER] * N + n, fin, P.final_size);
  }
  for (long long q = 0; q < P.dp_n; ++q) {
    const int raw = P.dp_score[q * N + n];
    const int fin = wrap_mul(raw, P.dp_w[q]);
    partial = wrap_add(partial, fin);
    if (full) store_int(P.raw_out, rowS + P.dp_row[q] * N + n, raw, P.raw_size);
    if (finals) store_int(P.final_out, rowS + P.dp_row[q] * N + n, fin, P.final_size);
  }
  return partial;
}

// The reference's `//` for any signs (b != 0).
__device__ inline int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ---- block reductions (every thread gets the result) ----------------------

enum RedOp : int { RSUM = 0, RMAX = 1, RMIN = 2 };

__device__ inline int red_op(int a, int b, int op) {
  return op == RSUM ? a + b : op == RMAX ? max(a, b) : min(a, b);
}

// Reduces v[0..K) across the block, v[k] by op[k] (K <= RED_MAX); every
// thread gets the results in v.  Two barriers: the second publishes the
// results, in a row (32) that the next call writes only after its first
// barrier, which every thread reaches after reading this call's results.
__device__ inline void block_reduce(int* v, const int* op, int K, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int k = 0; k < K; ++k) {
    int x = v[k];
    for (int o = 16; o > 0; o >>= 1) x = red_op(x, __shfl_xor_sync(0xffffffffu, x, o), op[k]);
    if (lane == 0) red[warp * RED_MAX + k] = x;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < K) {
    const int k = threadIdx.x;
    int x = red[k];
    for (int w = 1; w < nw; ++w) x = red_op(x, red[w * RED_MAX + k], op[k]);
    red[32 * RED_MAX + k] = x;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) v[k] = red[32 * RED_MAX + k];
}

__device__ inline unsigned long long warp_max_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ inline unsigned long long block_max_u64(unsigned long long v, unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max_u64(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned long long x = lane < nw ? red[lane] : 0ULL;
    x = warp_max_u64(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// The per-domain parts of Smem::dom: filter sum, filter presence, score
// registration, score sum.
enum DomPart : int { F_SUM = 0, F_PRES = 1, S_REG = 2, S_SUM = 3 };

struct Spread;

// The phases a cluster team times (ClusterTeam::mark): those of a pod,
// then (kernel D) those of a replay step around its pods.  Each
// reduction's phase includes its wait for the cluster's slowest block.
enum Phase : int {
  PH_SETUP = 0,
  PH_SPREAD_F,  // PodTopologySpread's filter statistics
  PH_FILTER,
  PH_WINDOW,  // kernel C's visit window
  PH_SPREAD_S,  // PodTopologySpread's score statistics
  PH_SCORE,
  PH_EX_REDUCE,  // the normalize extrema across the team
  PH_NORMALIZE,  // normalizes, totals, the selection key
  PH_SELECT,  // selectHost's maximum across the team
  PH_COMMIT,  // the commit, up to the next pod
  PH_EVENTS,  // kernel D: a step's events
  PH_QUEUE,  // kernel D: the flush, the backoff test and the queue
  PH_DERIVE,  // kernel D: InterPodAffinity's domain view (row 6)
  PH_SEARCH,  // kernel D: DefaultPreemption's pass and victim searches
  PH_STEP_END,  // kernel D: binds, backoff and the step's outputs
  NPHASES,
};

// selectHost key: the larger total wins, then the LOWER node index.
// 0 means "no feasible node" (every feasible key is > 0).
__device__ inline unsigned long long select_key(int total, long long n) {
  const unsigned int biased = static_cast<unsigned int>(total) ^ 0x80000000u;
  return (static_cast<unsigned long long>(biased) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned int>(n));
}

__device__ inline int key_node(unsigned long long key) {
  return key == 0ULL ? -1
                     : static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key & 0xFFFFFFFFULL));
}

// ---- NodeResourcesFit scores ----------------------------------------------

// helper/shape_score.go BuildBrokenLinearFunction; Go's division
// truncates, and so does C++'s (segment slopes may be negative here).
__device__ inline int broken_linear(const ChainParams& P, int p) {
  const int n = static_cast<int>(P.fit_nshape);
  int res = static_cast<int>(P.shape_s[n - 1]);
  for (int i = n - 1; i >= 0; --i) {
    const int u_i = static_cast<int>(P.shape_u[i]);
    int expr;
    if (i == 0) {
      expr = static_cast<int>(P.shape_s[0]);
    } else {
      const int u_p = static_cast<int>(P.shape_u[i - 1]);
      const int s_p = static_cast<int>(P.shape_s[i - 1]);
      const int s_i = static_cast<int>(P.shape_s[i]);
      expr = s_p + ((s_i - s_p) * (p - u_p)) / (u_i - u_p);
    }
    if (p <= u_i) res = expr;
  }
  return res;
}

__device__ inline int fit_score(const ChainParams& P, long long p, long long n) {
  int node_score = 0, weight_sum = 0;
  for (int k = 0; k < P.fit_nspec; ++k) {
    const long long ri = P.fit_spec_idx[k];
    const int w = static_cast<int>(P.fit_spec_w[k]);
    const int c = P.alloc[n * P.R + ri];
    const int r = P.nz_requested[n * P.R + ri] + P.pnz[p * P.R + ri];
    const bool has = c > 0;
    if (P.fit_strategy == RTCR) {
      // DIVISION: r >= 0 and c > 0 where taken.
      const int util = (has && r <= c) ? (r * MAX_NODE_SCORE) / max(c, 1) : MAX_NODE_SCORE;
      const int s = broken_linear(P, util);
      if (has && s > 0) {
        node_score += s * w;
        weight_sum += w;
      }
    } else {
      int s = 0;
      if (P.fit_strategy == MOST) {
        // DIVISION: min(r, c) >= 0 and c > 0 where taken.
        if (has) s = (min(r, c) * MAX_NODE_SCORE) / max(c, 1);
      } else {
        // DIVISION: c - r >= 0 and c > 0 where taken.
        if (has && r <= c) s = ((c - r) * MAX_NODE_SCORE) / max(c, 1);
      }
      node_score += s * w;
      if (has) weight_sum += w;
    }
  }
  if (weight_sum <= 0) return 0;
  if (P.fit_strategy == RTCR) {
    // math.Round of the weighted mean; DIVISION: both operands > 0.
    const int d = max(weight_sum, 1);
    return (2 * node_score + d) / (2 * d);
  }
  return node_score / max(weight_sum, 1);  // DIVISION: node_score >= 0
}

// ---- NodeResourcesBalancedAllocation --------------------------------------

// Resource k's requested fraction min(r / c, 1) (0 where c <= 0) and
// whether the node has that resource.
__device__ inline float balanced_frac(const ChainParams& P, long long p, long long n, int k, bool& present) {
  const long long ri = P.bal_spec[k];
  const float c = static_cast<float>(P.alloc[n * P.R + ri]);
  const float r = static_cast<float>(P.nz_requested[n * P.R + ri] + P.pnz[p * P.R + ri]);
  present = c > 0.0f;
  const float f = c > 0.0f ? __fdiv_rn(r, fmaxf(c, 1.0f)) : 0.0f;
  return fminf(f, 1.0f);
}

__device__ inline int balanced_score(const ChainParams& P, long long p, long long n) {
  if (P.exact && P.bal_nspec == 2) {
    // Exact rational floor in int64: |r1*c2 - r2*c1| * 50 needs 64 bits.
    const long long i1 = P.bal_spec[0], i2 = P.bal_spec[1];
    const long long c1 = P.alloc[n * P.R + i1], c2 = P.alloc[n * P.R + i2];
    long long r1 = static_cast<long long>(P.nz_requested[n * P.R + i1] + P.pnz[p * P.R + i1]);
    long long r2 = static_cast<long long>(P.nz_requested[n * P.R + i2] + P.pnz[p * P.R + i2]);
    r1 = r1 < c1 ? r1 : c1;
    r2 = r2 < c2 ? r2 : c2;
    if (!(c1 > 0 && c2 > 0)) return MAX_NODE_SCORE;
    long long diff = r1 * c2 - r2 * c1;
    if (diff < 0) diff = -diff;
    const long long num = diff * 50;
    const long long d = c1 * c2 > 1 ? c1 * c2 : 1;
    // DIVISION: num + d - 1 >= 0 and d > 0 (a ceiling written as a floor).
    return static_cast<int>(MAX_NODE_SCORE - (num + d - 1) / d);
  }
  // float32 in the reference's order: fractions, their sum, mean, squared
  // deviations, / count, sqrt, (1 - std) * 100 + 1e-4, floor.  The
  // second pass recomputes each fraction (the same rounded operations), so
  // the chain keeps no per-resource array.
  int count_i = 0;
  float sum = 0.0f;
  for (int k = 0; k < P.bal_nspec; ++k) {
    bool present;
    const float f = balanced_frac(P, p, n, k, present);
    count_i += present ? 1 : 0;
    sum = __fadd_rn(sum, present ? f : 0.0f);
  }
  const float count = static_cast<float>(count_i);
  const float safe = fmaxf(count, 1.0f);
  const float mean = __fdiv_rn(sum, safe);
  float sq = 0.0f;
  for (int k = 0; k < P.bal_nspec; ++k) {
    bool present;
    const float d = __fsub_rn(balanced_frac(P, p, n, k, present), mean);
    sq = __fadd_rn(sq, present ? __fmul_rn(d, d) : 0.0f);
  }
  const float var = __fdiv_rn(sq, safe);
  const float std = count >= 2.0f ? __fsqrt_rn(var) : 0.0f;
  const float v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, std), 100.0f), 1e-4f);
  return static_cast<int>(floorf(v));
}

// ---- ImageLocality --------------------------------------------------------

// The pod's per-image weight trunc(size * numNodes / totalNodes) * count,
// one image per thread, into smem before the node pass.
__device__ inline void image_weights(const ChainParams& P, long long j, Smem& s) {
  for (long long i = threadIdx.x; i < P.I; i += blockDim.x) {
    const int cnt = P.pod_image_count[j * P.I + i];
    if (P.exact) {
      const double spread = __ddiv_rn(static_cast<double>(P.image_num_nodes[i]), *P.total_nodes_f);
      const double scaled = trunc(__dmul_rn(P.image_size[i], spread));
      s.imgw[i] = __dmul_rn(scaled, static_cast<double>(cnt));
    } else {
      const float spread = __fdiv_rn(static_cast<float>(P.image_num_nodes[i]),
                                     static_cast<float>(*P.total_nodes_f));
      const float scaled = truncf(__fmul_rn(static_cast<float>(P.image_size[i]), spread));
      reinterpret_cast<float*>(s.imgw)[i] = __fmul_rn(scaled, static_cast<float>(cnt));
    }
  }
}

// The score from the sum of the weights of the images the node has, and
// the pod's container count (exact: float64; else float32).
__device__ inline int image_from_sum64(double sum, int nc) {
  const double max_t = __dmul_rn(static_cast<double>(nc), MAX_CONTAINER_THRESHOLD);
  const double clamped = fmin(fmax(sum, MIN_THRESHOLD), fmax(max_t, MIN_THRESHOLD));
  const double val = __ddiv_rn(__dmul_rn(100.0, __dsub_rn(clamped, MIN_THRESHOLD)),
                               fmax(__dsub_rn(max_t, MIN_THRESHOLD), 1.0));
  return static_cast<int>(trunc(val));
}

__device__ inline int image_from_sum32(float sum, int nc) {
  const float lo = static_cast<float>(MIN_THRESHOLD);
  const float max_t = __fmul_rn(static_cast<float>(nc), static_cast<float>(MAX_CONTAINER_THRESHOLD));
  const float clamped = fminf(fmaxf(sum, lo), fmaxf(max_t, lo));
  const float val = __fdiv_rn(__fmul_rn(100.0f, __fsub_rn(clamped, lo)), fmaxf(__fsub_rn(max_t, lo), 1.0f));
  return static_cast<int>(truncf(val));
}

__device__ inline int image_score(const ChainParams& P, long long j, long long n, const Smem& s) {
  const uint8_t* has = P.node_has_image + n * P.I;
  const int nc = P.pod_num_containers[j];
  if (P.exact) {
    double sum = 0.0;  // ORDER: image-index order, one add at a time
    for (long long i = 0; i < P.I; ++i)
      if (has[i]) sum = __dadd_rn(sum, s.imgw[i]);
    return image_from_sum64(sum, nc);
  }
  const float* w = reinterpret_cast<const float*>(s.imgw);
  float sum = 0.0f;
  for (long long i = 0; i < P.I; ++i)
    if (has[i]) sum = __fadd_rn(sum, w[i]);
  return image_from_sum32(sum, nc);
}

// ---- TaintToleration / NodeAffinity predicates -----------------------------

// First untolerated NoSchedule/NoExecute taint by node position: its vocab
// index + 1 (lowest index on a tie), 0 when there is none.
__device__ inline int taint_block(const ChainParams& P, long long j, long long n) {
  const int32_t* order = P.taint_order + n * P.W;
  const uint8_t* tol = P.pod_tolerated + j * P.W;
  int first = INT_MAX, widx = 0;
  for (long long w = 0; w < P.W; ++w) {
    const int o = order[w];
    if (o > 0 && P.forbidding[w] && !tol[w] && o < first) {
      first = o;
      widx = static_cast<int>(w);
    }
  }
  return first != INT_MAX ? widx + 1 : 0;
}

// The pod's nodeSelector AND required node affinity (required_affinity_match).
__device__ inline bool affinity_match(const ChainParams& P, long long j, long long n) {
  const uint8_t* tok = P.term_ok + n * P.T;
  const int sel = P.selector_term[j];
  if (sel >= 0 && !tok[sel]) return false;
  if (!P.has_required[j]) return true;
  const uint8_t* req = P.required_terms + j * P.T;
  for (long long t = 0; t < P.T; ++t)
    if (tok[t] && req[t]) return true;
  return false;
}

// ---- volume filters ---------------------------------------------------------

__device__ inline int volume_binding_code(const ChainParams& P, long long j, long long n) {
  bool node_conf = false, bind_conf = false;
  for (long long v = 0; v < P.NPV; ++v)
    node_conf = node_conf || (P.pod_pv[j * P.NPV + v] && !P.pv_node_ok[v * P.N + n]);
  for (long long c = 0; c < P.NC; ++c)
    bind_conf = bind_conf ||
                (P.pod_wffc[j * P.NC + c] && !(P.pvc_cand_ok[c * P.N + n] || P.pvc_provisionable[c]));
  return P.pod_fail[j] + (node_conf ? 4 : 0) + (bind_conf ? 8 : 0);
}

__device__ inline bool volume_zone_conflict(const ChainParams& P, long long j, long long n) {
  for (long long v = 0; v < P.NPV; ++v)
    if (P.pod_pv[j * P.NPV + v] && !P.pv_zone_ok[v * P.N + n]) return true;
  return false;
}

// NodeVolumeLimits instance q at node n: some pool of the instance would
// hold more attached volumes than its limit with the pod's new ones.
__device__ inline bool volume_limits_over(const ChainParams& P, long long q, long long j, long long n) {
  const int32_t* att = P.attached + n * P.VV;
  const uint8_t* uses = P.pod_vol + j * P.VV;
  bool over = false;
  for (long long i = P.nvl_pool_off[q]; i < P.nvl_pool_off[q + 1]; ++i) {
    const long long k = P.nvl_pools[i];
    int used = 0, added = 0;  // attached in the pool; the pod's new ones (dedup'd)
    for (long long v = 0; v < P.VV; ++v) {
      if (P.vol_key[v] != k) continue;
      if (att[v] > 0) used += 1;
      else if (uses[v]) added += 1;
    }
    const int limit = P.vol_limits[n * P.NK + k];
    over = over || (limit >= 0 && used + added > limit);
  }
  return over;
}

__device__ inline int volume_restrictions_code(const ChainParams& P, long long j, long long n) {
  bool rwop = false, disk = false;
  for (long long r = 0; r < P.RW; ++r)
    rwop = rwop || (P.rwop[n * P.RW + r] > 0 && P.pod_rwop[j * P.RW + r]);
  for (long long d = 0; d < P.DD; ++d) {
    const bool any_used = P.disk_any[n * P.DD + d] > 0, rw_used = P.disk_rw[n * P.DD + d] > 0;
    const bool pod_any = P.pod_disk_any[j * P.DD + d], pod_rw = P.pod_disk_rw[j * P.DD + d];
    const bool share = P.disk_shareable[d];
    // EBS never shares; GCE/ISCSI/RBD share only when BOTH uses are read-only.
    disk = disk || (any_used && pod_any && !share) || (any_used && pod_rw && share) ||
           (rw_used && pod_any && !pod_rw && share);
  }
  return (disk ? 1 : 0) + (rwop ? 2 : 0);
}

// ---- PodTopologySpread ------------------------------------------------------

// The pod's constraints as the kernel reads them (Spread::con, staged in
// shared memory by stage_spread): per constraint its key, selector
// context, parameters, CF_* flags and the two per-pod statistics the
// phases compute, so any number of constraints and keys fits.
struct Spread {
  SpreadCon* con;  // [MC]
  bool any_f, any_s;  // some valid DoNotSchedule / ScheduleAnyway constraint
  bool has_score;
};

// Phase 0: constraint c of pod j into con[c] (one thread each); the setup
// barrier publishes them.
__device__ inline void stage_spread(const ChainParams& P, long long j, SpreadCon* con) {
  for (long long c = threadIdx.x; c < P.MC; c += blockDim.x) {
    const long long i = j * P.MC + c;
    SpreadCon x;
    x.key = P.con_tk[i];
    x.sel = P.con_sel[i];
    x.max_skew = P.con_max_skew[i];
    x.min_domains = P.con_min_domains[i];
    const bool single = x.key < 0 || x.key >= P.sp_ntk || P.tk_singleton[x.key] != 0;
    x.dsize = single ? 0 : P.tk_size[x.key];
    unsigned f = single ? CF_SINGLE : 0u;
    if (P.con_valid[i]) f |= P.con_mode[i] == 0 ? CF_F : P.con_mode[i] == 1 ? CF_S : 0u;
    if (P.con_self[i]) f |= CF_SELF;
    if (P.con_honor_aff[i]) f |= CF_HAFF;
    if (P.con_honor_taints[i]) f |= CF_HTNT;
    x.flags = f;
    x.min_match = 0;
    x.dom_num = 0;
    con[c] = x;
  }
}

// After the setup barrier.
__device__ inline Spread spread_pod(const ChainParams& P, long long j, SpreadCon* con) {
  Spread sp{con, false, false, P.has_score_con[j] != 0};
  for (long long c = 0; c < P.MC; ++c) {
    sp.any_f = sp.any_f || (con[c].flags & CF_F);
    sp.any_s = sp.any_s || (con[c].flags & CF_S);
  }
  return sp;
}

// The node's local domain for key k, -1 when it misses the key (or k is
// outside the key vocabulary).
__device__ inline int sp_ldom(const ChainParams& P, long long n, int k) {
  return (k >= 0 && k < P.TK) ? P.sp_ldom[n * P.TK + k] : -1;
}

// The carried matching-pod count for a constraint's selector context.
__device__ inline int sp_count(const ChainParams& P, const SpreadCon& c, long long n) {
  return (c.sel >= 0 && c.sel < P.SS) ? P.sp_counts[n * P.SS + c.sel] : 0;
}

// Inclusion policies (nodeAffinityPolicy / nodeTaintsPolicy Honor).
__device__ inline bool sp_policy(const ChainParams& P, const SpreadCon& c, long long n, uint8_t fl) {
  return P.nvalid[n] && (!(c.flags & CF_HAFF) || (fl & FL_AFF)) && (!(c.flags & CF_HTNT) || (fl & FL_TNT));
}

// Every constraint with flag `kind` (CF_F or CF_S) has its key on the node.
__device__ inline bool sp_allkeys(const ChainParams& P, const Spread& sp, unsigned kind, long long n) {
  for (long long c = 0; c < P.MC; ++c)
    if ((sp.con[c].flags & kind) && sp_ldom(P, n, sp.con[c].key) < 0) return false;
  return true;
}

// Part `part` of constraint c's per-domain arrays in `base` (Smem::dom or
// Smem::domc).
__device__ inline int* dom_part(const ChainParams& P, int* base, int part, long long c) {
  return base + (part * P.MC + c) * P.DMAX;
}

// The pod's nodeSelector / required node affinity and taint flags at n
// (the teams' node_flags, but kernel B's, which reads its node summary).
__device__ inline uint8_t node_flags(const ChainParams& P, long long j, long long n) {
  return (affinity_match(P, j, n) ? FL_AFF : 0) | (taint_block(P, j, n) == 0 ? FL_TNT : 0);
}

// The statistics reduce the constraints a group of SP_GROUP at a time
// (team.reduce takes at most RED_MAX values).
constexpr int SP_GROUP = RED_MAX / 2;

// Filter phase 1: con[c].min_match per DoNotSchedule constraint (0 where
// unused), published to the team by the closing barrier.
template <class Team>
__device__ inline void spread_filter_stats(const ChainParams& P, const Spread& sp, long long j, Smem& s, Team& team) {
  const int MC = static_cast<int>(P.MC);
  for (int c0 = 0; c0 < MC; c0 += SP_GROUP) {
    const int G = min(SP_GROUP, MC - c0);
    int v[2 * SP_GROUP], op[2 * SP_GROUP];
    for (int g = 0; g < G; ++g) {
      v[g] = 0;  // present domains
      op[g] = RSUM;
      v[G + g] = INT_MAX;  // least present-domain sum
      op[G + g] = RMIN;
    }
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= P.N) continue;
      if (!sp_allkeys(P, sp, CF_F, n)) continue;
      const uint8_t fl = team.node_flags(P, j, n);
      for (int g = 0; g < G; ++g) {
        const SpreadCon& c = sp.con[c0 + g];
        if (!(c.flags & CF_F)) continue;
        const int l = sp_ldom(P, n, c.key);
        if (l < 0 || !sp_policy(P, c, n, fl)) continue;  // not stat-eligible
        const int x = sp_count(P, c, n);
        if (c.flags & CF_SINGLE) {
          v[g] += 1;
          v[G + g] = min(v[G + g], x);
        } else {
          atomicAdd(dom_part(P, s.dom, F_SUM, c0 + g) + l, x);
          dom_part(P, s.dom, F_PRES, c0 + g)[l] = 1;
        }
      }
    }
    team.domains(P, sp, s, CF_F, F_SUM, 2, c0, c0 + G);
    if (team.leader()) {
      for (int g = 0; g < G; ++g) {
        const SpreadCon& c = sp.con[c0 + g];
        if (!(c.flags & CF_F) || (c.flags & CF_SINGLE)) continue;
        for (long long d = threadIdx.x; d < c.dsize; d += blockDim.x) {
          if (!dom_part(P, s.domc, F_PRES, c0 + g)[d]) continue;
          v[g] += 1;
          v[G + g] = min(v[G + g], dom_part(P, s.domc, F_SUM, c0 + g)[d]);
        }
      }
    }
    team.reduce(v, op, 2 * G, s);
    if (static_cast<int>(threadIdx.x) < G) {
      const int g = threadIdx.x;
      SpreadCon& c = sp.con[c0 + g];
      const int dom_num = v[g];
      int mm = dom_num > 0 ? v[G + g] : 0;
      if (c.min_domains > 0 && dom_num < c.min_domains) mm = 0;
      c.min_match = mm;
    }
  }
  __syncthreads();
}

// Filter phase 2: the reason code at node n (first failing constraint).
__device__ inline int spread_filter_code(const ChainParams& P, const Spread& sp, const Smem& s, long long n,
                                         uint8_t fl) {
  const bool allkeys = sp_allkeys(P, sp, CF_F, n);
  for (long long ci = 0; ci < P.MC; ++ci) {
    const SpreadCon& c = sp.con[ci];
    if (!(c.flags & CF_F)) continue;
    const int l = sp_ldom(P, n, c.key);
    if (l < 0) return 2;  // MISSING_LABEL_BIT
    int seg;
    if (c.flags & CF_SINGLE) {
      seg = (allkeys && sp_policy(P, c, n, fl)) ? sp_count(P, c, n) : 0;
    } else {
      seg = dom_part(P, s.domc, F_SUM, ci)[l];
    }
    const int skew = seg + ((c.flags & CF_SELF) ? 1 : 0) - c.min_match;
    if (skew > c.max_skew) return 1;  // SKEW_BIT
  }
  return 0;
}

// Score phase 3: con[c].dom_num, the registered-domain counts (published
// by the closing barrier); fills the score sums.  With `lazy`, a node's
// FL_AFF / FL_TNT hold only where FL_VIS is set (kernel C under
// record="selection" filters the visited nodes alone), and are computed
// here for the others the contributions reach.
template <class Team>
__device__ inline void spread_score_stats(const ChainParams& P, const Spread& sp, long long j, Smem& s, Team& team,
                                          bool lazy) {
  const int MC = static_cast<int>(P.MC);
  for (int c0 = 0; c0 < MC; c0 += 2 * SP_GROUP) {
    const int G = min(2 * SP_GROUP, MC - c0);
    int v[2 * SP_GROUP], op[2 * SP_GROUP];
    for (int g = 0; g < G; ++g) {
      v[g] = 0;
      op[g] = RSUM;
    }
    // Domains present among feasible, non-ignored nodes.
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= P.N || !(s.flags[li] & FL_OK) || !sp_allkeys(P, sp, CF_S, n)) continue;
      for (int g = 0; g < G; ++g) {
        const SpreadCon& c = sp.con[c0 + g];
        if (!(c.flags & CF_S)) continue;
        const int l = sp_ldom(P, n, c.key);
        if (l < 0) continue;
        if (c.flags & CF_SINGLE) v[g] += 1;
        else dom_part(P, s.dom, S_REG, c0 + g)[l] = 1;
      }
    }
    team.domains(P, sp, s, CF_S, S_REG, 1, c0, c0 + G);
    // Contributions of policy-passing nodes in registered domains.
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= P.N) continue;
      uint8_t fl = s.flags[li];
      for (int g = 0; g < G; ++g) {
        const SpreadCon& c = sp.con[c0 + g];
        if (!(c.flags & CF_S) || (c.flags & CF_SINGLE)) continue;
        const int l = sp_ldom(P, n, c.key);
        if (l < 0 || !dom_part(P, s.domc, S_REG, c0 + g)[l]) continue;
        if (lazy && !(fl & FL_VIS) && P.nvalid[n]) fl = team.node_flags(P, j, n) | FL_VIS;
        if (sp_policy(P, c, n, fl)) atomicAdd(dom_part(P, s.dom, S_SUM, c0 + g) + l, sp_count(P, c, n));
      }
    }
    if (team.leader()) {
      for (int g = 0; g < G; ++g) {
        const SpreadCon& c = sp.con[c0 + g];
        if (!(c.flags & CF_S) || (c.flags & CF_SINGLE)) continue;
        for (long long d = threadIdx.x; d < c.dsize; d += blockDim.x) v[g] += dom_part(P, s.domc, S_REG, c0 + g)[d];
      }
    }
    team.reduce(v, op, G, s);  // its barriers also publish the atomics
    team.domains_after_reduce(P, sp, s, CF_S, S_SUM, c0, c0 + G);
    if (static_cast<int>(threadIdx.x) < G) sp.con[c0 + threadIdx.x].dom_num = v[threadIdx.x];
  }
  __syncthreads();
}

// The raw score at node n: sum over constraints, in constraint order, of
// seg * log(dom_num + 2) + (maxSkew - 1) where gated, rounded half to even.
__device__ inline int spread_raw(const ChainParams& P, const Spread& sp, const Smem& s, long long n, uint8_t fl) {
  if (!sp.has_score) return 0;
  const bool filtered = (fl & FL_OK) && sp_allkeys(P, sp, CF_S, n);
  double total64 = 0.0;
  float total32 = 0.0f;
  for (long long ci = 0; ci < P.MC; ++ci) {
    const SpreadCon& c = sp.con[ci];
    int seg = 0;
    const bool gate = (c.flags & CF_S) && filtered;
    if (gate) {
      const int l = sp_ldom(P, n, c.key);
      if (l >= 0) {
        if (c.flags & CF_SINGLE) seg = sp_policy(P, c, n, fl) ? sp_count(P, c, n) : 0;
        else seg = dom_part(P, s.domc, S_SUM, ci)[l];
      }
    }
    const long long w = min(max(static_cast<long long>(c.dom_num), 0LL), P.N);
    if (P.exact) {
      const double wt = static_cast<const double*>(P.sp_logw)[w];
      const double v = gate ? __dadd_rn(__dmul_rn(static_cast<double>(seg), wt),
                                        __dsub_rn(static_cast<double>(c.max_skew), 1.0))
                            : 0.0;
      total64 = ci == 0 ? v : __dadd_rn(total64, v);
    } else {
      const float wt = static_cast<const float*>(P.sp_logw)[w];
      const float v = gate ? __fadd_rn(__fmul_rn(static_cast<float>(seg), wt),
                                       __fsub_rn(static_cast<float>(c.max_skew), 1.0f))
                           : 0.0f;
      total32 = ci == 0 ? v : __fadd_rn(total32, v);
    }
  }
  return P.exact ? __double2int_rn(total64) : __float2int_rn(total32);
}

// ---- InterPodAffinity -------------------------------------------------------

struct Interpod {
  long long base;  // j * T2
  bool filter, score;
  bool escape;  // no matching pod anywhere and the pod matches its own terms
  bool raff;  // the pod has required affinity terms
};

// `total` is the term totals the team reads (ipa_total, or a cluster
// block's copy of it; null when InterPodAffinity is off).
__device__ inline Interpod interpod_pod(const ChainParams& P, long long j, const int32_t* total) {
  Interpod ip;
  ip.base = j * P.T2;
  bool any_raff = false, any_ranti = false, any_qm = false, any_pref = false;
  unsigned total_req = 0;  // WRAP: the reference's int32 dot
  for (long long t = 0; t < P.T2; ++t) {
    const bool raff = P.ipa_raff[ip.base + t], qm = P.ipa_qm[ip.base + t];
    any_raff = any_raff || raff;
    any_ranti = any_ranti || P.ipa_ranti[ip.base + t];
    any_qm = any_qm || qm;
    any_pref = any_pref || P.ipa_pref_w[ip.base + t] != 0;
    if (raff && total != nullptr) total_req += static_cast<unsigned>(total[t]);
  }
  ip.filter = any_raff || any_ranti || any_qm;
  ip.score = any_pref || any_qm;
  ip.raff = any_raff;
  ip.escape = static_cast<int>(total_req) == 0 && P.ipa_self_aff[j];
  return ip;
}


// The pod's required affinity terms admit node n (true without any).
__device__ inline bool interpod_aff_pass(const ChainParams& P, const Interpod& ip, long long n) {
  if (!ip.raff) return true;
  const int32_t* dom = P.ipa_dom + n * P.T2;
  const int32_t* cnt = P.ipa_cnt + n * P.T2;
  bool missing = false, no_pods = false;
  for (long long t = 0; t < P.T2; ++t) missing = missing || (P.ipa_raff[ip.base + t] && dom[t] < 0);
  // Required terms sharing a topology key share one count.
  for (long long k = 0; k < P.TKI && !no_pods; ++k) {
    bool need = false;
    unsigned key_cnt = 0;  // WRAP
    for (long long t = 0; t < P.T2; ++t) {
      if (!P.ipa_raff[ip.base + t] || P.ipa_term_tk[t] != k) continue;
      need = true;
      key_cnt += static_cast<unsigned>(cnt[t]);
    }
    no_pods = need && static_cast<int>(key_cnt) <= 0;
  }
  return !missing && (!no_pods || ip.escape);
}

// The reason code at node n; checks in upstream order.
__device__ inline int interpod_code(const ChainParams& P, const Interpod& ip, long long n) {
  const int32_t* cnt = P.ipa_cnt + n * P.T2;
  const int32_t* ecnt = P.ipa_ecnt + n * P.T2;
  if (!interpod_aff_pass(P, ip, n)) return 1;
  for (long long t = 0; t < P.T2; ++t)
    if (cnt[t] > 0 && P.ipa_ranti[ip.base + t]) return 2;
  for (long long t = 0; t < P.T2; ++t)
    if (ecnt[t] > 0 && P.ipa_qm[ip.base + t]) return 4;
  return 0;
}

__device__ inline int interpod_raw(const ChainParams& P, const Interpod& ip, long long n) {
  if (!ip.score) return 0;
  unsigned acc = 0;  // WRAP: two int32 dots
  for (long long t = 0; t < P.T2; ++t) {
    acc += static_cast<unsigned>(P.ipa_cnt[n * P.T2 + t]) * static_cast<unsigned>(P.ipa_pref_w[ip.base + t]);
    if (P.ipa_qm[ip.base + t]) acc += static_cast<unsigned>(P.ipa_ew[n * P.T2 + t]);
  }
  return static_cast<int>(acc);
}

// NormalizeScore at a feasible node, given min/max over the feasible ones.
__device__ inline int interpod_norm(const ChainParams& P, int raw, int mn, int mx) {
  const int diff = wrap_sub(mx, mn);
  if (diff <= 0) return 0;
  const int shifted = wrap_sub(raw, mn);  // 0 <= shifted <= diff here
  if (shifted < IPA_IN_RANGE) return (shifted * MAX_NODE_SCORE) / diff;  // DIVISION: both >= 0
  if (P.exact)
    return static_cast<int>(floor(__dmul_rn(100.0, __ddiv_rn(static_cast<double>(shifted), static_cast<double>(diff)))));
  return static_cast<int>(floorf(__fmul_rn(100.0f, __fdiv_rn(static_cast<float>(shifted), static_cast<float>(diff)))));
}

// ---- TaintToleration / NodeAffinity scores and the normalizes ----------------
//
// The phases of a pod that eval_pod_team (kernels A, C, D) and kernel E
// (chain_stages.cu) both run, one node or one value at a time.

// TaintToleration's raw score at node n: the node's PreferNoSchedule taints
// the pod does not tolerate.
__device__ inline int taint_prefer_count(const ChainParams& P, long long j, long long n) {
  const int32_t* order = P.taint_order + n * P.W;
  const uint8_t* tolp = P.pod_tolerated_prefer + j * P.W;
  int c = 0;
  for (long long w = 0; w < P.W; ++w) c += (order[w] > 0 && P.prefer[w] && !tolp[w]) ? 1 : 0;
  return c;
}

// NodeAffinity's raw score at node n: the weights of the preferred and
// added terms the node satisfies.  The weight sum is at most 100 per term:
// it fits in 32 bits.
__device__ inline long long affinity_pref_sum(const ChainParams& P, long long j, long long n) {
  const uint8_t* tok = P.term_ok + n * P.T;
  const int32_t* pw = P.preferred_weights + j * P.T;
  long long sc = 0;
  for (long long t = 0; t < P.T; ++t)
    if (tok[t]) sc += pw[t] + P.added_pref[t];
  return sc;
}

// TaintToleration's normalize, the reverse DefaultNormalizeScore over the
// maximum mx of the feasible raw scores; DIVISION: raw >= 0, max > 0.
__device__ inline int taint_norm(int raw, int mx) {
  return mx > 0 ? MAX_NODE_SCORE - (MAX_NODE_SCORE * raw) / mx : MAX_NODE_SCORE;
}

// NodeAffinity's normalize, DefaultNormalizeScore; DIVISION: raw >= 0, max > 0.
__device__ inline int affinity_norm(long long raw, long long mx) {
  return static_cast<int>(mx > 0 ? (static_cast<long long>(MAX_NODE_SCORE) * raw) / mx : raw);
}

// PodTopologySpread's normalize at a node that is not ignored, given the
// maximum and minimum over the scoreable nodes: WRAP, then a real floor
// division, the reference's int32 math.
__device__ inline int spread_norm(int raw, int mx, int mn) {
  return mx == 0 ? MAX_NODE_SCORE
                 : floordiv(wrap_mul(MAX_NODE_SCORE, wrap_sub(wrap_add(mx, mn), raw)), max(mx, 1));
}

// PodTopologySpread scores node n: the pod has a ScheduleAnyway
// constraint and the node carries every one of their keys.
__device__ inline bool spread_scoreable(const ChainParams& P, const Spread& sp, long long n) {
  return sp.has_score && sp_allkeys(P, sp, CF_S, n);
}

// One pod's extrema the normalizes read, folded a node at a time by each
// thread and reduced over the team (eval_pod_team's phases 4-5 and kernel
// E's normalize stage): taint max, affinity max, spread max / min / any
// over the scoreable nodes, interpod max / min / any over the feasible
// nodes, interpod any nonzero over all nodes.
struct NormExtrema {
  int v[9] = {0, 0, INT_MIN, INT_MAX, 0, INT_MIN, INT_MAX, 0, 0};

  __device__ void taint(int raw, bool ok) {
    if (ok) v[0] = max(v[0], raw);
  }
  __device__ void affinity(int raw, bool ok) {
    if (ok) v[1] = max(v[1], raw);
  }
  // `counted`: a feasible node that is scoreable.
  __device__ void spread(int raw, bool counted) {
    if (counted) {
      v[2] = max(v[2], raw);
      v[3] = min(v[3], raw);
      v[4] = 1;
    }
  }
  __device__ void interpod(int raw, bool ok) {
    if (ok) {
      v[5] = max(v[5], raw);
      v[6] = min(v[6], raw);
      v[7] = 1;
    }
    if (raw != 0) v[8] = 1;
  }
  template <class Team>
  __device__ void reduce(Team& team, Smem& s) {
    const int op[9] = {RMAX, RMAX, RMAX, RMIN, RMAX, RMAX, RMIN, RMAX, RMAX};
    team.reduce(v, op, 9, s);
  }

  // The normalizes, before the weight (after reduce).  The spread and
  // interpod ones take their raw score as a callable, evaluated only at
  // the nodes they normalize.
  __device__ int taint_norm(int raw) const { return ksim::taint_norm(raw, v[0]); }
  __device__ int affinity_norm(long long raw) const { return ksim::affinity_norm(raw, v[1]); }
  template <class Raw>
  __device__ int spread_norm(const ChainParams& P, const Spread& sp, long long n, Raw raw) const {
    return spread_scoreable(P, sp, n) ? ksim::spread_norm(raw(), v[4] ? v[2] : 0, v[4] ? v[3] : 0) : 0;
  }
  // spread_norm at a node whose scoreable flag the caller holds (kernel E's
  // normalize stage).
  __device__ int spread_norm_flag(bool scoreable, int raw) const {
    return scoreable ? ksim::spread_norm(raw, v[4] ? v[2] : 0, v[4] ? v[3] : 0) : 0;
  }
  template <class Raw>
  __device__ int interpod_norm(const ChainParams& P, bool ok, Raw raw) const {
    return (v[8] && ok) ? ksim::interpod_norm(P, raw(), v[7] ? v[6] : 0, v[7] ? v[5] : 0) : 0;
  }
};

// ---- sampling (kernel C) ------------------------------------------------------

__device__ inline long long floormod(long long a, long long m) { return ((a % m) + m) % m; }

// ---- one pod against every node -------------------------------------------

// Every filter of the chain for chunk row p (pod j) at node n: the FL_*
// flags, with FL_OK when the node is feasible.  With `record_bits` the
// reason codes go to row rowF of bits_out.  Kernel D's victim search
// calls it alone, for one node, over a modified node state (csrc/
// replay_segment.cu eval_fit).
__device__ inline uint8_t filter_node(const ChainParams& P, long long p, long long j, long long n,
                                      const Smem& s, const Spread& sp, const Interpod& ip, bool sp_filter,
                                      bool record_bits, long long rowF) {
  const long long N = P.N;
  bool ok = P.nvalid[n] != 0;
  const int taint = taint_block(P, j, n);
  const bool aff = affinity_match(P, j, n);
  const uint8_t fl = (aff ? FL_AFF : 0) | (taint == 0 ? FL_TNT : 0);
  if (P.f_row[UNSCHED] >= 0) {
    const bool blocked = P.unsched[n] && !P.ptol[p];
    ok = ok && !blocked;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[UNSCHED] * N + n, blocked, P.bits_size);
  }
  if (P.f_row[NODENAME] >= 0) {
    const int req = P.pod_req_node[j];
    const bool pass = req == -1 || n == req;
    ok = ok && pass;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[NODENAME] * N + n, !pass, P.bits_size);
  }
  if (P.f_row[TAINT] >= 0) {
    ok = ok && taint == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[TAINT] * N + n, taint, P.bits_size);
  }
  if (P.f_row[AFFINITY] >= 0) {
    bool added_ok = true;
    if (P.has_added[0]) {
      const uint8_t* tok = P.term_ok + n * P.T;
      added_ok = false;
      for (long long t = 0; t < P.T; ++t) added_ok = added_ok || (tok[t] && P.added_terms[t]);
    }
    const int bits = (added_ok ? 0 : 2) | (aff ? 0 : 1);
    ok = ok && bits == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[AFFINITY] * N + n, bits, P.bits_size);
  }
  if (P.f_row[PORTS] >= 0) {
    const int32_t* cnt = P.port_counts + n * P.V;
    const uint8_t* wants = P.pod_wants + j * P.V;
    bool conflict = false;
    for (long long v = 0; v < P.V; ++v) conflict = conflict || (cnt[v] > 0 && wants[v]);
    ok = ok && !conflict;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[PORTS] * N + n, conflict, P.bits_size);
  }
  if (P.f_row[FIT] >= 0) {
    int bits = P.pod_count[n] + 1 > P.allowed[n] ? 1 : 0;
    if (P.phas[p]) {
      for (long long r = 0; r < P.R; ++r) {
        const int podr = P.preq[p * P.R + r];
        const bool checked = r < P.fit_base_count || podr > 0;
        const int freev = P.alloc[n * P.R + r] - P.requested[n * P.R + r];
        if (checked && podr > freev) bits |= 1 << (r + 1 < 30 ? r + 1 : 30);
      }
    }
    ok = ok && bits == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[FIT] * N + n, bits, P.bits_size);
  }
  if (P.f_row[BALANCED] >= 0 && record_bits) {
    store_int(P.bits_out, rowF + P.f_row[BALANCED] * N + n, 0, P.bits_size);
  }
  if (P.f_row[VOLRESTR] >= 0) {
    const int code = volume_restrictions_code(P, j, n);
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLRESTR] * N + n, code, P.bits_size);
  }
  for (long long q = 0; q < P.nvl_ninst; ++q) {
    const bool over = volume_limits_over(P, q, j, n);
    ok = ok && !over;
    if (record_bits) store_int(P.bits_out, rowF + P.nvl_row[q] * N + n, over, P.bits_size);
  }
  if (P.f_row[VOLBIND] >= 0) {
    const int code = volume_binding_code(P, j, n);
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLBIND] * N + n, code, P.bits_size);
  }
  if (P.f_row[VOLZONE] >= 0) {
    const bool conflict = volume_zone_conflict(P, j, n);
    ok = ok && !conflict;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLZONE] * N + n, conflict, P.bits_size);
  }
  if (P.f_row[SPREAD] >= 0) {
    const int code = sp_filter ? spread_filter_code(P, sp, s, n, fl) : 0;
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[SPREAD] * N + n, code, P.bits_size);
  }
  if (P.f_row[INTERPOD] >= 0) {
    const int code = ip.filter ? interpod_code(P, ip, n) : 0;
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[INTERPOD] * N + n, code, P.bits_size);
  }
  return fl | (ok ? FL_OK : 0);
}


// Kernel C's visit window from the rotated start sm: the real nodes in
// index order from sm, wrapping, up to the k-th feasible one (all of them
// when fewer are feasible); returns the last visited position (the
// threshold).  The walk goes a cluster tile at a time (team.T nodes of
// index order, every thread one node) in visit order: the tile that holds
// sm from sm on, the tiles after it, wrapping, then that tile's nodes
// before sm; one exchange across the cluster per tile
// (team.piece_find), and the walk stops after the tile that holds the
// k-th feasible node.  When one tile holds every real node, the walk is
// that one tile in rotated order, found in one exchange.  With FILTER
// (record="selection") the walk runs the filters on the nodes it
// reaches and nowhere else (flags stay 0 on the rest), and takes FL_OK
// back from those past the k-th; without, the flags of every node are
// already set and the walk only counts.
template <bool FILTER, class Team>
__device__ inline long long visit_window(const ChainParams& P, long long p, long long j, Smem& s, const Spread& sp,
                                         const Interpod& ip, bool sp_filter, Team& team,
                                         long long sm) {
  const long long nreal = P.n_real, nr = max(nreal, 1LL);
  const long long tiles = (nreal + team.T - 1) / team.T;  // the tiles that hold real nodes
  const long long t0 = sm / team.T;
  long long running = 0;  // feasible nodes visited so far
  for (long long step = 0; step < tiles + (tiles > 1 ? 1 : 0); ++step) {
    const long long tile = (t0 + step) % tiles;
    const long long li = tile * blockDim.x + threadIdx.x;
    const long long n = team.node(li);
    // The nodes of this step: with one tile, all of it (rotated at sm);
    // else the start tile's nodes from sm first and before sm last.
    const bool in = n < nreal && (tiles == 1 || (step == 0 ? n >= sm : step < tiles || n < sm));
    bool f = false;
    if (in) {
      if constexpr (FILTER) {
        const uint8_t fl = P.nvalid[n] ? filter_node(P, p, j, n, s, sp, ip, sp_filter, false, 0) | FL_VIS : 0;
        s.flags[li] = fl;
        f = fl & FL_OK;
      } else {
        f = s.flags[li] & FL_OK;
      }
    }
    long long count;
    const long long nstar = team.piece_find(f, tile, P.samp_k - running, s, count, tiles == 1 ? sm : -1);
    if (nstar >= 0) {
      const long long thr = floormod(nstar - sm, nr);
      if constexpr (FILTER) {
        if (in && floormod(n - sm, nr) > thr) s.flags[li] &= static_cast<uint8_t>(~FL_OK);
      }
      return thr;
    }
    running += count;
  }
  return nreal - 1;
}

// Runs the chain for chunk row p over all N nodes with the team, writes
// the records of P.record (at row orow when one is given: kernel D
// writes attempt k * Q + q), and returns the selected node (-1 when
// none is feasible or the pod is padding) to every thread.  SAMPLED
// (kernel C, a cluster team) narrows the scored set to the visit window
// and advances team.start.  RANKED (kernel D) selects among the max-total
// feasible nodes the one of minimal rank[n] (ksim_tpu/engine/replay.py:
// 942-951): a jnp.argmin over the whole node axis, so the lowest index of
// minimal value wins, non-candidates counting as INT_MAX.
template <bool SAMPLED, bool RANKED, class Team>
__device__ inline int eval_pod_team(const ChainParams& P, long long p, Smem& s, Team& team,
                                    const int32_t* rank, long long orow) {
  static_assert(!SAMPLED || Team::kCluster, "the sampled scan runs on a cluster team");
  const long long N = P.N;
  const long long j = P.pindex[p];
  const bool full = P.record == 2;
  const bool finals = P.record >= 1;
  // No work on pairs the record never holds (cluster teams, selection).
  const bool sparse = Team::kCluster && P.record == 0;
  const long long o = orow < 0 ? p : orow;  // the records' row
  const long long rowF = o * P.F * N;
  const long long rowS = o * P.S * N;
  const bool use_spread = P.f_row[SPREAD] >= 0 || P.s_row[SPREAD] >= 0;
  const bool use_ipa = P.f_row[INTERPOD] >= 0 || P.s_row[INTERPOD] >= 0;
  const bool use_samples = P.s_row[NODENUMBER] >= 0 || P.dp_n > 0;

  // -- phase 0: setup; the barrier also orders the previous pod's commit --
  team.mark(PH_SETUP);
  if (P.s_row[IMAGE] >= 0) image_weights(P, j, s);
  if (use_spread) {
    for (long long i = threadIdx.x; i < domain_ints(P); i += blockDim.x) s.dom[i] = 0;
    stage_spread(P, j, s.con);
  }
  __syncthreads();
  const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
  const Interpod ip = use_ipa ? interpod_pod(P, j, team.ipa_total(P)) : Interpod{0, false, false, false, false};

  // -- phase 1: PodTopologySpread's filter statistics --
  team.mark(PH_SPREAD_F);
  const bool sp_filter = P.f_row[SPREAD] >= 0 && sp.any_f;
  if (sp_filter) spread_filter_stats(P, sp, j, s, team);

  // -- phase 2: filters (every one runs: all reason codes are recorded);
  //    kernel C's visit window --
  team.mark(PH_FILTER);
  long long thr = 0, start = 0;
  if constexpr (SAMPLED) start = team.start;
  if (SAMPLED && sparse) {
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) s.flags[li] = 0;
  } else {
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      s.flags[li] = (sparse && !P.nvalid[n]) ? 0 : filter_node(P, p, j, n, s, sp, ip, sp_filter, full, rowF);
    }
  }
  __syncthreads();
  if constexpr (SAMPLED) {
    team.mark(PH_WINDOW);
    const long long nr = max(P.n_real, 1LL);
    const long long sm = floormod(start, nr);
    if (sparse) {
      thr = visit_window<true>(P, p, j, s, sp, ip, sp_filter, team, sm);
    } else {
      thr = visit_window<false>(P, p, j, s, sp, ip, sp_filter, team, sm);
      for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
        const long long n = team.node(li);
        if (n >= N) continue;
        const bool visited = n < P.n_real && floormod(n - sm, nr) <= thr;
        if (!visited) s.flags[li] &= static_cast<uint8_t>(~FL_OK);
        if (full) P.visited_out[p * N + n] = visited;
      }
    }
    __syncthreads();
  }

  // -- phase 3: PodTopologySpread's score statistics --
  team.mark(PH_SPREAD_S);
  if (P.s_row[SPREAD] >= 0 && sp.has_score) spread_score_stats(P, sp, j, s, team, SAMPLED && sparse);

  // -- phase 4: scores and the normalizes' extrema; the unnormalized
  //    finals are summed right away --
  team.mark(PH_SCORE);
  NormExtrema ex;
  for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= N) continue;
    const uint8_t fl = s.flags[li];
    const bool ok = fl & FL_OK;
    if (sparse && !ok) {
      if (P.s_row[INTERPOD] >= 0) ex.interpod(interpod_raw(P, ip, n), false);
      continue;
    }
    int partial = 0;
    if (P.s_row[TAINT] >= 0) {
      const int c = taint_prefer_count(P, j, n);
      s.raw_taint[li] = c;
      ex.taint(c, ok);
      if (full) store_int(P.raw_out, rowS + P.s_row[TAINT] * N + n, c, P.raw_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      const long long sc = affinity_pref_sum(P, j, n);
      s.raw_aff[li] = static_cast<int>(sc);
      ex.affinity(static_cast<int>(sc), ok);
      if (full) store_int(P.raw_out, rowS + P.s_row[AFFINITY] * N + n, sc, P.raw_size);
    }
    if (P.s_row[FIT] >= 0) {
      const int raw = fit_score(P, p, n);
      const int fin = raw * static_cast<int>(P.weight[FIT]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[FIT] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[FIT] * N + n, fin, P.final_size);
    }
    if (P.s_row[BALANCED] >= 0) {
      const int raw = balanced_score(P, p, n);
      const int fin = raw * static_cast<int>(P.weight[BALANCED]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[BALANCED] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[BALANCED] * N + n, fin, P.final_size);
    }
    if (P.s_row[SPREAD] >= 0) {
      const int raw = spread_raw(P, sp, s, n, fl);
      ex.spread(raw, ok && spread_scoreable(P, sp, n));
      if (full) store_int(P.raw_out, rowS + P.s_row[SPREAD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[INTERPOD] >= 0) {
      const int raw = interpod_raw(P, ip, n);
      ex.interpod(raw, ok);
      if (full) store_int(P.raw_out, rowS + P.s_row[INTERPOD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[IMAGE] >= 0) {
      const int raw = image_score(P, j, n, s);
      const int fin = raw * static_cast<int>(P.weight[IMAGE]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[IMAGE] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[IMAGE] * N + n, fin, P.final_size);
    }
    if (use_samples) partial = wrap_add(partial, sample_scores(P, j, n, rowS, full, finals));
    s.partial[li] = partial;
  }
  team.mark(PH_EX_REDUCE);
  ex.reduce(team, s);

  // -- phase 5: normalizes, total, selectHost --
  team.mark(PH_NORMALIZE);
  unsigned long long best = 0ULL;
  for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= N) continue;
    const uint8_t fl = s.flags[li];
    if (sparse && !(fl & FL_OK)) continue;
    int total = s.partial[li];
    if (P.s_row[TAINT] >= 0) {
      const int norm = ex.taint_norm(s.raw_taint[li]);
      const int fin = norm * static_cast<int>(P.weight[TAINT]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[TAINT] * N + n, fin, P.final_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      const int norm = ex.affinity_norm(s.raw_aff[li]);
      const int fin = norm * static_cast<int>(P.weight[AFFINITY]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[AFFINITY] * N + n, fin, P.final_size);
    }
    if (P.s_row[SPREAD] >= 0) {
      const int norm = ex.spread_norm(P, sp, n, [&] { return spread_raw(P, sp, s, n, fl); });
      const int fin = norm * static_cast<int>(P.weight[SPREAD]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[SPREAD] * N + n, fin, P.final_size);
    }
    if (P.s_row[INTERPOD] >= 0) {
      const int norm = ex.interpod_norm(P, fl & FL_OK, [&] { return interpod_raw(P, ip, n); });
      const int fin = norm * static_cast<int>(P.weight[INTERPOD]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[INTERPOD] * N + n, fin, P.final_size);
    }
    if (finals && P.total != nullptr) P.total[o * N + n] = total;
    if (RANKED) s.partial[li] = total;  // this thread's node: read below
    if (fl & FL_OK) {
      const unsigned long long key = select_key(total, n);
      best = key > best ? key : best;
    }
  }
  team.mark(PH_SELECT);
  best = team.max_u64(best, s);
  team.mark(PH_COMMIT);
  if (RANKED) {
    if (best == 0ULL || !P.pvalid[p]) return -1;
    const int mx = static_cast<int>(static_cast<unsigned int>(best >> 32) ^ 0x80000000u);
    // Key: the smaller value, then the lower index, wins the max.
    unsigned long long rk = 0ULL;
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      const bool cand = (s.flags[li] & FL_OK) && s.partial[li] == mx;
      const int v = cand ? rank[n] : INT_MAX;
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned int>(INT_MAX - v)) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned int>(n));
      rk = key > rk ? key : rk;
    }
    rk = team.max_u64(rk, s);
    return key_node(rk);
  }
  // Padding pods never ran a cycle upstream: no rotation.
  if constexpr (SAMPLED) {
    if (P.pvalid[p]) team.start = floormod(start + thr + 1, max(P.n_real, 1LL));
  }
  return P.pvalid[p] ? key_node(best) : -1;
}

// ---- the commit (kernels A, C and D) ------------------------------------------

// Commits pod p onto node `best` (>= 0): the node state and every carry.
// Only the thread that owns a node touches its carried rows, here and in
// the chain, so the commit needs no barrier of its own; the term totals
// are the team's (team.commit_total).
template <class Team>
__device__ inline void commit_pod(const ChainParams& P, long long p, int best, Team& team) {
  const long long j = P.pindex[p];
  if (team.owns(best)) {
    for (long long r = 0; r < P.R; ++r) {
      P.requested[best * P.R + r] += P.preq[p * P.R + r];
      P.nz_requested[best * P.R + r] += P.pnz[p * P.R + r];
    }
    P.pod_count[best] += 1;
    if (P.port_counts != nullptr)
      for (long long v = 0; v < P.V; ++v) P.port_counts[best * P.V + v] += P.pod_adds[j * P.V + v];
    if (P.sp_counts != nullptr)
      for (long long c = 0; c < P.SS; ++c) P.sp_counts[best * P.SS + c] += P.sp_sel_match[j * P.SS + c];
    if (P.attached != nullptr)  // attachment is unique per (volume, node): saturate at 1
      for (long long v = 0; v < P.VV; ++v)
        P.attached[best * P.VV + v] = max(P.attached[best * P.VV + v], static_cast<int>(P.pod_vol[j * P.VV + v]));
    if (P.rwop != nullptr) {
      for (long long r = 0; r < P.RW; ++r) P.rwop[best * P.RW + r] += P.pod_rwop[j * P.RW + r];
      for (long long d = 0; d < P.DD; ++d) {
        P.disk_any[best * P.DD + d] += P.pod_disk_any[j * P.DD + d];
        P.disk_rw[best * P.DD + d] += P.pod_disk_rw[j * P.DD + d];
      }
    }
  }
  if (P.ipa_cnt != nullptr) {
    // Every node in the chosen node's domain, term by term.
    const long long base = j * P.T2;
    bool any = false;
    for (long long t = 0; t < P.T2; ++t)
      any = any || P.ipa_qm[base + t] || P.ipa_vw[base + t] != 0 || P.ipa_eat[base + t] != 0;
    if (!any) return;
    const int32_t* db = P.ipa_dom + best * P.T2;
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= P.N) continue;
      for (long long t = 0; t < P.T2; ++t) {
        if (db[t] < 0 || P.ipa_dom[n * P.T2 + t] != db[t]) continue;
        P.ipa_cnt[n * P.T2 + t] += P.ipa_qm[base + t];
        P.ipa_ecnt[n * P.T2 + t] += P.ipa_eat[base + t];
        P.ipa_ew[n * P.T2 + t] += P.ipa_vw[base + t];
      }
    }
    team.commit_total(P, db, base);
  }
}

}  // namespace ksim
