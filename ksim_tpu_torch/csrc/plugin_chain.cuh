// The default profile's plugin chain, one pod against every node, for sm_90a.
//
// Shared by schedule_scan.cu (kernel A, the sequential-commit scan),
// schedule_sampled.cu (kernel C, the scan with percentageOfNodesToScore
// sampling) and batch_eval.cu (kernel B, batch evaluation).  One thread
// block evaluates one pod at a time: thread t owns nodes t, t + blockDim.x,
// ... (so the per-node records a warp writes are contiguous), and the
// node-axis reductions (domain statistics, normalize extrema, selectHost's
// argmax) run in-block.
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
//   0. setup: image weights, the pod's per-domain scratch zeroed;
//   1. PodTopologySpread's filter statistics: per DoNotSchedule constraint,
//      per-domain sums of the carried counts over eligible nodes (integer
//      atomics) and, reduced over the block, the present-domain count and
//      the least domain sum;
//   2. every filter, per node: the feasible mask and the reason codes;
//   (kernel C: the visit window from the rotating start, by a block-wide
//      prefix count; the feasible mask becomes the sampled mask;)
//   3. PodTopologySpread's score statistics: the domains registered among
//      the feasible (sampled) nodes, then the contributions of eligible
//      nodes in registered domains, and the registered-domain count;
//   4. every score, per node, and the normalize extrema (block reduce);
//   5. the normalizes (PodTopologySpread's and InterPodAffinity's raw
//      scores are recomputed here rather than kept per node), the total
//      and selectHost's block argmax.
// A domain sum of a singleton key (every domain one node: hostname) is
// the node's own value, so such keys need no domain array.
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
//    canonical rank instead (eval_pod's RANKED).
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
  NPLUGINS = 14,
};

enum FitStrategy : int { LEAST = 0, MOST = 1, RTCR = 2 };

constexpr int MAX_SPEC = 8;
constexpr int MAX_SHAPE = 16;
constexpr int MAX_POOLS = 16;
constexpr int MAX_MC = 8;
constexpr int MAX_TK = 16;
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
  // Shapes.
  long long N, R, W, T, V, I, Pc, F, S;
  long long record;  // 0 = selection, 1 = final, 2 = full
  long long bits_size, final_size, raw_size;  // bytes per element
  long long exact;  // 1: int64 BalancedAllocation, f64 ImageLocality / spread weight
  long long NPV, NC, VV, NK, RW, DD;
  long long TK, SS, MC, DMAX, sp_smem;
  long long T2, TKI;
  long long n_real, samp_k;
  // Per plugin id: its row in bits (-1 = filter off), its row in
  // raw/final (-1 = score off), its weight.
  long long f_row[NPLUGINS];
  long long s_row[NPLUGINS];
  long long weight[NPLUGINS];
  // NodeResourcesFit.
  long long fit_base_count, fit_strategy, fit_nspec;
  long long fit_spec_idx[MAX_SPEC];
  long long fit_spec_w[MAX_SPEC];
  long long fit_nshape;
  long long shape_u[MAX_SHAPE];
  long long shape_s[MAX_SHAPE];
  // NodeResourcesBalancedAllocation.
  long long bal_nspec;
  long long bal_spec[MAX_SPEC];
  // NodeVolumeLimits: the pools this instance checks.
  long long nvl_npools;
  long long nvl_pools[MAX_POOLS];
  // PodTopologySpread: per topology key, singleton or not, domain count.
  long long tk_singleton[MAX_TK];
  long long tk_size[MAX_TK];
};

// Per-node flag bits kept in shared memory between phases.
constexpr uint8_t FL_OK = 1;  // feasible (kernel C: feasible and visited)
constexpr uint8_t FL_AFF = 2;  // pod's nodeSelector + required node affinity match
constexpr uint8_t FL_TNT = 4;  // no untolerated NoSchedule/NoExecute taint

// Block-reduction slots (see block_reduce) and the prefix-count scratch.
constexpr int RED_MAX = 24;
constexpr int SCAN_INTS = 64;

// Dynamic shared memory: per-node values carried from one phase to the
// next, the pod's image weights, the reduction scratch and, when it fits,
// the pod's per-domain scratch.
struct Smem {
  int32_t* raw_taint;  // [N]
  int32_t* raw_aff;  // [N]
  int32_t* partial;  // [N] sum of the unnormalized finals
  uint8_t* flags;  // [N] FL_* bits
  double* imgw;  // [I] (float in f32 mode, in the same slots)
  unsigned long long* red64;  // [33]
  int* red;  // [33 * RED_MAX]
  int* scan;  // [SCAN_INTS]
  int* dom;  // [4 * MC * DMAX]: filter sum, filter presence, score registration, score sum
};

__host__ __device__ inline long long align8(long long x) { return (x + 7) & ~7LL; }

__host__ __device__ inline long long domain_ints(const ChainParams& P) { return 4 * P.MC * P.DMAX; }

__host__ __device__ inline long long smem_bytes(const ChainParams& P) {
  return align8(3 * 4 * P.N + P.N) + 8 * P.I + 8 * 33 + 4 * 33 * RED_MAX + 4 * SCAN_INTS +
         (P.sp_smem ? 4 * domain_ints(P) : 0);
}

__device__ inline Smem carve(unsigned char* base, const ChainParams& P) {
  const long long N = P.N;
  Smem s;
  s.raw_taint = reinterpret_cast<int32_t*>(base);
  s.raw_aff = s.raw_taint + N;
  s.partial = s.raw_aff + N;
  s.flags = reinterpret_cast<uint8_t*>(s.partial + N);
  s.imgw = reinterpret_cast<double*>(base + align8(3 * 4 * N + N));
  s.red64 = reinterpret_cast<unsigned long long*>(s.imgw + P.I);
  s.red = reinterpret_cast<int*>(s.red64 + 33);
  s.scan = s.red + 33 * RED_MAX;
  s.dom = P.sp_smem ? s.scan + SCAN_INTS : P.sp_scratch + blockIdx.x * domain_ints(P);
  return s;
}

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
  // deviations, / count, sqrt, (1 - std) * 100 + 1e-4, floor.
  float frac[MAX_SPEC];
  bool present[MAX_SPEC];
  int count_i = 0;
  float sum = 0.0f;
  for (int k = 0; k < P.bal_nspec; ++k) {
    const long long ri = P.bal_spec[k];
    const float c = static_cast<float>(P.alloc[n * P.R + ri]);
    const float r = static_cast<float>(P.nz_requested[n * P.R + ri] + P.pnz[p * P.R + ri]);
    float f = c > 0.0f ? __fdiv_rn(r, fmaxf(c, 1.0f)) : 0.0f;
    f = fminf(f, 1.0f);
    frac[k] = f;
    present[k] = c > 0.0f;
    count_i += present[k] ? 1 : 0;
    sum = __fadd_rn(sum, present[k] ? f : 0.0f);
  }
  const float count = static_cast<float>(count_i);
  const float safe = fmaxf(count, 1.0f);
  const float mean = __fdiv_rn(sum, safe);
  float sq = 0.0f;
  for (int k = 0; k < P.bal_nspec; ++k) {
    const float d = __fsub_rn(frac[k], mean);
    sq = __fadd_rn(sq, present[k] ? __fmul_rn(d, d) : 0.0f);
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

__device__ inline int image_score(const ChainParams& P, long long j, long long n, const Smem& s) {
  const uint8_t* has = P.node_has_image + n * P.I;
  const int nc = P.pod_num_containers[j];
  if (P.exact) {
    double sum = 0.0;  // ORDER: image-index order, one add at a time
    for (long long i = 0; i < P.I; ++i)
      if (has[i]) sum = __dadd_rn(sum, s.imgw[i]);
    const double max_t = __dmul_rn(static_cast<double>(nc), MAX_CONTAINER_THRESHOLD);
    const double clamped = fmin(fmax(sum, MIN_THRESHOLD), fmax(max_t, MIN_THRESHOLD));
    const double val = __ddiv_rn(__dmul_rn(100.0, __dsub_rn(clamped, MIN_THRESHOLD)),
                                 fmax(__dsub_rn(max_t, MIN_THRESHOLD), 1.0));
    return static_cast<int>(trunc(val));
  }
  const float* w = reinterpret_cast<const float*>(s.imgw);
  float sum = 0.0f;
  for (long long i = 0; i < P.I; ++i)
    if (has[i]) sum = __fadd_rn(sum, w[i]);
  const float lo = static_cast<float>(MIN_THRESHOLD);
  const float max_t = __fmul_rn(static_cast<float>(nc), static_cast<float>(MAX_CONTAINER_THRESHOLD));
  const float clamped = fminf(fmaxf(sum, lo), fmaxf(max_t, lo));
  const float val = __fdiv_rn(__fmul_rn(100.0f, __fsub_rn(clamped, lo)),
                              fmaxf(__fsub_rn(max_t, lo), 1.0f));
  return static_cast<int>(truncf(val));
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

__device__ inline bool volume_limits_over(const ChainParams& P, long long j, long long n) {
  const int32_t* att = P.attached + n * P.VV;
  const uint8_t* uses = P.pod_vol + j * P.VV;
  bool over = false;
  for (long long q = 0; q < P.nvl_npools; ++q) {
    const long long k = P.nvl_pools[q];
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

// The pod's constraints as the kernel reads them; `active_f`/`active_s`
// are bit masks of the valid DoNotSchedule / ScheduleAnyway constraints.
struct Spread {
  long long base;  // j * MC
  unsigned active_f, active_s;
  bool has_score;
};

__device__ inline Spread spread_pod(const ChainParams& P, long long j) {
  Spread sp;
  sp.base = j * P.MC;
  sp.active_f = sp.active_s = 0;
  for (long long c = 0; c < P.MC; ++c) {
    if (!P.con_valid[sp.base + c]) continue;
    if (P.con_mode[sp.base + c] == 0) sp.active_f |= 1u << c;
    if (P.con_mode[sp.base + c] == 1) sp.active_s |= 1u << c;
  }
  sp.has_score = P.has_score_con[j] != 0;
  return sp;
}

__device__ inline int sp_key(const ChainParams& P, const Spread& sp, long long c) {
  return P.con_tk[sp.base + c];
}

// The node's local domain for key k, -1 when it misses the key (or k is
// outside the key vocabulary).
__device__ inline int sp_ldom(const ChainParams& P, long long n, int k) {
  return (k >= 0 && k < P.TK) ? P.sp_ldom[n * P.TK + k] : -1;
}

__device__ inline bool sp_singleton(const ChainParams& P, int k) {
  return k < 0 || k >= MAX_TK || P.tk_singleton[k] != 0;
}

// The carried matching-pod count for constraint c's selector context.
__device__ inline int sp_count(const ChainParams& P, const Spread& sp, long long c, long long n) {
  const int sel = P.con_sel[sp.base + c];
  return (sel >= 0 && sel < P.SS) ? P.sp_counts[n * P.SS + sel] : 0;
}

// Inclusion policies (nodeAffinityPolicy / nodeTaintsPolicy Honor).
__device__ inline bool sp_policy(const ChainParams& P, const Spread& sp, long long c, long long n,
                                 uint8_t fl) {
  return P.nvalid[n] && (!P.con_honor_aff[sp.base + c] || (fl & FL_AFF)) &&
         (!P.con_honor_taints[sp.base + c] || (fl & FL_TNT));
}

// Every constraint of `mask` has its key on the node.
__device__ inline bool sp_allkeys(const ChainParams& P, const Spread& sp, unsigned mask, long long n) {
  for (long long c = 0; c < P.MC; ++c)
    if (((mask >> c) & 1u) && sp_ldom(P, n, sp_key(P, sp, c)) < 0) return false;
  return true;
}

__device__ inline int* dom_f_sum(const ChainParams& P, const Smem& s, long long c) {
  return s.dom + (0 * P.MC + c) * P.DMAX;
}
__device__ inline int* dom_f_pres(const ChainParams& P, const Smem& s, long long c) {
  return s.dom + (1 * P.MC + c) * P.DMAX;
}
__device__ inline int* dom_s_reg(const ChainParams& P, const Smem& s, long long c) {
  return s.dom + (2 * P.MC + c) * P.DMAX;
}
__device__ inline int* dom_s_sum(const ChainParams& P, const Smem& s, long long c) {
  return s.dom + (3 * P.MC + c) * P.DMAX;
}

// Filter phase 1: min_match per DoNotSchedule constraint (0 where unused).
__device__ inline void spread_filter_stats(const ChainParams& P, const Spread& sp, long long j, Smem& s,
                                           int* min_match) {
  int v[2 * MAX_MC], op[2 * MAX_MC];
  const int MC = static_cast<int>(P.MC);
  for (int c = 0; c < MC; ++c) {
    v[c] = 0;  // present domains
    op[c] = RSUM;
    v[MC + c] = INT_MAX;  // least present-domain sum
    op[MC + c] = RMIN;
  }
  for (long long n = threadIdx.x; n < P.N; n += blockDim.x) {
    const uint8_t fl = (affinity_match(P, j, n) ? FL_AFF : 0) | (taint_block(P, j, n) == 0 ? FL_TNT : 0);
    if (!sp_allkeys(P, sp, sp.active_f, n)) continue;
    for (int c = 0; c < MC; ++c) {
      if (!((sp.active_f >> c) & 1u)) continue;
      const int k = sp_key(P, sp, c);
      const int l = sp_ldom(P, n, k);
      if (l < 0 || !sp_policy(P, sp, c, n, fl)) continue;  // not stat-eligible
      const int x = sp_count(P, sp, c, n);
      if (sp_singleton(P, k)) {
        v[c] += 1;
        v[MC + c] = min(v[MC + c], x);
      } else {
        atomicAdd(dom_f_sum(P, s, c) + l, x);
        dom_f_pres(P, s, c)[l] = 1;
      }
    }
  }
  __syncthreads();
  for (int c = 0; c < MC; ++c) {
    const int k = sp_key(P, sp, c);
    if (!((sp.active_f >> c) & 1u) || sp_singleton(P, k)) continue;
    for (long long d = threadIdx.x; d < P.tk_size[k]; d += blockDim.x) {
      if (!dom_f_pres(P, s, c)[d]) continue;
      v[c] += 1;
      v[MC + c] = min(v[MC + c], dom_f_sum(P, s, c)[d]);
    }
  }
  block_reduce(v, op, 2 * MC, s.red);
  for (int c = 0; c < MC; ++c) {
    const int dom_num = v[c];
    int mm = dom_num > 0 ? v[MC + c] : 0;
    const int min_domains = P.con_min_domains[sp.base + c];
    if (min_domains > 0 && dom_num < min_domains) mm = 0;
    min_match[c] = mm;
  }
}

// Filter phase 2: the reason code at node n (first failing constraint).
__device__ inline int spread_filter_code(const ChainParams& P, const Spread& sp, const Smem& s,
                                         const int* min_match, long long n, uint8_t fl) {
  const bool allkeys = sp_allkeys(P, sp, sp.active_f, n);
  for (long long c = 0; c < P.MC; ++c) {
    if (!((sp.active_f >> c) & 1u)) continue;
    const int k = sp_key(P, sp, c);
    const int l = sp_ldom(P, n, k);
    if (l < 0) return 2;  // MISSING_LABEL_BIT
    int seg;
    if (sp_singleton(P, k)) {
      seg = (allkeys && sp_policy(P, sp, c, n, fl)) ? sp_count(P, sp, c, n) : 0;
    } else {
      seg = dom_f_sum(P, s, c)[l];
    }
    const int skew = seg + static_cast<int>(P.con_self[sp.base + c]) - min_match[c];
    if (skew > P.con_max_skew[sp.base + c]) return 1;  // SKEW_BIT
  }
  return 0;
}

// Score phase 3: the registered-domain counts; fills the score sums.
__device__ inline void spread_score_stats(const ChainParams& P, const Spread& sp, Smem& s, int* dom_num) {
  int v[MAX_MC], op[MAX_MC];
  const int MC = static_cast<int>(P.MC);
  for (int c = 0; c < MC; ++c) {
    v[c] = 0;
    op[c] = RSUM;
  }
  // Domains present among feasible, non-ignored nodes.
  for (long long n = threadIdx.x; n < P.N; n += blockDim.x) {
    if (!(s.flags[n] & FL_OK) || !sp_allkeys(P, sp, sp.active_s, n)) continue;
    for (int c = 0; c < MC; ++c) {
      if (!((sp.active_s >> c) & 1u)) continue;
      const int k = sp_key(P, sp, c);
      const int l = sp_ldom(P, n, k);
      if (l < 0) continue;
      if (sp_singleton(P, k)) v[c] += 1;
      else dom_s_reg(P, s, c)[l] = 1;
    }
  }
  __syncthreads();
  // Contributions of policy-passing nodes in registered domains.
  for (long long n = threadIdx.x; n < P.N; n += blockDim.x) {
    const uint8_t fl = s.flags[n];
    for (int c = 0; c < MC; ++c) {
      const int k = sp_key(P, sp, c);
      if (!((sp.active_s >> c) & 1u) || sp_singleton(P, k)) continue;
      const int l = sp_ldom(P, n, k);
      if (l >= 0 && dom_s_reg(P, s, c)[l] && sp_policy(P, sp, c, n, fl))
        atomicAdd(dom_s_sum(P, s, c) + l, sp_count(P, sp, c, n));
    }
  }
  for (int c = 0; c < MC; ++c) {
    const int k = sp_key(P, sp, c);
    if (!((sp.active_s >> c) & 1u) || sp_singleton(P, k)) continue;
    for (long long d = threadIdx.x; d < P.tk_size[k]; d += blockDim.x) v[c] += dom_s_reg(P, s, c)[d];
  }
  block_reduce(v, op, MC, s.red);  // its barriers also publish the atomics
  for (int c = 0; c < MC; ++c) dom_num[c] = v[c];
}

// The raw score at node n: sum over constraints, in constraint order, of
// seg * log(dom_num + 2) + (maxSkew - 1) where gated, rounded half to even.
__device__ inline int spread_raw(const ChainParams& P, const Spread& sp, const Smem& s,
                                 const int* dom_num, long long n, uint8_t fl) {
  if (!sp.has_score) return 0;
  const bool filtered = (fl & FL_OK) && sp_allkeys(P, sp, sp.active_s, n);
  double total64 = 0.0;
  float total32 = 0.0f;
  for (long long c = 0; c < P.MC; ++c) {
    int seg = 0;
    const bool gate = ((sp.active_s >> c) & 1u) && filtered;
    if (gate) {
      const int k = sp_key(P, sp, c);
      const int l = sp_ldom(P, n, k);
      if (l >= 0) {
        if (sp_singleton(P, k)) seg = sp_policy(P, sp, c, n, fl) ? sp_count(P, sp, c, n) : 0;
        else seg = dom_s_sum(P, s, c)[l];
      }
    }
    const long long w = min(max(static_cast<long long>(dom_num[c]), 0LL), P.N);
    if (P.exact) {
      const double wt = static_cast<const double*>(P.sp_logw)[w];
      const double v = gate ? __dadd_rn(__dmul_rn(static_cast<double>(seg), wt),
                                        __dsub_rn(static_cast<double>(P.con_max_skew[sp.base + c]), 1.0))
                            : 0.0;
      total64 = c == 0 ? v : __dadd_rn(total64, v);
    } else {
      const float wt = static_cast<const float*>(P.sp_logw)[w];
      const float v = gate ? __fadd_rn(__fmul_rn(static_cast<float>(seg), wt),
                                       __fsub_rn(static_cast<float>(P.con_max_skew[sp.base + c]), 1.0f))
                           : 0.0f;
      total32 = c == 0 ? v : __fadd_rn(total32, v);
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

__device__ inline Interpod interpod_pod(const ChainParams& P, long long j) {
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
    if (raff && P.ipa_total != nullptr) total_req += static_cast<unsigned>(P.ipa_total[t]);
  }
  ip.filter = any_raff || any_ranti || any_qm;
  ip.score = any_pref || any_qm;
  ip.raff = any_raff;
  ip.escape = static_cast<int>(total_req) == 0 && P.ipa_self_aff[j];
  return ip;
}

// The reason code at node n; checks in upstream order.
__device__ inline int interpod_code(const ChainParams& P, const Interpod& ip, long long n) {
  const int32_t* dom = P.ipa_dom + n * P.T2;
  const int32_t* cnt = P.ipa_cnt + n * P.T2;
  const int32_t* ecnt = P.ipa_ecnt + n * P.T2;
  bool pass_aff = true;
  if (ip.raff) {
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
    pass_aff = !missing && (!no_pods || ip.escape);
  }
  if (!pass_aff) return 1;
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

// ---- sampling (kernel C) ------------------------------------------------------

__device__ inline long long floormod(long long a, long long m) { return ((a % m) + m) % m; }

// Narrows the feasible mask to the visited window: from the rotating start,
// in index order over the real nodes, up to the k-th feasible node.
// Returns the window's last visit position (the threshold).
__device__ inline long long sample_window(const ChainParams& P, long long p, long long start, Smem& s) {
  const long long nr = max(P.n_real, 1LL);
  const long long sm = floormod(start, nr);
  int v[2] = {0, 0};  // feasible before the start, feasible in all
  const int op[2] = {RSUM, RSUM};
  for (long long n = threadIdx.x; n < P.n_real; n += blockDim.x) {
    if (!(s.flags[n] & FL_OK)) continue;
    v[1] += 1;
    if (n < sm) v[0] += 1;
  }
  block_reduce(v, op, 2, s.red);
  const int before = v[0], all = v[1];
  long long thr = P.n_real - 1;
  if (all >= P.samp_k) {
    // The k-th feasible node in visit order is the one whose rotated
    // feasible rank is k: a prefix count over index order, tile by tile.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    long long running = 0;
    for (long long base = 0; base < P.n_real; base += blockDim.x) {
      const long long n = base + threadIdx.x;
      const bool f = n < P.n_real && (s.flags[n] & FL_OK);
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (lane == 0) s.scan[warp] = __popc(mask);
      __syncthreads();
      int below = 0, tile = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = s.scan[w];
        if (w < warp) below += c;
        tile += c;
      }
      const long long incl = running + below + __popc(mask & ((2u << lane) - 1u));
      const long long rank = n >= sm ? incl - before : incl + (all - before);
      if (f && rank == P.samp_k) s.scan[33] = static_cast<int>(n - sm + (n < sm ? nr : 0));
      __syncthreads();
      running += tile;
    }
    thr = s.scan[33];
  }
  const bool full = P.record == 2;
  for (long long n = threadIdx.x; n < P.N; n += blockDim.x) {
    const bool visited = n < P.n_real && floormod(n - sm, nr) <= thr;
    if (!visited) s.flags[n] &= static_cast<uint8_t>(~FL_OK);
    if (full) P.visited_out[p * P.N + n] = visited;
  }
  __syncthreads();
  return thr;
}

// ---- one pod against every node -------------------------------------------

// Runs the chain for chunk row p over all N nodes with the calling block,
// writes the records of P.record, and returns the selected node (-1 when
// none is feasible or the pod is padding) to every thread.  SAMPLED
// (kernel C) narrows the scored set to the visit window and advances
// *P.samp_start.  RANKED (kernel D) selects among the max-total feasible
// nodes the one of minimal rank[n] (ksim_tpu/engine/replay.py:942-951):
// a jnp.argmin over the whole node axis, so the lowest index of minimal
// value wins, non-candidates counting as INT_MAX.
template <bool SAMPLED, bool RANKED = false>
__device__ inline int eval_pod(const ChainParams& P, long long p, Smem& s, const int32_t* rank = nullptr) {
  const long long N = P.N;
  const long long j = P.pindex[p];
  const bool full = P.record == 2;
  const bool finals = P.record >= 1;
  const long long rowF = p * P.F * N;
  const long long rowS = p * P.S * N;
  const bool use_spread = P.f_row[SPREAD] >= 0 || P.s_row[SPREAD] >= 0;
  const bool use_ipa = P.f_row[INTERPOD] >= 0 || P.s_row[INTERPOD] >= 0;

  // -- phase 0: setup; the barrier also orders the previous pod's commit --
  if (P.s_row[IMAGE] >= 0) image_weights(P, j, s);
  if (use_spread)
    for (long long i = threadIdx.x; i < domain_ints(P); i += blockDim.x) s.dom[i] = 0;
  __syncthreads();
  const Spread sp = use_spread ? spread_pod(P, j) : Spread{0, 0u, 0u, false};
  const Interpod ip = use_ipa ? interpod_pod(P, j) : Interpod{0, false, false, false, false};
  const long long start = SAMPLED ? static_cast<long long>(*P.samp_start) : 0;

  // -- phase 1: PodTopologySpread's filter statistics --
  int min_match[MAX_MC];
  const bool sp_filter = P.f_row[SPREAD] >= 0 && sp.active_f != 0;
  if (sp_filter) spread_filter_stats(P, sp, j, s, min_match);

  // -- phase 2: filters (every one runs: all reason codes are recorded) --
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    bool ok = P.nvalid[n] != 0;
    const int taint = taint_block(P, j, n);
    const bool aff = affinity_match(P, j, n);
    const uint8_t fl = (aff ? FL_AFF : 0) | (taint == 0 ? FL_TNT : 0);
    if (P.f_row[UNSCHED] >= 0) {
      const bool blocked = P.unsched[n] && !P.ptol[p];
      ok = ok && !blocked;
      if (full) store_int(P.bits_out, rowF + P.f_row[UNSCHED] * N + n, blocked, P.bits_size);
    }
    if (P.f_row[NODENAME] >= 0) {
      const int req = P.pod_req_node[j];
      const bool pass = req == -1 || n == req;
      ok = ok && pass;
      if (full) store_int(P.bits_out, rowF + P.f_row[NODENAME] * N + n, !pass, P.bits_size);
    }
    if (P.f_row[TAINT] >= 0) {
      ok = ok && taint == 0;
      if (full) store_int(P.bits_out, rowF + P.f_row[TAINT] * N + n, taint, P.bits_size);
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
      if (full) store_int(P.bits_out, rowF + P.f_row[AFFINITY] * N + n, bits, P.bits_size);
    }
    if (P.f_row[PORTS] >= 0) {
      const int32_t* cnt = P.port_counts + n * P.V;
      const uint8_t* wants = P.pod_wants + j * P.V;
      bool conflict = false;
      for (long long v = 0; v < P.V; ++v) conflict = conflict || (cnt[v] > 0 && wants[v]);
      ok = ok && !conflict;
      if (full) store_int(P.bits_out, rowF + P.f_row[PORTS] * N + n, conflict, P.bits_size);
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
      if (full) store_int(P.bits_out, rowF + P.f_row[FIT] * N + n, bits, P.bits_size);
    }
    if (P.f_row[BALANCED] >= 0 && full) {
      store_int(P.bits_out, rowF + P.f_row[BALANCED] * N + n, 0, P.bits_size);
    }
    if (P.f_row[VOLRESTR] >= 0) {
      const int code = volume_restrictions_code(P, j, n);
      ok = ok && code == 0;
      if (full) store_int(P.bits_out, rowF + P.f_row[VOLRESTR] * N + n, code, P.bits_size);
    }
    if (P.f_row[VOLLIMITS] >= 0) {
      const bool over = volume_limits_over(P, j, n);
      ok = ok && !over;
      if (full) store_int(P.bits_out, rowF + P.f_row[VOLLIMITS] * N + n, over, P.bits_size);
    }
    if (P.f_row[VOLBIND] >= 0) {
      const int code = volume_binding_code(P, j, n);
      ok = ok && code == 0;
      if (full) store_int(P.bits_out, rowF + P.f_row[VOLBIND] * N + n, code, P.bits_size);
    }
    if (P.f_row[VOLZONE] >= 0) {
      const bool conflict = volume_zone_conflict(P, j, n);
      ok = ok && !conflict;
      if (full) store_int(P.bits_out, rowF + P.f_row[VOLZONE] * N + n, conflict, P.bits_size);
    }
    if (P.f_row[SPREAD] >= 0) {
      const int code = sp_filter ? spread_filter_code(P, sp, s, min_match, n, fl) : 0;
      ok = ok && code == 0;
      if (full) store_int(P.bits_out, rowF + P.f_row[SPREAD] * N + n, code, P.bits_size);
    }
    if (P.f_row[INTERPOD] >= 0) {
      const int code = ip.filter ? interpod_code(P, ip, n) : 0;
      ok = ok && code == 0;
      if (full) store_int(P.bits_out, rowF + P.f_row[INTERPOD] * N + n, code, P.bits_size);
    }
    s.flags[n] = fl | (ok ? FL_OK : 0);
  }
  __syncthreads();

  long long thr = 0;
  if (SAMPLED) thr = sample_window(P, p, start, s);

  // -- phase 3: PodTopologySpread's score statistics --
  int dom_num[MAX_MC];
  for (int c = 0; c < MAX_MC; ++c) dom_num[c] = 0;
  if (P.s_row[SPREAD] >= 0 && sp.has_score) spread_score_stats(P, sp, s, dom_num);

  // -- phase 4: scores; the unnormalized finals are summed right away --
  // Extrema: taint max, affinity max, spread max / min / any over the
  // scoreable nodes, interpod max / min / any over the feasible nodes,
  // interpod any nonzero over all nodes.
  int ex[9] = {0, 0, INT_MIN, INT_MAX, 0, INT_MIN, INT_MAX, 0, 0};
  const int ex_op[9] = {RMAX, RMAX, RMAX, RMIN, RMAX, RMAX, RMIN, RMAX, RMAX};
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    const uint8_t fl = s.flags[n];
    const bool ok = fl & FL_OK;
    int partial = 0;
    if (P.s_row[TAINT] >= 0) {
      const int32_t* order = P.taint_order + n * P.W;
      const uint8_t* tolp = P.pod_tolerated_prefer + j * P.W;
      int c = 0;
      for (long long w = 0; w < P.W; ++w) c += (order[w] > 0 && P.prefer[w] && !tolp[w]) ? 1 : 0;
      s.raw_taint[n] = c;
      if (ok) ex[0] = max(ex[0], c);
      if (full) store_int(P.raw_out, rowS + P.s_row[TAINT] * N + n, c, P.raw_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      // The weight sum is at most 100 per term: it fits in 32 bits.
      const uint8_t* tok = P.term_ok + n * P.T;
      const int32_t* pw = P.preferred_weights + j * P.T;
      long long sc = 0;
      for (long long t = 0; t < P.T; ++t)
        if (tok[t]) sc += pw[t] + P.added_pref[t];
      s.raw_aff[n] = static_cast<int>(sc);
      if (ok) ex[1] = max(ex[1], static_cast<int>(sc));
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
      const int raw = spread_raw(P, sp, s, dom_num, n, fl);
      if (ok && sp.has_score && sp_allkeys(P, sp, sp.active_s, n)) {  // scoreable
        ex[2] = max(ex[2], raw);
        ex[3] = min(ex[3], raw);
        ex[4] = 1;
      }
      if (full) store_int(P.raw_out, rowS + P.s_row[SPREAD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[INTERPOD] >= 0) {
      const int raw = interpod_raw(P, ip, n);
      if (ok) {
        ex[5] = max(ex[5], raw);
        ex[6] = min(ex[6], raw);
        ex[7] = 1;
      }
      if (raw != 0) ex[8] = 1;
      if (full) store_int(P.raw_out, rowS + P.s_row[INTERPOD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[IMAGE] >= 0) {
      const int raw = image_score(P, j, n, s);
      const int fin = raw * static_cast<int>(P.weight[IMAGE]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[IMAGE] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[IMAGE] * N + n, fin, P.final_size);
    }
    s.partial[n] = partial;
  }
  block_reduce(ex, ex_op, 9, s.red);
  const int mx_taint = ex[0], mx_aff = ex[1];
  const int sp_mx = ex[4] ? ex[2] : 0, sp_mn = ex[4] ? ex[3] : 0;
  const int ipa_mx = ex[7] ? ex[5] : 0, ipa_mn = ex[7] ? ex[6] : 0;
  const bool ipa_nonzero = ex[8] != 0;

  // -- phase 5: normalizes, total, selectHost --
  unsigned long long best = 0ULL;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    const uint8_t fl = s.flags[n];
    int total = s.partial[n];
    if (P.s_row[TAINT] >= 0) {
      // Reverse DefaultNormalizeScore; DIVISION: raw >= 0, max > 0.
      const int raw = s.raw_taint[n];
      const int norm = mx_taint > 0 ? MAX_NODE_SCORE - (MAX_NODE_SCORE * raw) / mx_taint : MAX_NODE_SCORE;
      const int fin = norm * static_cast<int>(P.weight[TAINT]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[TAINT] * N + n, fin, P.final_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      // DefaultNormalizeScore; DIVISION: raw >= 0, max > 0.
      const long long raw = s.raw_aff[n];
      const int norm = static_cast<int>(
          mx_aff > 0 ? (static_cast<long long>(MAX_NODE_SCORE) * raw) / mx_aff : raw);
      const int fin = norm * static_cast<int>(P.weight[AFFINITY]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[AFFINITY] * N + n, fin, P.final_size);
    }
    if (P.s_row[SPREAD] >= 0) {
      int norm = 0;
      if (sp.has_score && sp_allkeys(P, sp, sp.active_s, n)) {  // not ignored
        const int raw = spread_raw(P, sp, s, dom_num, n, fl);
        // WRAP, then a real floor division: the reference's int32 math.
        norm = sp_mx == 0 ? MAX_NODE_SCORE
                          : floordiv(wrap_mul(MAX_NODE_SCORE, wrap_sub(wrap_add(sp_mx, sp_mn), raw)),
                                     max(sp_mx, 1));
      }
      const int fin = norm * static_cast<int>(P.weight[SPREAD]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[SPREAD] * N + n, fin, P.final_size);
    }
    if (P.s_row[INTERPOD] >= 0) {
      const int norm =
          (ipa_nonzero && (fl & FL_OK)) ? interpod_norm(P, interpod_raw(P, ip, n), ipa_mn, ipa_mx) : 0;
      const int fin = norm * static_cast<int>(P.weight[INTERPOD]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[INTERPOD] * N + n, fin, P.final_size);
    }
    if (finals) P.total[p * N + n] = total;
    if (RANKED) s.partial[n] = total;  // this thread's node: read below
    if (fl & FL_OK) {
      const unsigned long long key = select_key(total, n);
      best = key > best ? key : best;
    }
  }
  best = block_max_u64(best, s.red64);
  if (RANKED) {
    if (best == 0ULL || !P.pvalid[p]) return -1;
    const int mx = static_cast<int>(static_cast<unsigned int>(best >> 32) ^ 0x80000000u);
    // Key: the smaller value, then the lower index, wins the max.
    unsigned long long rk = 0ULL;
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
      const bool cand = (s.flags[n] & FL_OK) && s.partial[n] == mx;
      const int v = cand ? rank[n] : INT_MAX;
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned int>(INT_MAX - v)) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned int>(n));
      rk = key > rk ? key : rk;
    }
    rk = block_max_u64(rk, s.red64);
    return key_node(rk);
  }
  // Padding pods never ran a cycle upstream: no rotation.  Every thread
  // read *samp_start in phase 0, before the barriers since.
  if (SAMPLED && threadIdx.x == 0 && P.pvalid[p])
    *P.samp_start = static_cast<int32_t>(floormod(start + thr + 1, max(P.n_real, 1LL)));
  return P.pvalid[p] ? key_node(best) : -1;
}

// ---- the sequential-commit scan (kernels A and C) ---------------------------

// Commits pod p onto node `best` (>= 0): the node state and every carry.
// Each thread updates only the nodes it owns; the cluster-wide interpod
// total is thread 0's.  The next pod's first barrier publishes it all.
__device__ inline void commit_pod(const ChainParams& P, long long p, int best) {
  const long long j = P.pindex[p];
  if (best % blockDim.x == threadIdx.x) {
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
    for (long long n = threadIdx.x; n < P.N; n += blockDim.x) {
      for (long long t = 0; t < P.T2; ++t) {
        if (db[t] < 0 || P.ipa_dom[n * P.T2 + t] != db[t]) continue;
        P.ipa_cnt[n * P.T2 + t] += P.ipa_qm[base + t];
        P.ipa_ecnt[n * P.T2 + t] += P.ipa_eat[base + t];
        P.ipa_ew[n * P.T2 + t] += P.ipa_vw[base + t];
      }
    }
    if (threadIdx.x == 0)
      for (long long t = 0; t < P.T2; ++t)
        if (db[t] >= 0) P.ipa_total[t] += P.ipa_qm[base + t];
  }
}

template <bool SAMPLED>
__device__ inline void scan_pods(const ChainParams& P, Smem& s) {
  for (long long p = 0; p < P.Pc; ++p) {
    const int best = eval_pod<SAMPLED>(P, p, s);
    if (threadIdx.x == 0) P.selected[p] = best;
    if (best >= 0) commit_pod(P, p, best);
  }
}

}  // namespace ksim
