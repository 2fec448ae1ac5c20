// The eight-plugin chain of one pod against every node, for sm_90a.
//
// Shared by schedule_scan.cu (kernel A, the sequential-commit scan) and
// batch_eval.cu (kernel B, batch evaluation).  One thread block evaluates
// one pod at a time: thread t owns nodes t, t + blockDim.x, ... (so the
// per-node records a warp writes are contiguous), and the node-axis
// reductions (the normalize maxima and selectHost's argmax) run in-block.
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
// plus the weight (core.py _final_from_raw) and _select's tie rule.
//
// Numerics, each flagged where it is handled:
//  - DIVISION: the reference's `//` floors, C++ `/` truncates.  Every
//    integer division here is reached only with a non-negative numerator
//    and a positive denominator, where the two agree.
//  - FLOAT: correctly rounded __f*_rn / __d*_rn intrinsics throughout
//    (and the build passes --fmad=false), so no a*b+c is contracted into
//    an FMA that the reference rounds twice.
//  - ORDER: float sums run in the reference's order (resource order for
//    BalancedAllocation, image-index order for ImageLocality).
//  - TIES: selectHost takes the max total, ties to the LOWEST node index;
//    padding nodes (valid == false) are never feasible and never enter a
//    normalize maximum.
#pragma once

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
  NPLUGINS = 8,
};

enum FitStrategy : int { LEAST = 0, MOST = 1, RTCR = 2 };

constexpr int MAX_SPEC = 8;
constexpr int MAX_SHAPE = 16;
constexpr int MAX_NODE_SCORE = 100;
constexpr double MB = 1024.0 * 1024.0;
constexpr double MIN_THRESHOLD = 23.0 * MB;
constexpr double MAX_CONTAINER_THRESHOLD = 1000.0 * MB;

// Every field is 8 bytes wide (a pointer or a long long), so the ctypes
// mirror in kernels/chain.py has no padding to agree on.
struct ChainParams {
  // Node state [N] / [N, R].  requested, nz_requested, pod_count and
  // port_counts are written by kernel A's commit (the wrapper passes
  // fresh copies).
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
  int32_t* port_counts;  // [N, V]
  const uint8_t* pod_wants;  // [P, V]
  const int32_t* pod_adds;  // [P, V]
  // ImageLocality
  const uint8_t* node_has_image;  // [N, I]
  const double* image_size;  // [I]
  const int32_t* image_num_nodes;  // [I]
  const double* total_nodes_f;  // scalar
  const int32_t* pod_image_count;  // [P, I]
  const int32_t* pod_num_containers;  // [P]
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
  long long exact;  // 1: int64 BalancedAllocation, f64 ImageLocality
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
};

// Dynamic shared memory: per-node values carried from the first pass
// over the nodes to the second, the pod's image weights, and the
// reduction scratch.
struct Smem {
  int32_t* raw_taint;  // [N]
  int32_t* raw_aff;  // [N]
  int32_t* partial;  // [N] sum of the unnormalized finals
  uint8_t* ok;  // [N]
  double* imgw;  // [I] (float in f32 mode, in the same slots)
  unsigned long long* red64;  // [33]
  int* red32;  // [2 * 33]
};

__host__ __device__ inline long long align8(long long x) { return (x + 7) & ~7LL; }

__host__ __device__ inline long long smem_bytes(long long N, long long I) {
  return align8(3 * 4 * N + N) + 8 * I + 8 * 33 + 4 * 2 * 33;
}

__device__ inline Smem carve(unsigned char* base, long long N, long long I) {
  Smem s;
  s.raw_taint = reinterpret_cast<int32_t*>(base);
  s.raw_aff = s.raw_taint + N;
  s.partial = s.raw_aff + N;
  s.ok = reinterpret_cast<uint8_t*>(s.partial + N);
  s.imgw = reinterpret_cast<double*>(base + align8(3 * 4 * N + N));
  s.red64 = reinterpret_cast<unsigned long long*>(s.imgw + I);
  s.red32 = reinterpret_cast<int*>(s.red64 + 33);
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

// ---- block reductions (every thread gets the result) ----------------------

__device__ inline int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline unsigned long long warp_max_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Two maxima at once.  Two barriers: the second publishes the result;
// the scratch is next written only after the first barrier of the next
// call, which every thread reaches after reading this result.
__device__ inline void block_max2(int& a, int& b, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  a = warp_max_i(a);
  b = warp_max_i(b);
  if (lane == 0) {
    red[warp] = a;
    red[33 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int x = lane < nw ? red[lane] : 0;
    int y = lane < nw ? red[33 + lane] : 0;
    x = warp_max_i(x);
    y = warp_max_i(y);
    if (lane == 0) {
      red[32] = x;
      red[33 + 32] = y;
    }
  }
  __syncthreads();
  a = red[32];
  b = red[33 + 32];
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

// ---- one pod against every node -------------------------------------------

// Runs the chain for chunk row p over all N nodes with the calling block,
// writes the records of P.record, and returns the selected node (-1 when
// none is feasible or the pod is padding) to every thread.
__device__ inline int eval_pod(const ChainParams& P, long long p, Smem& s) {
  const long long N = P.N;
  const long long j = P.pindex[p];
  const bool full = P.record == 2;
  const bool finals = P.record >= 1;
  const long long rowF = p * P.F * N;
  const long long rowS = p * P.S * N;

  if (P.s_row[IMAGE] >= 0) image_weights(P, j, s);
  __syncthreads();

  int mx_taint = 0, mx_aff = 0;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    bool ok = P.nvalid[n] != 0;
    // -- filters (every one runs: all reason codes are recorded) --
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
      // First untolerated NoSchedule/NoExecute taint by node position;
      // the reason is its 1-based vocab index (lowest index on a tie).
      const int32_t* order = P.taint_order + n * P.W;
      const uint8_t* tol = P.pod_tolerated + j * P.W;
      int first = 0x7fffffff, widx = 0;
      for (long long w = 0; w < P.W; ++w) {
        const int o = order[w];
        if (o > 0 && P.forbidding[w] && !tol[w] && o < first) {
          first = o;
          widx = static_cast<int>(w);
        }
      }
      const bool blocked = first != 0x7fffffff;
      ok = ok && !blocked;
      if (full) store_int(P.bits_out, rowF + P.f_row[TAINT] * N + n, blocked ? widx + 1 : 0, P.bits_size);
    }
    if (P.f_row[AFFINITY] >= 0) {
      const uint8_t* tok = P.term_ok + n * P.T;
      const int sel = P.selector_term[j];
      const bool sel_ok = sel >= 0 ? tok[sel] != 0 : true;
      bool req_ok = true;
      if (P.has_required[j]) {
        req_ok = false;
        const uint8_t* req = P.required_terms + j * P.T;
        for (long long t = 0; t < P.T; ++t) req_ok = req_ok || (tok[t] && req[t]);
      }
      bool added_ok = true;
      if (P.has_added[0]) {
        added_ok = false;
        for (long long t = 0; t < P.T; ++t) added_ok = added_ok || (tok[t] && P.added_terms[t]);
      }
      const int bits = (added_ok ? 0 : 2) | (sel_ok && req_ok ? 0 : 1);
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

    // -- scores; the unnormalized finals are summed right away --
    int partial = 0;
    if (P.s_row[TAINT] >= 0) {
      const int32_t* order = P.taint_order + n * P.W;
      const uint8_t* tolp = P.pod_tolerated_prefer + j * P.W;
      int c = 0;
      for (long long w = 0; w < P.W; ++w) c += (order[w] > 0 && P.prefer[w] && !tolp[w]) ? 1 : 0;
      s.raw_taint[n] = c;
      if (ok) mx_taint = max(mx_taint, c);
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
      if (ok) mx_aff = max(mx_aff, static_cast<int>(sc));
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
    if (P.s_row[IMAGE] >= 0) {
      const int raw = image_score(P, j, n, s);
      const int fin = raw * static_cast<int>(P.weight[IMAGE]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[IMAGE] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[IMAGE] * N + n, fin, P.final_size);
    }
    s.partial[n] = partial;
    s.ok[n] = ok;
  }

  // Normalize maxima over the feasible nodes (0 when there are none).
  block_max2(mx_taint, mx_aff, s.red32);

  unsigned long long best = 0ULL;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
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
    if (finals) P.total[p * N + n] = total;
    if (s.ok[n]) {
      const unsigned long long key = select_key(total, n);
      best = key > best ? key : best;
    }
  }
  best = block_max_u64(best, s.red64);
  return P.pvalid[p] ? key_node(best) : -1;
}

}  // namespace ksim
