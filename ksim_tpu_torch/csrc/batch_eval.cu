// Kernel B: batch evaluation of the plugin chain, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._batch_eval (core.py:669-685),
// the body of _batch_fn (core.py:687-690, one program per pod chunk) and
// _batch_fused_fn (core.py:692-715, the whole pod axis in one program):
// every pod of a chunk against the FIXED node state, with no commit.
//
// Two kernels, launched one after the other on the caller's stream:
//
//  1. node_summary_kernel, one thread per node: the node state, which no
//     pod of the launch changes, folded into per-node words the chain
//     reads with one coalesced load each (SoA: word w of node n at
//     words[w * N + n]).  Bit sets, one bit per vocabulary entry, 64 to a
//     word: the occupied host ports (port_counts > 0), the untolerable
//     (NoSchedule / NoExecute) and the prefer-no-schedule taints present,
//     the node-affinity terms the node satisfies, the images it holds, its
//     ReadWriteOncePod claims, its disks in use (any / read-write) and the
//     inter-pod terms with a matching pod (cnt > 0 / ecnt > 0) in its
//     domain; and
//     per node the attach room of each volume pool (limit - attached, or
//     INT_MAX without a limit), the added node-affinity preference sum
//     and whether the added required terms admit the node.
//
//  2. batch_eval_kernel, a persistent grid: as many blocks of 256 threads
//     as are resident at once (the occupancy query's blocks per SM times
//     the SMs), block b taking pods b, b + grid, ...  Each pod's rows are
//     staged once into shared memory as the same words (its host ports,
//     untolerated taints, required and preferred terms, images with a
//     nonzero weight, volume uses), so each per-pair predicate is an AND /
//     popcount / find-first-set of a node word and a pod word:
//       TaintToleration's code: the untolerated taint of least node
//         position (taint_order), read only for the set bits of the AND;
//       its score: popcount(prefer taints & ~pod's prefer tolerations);
//       NodeAffinity: the selector term's bit, any(terms & required), the
//         node's added-terms flag; its score: the node's added sum plus the
//         pod's preferred weights over the set bits of terms & preferred;
//       NodePorts, VolumeRestrictions, InterPodAffinity's anti-affinity
//         codes: any(node & pod) per word; its raw score over the set bits
//         of the pod's contributing terms only;
//       ImageLocality: the weights of the set bits of images & pod images,
//         in image-index order (a zero weight adds nothing);
//       NodeVolumeLimits, for a pod with no volume rows (the pod adds
//         nothing): some pool of the instance has a negative room.
//     A pod the plugin cannot fail skips its loop: no PV or WFFC claim
//     (VolumeBinding's code is the pod's own, VolumeZone passes), no
//     volume rows (NodeVolumeLimits reads the room), no image weight
//     (ImageLocality's sum is 0).  Each skip reads only what ksim_tpu's own
//     formula reads, so the records are the same bit for bit.
//
// Occupancy.  A block keeps 5 bytes per node between phases (FL_* flags and
// the partial sum of the unnormalized finals; TaintToleration's and
// NodeAffinity's raw scores are recomputed in the normalize from the
// words) in a global scratch row of its own, so its shared memory (the
// pod's staged rows, its spread constraints and the reductions) does not
// grow with the node axis and the node axis has no bound of its own.
// __launch_bounds__(256, MIN_BLOCKS) caps the registers at 64.
//
// What bounds it: P x N pairs of integer / float64 operations and, in the
// recording modes, the outputs ([P, S, N] finals, [P, F, N] reason codes).

#include "plugin_chain.cuh"

namespace ksim {

constexpr int B_THREADS = 256;
constexpr int MIN_BLOCKS = 4;

// Word groups (kernels/batch_eval.py GROUPS): the node side's first
// NODE_GROUPS, the pod side's all of them.
enum Group : int {
  G_PORTS = 0,  // V host ports: node occupied / pod wants
  G_TFORB,  // W taints: node has an untolerable one / pod does not tolerate it
  G_TPREF,  // W taints: node has a prefer-no-schedule one / pod does not tolerate it
  G_TERMS,  // T terms: node satisfies / pod's required terms
  G_IMG,  // I images: node holds / pod's weight is nonzero
  G_RWOP,  // RW claims: node uses / pod uses
  G_DANY,  // DD disks: node uses / pod conflicts with any use
  G_DRW,  // DD disks: node uses read-write / pod conflicts with a read-write use
  G_ICNT,  // T2 inter-pod terms: node's domain holds a matching pod / pod's required anti-affinity
  G_IECNT,  // T2 terms: node's domain holds a pod whose anti-affinity term the pod matches / pod matches
  NODE_GROUPS,
  G_PREF = NODE_GROUPS,  // T terms: pod's preferred weight is nonzero (pod side only)
  G_IRAW,  // T2 terms: pod's preferred weight is nonzero or it matches the term (pod side only)
  NGROUPS,
};

// Node-summary flags.
constexpr uint8_t NS_ADDED_OK = 1;  // the added required node-affinity terms admit the node

// Every field is 8 bytes wide, as ChainParams (the ctypes mirror is
// kernels/batch_eval.py SummaryParams).
struct SummaryParams {
  unsigned long long* words;  // [off[NODE_GROUPS], N]
  int32_t* room;  // [NK, N] attach room per pool (null without NodeVolumeLimits)
  int32_t* aff_added;  // [N] sum of added_pref over the node's terms
  uint8_t* nflags;  // [N] NS_*
  uint8_t* node_scratch;  // [grid, node_stride]: each block's partial [N] int32, flags [N]
  long long* stats;  // [2 + NPHASES] or null: block 0's pods, 0, its cycles per Phase
  long long off[NGROUPS + 1];  // first word of each group; off[NGROUPS] = the pod's words
  long long size[NGROUPS];  // bits of each group
  long long node_stride;  // bytes of one block's node scratch row
};

__device__ inline long long nwords(const SummaryParams& S, int g) { return S.off[g + 1] - S.off[g]; }

// ---- the pre-pass -------------------------------------------------------------

__device__ inline bool node_bit(const ChainParams& P, int g, long long n, long long i) {
  switch (g) {
    case G_PORTS: return P.port_counts != nullptr && P.port_counts[n * P.V + i] > 0;
    case G_TFORB: return P.taint_order[n * P.W + i] > 0 && P.forbidding[i];
    case G_TPREF: return P.taint_order[n * P.W + i] > 0 && P.prefer[i];
    case G_TERMS: return P.term_ok[n * P.T + i] != 0;
    case G_IMG: return P.node_has_image[n * P.I + i] != 0;
    case G_RWOP: return P.rwop != nullptr && P.rwop[n * P.RW + i] > 0;
    case G_DANY: return P.disk_any != nullptr && P.disk_any[n * P.DD + i] > 0;
    case G_DRW: return P.disk_rw != nullptr && P.disk_rw[n * P.DD + i] > 0;
    case G_ICNT: return P.ipa_cnt != nullptr && P.ipa_cnt[n * P.T2 + i] > 0;
    default: return P.ipa_ecnt != nullptr && P.ipa_ecnt[n * P.T2 + i] > 0;  // G_IECNT
  }
}

__global__ void node_summary_kernel(const ChainParams P, const SummaryParams S) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= P.N) return;
  for (int g = 0; g < NODE_GROUPS; ++g) {
    for (long long w = 0; w < nwords(S, g); ++w) {
      unsigned long long word = 0;
      for (long long b = 0; b < 64 && w * 64 + b < S.size[g]; ++b)
        if (node_bit(P, g, n, w * 64 + b)) word |= 1ULL << b;
      S.words[(S.off[g] + w) * P.N + n] = word;
    }
  }
  if (S.room != nullptr) {
    for (long long k = 0; k < P.NK; ++k) {
      int used = 0;
      for (long long v = 0; v < P.VV; ++v) used += (P.vol_key[v] == k && P.attached[n * P.VV + v] > 0) ? 1 : 0;
      const int limit = P.vol_limits[n * P.NK + k];
      S.room[k * P.N + n] = limit >= 0 ? limit - used : INT_MAX;
    }
  }
  int added = 0;
  bool added_ok = !P.has_added[0];
  for (long long t = 0; t < P.T; ++t) {
    if (!P.term_ok[n * P.T + t]) continue;
    added += P.added_pref[t];
    added_ok = added_ok || P.added_terms[t];
  }
  S.aff_added[n] = added;
  S.nflags[n] = added_ok ? NS_ADDED_OK : 0;
}

// ---- the pod's staged rows ---------------------------------------------------

// Per-pod flags in shared memory (PodStage::pflags).
constexpr unsigned PF_VOL = 1;  // some volume row (NodeVolumeLimits adds to a pool)
constexpr unsigned PF_PV = 2;  // some bound PV (VolumeBinding, VolumeZone)
constexpr unsigned PF_WFFC = 4;  // some WaitForFirstConsumer claim
constexpr unsigned PF_IMG = 8;  // some image of nonzero weight

// Kernel B's shared memory beside the chain's Smem: the pod's words, its
// preferred term weights and its flags.
struct PodStage {
  unsigned long long* words;  // [off[NGROUPS]]
  int32_t* pref;  // [T] preferred weights
  unsigned* pflags;  // [1]
};

__device__ inline bool pod_bit(const ChainParams& P, int g, long long j, long long i) {
  switch (g) {
    case G_PORTS: return P.pod_wants[j * P.V + i] != 0;
    case G_TFORB: return !P.pod_tolerated[j * P.W + i];
    case G_TPREF: return !P.pod_tolerated_prefer[j * P.W + i];
    case G_TERMS: return P.required_terms[j * P.T + i] != 0;
    case G_IMG: return P.pod_image_count[j * P.I + i] != 0;  // refined by the weight below
    case G_RWOP: return P.pod_rwop[j * P.RW + i] != 0;
    case G_DANY: {  // EBS never shares; the others conflict with any use where the pod writes
      const bool share = P.disk_shareable[i];
      return (P.pod_disk_any[j * P.DD + i] && !share) || (P.pod_disk_rw[j * P.DD + i] && share);
    }
    case G_DRW:  // a read-only use of a shareable disk conflicts with a read-write one
      return P.pod_disk_any[j * P.DD + i] && !P.pod_disk_rw[j * P.DD + i] && P.disk_shareable[i];
    case G_ICNT: return P.ipa_ranti[j * P.T2 + i] != 0;
    case G_IECNT: return P.ipa_qm[j * P.T2 + i] != 0;
    case G_PREF: return P.preferred_weights[j * P.T + i] != 0;
    default: return P.ipa_pref_w[j * P.T2 + i] != 0 || P.ipa_qm[j * P.T2 + i];  // G_IRAW
  }
}

// Phase 0 (every thread some words): the pod's words, image weights,
// preferred weights and flags.  The setup barrier publishes them.
__device__ inline void stage_pod(const ChainParams& P, const SummaryParams& S, long long j, Smem& s,
                                 const PodStage& ps, bool images) {
  if (images) image_weights(P, j, s);  // the image group below reads them
  for (long long i = threadIdx.x; i < P.T; i += blockDim.x) ps.pref[i] = P.preferred_weights[j * P.T + i];
  __syncthreads();
  unsigned any_img = 0;
  for (long long w = threadIdx.x; w < S.off[NGROUPS]; w += blockDim.x) {
    int g = 0;
    while (S.off[g + 1] <= w) ++g;
    const long long first = (w - S.off[g]) * 64;
    unsigned long long word = 0;
    for (long long b = 0; b < 64 && first + b < S.size[g]; ++b) {
      bool bit = pod_bit(P, g, j, first + b);
      if (g == G_IMG && bit && images)
        bit = P.exact ? s.imgw[first + b] != 0.0 : reinterpret_cast<const float*>(s.imgw)[first + b] != 0.0f;
      if (g == G_IMG && !images) bit = false;
      if (bit) word |= 1ULL << b;
    }
    ps.words[w] = word;
    if (g == G_IMG && word) any_img = 1;
  }
  if (threadIdx.x == 0) {
    unsigned f = 0;
    for (long long v = 0; v < P.VV; ++v) f |= P.pod_vol[j * P.VV + v] ? PF_VOL : 0u;
    for (long long v = 0; v < P.NPV; ++v) f |= P.pod_pv[j * P.NPV + v] ? PF_PV : 0u;
    for (long long c = 0; c < P.NC; ++c) f |= P.pod_wffc[j * P.NC + c] ? PF_WFFC : 0u;
    ps.pflags[0] = f;
  }
  __syncthreads();
  if (any_img) atomicOr(ps.pflags, PF_IMG);
}

// ---- per-pair predicates from the words ------------------------------------------

__device__ inline unsigned long long nword(const SummaryParams& S, const ChainParams& P, long long w, long long n) {
  return S.words[w * P.N + n];
}

__device__ inline bool any_and(const ChainParams& P, const SummaryParams& S, const PodStage& ps, int g, long long n) {
  for (long long w = S.off[g]; w < S.off[g + 1]; ++w)
    if (nword(S, P, w, n) & ps.words[w]) return true;
  return false;
}

// TaintToleration's code (plugin_chain.cuh taint_block): among the
// untolerated untolerable taints, the one of least node position, the
// lowest index on a tie; its index + 1, 0 when there is none.
__device__ inline int taint_code(const ChainParams& P, const SummaryParams& S, const PodStage& ps, long long n) {
  int first = INT_MAX, widx = 0;
  for (long long w = S.off[G_TFORB]; w < S.off[G_TFORB + 1]; ++w) {
    unsigned long long m = nword(S, P, w, n) & ps.words[w];
    while (m) {
      const long long t = (w - S.off[G_TFORB]) * 64 + (__ffsll(static_cast<long long>(m)) - 1);
      m &= m - 1;
      const int o = P.taint_order[n * P.W + t];
      if (o < first) {
        first = o;
        widx = static_cast<int>(t);
      }
    }
  }
  return first != INT_MAX ? widx + 1 : 0;
}

// TaintToleration's raw score: the prefer-no-schedule taints the pod does
// not tolerate.
__device__ inline int taint_raw(const ChainParams& P, const SummaryParams& S, const PodStage& ps, long long n) {
  int c = 0;
  for (long long w = S.off[G_TPREF]; w < S.off[G_TPREF + 1]; ++w) c += __popcll(nword(S, P, w, n) & ps.words[w]);
  return c;
}

// The pod's nodeSelector AND required node affinity (affinity_match).
__device__ inline bool aff_match(const ChainParams& P, const SummaryParams& S, const PodStage& ps, int sel,
                                 bool has_required, long long n) {
  if (sel >= 0 && !((nword(S, P, S.off[G_TERMS] + (sel >> 6), n) >> (sel & 63)) & 1ULL)) return false;
  return !has_required || any_and(P, S, ps, G_TERMS, n);
}

// NodeAffinity's raw score: the node's added preference sum and the pod's
// preferred weights of the terms the node satisfies.
__device__ inline long long aff_raw(const ChainParams& P, const SummaryParams& S, const PodStage& ps, long long n) {
  long long sc = S.aff_added[n];
  for (long long w = 0; w < nwords(S, G_TERMS); ++w) {
    unsigned long long m = nword(S, P, S.off[G_TERMS] + w, n) & ps.words[S.off[G_PREF] + w];
    while (m) {
      sc += ps.pref[w * 64 + (__ffsll(static_cast<long long>(m)) - 1)];
      m &= m - 1;
    }
  }
  return sc;
}

// ImageLocality: the weights of the pod's images the node holds, in
// image-index order.
__device__ inline int image_raw(const ChainParams& P, const SummaryParams& S, const PodStage& ps, long long j,
                                long long n, const Smem& s) {
  const int nc = P.pod_num_containers[j];
  const bool any = ps.pflags[0] & PF_IMG;
  double sum64 = 0.0;
  float sum32 = 0.0f;
  for (long long w = S.off[G_IMG]; any && w < S.off[G_IMG + 1]; ++w) {
    unsigned long long m = nword(S, P, w, n) & ps.words[w];
    while (m) {
      const long long i = (w - S.off[G_IMG]) * 64 + (__ffsll(static_cast<long long>(m)) - 1);
      m &= m - 1;
      if (P.exact) sum64 = __dadd_rn(sum64, s.imgw[i]);
      else sum32 = __fadd_rn(sum32, reinterpret_cast<const float*>(s.imgw)[i]);
    }
  }
  // A zero sum clamps to the threshold, and 100 * 0 / x is 0: the
  // formula's own value, without its division.
  if (P.exact) return sum64 == 0.0 ? 0 : image_from_sum64(sum64, nc);
  return sum32 == 0.0f ? 0 : image_from_sum32(sum32, nc);
}

// InterPodAffinity's code (interpod_code): the required affinity terms,
// then a matching pod in the domain of a required anti-affinity term, then
// a pod in the node's domain whose anti-affinity term the pod matches.
__device__ inline int interpod_code_words(const ChainParams& P, const SummaryParams& S, const PodStage& ps,
                                          const Interpod& ip, long long n) {
  if (!interpod_aff_pass(P, ip, n)) return 1;
  if (any_and(P, S, ps, G_ICNT, n)) return 2;
  return any_and(P, S, ps, G_IECNT, n) ? 4 : 0;
}

// InterPodAffinity's raw score (interpod_raw) over the terms that add to
// it: those of nonzero preferred weight or that the pod matches (WRAP:
// the sums of the reference's int32 dots, in any order).
__device__ inline int interpod_raw_words(const ChainParams& P, const SummaryParams& S, const PodStage& ps,
                                         const Interpod& ip, long long n) {
  if (!ip.score) return 0;
  unsigned acc = 0;
  for (long long w = S.off[G_IRAW]; w < S.off[G_IRAW + 1]; ++w) {
    unsigned long long m = ps.words[w];
    while (m) {
      const long long t = (w - S.off[G_IRAW]) * 64 + (__ffsll(static_cast<long long>(m)) - 1);
      m &= m - 1;
      acc += static_cast<unsigned>(P.ipa_cnt[n * P.T2 + t]) * static_cast<unsigned>(P.ipa_pref_w[ip.base + t]);
      if (P.ipa_qm[ip.base + t]) acc += static_cast<unsigned>(P.ipa_ew[n * P.T2 + t]);
    }
  }
  return static_cast<int>(acc);
}

// ---- the team ----------------------------------------------------------------

// One thread block is the team: every node is a slot of the block (thread
// t owns nodes t, t + blockDim.x, ..., so the records a warp writes are
// contiguous), the reductions are block_reduce / block_max_u64, and the
// per-domain atomics are read where they landed after a block barrier.
struct BatchTeam {
  static constexpr bool kCluster = false;
  const SummaryParams* S;
  const PodStage* ps;
  int sel;  // the pod's selector term
  bool has_required;
  // Block 0's thread 0 times the phases of each pod (clock64 cycles).
  bool timer = false;
  int phase = PH_COMMIT;
  long long t_last = 0;
  long long cycles[NPHASES] = {};

  __device__ long long slots(const ChainParams& P) const { return P.N; }
  __device__ long long node(long long li) const { return li; }
  __device__ bool leader() const { return true; }
  __device__ void mark(int next) {
    if (!timer) return;
    const long long now = clock64();
    cycles[phase] += now - t_last;
    t_last = now;
    phase = next;
  }
  __device__ uint8_t node_flags(const ChainParams& P, long long, long long n) const {
    return (aff_match(P, *S, *ps, sel, has_required, n) ? FL_AFF : 0) |
           (any_and(P, *S, *ps, G_TFORB, n) ? 0 : FL_TNT);
  }
  __device__ void reduce(int* v, const int* op, int K, Smem& s) { block_reduce(v, op, K, s.red); }
  __device__ unsigned long long max_u64(unsigned long long v, Smem& s) { return block_max_u64(v, s.red64); }
  __device__ void domains(const ChainParams&, const Spread&, Smem&, unsigned, int, int, int, int) { __syncthreads(); }
  __device__ void domains_after_reduce(const ChainParams&, const Spread&, Smem&, unsigned, int, int, int) {}
};

// Every filter for chunk row p (pod j) at node n, from the words where the
// pod's flags allow (filter_node's order and codes).
__device__ inline uint8_t batch_filter(const ChainParams& P, const SummaryParams& S, const PodStage& ps,
                                       const BatchTeam& team, long long p, long long j, long long n, const Smem& s,
                                       const Spread& sp, const Interpod& ip, bool sp_filter, bool record_bits,
                                       long long rowF) {
  const long long N = P.N;
  const unsigned pf = ps.pflags[0];
  bool ok = P.nvalid[n] != 0;
  const int taint = taint_code(P, S, ps, n);
  const bool aff = aff_match(P, S, ps, team.sel, team.has_required, n);
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
    const bool added_ok = S.nflags[n] & NS_ADDED_OK;
    const int bits = (added_ok ? 0 : 2) | (aff ? 0 : 1);
    ok = ok && bits == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[AFFINITY] * N + n, bits, P.bits_size);
  }
  if (P.f_row[PORTS] >= 0) {
    const bool conflict = any_and(P, S, ps, G_PORTS, n);
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
    const int code = (any_and(P, S, ps, G_DANY, n) || any_and(P, S, ps, G_DRW, n) ? 1 : 0) +
                     (any_and(P, S, ps, G_RWOP, n) ? 2 : 0);
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLRESTR] * N + n, code, P.bits_size);
  }
  for (long long q = 0; q < P.nvl_ninst; ++q) {
    bool over = false;
    if (pf & PF_VOL) {
      over = volume_limits_over(P, q, j, n);
    } else {  // the pod adds nothing: a pool already over its limit
      for (long long i = P.nvl_pool_off[q]; i < P.nvl_pool_off[q + 1]; ++i) over = over || S.room[P.nvl_pools[i] * N + n] < 0;
    }
    ok = ok && !over;
    if (record_bits) store_int(P.bits_out, rowF + P.nvl_row[q] * N + n, over, P.bits_size);
  }
  if (P.f_row[VOLBIND] >= 0) {
    const int code = (pf & (PF_PV | PF_WFFC)) ? volume_binding_code(P, j, n) : P.pod_fail[j];
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLBIND] * N + n, code, P.bits_size);
  }
  if (P.f_row[VOLZONE] >= 0) {
    const bool conflict = (pf & PF_PV) && volume_zone_conflict(P, j, n);
    ok = ok && !conflict;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[VOLZONE] * N + n, conflict, P.bits_size);
  }
  if (P.f_row[SPREAD] >= 0) {
    const int code = sp_filter ? spread_filter_code(P, sp, s, n, fl) : 0;
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[SPREAD] * N + n, code, P.bits_size);
  }
  if (P.f_row[INTERPOD] >= 0) {
    const int code = ip.filter ? interpod_code_words(P, S, ps, ip, n) : 0;
    ok = ok && code == 0;
    if (record_bits) store_int(P.bits_out, rowF + P.f_row[INTERPOD] * N + n, code, P.bits_size);
  }
  return fl | (ok ? FL_OK : 0);
}

// Chunk row p against every node (eval_pod_team's phases, with the
// block's words): writes the records of P.record and returns the
// selected node (-1 when none is feasible or the pod is padding) to every
// thread.
__device__ inline int eval_pod_batch(const ChainParams& P, const SummaryParams& S, long long p, Smem& s,
                                     const PodStage& ps, BatchTeam& team) {
  const long long N = P.N;
  const long long j = P.pindex[p];
  const bool full = P.record == 2;
  const bool finals = P.record >= 1;
  const bool sparse = P.record == 0;  // no work on pairs the record never holds
  const long long rowF = p * P.F * N;
  const long long rowS = p * P.S * N;
  const bool use_spread = P.f_row[SPREAD] >= 0 || P.s_row[SPREAD] >= 0;
  const bool use_ipa = P.f_row[INTERPOD] >= 0 || P.s_row[INTERPOD] >= 0;
  const bool use_samples = P.s_row[NODENUMBER] >= 0 || P.dp_n > 0;

  // -- phase 0: setup --
  team.mark(PH_SETUP);
  if (use_spread) {
    for (long long i = threadIdx.x; i < domain_ints(P); i += blockDim.x) s.dom[i] = 0;
    stage_spread(P, j, s.con);
  }
  stage_pod(P, S, j, s, ps, P.s_row[IMAGE] >= 0);
  __syncthreads();
  team.sel = P.selector_term[j];
  team.has_required = P.has_required[j] != 0;
  const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
  const Interpod ip = use_ipa ? interpod_pod(P, j, P.ipa_total) : Interpod{0, false, false, false, false};

  // -- phase 1: PodTopologySpread's filter statistics --
  team.mark(PH_SPREAD_F);
  const bool sp_filter = P.f_row[SPREAD] >= 0 && sp.any_f;
  if (sp_filter) spread_filter_stats(P, sp, j, s, team);

  // -- phase 2: filters --
  team.mark(PH_FILTER);
  for (long long n = threadIdx.x; n < N; n += blockDim.x)
    s.flags[n] = (sparse && !P.nvalid[n]) ? 0 : batch_filter(P, S, ps, team, p, j, n, s, sp, ip, sp_filter, full, rowF);
  __syncthreads();

  // -- phase 3: PodTopologySpread's score statistics --
  team.mark(PH_SPREAD_S);
  if (P.s_row[SPREAD] >= 0 && sp.has_score) spread_score_stats(P, sp, j, s, team, false);

  // -- phase 4: scores; the unnormalized finals are summed right away --
  team.mark(PH_SCORE);
  int ex[9] = {0, 0, INT_MIN, INT_MAX, 0, INT_MIN, INT_MAX, 0, 0};
  const int ex_op[9] = {RMAX, RMAX, RMAX, RMIN, RMAX, RMAX, RMIN, RMAX, RMAX};
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    const uint8_t fl = s.flags[n];
    const bool ok = fl & FL_OK;
    if (sparse && !ok) {
      if (P.s_row[INTERPOD] >= 0 && interpod_raw_words(P, S, ps, ip, n) != 0) ex[8] = 1;
      continue;
    }
    int partial = 0;
    if (P.s_row[TAINT] >= 0) {
      const int c = taint_raw(P, S, ps, n);
      if (ok) ex[0] = max(ex[0], c);
      if (full) store_int(P.raw_out, rowS + P.s_row[TAINT] * N + n, c, P.raw_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      const long long sc = aff_raw(P, S, ps, n);
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
      const int raw = spread_raw(P, sp, s, n, fl);
      if (ok && sp.has_score && sp_allkeys(P, sp, CF_S, n)) {  // scoreable
        ex[2] = max(ex[2], raw);
        ex[3] = min(ex[3], raw);
        ex[4] = 1;
      }
      if (full) store_int(P.raw_out, rowS + P.s_row[SPREAD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[INTERPOD] >= 0) {
      const int raw = interpod_raw_words(P, S, ps, ip, n);
      if (ok) {
        ex[5] = max(ex[5], raw);
        ex[6] = min(ex[6], raw);
        ex[7] = 1;
      }
      if (raw != 0) ex[8] = 1;
      if (full) store_int(P.raw_out, rowS + P.s_row[INTERPOD] * N + n, raw, P.raw_size);
    }
    if (P.s_row[IMAGE] >= 0) {
      const int raw = image_raw(P, S, ps, j, n, s);
      const int fin = raw * static_cast<int>(P.weight[IMAGE]);
      partial += fin;
      if (full) store_int(P.raw_out, rowS + P.s_row[IMAGE] * N + n, raw, P.raw_size);
      if (finals) store_int(P.final_out, rowS + P.s_row[IMAGE] * N + n, fin, P.final_size);
    }
    if (use_samples) partial = wrap_add(partial, sample_scores(P, j, n, rowS, full, finals));
    s.partial[n] = partial;
  }
  team.mark(PH_EX_REDUCE);
  team.reduce(ex, ex_op, 9, s);
  const int mx_taint = ex[0], mx_aff = ex[1];
  const int sp_mx = ex[4] ? ex[2] : 0, sp_mn = ex[4] ? ex[3] : 0;
  const int ipa_mx = ex[7] ? ex[5] : 0, ipa_mn = ex[7] ? ex[6] : 0;
  const bool ipa_nonzero = ex[8] != 0;

  // -- phase 5: normalizes (the taint, affinity, spread and interpod raw
  //    scores recomputed), total, selectHost --
  team.mark(PH_NORMALIZE);
  unsigned long long best = 0ULL;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    const uint8_t fl = s.flags[n];
    if (sparse && !(fl & FL_OK)) continue;
    int total = s.partial[n];
    if (P.s_row[TAINT] >= 0) {
      // Reverse DefaultNormalizeScore; DIVISION: raw >= 0, max > 0.
      const int raw = taint_raw(P, S, ps, n);
      const int norm = mx_taint > 0 ? MAX_NODE_SCORE - (MAX_NODE_SCORE * raw) / mx_taint : MAX_NODE_SCORE;
      const int fin = norm * static_cast<int>(P.weight[TAINT]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[TAINT] * N + n, fin, P.final_size);
    }
    if (P.s_row[AFFINITY] >= 0) {
      // DefaultNormalizeScore; DIVISION: raw >= 0, max > 0.  The product
      // fits 32 bits below IPA_IN_RANGE, where the 32-bit quotient is the
      // same and costs a fraction of the 64-bit one.
      const long long raw = static_cast<int>(aff_raw(P, S, ps, n));
      const int norm = static_cast<int>(
          mx_aff <= 0 ? raw
          : raw < IPA_IN_RANGE ? (MAX_NODE_SCORE * static_cast<int>(raw)) / mx_aff
                               : (static_cast<long long>(MAX_NODE_SCORE) * raw) / mx_aff);
      const int fin = norm * static_cast<int>(P.weight[AFFINITY]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[AFFINITY] * N + n, fin, P.final_size);
    }
    if (P.s_row[SPREAD] >= 0) {
      int norm = 0;
      if (sp.has_score && sp_allkeys(P, sp, CF_S, n)) {  // not ignored
        const int raw = spread_raw(P, sp, s, n, fl);
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
          (ipa_nonzero && (fl & FL_OK)) ? interpod_norm(P, interpod_raw_words(P, S, ps, ip, n), ipa_mn, ipa_mx) : 0;
      const int fin = norm * static_cast<int>(P.weight[INTERPOD]);
      total += fin;
      if (finals) store_int(P.final_out, rowS + P.s_row[INTERPOD] * N + n, fin, P.final_size);
    }
    if (finals) P.total[p * N + n] = total;
    if (fl & FL_OK) {
      const unsigned long long key = select_key(total, n);
      best = key > best ? key : best;
    }
  }
  team.mark(PH_SELECT);
  best = team.max_u64(best, s);
  team.mark(PH_COMMIT);
  return P.pvalid[p] ? key_node(best) : -1;
}

// ---- the block's shared memory --------------------------------------------------

// The layout (kernels/batch_eval.py batch_smem_bytes): 8-byte words first
// (the pod's words, image weights, reduction), then ints (reduction,
// prefix scratch, spread constraints, the domain scratch when it fits, the
// preferred weights and pod flags).  The node arrays are the block's row
// of node_scratch.
__host__ __device__ inline long long batch_fixed_bytes(const ChainParams& P, const SummaryParams& S) {
  return 8 * S.off[NGROUPS] + 8 * P.I + 8 * 33 + 4 * 33 * RED_MAX + 4 * SCAN_INTS +
         static_cast<long long>(sizeof(SpreadCon)) * P.MC + (P.sp_smem ? 4 * domain_ints(P) : 0) + 4 * P.T + 4;
}

__host__ __device__ inline long long batch_smem_bytes(const ChainParams& P, const SummaryParams& S) {
  return align8(batch_fixed_bytes(P, S));
}

__device__ inline Smem carve_batch(unsigned char* base, const ChainParams& P, const SummaryParams& S,
                                   PodStage& ps) {
  Smem s = {};
  ps.words = reinterpret_cast<unsigned long long*>(base);
  s.imgw = reinterpret_cast<double*>(ps.words + S.off[NGROUPS]);
  s.red64 = reinterpret_cast<unsigned long long*>(s.imgw + P.I);
  s.red = reinterpret_cast<int*>(s.red64 + 33);
  s.scan = s.red + 33 * RED_MAX;
  s.con = reinterpret_cast<SpreadCon*>(s.scan + SCAN_INTS);
  int* after = reinterpret_cast<int*>(s.con + P.MC);
  if (P.sp_smem) {
    s.dom = after;
    after += domain_ints(P);
  } else {
    s.dom = P.sp_scratch + blockIdx.x * domain_ints(P);
  }
  s.domc = s.dom;
  ps.pref = after;
  ps.pflags = reinterpret_cast<unsigned*>(after + P.T);
  unsigned char* nodes = S.node_scratch + blockIdx.x * S.node_stride;
  s.partial = reinterpret_cast<int32_t*>(nodes);
  s.flags = nodes + 4 * P.N;
  return s;
}

// ---- the kernel -------------------------------------------------------------------

__global__ void __launch_bounds__(B_THREADS, MIN_BLOCKS) batch_eval_kernel(const ChainParams P,
                                                                           const SummaryParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PodStage ps;
  Smem s = carve_batch(smem_raw, P, S, ps);
  BatchTeam team;
  team.S = &S;
  team.ps = &ps;
  team.timer = S.stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (team.timer) team.t_last = clock64();
  const bool selection = P.record == 0;
  long long evaluated = 0;
  for (long long p = blockIdx.x; p < P.Pc; p += gridDim.x) {
    if (selection && !P.pvalid[p]) {  // records only the selection: -1
      if (threadIdx.x == 0) P.selected[p] = -1;
      continue;
    }
    const int best = eval_pod_batch(P, S, p, s, ps, team);
    ++evaluated;
    if (threadIdx.x == 0) P.selected[p] = best;
  }
  if (team.timer) {
    S.stats[0] = evaluated;
    S.stats[1] = 0;
    team.mark(PH_COMMIT);
    for (int i = 0; i < NPHASES; ++i) S.stats[2 + i] = team.cycles[i];
  }
}

// Raise kernel B's dynamic shared memory cap to `smem` where the current
// device's cap is below it (set once per size and device, not per launch).
inline cudaError_t allow_smem(long long smem) {
  constexpr int MAX_DEVICES = 64;
  static long long allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(batch_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return err;
}

}  // namespace ksim

// The launch's shape: blocks per SM (the occupancy query at the launch's
// shared memory), the SMs, and the dynamic shared memory per block.
// Returns a CUDA error code.
extern "C" int ksim_batch_eval_occupancy(const ksim::ChainParams* params, const ksim::SummaryParams* summary,
                                         long long* info) {
  const long long smem = ksim::batch_smem_bytes(*params, *summary);
  cudaError_t err = ksim::allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ksim::batch_eval_kernel, ksim::B_THREADS,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ksim::batch_eval_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = per_sm;
  info[1] = sms;
  info[2] = smem;
  info[3] = attr.numRegs;
  info[4] = static_cast<long long>(attr.localSizeBytes);
  return 0;
}

extern "C" int ksim_node_summary(const ksim::ChainParams* params, const ksim::SummaryParams* summary, void* stream) {
  if (params->N == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((params->N + 255) / 256);
  ksim::node_summary_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(*params, *summary);
  return static_cast<int>(cudaGetLastError());
}

// The persistent launch of `grid` blocks (at most the resident ones, which
// the scratch was sized for).
extern "C" int ksim_batch_eval(const ksim::ChainParams* params, const ksim::SummaryParams* summary, void* stream,
                               long long grid) {
  if (params->Pc == 0) return 0;
  const long long smem = ksim::batch_smem_bytes(*params, *summary);
  cudaError_t err = ksim::allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::batch_eval_kernel<<<static_cast<unsigned>(grid), ksim::B_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      *params, *summary);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" long long ksim_summary_params_size() { return sizeof(ksim::SummaryParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
