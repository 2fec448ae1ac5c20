// Kernel E: the plugin chain in stages, for sm_90a.
//
// Replaces, for a profile the fused kernels cannot run (a plugin carrying a
// PluginExtender device hook, or a filter or score with no kernel code),
// the same ksim_tpu programs kernels A-C replace for the others:
// _Program._batch_eval, _batch_fn and _batch_fused_fn (ksim_tpu/engine/
// core.py:670, 689, 694), _schedule_sampled_fn with _sample_visited
// (:717-786) and _schedule_fn (:790).  ksim_tpu traces the hooks and the
// kernel-less plugins into those programs; here the program becomes a
// sequence of launches (engine/staged.py), and between them the hooks and
// the kernel-less plugins run as torch code on device tensors:
//
//   E1 filter_stage_kernel: for B pods against one (state, pods) input,
//      the filter rows that ChainParams' f_row / nvl_row turn on (a
//      sub-profile, kernels/chain_stages.py): reason codes int32
//      [B, F', N] and the AND of their ok with the node's validity [B, N];
//   E2 score_stage_kernel: the score rows over a given ok_in [B, N] (the
//      whole feasible set after every filter and after_filter, or the
//      sampled set): raw scores int64 [B, S', N], before normalizing;
//   E3 normalize_stage_kernel: per score row, the plugin's normalize over
//      ok_in (the extrema reduce, then the normalize) of given raw scores
//      int64 [B, S', N], before the weight: int64 [B, S', N]; a row with no
//      normalize passes through;
//   E4 window_stage_kernel: the percentageOfNodesToScore visit window of
//      one pod over ok_in: the sampled ok, the visited mask and the next
//      rotating start (in place);
//      select_stage_kernel: weight x normalized, the total in int32 as the
//      reference sums it, selectHost with ties to the lowest index; in the
//      scan (commit, one pod) the chosen node's state and the plugins'
//      carries are committed on the card (commit_pod).
//
// Every stage is built from plugin_chain.cuh's device functions, the ones
// kernels A-D run (filter_node, spread_filter_stats, spread_score_stats,
// interpod_pod, the scores, the normalizes, visit_window, commit_pod).
//
// Every stage spreads each pod row's node axis over a thread-block
// cluster of Cs blocks (cluster_scan.cuh's ClusterTeam, the team of
// kernels A and C): one node slot per thread, chunks of 32 nodes dealt
// round robin over the ranks, the reductions (PodTopologySpread's
// statistics, the normalizes' extrema, the selection's key maximum, the
// window's visit walk) crossing the cluster through distributed shared
// memory, so every block ends with the same integer values.  A launch is a grid of clusters;
// cluster c takes rows c, c + clusters, ...  Cs comes from the row count B
// (stage_cluster), one rule for the five stages: the largest of 16, 8, 4,
// 2 at which the B clusters take no more blocks than the card has SMs and
// the occupancy query finds room for all of them at once, else 1.  So one
// pod of the scan runs on 16 SMs (8 where a 16-block cluster does not
// fit), and once B exceeds half the SM count each row is a cluster of one
// block of E_THREADS, launched without the cluster attribute and closing
// its barriers on the block alone.  The committing selection is one row
// on one cluster: the owner of the chosen node commits its rows, every
// thread updates InterPodAffinity's counts on its own nodes, every block
// its copy of the term totals, and rank 0 writes that copy back at the
// end.  E4's visit window is one pod on one cluster too: kernel C's walk
// (plugin_chain.cuh visit_window, ClusterTeam::piece_find) over the flags
// of the block's node slots in shared memory, one exchange per cluster
// tile (one in all where a tile holds every real node).
//
// What bounds it: latency.  Each launch reads the node state and the
// pod's aux rows and writes [B, rows, N] values, a few operations per pair
// and row: well under a microsecond at the card's memory rate for one
// pod.  On a cluster a pod row takes about one node's chain of filters
// (E1) or scores (E2), or one node's loads and stores (E3, E4), the
// cluster barriers of its reductions and the launch; in the scan (B = 1)
// the host's hooks and parameters between the launches set the pace of a
// pod.  At B = 256 (one block per row) E3 and E4's selection stream their
// rows: E3 reads each raw value once where a thread keeps its node slots'
// raw values in registers (the first E3_KEEP of them), and re-reads those
// of further slots after the extrema reduce.

#include <mutex>

#include "cluster_scan.cuh"

namespace ksim {

// Threads per block of the stages on clusters of one block; they are
// built for blocks of up to E_MAX_THREADS (128 registers a thread).
constexpr int E_THREADS = 256;
constexpr int E_MAX_THREADS = 512;

enum Stage : int { E_FILTER = 1, E_SCORE = 2, E_NORMALIZE = 3, E_WINDOW = 4, E_SELECT = 5 };

// Every field is 8 bytes wide (the ctypes mirror is kernels/chain_stages.py
// StageParams).
struct StageParams {
  const uint8_t* ok_in;  // [B, N]: E2, E3, E4
  uint8_t* ok_out;  // [B, N]: E1's ok, E4 window's sampled ok
  void* out;  // E1: int32 [B, F, N] codes; E2, E3: int64 [B, S, N]
  const long long* in;  // E3: raw int64 [B, S, N]; E4 select: normalized int64 [B, S, N]
  const int32_t* weights;  // E4 select: [S]
  uint8_t* visited;  // E4 window: [N] or null
  int32_t* start;  // E4 window: the rotating start [1], in place
  int32_t* selected;  // E4 select: [B]
  int32_t* total;  // E4 select: [B, N] or null
  void* final_out;  // E4 select: [B, S, N] in final_size bytes, or null
  long long B, S, final_size, commit;
  long long scratch_rows;  // E1, E2: rows of P.sp_scratch (2 * domain_ints each) when it is used
};

// ---- every stage: one pod row on one cluster ---------------------------------

// The largest cluster the rule may take for B pod rows on a card of `sms`
// SMs: the largest of 16, 8, 4, 2 whose B clusters take no more blocks
// than the card has SMs, else 1.
__host__ __device__ inline int stage_cluster_cap(long long B, int sms) {
  for (int cs = MAX_CLUSTER; cs > 1; cs >>= 1)
    if (B * cs <= sms) return cs;
  return 1;
}

// The cluster size of a launch of B pod rows: the largest cs up to the cap
// at which the card holds all B clusters at once (fits(cs) >= B, fits the
// occupancy query's answer), else 1.  At B = 1: 16 where one 16-block
// cluster fits, else 8.  kernels/chain.py stage_cluster mirrors it.
template <class Fits>
inline int stage_cluster(long long B, int sms, Fits fits) {
  for (int cs = stage_cluster_cap(B, sms); cs > 1; cs >>= 1)
    if (fits(cs) >= B) return cs;
  return 1;
}

// Threads per block: a cluster of one keeps one block of E_THREADS; a
// larger cluster one node slot per thread for N / cs nodes
// (cluster_threads), at most E_MAX_THREADS.
__host__ __device__ inline int stage_threads(long long N, int cs) {
  if (cs == 1) return E_THREADS;
  const int t = cluster_threads(N, cs);
  return t < E_MAX_THREADS ? t : E_MAX_THREADS;
}

// The parts of the cluster layout each stage carves: E2's image weights;
// the 64-bit reduction and its two partials (E1, E2, E4 select); the int
// reduction and its two partial slots (E1, E2, E3); the copy of
// InterPodAffinity's term totals (E1, E2, E4 select); the pod's spread
// constraints (E1, E2, E3); when it fits, the partial and combined
// per-domain scratch (E1, E2); the visit walk's prefix scratch and its
// counts and ballots, two of each (E4 window); the flags, one byte per
// node slot (E2, E4 window).  kernels/chain.py STAGE_PARTS mirrors it.
struct StageParts {
  bool imgw, red64, red, tot, con, dom, walk, flags;
};

__host__ __device__ inline StageParts stage_parts(int stage) {
  const bool fs = stage == E_FILTER || stage == E_SCORE;
  return {stage == E_SCORE, fs || stage == E_SELECT, fs || stage == E_NORMALIZE, fs || stage == E_SELECT,
          fs || stage == E_NORMALIZE, fs, stage == E_WINDOW, stage == E_SCORE || stage == E_WINDOW};
}

// A cluster stage's shared memory per block (carve_stage_cluster): 8-byte
// words first, then ints, the spread constraints, the domain scratch, the
// walk's ints and the flags.
__host__ __device__ inline long long stage_cluster_smem_bytes(const ChainParams& P, long long slots, int stage) {
  const StageParts k = stage_parts(stage);
  return (k.imgw ? 8 * P.I : 0) + (k.red64 ? 8 * (33 + 2) : 0) + (k.red ? 4 * (33 * RED_MAX + 2 * RED_MAX) : 0) +
         (k.tot ? 4 * P.T2 : 0) + (k.con ? static_cast<long long>(sizeof(SpreadCon)) * P.MC : 0) +
         (k.dom && P.sp_smem ? 2 * 4 * domain_ints(P) : 0) + (k.walk ? 4 * (SCAN_INTS + 2 * 32 + 2 * 32) : 0) +
         (k.flags ? slots : 0);
}

// Where the domains do not fit shared memory, block `rank` of cluster c
// has row pair c * Cs + rank of P.sp_scratch (ClusterTeam::combine reads
// its cluster's Cs pairs).
__device__ inline Smem carve_stage_cluster(unsigned char* base, const ChainParams& P, const ClusterTeam& team,
                                           long long cluster, int stage) {
  const StageParts k = stage_parts(stage);
  const long long di = domain_ints(P);
  Smem s = {};
  unsigned char* at = base;
  if (k.imgw) {
    s.imgw = reinterpret_cast<double*>(at);
    at += 8 * P.I;
  }
  if (k.red64) {
    s.red64 = reinterpret_cast<unsigned long long*>(at);
    s.cred64 = s.red64 + 33;
    at += 8 * (33 + 2);
  }
  if (k.red) {
    s.red = reinterpret_cast<int*>(at);
    s.cred = s.red + 33 * RED_MAX;
    at += 4 * (33 * RED_MAX + 2 * RED_MAX);
  }
  if (k.tot) {
    s.ipa_tot = reinterpret_cast<int32_t*>(at);
    at += 4 * P.T2;
  }
  if (k.con) {
    s.con = reinterpret_cast<SpreadCon*>(at);
    at += sizeof(SpreadCon) * P.MC;
  }
  if (k.dom) {
    if (P.sp_smem) {
      s.dom = reinterpret_cast<int*>(at);
      at += 2 * 4 * di;
    } else {
      s.dom = P.sp_scratch + (cluster * team.size + team.rank) * 2 * di;
    }
    s.domc = s.dom + di;
  }
  if (k.walk) {
    s.scan = reinterpret_cast<int*>(at);
    s.wcnt = s.scan + SCAN_INTS;
    s.wmask = reinterpret_cast<unsigned*>(s.wcnt + 2 * 32);
    at += 4 * (SCAN_INTS + 2 * 32 + 2 * 32);
  }
  if (k.flags) s.flags = at;
  return s;
}

// The team of this block's cluster, its shared memory, and the cluster's
// pod rows (c, c + nc, ...).  Where the stage carves it, every block
// keeps its own copy of the term totals, published by the first row's
// block barrier; E1 and E2 only read it, the committing selection adds
// the pod's terms to it.  On a cluster of one block (a launch without
// the cluster attribute: the card's implicit cluster of one) the team's
// barriers are block barriers.
struct StageCluster {
  ClusterTeam team;
  Smem s;
  long long c, nc;

  __device__ StageCluster(unsigned char* base, const ChainParams& P, int stage) {
    team = make_cluster_team(P.N);
    team.one_block = team.size == 1;
    c = blockIdx.x / team.size;
    nc = gridDim.x / team.size;
    s = carve_stage_cluster(base, P, team, c, stage);
    team.tot = s.ipa_tot;
    if (s.ipa_tot != nullptr && P.ipa_total != nullptr)
      for (long long t = threadIdx.x; t < P.T2; t += blockDim.x) s.ipa_tot[t] = P.ipa_total[t];
  }

  // The end of a pod row.  After a row whose reductions crossed the
  // cluster, the team's barrier: no block zeroes its domain partials for
  // the next row, or leaves the kernel, while another block may still read
  // them or its reduction slots.  Else (or on a cluster of one) a block
  // barrier: the next row restages the constraints, the image weights and
  // the flags.
  __device__ void row_end(bool crossed) {
    if (crossed) team.sync();
    else __syncthreads();
  }
};

// The pod's spread constraints staged and its domain partials zeroed; the
// caller's barrier publishes them.
__device__ inline void stage_pod_spread(const ChainParams& P, long long j, Smem& s) {
  for (long long i = threadIdx.x; i < domain_ints(P); i += blockDim.x) s.dom[i] = 0;
  stage_spread(P, j, s.con);
}

// ---- E1: the filters ---------------------------------------------------------

__global__ void __launch_bounds__(E_MAX_THREADS, 1) filter_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageCluster k(smem_raw, P, E_FILTER);
  ClusterTeam& team = k.team;
  Smem& s = k.s;
  const long long N = P.N;
  const bool use_spread = P.f_row[SPREAD] >= 0;
  const bool use_ipa = P.f_row[INTERPOD] >= 0;
  for (long long b = k.c; b < S.B; b += k.nc) {
    const long long j = P.pindex[b];
    if (use_spread) stage_pod_spread(P, j, s);
    __syncthreads();
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const Interpod ip = use_ipa ? interpod_pod(P, j, team.ipa_total(P)) : Interpod{0, false, false, false, false};
    const bool sp_filter = use_spread && sp.any_f;
    if (sp_filter) spread_filter_stats(P, sp, j, s, team);
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      const uint8_t fl = filter_node(P, b, j, n, s, sp, ip, sp_filter, true, b * P.F * N);
      S.ok_out[b * N + n] = (fl & FL_OK) ? 1 : 0;
    }
    k.row_end(sp_filter);
  }
}

// ---- E2: the raw scores ------------------------------------------------------

__global__ void __launch_bounds__(E_MAX_THREADS, 1) score_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageCluster k(smem_raw, P, E_SCORE);
  ClusterTeam& team = k.team;
  Smem& s = k.s;
  const long long N = P.N;
  const bool use_spread = P.s_row[SPREAD] >= 0;
  const bool use_ipa = P.s_row[INTERPOD] >= 0;
  const bool use_samples = P.s_row[NODENUMBER] >= 0 || P.dp_n > 0;
  for (long long b = k.c; b < S.B; b += k.nc) {
    const long long j = P.pindex[b];
    if (P.s_row[IMAGE] >= 0) image_weights(P, j, s);
    if (use_spread) stage_pod_spread(P, j, s);
    // Each slot's flags: the ok given, and (read by PodTopologySpread
    // alone) the pod's node affinity and taint flags.
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      s.flags[li] = (use_spread ? node_flags(P, j, n) : 0) | (S.ok_in[b * N + n] ? FL_OK : 0);
    }
    __syncthreads();
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const Interpod ip = use_ipa ? interpod_pod(P, j, team.ipa_total(P)) : Interpod{0, false, false, false, false};
    const bool stats = use_spread && sp.has_score;
    if (stats) spread_score_stats(P, sp, j, s, team, false);
    const long long rowS = b * P.S * N;
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      const uint8_t fl = s.flags[li];
      if (P.s_row[TAINT] >= 0) store_int(P.raw_out, rowS + P.s_row[TAINT] * N + n, taint_prefer_count(P, j, n), 8);
      if (P.s_row[AFFINITY] >= 0)
        store_int(P.raw_out, rowS + P.s_row[AFFINITY] * N + n, affinity_pref_sum(P, j, n), 8);
      if (P.s_row[FIT] >= 0) store_int(P.raw_out, rowS + P.s_row[FIT] * N + n, fit_score(P, b, n), 8);
      if (P.s_row[BALANCED] >= 0) store_int(P.raw_out, rowS + P.s_row[BALANCED] * N + n, balanced_score(P, b, n), 8);
      if (P.s_row[SPREAD] >= 0) store_int(P.raw_out, rowS + P.s_row[SPREAD] * N + n, spread_raw(P, sp, s, n, fl), 8);
      if (P.s_row[INTERPOD] >= 0) store_int(P.raw_out, rowS + P.s_row[INTERPOD] * N + n, interpod_raw(P, ip, n), 8);
      if (P.s_row[IMAGE] >= 0) store_int(P.raw_out, rowS + P.s_row[IMAGE] * N + n, image_score(P, j, n, s), 8);
      if (use_samples) sample_scores(P, j, n, rowS, true, false);
    }
    k.row_end(stats);
  }
}

// ---- E3: the normalizes ------------------------------------------------------

// The node slots per thread whose raw values E3 keeps in registers from the
// extrema fold to the normalize (one at one pod of the main path: 16
// blocks of 384 threads over 6144 nodes); a thread re-reads those of
// further slots after the reduce.
constexpr int E3_KEEP = 4;

// What the normalizes read at one node: the raw values of the rows with a
// normalize (at most four, whatever the stage's row count), the node's ok
// and PodTopologySpread's scoreable flag.  n < 0: no node.
struct NormSlot {
  long long n = -1;
  long long affinity = 0;
  int taint = 0, spread = 0, interpod = 0;
  bool ok = false, scoreable = false;
};

// Reads slot n's values (rows of `in`, the pod row's raw scores).
__device__ inline NormSlot norm_slot(const ChainParams& P, const Spread& sp, const long long* in, const uint8_t* ok,
                                     long long n, bool use_spread) {
  const long long N = P.N;
  NormSlot v;
  v.n = n;
  v.ok = ok[n] != 0;
  if (P.s_row[TAINT] >= 0) v.taint = static_cast<int>(in[P.s_row[TAINT] * N + n]);
  if (P.s_row[AFFINITY] >= 0) v.affinity = in[P.s_row[AFFINITY] * N + n];
  if (use_spread) {
    v.spread = static_cast<int>(in[P.s_row[SPREAD] * N + n]);
    v.scoreable = spread_scoreable(P, sp, n);
  }
  if (P.s_row[INTERPOD] >= 0) v.interpod = static_cast<int>(in[P.s_row[INTERPOD] * N + n]);
  return v;
}

__device__ inline void fold_slot(const ChainParams& P, const NormSlot& v, NormExtrema& ex, bool use_spread) {
  if (P.s_row[TAINT] >= 0) ex.taint(v.taint, v.ok);
  if (P.s_row[AFFINITY] >= 0) ex.affinity(static_cast<int>(v.affinity), v.ok);
  if (use_spread) ex.spread(v.spread, v.ok && v.scoreable);
  if (P.s_row[INTERPOD] >= 0) ex.interpod(v.interpod, v.ok);
}

// The rows without a normalize pass through; each is read and written once.
__device__ inline void pass_rows(const ChainParams& P, const long long* in, long long* out, long long n) {
  const long long N = P.N;
  for (long long r = 0; r < P.S; ++r)
    if (r != P.s_row[TAINT] && r != P.s_row[AFFINITY] && r != P.s_row[SPREAD] && r != P.s_row[INTERPOD])
      out[r * N + n] = in[r * N + n];
}

__device__ inline void write_norms(const ChainParams& P, const NormSlot& v, const NormExtrema& ex, long long* out,
                                   bool use_spread) {
  const long long N = P.N, n = v.n;
  if (P.s_row[TAINT] >= 0) out[P.s_row[TAINT] * N + n] = ex.taint_norm(v.taint);
  if (P.s_row[AFFINITY] >= 0) out[P.s_row[AFFINITY] * N + n] = ex.affinity_norm(v.affinity);
  if (use_spread) out[P.s_row[SPREAD] * N + n] = ex.spread_norm_flag(v.scoreable, v.spread);
  if (P.s_row[INTERPOD] >= 0) out[P.s_row[INTERPOD] * N + n] = ex.interpod_norm(P, v.ok, [&] { return v.interpod; });
}

// Per pod row: each thread reads its slots' raw values, copies the rows
// without a normalize and folds the extrema (eval_pod_team's, over the
// given raw scores); the cluster reduces them; each thread writes its
// slots' normalized rows, from registers for its first E3_KEEP slots.  A
// row with no normalize needs no reduce.
__global__ void __launch_bounds__(E_MAX_THREADS, 1) normalize_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageCluster k(smem_raw, P, E_NORMALIZE);
  ClusterTeam& team = k.team;
  Smem& s = k.s;
  const long long N = P.N, L = team.slots(P);
  const bool use_spread = P.s_row[SPREAD] >= 0;
  const bool normalizes = P.s_row[TAINT] >= 0 || P.s_row[AFFINITY] >= 0 || use_spread || P.s_row[INTERPOD] >= 0;
  for (long long b = k.c; b < S.B; b += k.nc) {
    const long long j = P.pindex[b];
    if (use_spread) {
      stage_spread(P, j, s.con);
      __syncthreads();
    }
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const long long* in = S.in + b * P.S * N;
    long long* out = static_cast<long long*>(S.out) + b * P.S * N;
    const uint8_t* ok = S.ok_in + b * N;
    NormExtrema ex;
    NormSlot kept[E3_KEEP];
#pragma unroll
    for (int q = 0; q < E3_KEEP; ++q) {
      const long long li = threadIdx.x + static_cast<long long>(q) * blockDim.x;
      const long long n = li < L ? team.node(li) : N;
      if (n >= N) continue;
      kept[q] = norm_slot(P, sp, in, ok, n, use_spread);
      fold_slot(P, kept[q], ex, use_spread);
      pass_rows(P, in, out, n);
    }
    for (long long li = threadIdx.x + static_cast<long long>(E3_KEEP) * blockDim.x; li < L; li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      fold_slot(P, norm_slot(P, sp, in, ok, n, use_spread), ex, use_spread);
      pass_rows(P, in, out, n);
    }
    if (!normalizes) {
      k.row_end(false);
      continue;
    }
    ex.reduce(team, s);
#pragma unroll
    for (int q = 0; q < E3_KEEP; ++q)
      if (kept[q].n >= 0) write_norms(P, kept[q], ex, out, use_spread);
    for (long long li = threadIdx.x + static_cast<long long>(E3_KEEP) * blockDim.x; li < L; li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      write_norms(P, norm_slot(P, sp, in, ok, n, use_spread), ex, out, use_spread);
    }
    k.row_end(true);
  }
}

// ---- E4: the visit window, and the selection with its commit -------------------

// One pod on one cluster: kernel C's visit window (plugin_chain.cuh
// visit_window) over ok_in, from the rotating start.  Each thread sets the
// flags of its node slots, the walk finds the threshold (one exchange per
// cluster tile it visits), and each thread writes its nodes' sampled ok
// and visited.  Every block reads the start in place; rank 0 advances it
// only after the closing barrier, when no block still reads it (nor
// another's counts and ballots).
__global__ void __launch_bounds__(E_MAX_THREADS, 1) window_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageCluster k(smem_raw, P, E_WINDOW);
  ClusterTeam& team = k.team;
  Smem& s = k.s;
  const long long N = P.N, L = team.slots(P);
  const long long nr = max(P.n_real, 1LL);
  const long long start = *S.start;
  const long long sm = floormod(start, nr);
  for (long long li = threadIdx.x; li < L; li += blockDim.x) {
    const long long n = team.node(li);
    s.flags[li] = n < N && S.ok_in[n] ? FL_OK : 0;
  }
  __syncthreads();
  const Spread none_sp{s.con, false, false, false};
  const Interpod none_ip{0, false, false, false, false};
  const long long thr = visit_window<false>(P, 0, 0, s, none_sp, none_ip, false, team, sm);
  for (long long li = threadIdx.x; li < L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= N) continue;
    const bool visited = n < P.n_real && floormod(n - sm, nr) <= thr;
    S.ok_out[n] = ((s.flags[li] & FL_OK) && visited) ? 1 : 0;
    if (S.visited != nullptr) S.visited[n] = visited;
  }
  k.row_end(true);
  // Padding pods never ran a cycle upstream: no rotation.
  if (team.leader() && threadIdx.x == 0 && P.pvalid[0]) *S.start = static_cast<int32_t>(floormod(start + thr + 1, nr));
}

// Per pod row: weight x normalized and the int32 total at each of the
// thread's nodes, the cluster's key maximum, and with `commit` (one row on
// one cluster) the pod committed onto the chosen node.
__global__ void __launch_bounds__(E_MAX_THREADS, 1) select_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageCluster k(smem_raw, P, E_SELECT);
  ClusterTeam& team = k.team;
  Smem& s = k.s;
  const long long N = P.N;
  for (long long b = k.c; b < S.B; b += k.nc) {
    const long long rowS = b * S.S * N;
    unsigned long long best = 0ULL;
    for (long long li = threadIdx.x; li < team.slots(P); li += blockDim.x) {
      const long long n = team.node(li);
      if (n >= N) continue;
      unsigned total = 0;  // WRAP: the reference's int32 sum of the finals
      for (long long r = 0; r < S.S; ++r) {
        const long long fin = S.in[rowS + r * N + n] * static_cast<long long>(S.weights[r]);
        total += static_cast<unsigned>(fin);
        if (S.final_out != nullptr) store_int(S.final_out, rowS + r * N + n, fin, S.final_size);
      }
      if (S.total != nullptr) S.total[b * N + n] = static_cast<int>(total);
      if (S.ok_in[b * N + n]) {
        const unsigned long long key = select_key(static_cast<int>(total), n);
        best = key > best ? key : best;
      }
    }
    best = team.max_u64(best, s);
    const int sel = P.pvalid[b] ? key_node(best) : -1;
    if (team.leader() && threadIdx.x == 0) S.selected[b] = sel;
    if (S.commit && sel >= 0) commit_pod(P, b, sel, team);
    k.row_end(true);
  }
  // The committing selection: after the barrier above (every block has
  // copied the totals and committed), rank 0 writes its copy back.
  if (S.commit && P.ipa_total != nullptr && team.leader())
    for (long long t = threadIdx.x; t < P.T2; t += blockDim.x) P.ipa_total[t] = s.ipa_tot[t];
}

// Raise a stage kernel's dynamic shared memory cap to `smem` where it is
// above the default 48 KB (set once per kernel, size and device).
inline cudaError_t allow_stage_smem(void (*kernel)(ChainParams, StageParams), int stage, long long smem) {
  constexpr int MAX_DEVICES = 64;
  static long long allowed[MAX_DEVICES][6] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem <= allowed[dev][stage]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev][stage] = smem;
  return err;
}

// What the cluster stages' launches ask of the card once and keep, per
// device: its SM count, that 16-block clusters are allowed, and the
// occupancy query's answers by stage, cluster size, threads and shared
// memory.
class StageCard {
 public:
  // The SM count of device `dev`, and the kernel allowed non-portable
  // cluster sizes there.
  cudaError_t prepare(void (*kernel)(ChainParams, StageParams), int stage, int dev, int* sms) {
    std::lock_guard<std::mutex> lock(mu_);
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    cudaError_t err = cudaSuccess;
    if (sms_[dev] == 0) err = cudaDeviceGetAttribute(&sms_[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && !nonportable_[dev][stage]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      nonportable_[dev][stage] = err == cudaSuccess;
    }
    *sms = sms_[dev];
    return err;
  }

  // The clusters of `cfg` the card holds at once (0 where it refuses the
  // shape).
  int fits(void (*kernel)(ChainParams, StageParams), int stage, int dev, const cudaLaunchConfig_t& cfg) {
    Fit key{dev, stage, static_cast<int>(cfg.attrs[0].val.clusterDim.x), static_cast<int>(cfg.blockDim.x),
            static_cast<long long>(cfg.dynamicSmemBytes), 0};
    std::lock_guard<std::mutex> lock(mu_);
    for (int i = 0; i < used_; ++i)
      if (fit_[i].same(key)) return fit_[i].clusters;
    if (cudaOccupancyMaxActiveClusters(&key.clusters, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a shape the card refuses: no room
      key.clusters = 0;
    }
    if (used_ < MAX_FITS) fit_[used_++] = key;
    return key.clusters;
  }

 private:
  static constexpr int MAX_DEVICES = 64, MAX_FITS = 256;
  struct Fit {
    int dev, stage, cs, nt;
    long long smem;
    int clusters;
    bool same(const Fit& o) const {
      return dev == o.dev && stage == o.stage && cs == o.cs && nt == o.nt && smem == o.smem;
    }
  };
  std::mutex mu_;
  int sms_[MAX_DEVICES] = {};
  bool nonportable_[MAX_DEVICES][E_SELECT + 1] = {};
  Fit fit_[MAX_FITS] = {};
  int used_ = 0;
};

inline StageCard& stage_card() {
  static StageCard card;
  return card;
}

// Launches a stage on `clusters` clusters of `cluster` blocks (0:
// stage_cluster's size) of stage_threads; a size of one launches without
// the cluster attribute (the card's implicit cluster of one block).  info
// (int64 [3]) receives the cluster size, the threads per block and the
// shared memory per block.  A refused launch is an error, never a smaller
// launch.
inline cudaError_t launch_stage_cluster(void (*kernel)(ChainParams, StageParams), int stage, const ChainParams& P,
                                        const StageParams& S, cudaStream_t stream, long long clusters, int cluster,
                                        long long* info) {
  if (cluster < 0 || cluster > MAX_CLUSTER) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = stage_card().prepare(kernel, stage, dev, &sms);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  // The launch at cluster size cs; its shared memory allowed.
  auto shape = [&](int cs) {
    const int nt = stage_threads(P.N, cs);
    const long long smem = stage_cluster_smem_bytes(P, cluster_slots(P.N, cs, nt), stage);
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * cs), 1, 1);
    cfg.blockDim = dim3(nt, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = cs > 1 ? 1 : 0;
    return allow_stage_smem(kernel, stage, smem);
  };
  int cs = cluster;
  if (cs == 0) {
    cs = stage_cluster(S.B, sms, [&](int c) {
      return shape(c) == cudaSuccess ? stage_card().fits(kernel, stage, dev, cfg) : 0;
    });
    cudaGetLastError();  // a size whose shared memory the card refuses was skipped
  }
  err = shape(cs);
  if (err != cudaSuccess) return err;
  if (stage_parts(stage).dom && !P.sp_smem && domain_ints(P) > 0 && S.scratch_rows < clusters * cs)
    return cudaErrorInvalidValue;
  info[0] = cs;
  info[1] = cfg.blockDim.x;
  info[2] = static_cast<long long>(cfg.dynamicSmemBytes);
  err = cudaLaunchKernelEx(&cfg, kernel, P, S);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ksim

// Launches stage `stage` (ksim::Stage) on the caller's stream on `grid`
// clusters of `cluster` blocks (0: the launch's choice,
// launch_stage_cluster; info, int64 [3], receives what ran); E4's window
// and the committing selection take one pod on one cluster.  Returns a
// CUDA error code; a refused launch is an error.
extern "C" int ksim_chain_stages(int stage, const ksim::ChainParams* params, const ksim::StageParams* sp,
                                 void* stream, long long grid, int cluster, long long* info) {
  using namespace ksim;
  void (*kernel)(ChainParams, StageParams) = nullptr;
  switch (stage) {
    case E_FILTER: kernel = filter_stage_kernel; break;
    case E_SCORE: kernel = score_stage_kernel; break;
    case E_NORMALIZE: kernel = normalize_stage_kernel; break;
    case E_WINDOW: kernel = window_stage_kernel; break;
    case E_SELECT: kernel = select_stage_kernel; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid < 1 || ((stage == E_WINDOW || sp->commit) && grid != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (sp->B == 0) return 0;
  return static_cast<int>(
      launch_stage_cluster(kernel, stage, *params, *sp, static_cast<cudaStream_t>(stream), grid, cluster, info));
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" long long ksim_stage_params_size() { return sizeof(ksim::StageParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
