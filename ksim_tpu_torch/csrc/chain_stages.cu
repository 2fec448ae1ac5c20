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
// interpod_pod, the scores, the normalizes, visit_window, commit_pod), on
// a team of one thread block per pod row (StageTeam): thread t owns nodes
// t, t + blockDim.x, ..., the reductions run in the block.  A block takes
// rows b, b + grid, ... of the launch.
//
// What bounds it: each launch reads the node state and the pod's aux rows
// and writes [B, rows, N] values, a few operations per pair and row; in
// the scan B = 1, so a launch is one block on one SM and the launch
// overhead and the host's hooks between launches bound it, not the card.
// A simple kernel, not yet redesigned (ROADMAP.md Queue 2).

#include "plugin_chain.cuh"

namespace ksim {

constexpr int E_THREADS = 256;

enum Stage : int { E_FILTER = 1, E_SCORE = 2, E_NORMALIZE = 3, E_WINDOW = 4, E_SELECT = 5 };

// Every field is 8 bytes wide (the ctypes mirror is kernels/chain_stages.py
// StageParams).
struct StageParams {
  const uint8_t* ok_in;  // [B, N]: E2, E3, E4
  uint8_t* ok_out;  // [B, N]: E1's ok, E4 window's sampled ok
  void* out;  // E1: int32 [B, F, N] codes; E2, E3: int64 [B, S, N]
  const long long* in;  // E3: raw int64 [B, S, N]; E4 select: normalized int64 [B, S, N]
  const int32_t* weights;  // E4 select: [S]
  uint8_t* node_scratch;  // [grid, N]: E2's per-node flags, E4 window's
  uint8_t* visited;  // E4 window: [N] or null
  int32_t* start;  // E4 window: the rotating start [1], in place
  int32_t* selected;  // E4 select: [B]
  int32_t* total;  // E4 select: [B, N] or null
  void* final_out;  // E4 select: [B, S, N] in final_size bytes, or null
  long long B, S, final_size, commit;
};

// One thread block is the team of one pod row (plugin_chain.cuh's team
// interface, as kernel B's BatchTeam, over plugin_chain.cuh's own
// predicates).
struct StageTeam {
  static constexpr bool kCluster = false;
  long long T = 0;  // nodes per visit tile (visit_window): the block's threads

  __device__ long long slots(const ChainParams& P) const { return P.N; }
  __device__ long long node(long long li) const { return li; }
  __device__ bool owns(long long n) const { return n % blockDim.x == threadIdx.x; }
  __device__ bool leader() const { return true; }
  __device__ void mark(int) {}
  __device__ const int32_t* ipa_total(const ChainParams& P) const { return P.ipa_total; }
  __device__ uint8_t node_flags(const ChainParams& P, long long j, long long n) const {
    return ksim::node_flags(P, j, n);
  }
  __device__ void reduce(int* v, const int* op, int K, Smem& s) { block_reduce(v, op, K, s.red); }
  __device__ unsigned long long max_u64(unsigned long long v, Smem& s) { return block_max_u64(v, s.red64); }
  __device__ void domains(const ChainParams&, const Spread&, Smem&, unsigned, int, int, int, int) { __syncthreads(); }
  __device__ void domains_after_reduce(const ChainParams&, const Spread&, Smem&, unsigned, int, int, int) {}
  __device__ void commit_total(const ChainParams& P, const int32_t* db, long long base) {
    if (threadIdx.x == 0)
      for (long long t = 0; t < P.T2; ++t)
        if (db[t] >= 0) P.ipa_total[t] += P.ipa_qm[base + t];
  }

  // One step of the visit walk (plugin_chain.cuh visit_window) in tile
  // `tile` (blockDim.x nodes of index order, thread t holding node
  // tile * blockDim.x + t): `f` is this thread's node's bit.  Sets `count`
  // to the bits set in the tile and returns the need-th set bit's node in
  // visit order when need <= count, else -1.  Visit order is index order,
  // rotated at node `rot` when rot >= 0 (then one tile holds every real
  // node).  ClusterTeam::piece_find with one block.
  __device__ long long piece_find(bool f, long long tile, long long need, Smem& s, long long& count, long long rot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) {
      s.wcnt[warp] = __popc(m);
      s.wmask[warp] = m;
    }
    __syncthreads();
    if (warp == 0) {
      const int val = lane < nw ? s.wcnt[lane] : 0;
      int incl = val;  // inclusive scan of the warps' counts, in node order
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      long long g = need;  // the wanted bit's rank in index order
      if (rot >= 0) {
        const int rc = static_cast<int>((rot >> 5) - tile * nw);  // rot's warp in the tile
        int before = 0;
        if (lane == rc) before = incl - val + __popc(s.wmask[lane] & ((1u << (rot & 31)) - 1u));
        before = __shfl_sync(0xffffffffu, before, rc);
        const long long after = total - before;
        g = need <= after ? before + need : need - after;
      }
      if (lane < nw && val > 0 && incl - val < g && g <= incl) {
        unsigned mm = s.wmask[lane];
        for (long long r = g - (incl - val); r > 1; --r) mm &= mm - 1;  // drop the lower set bits
        s.scan[0] = static_cast<int>((tile * nw + lane) * 32 + (__ffs(mm) - 1));
      }
      if (lane == 0) s.scan[1] = total;
    }
    __syncthreads();
    count = s.scan[1];
    const long long found = need <= count ? s.scan[0] : -1;
    __syncthreads();  // the next step rewrites s.scan and s.wcnt
    return found;
  }
};

// The block's shared memory (stage_smem_bytes):
// 8-byte words first (image weights, the 64-bit reduction), then ints (the
// reduction, the prefix scratch, the visit walk's counts and ballots), the
// pod's spread constraints and, when it fits, its per-domain scratch (else
// the block's row of P.sp_scratch).  The per-node flags are the block's
// row of S.node_scratch.
__host__ __device__ inline long long stage_smem_bytes(const ChainParams& P) {
  return align8(8 * P.I + 8 * 33 + 4 * (33 * RED_MAX + SCAN_INTS + 2 * 32) +
                static_cast<long long>(sizeof(SpreadCon)) * P.MC + (P.sp_smem ? 4 * domain_ints(P) : 0));
}

__device__ inline Smem carve_stage(unsigned char* base, const ChainParams& P, const StageParams& S) {
  Smem s = {};
  s.imgw = reinterpret_cast<double*>(base);
  s.red64 = reinterpret_cast<unsigned long long*>(s.imgw + P.I);
  s.red = reinterpret_cast<int*>(s.red64 + 33);
  s.scan = s.red + 33 * RED_MAX;
  s.wcnt = s.scan + SCAN_INTS;
  s.wmask = reinterpret_cast<unsigned*>(s.wcnt + 32);
  s.con = reinterpret_cast<SpreadCon*>(s.wmask + 32);
  s.dom = P.sp_smem ? reinterpret_cast<int*>(s.con + P.MC) : P.sp_scratch + blockIdx.x * domain_ints(P);
  s.domc = s.dom;
  s.flags = S.node_scratch != nullptr ? S.node_scratch + blockIdx.x * P.N : nullptr;
  return s;
}

// The pod's spread constraints staged and its domain scratch zeroed; the
// caller's barrier publishes them.
__device__ inline void stage_pod_spread(const ChainParams& P, long long j, Smem& s, bool zero_domains) {
  if (zero_domains)
    for (long long i = threadIdx.x; i < domain_ints(P); i += blockDim.x) s.dom[i] = 0;
  stage_spread(P, j, s.con);
}

// ---- E1: the filters ---------------------------------------------------------

__global__ void __launch_bounds__(E_THREADS) filter_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_stage(smem_raw, P, S);
  StageTeam team;
  const long long N = P.N;
  const bool use_spread = P.f_row[SPREAD] >= 0;
  const bool use_ipa = P.f_row[INTERPOD] >= 0;
  for (long long b = blockIdx.x; b < S.B; b += gridDim.x) {
    const long long j = P.pindex[b];
    if (use_spread) stage_pod_spread(P, j, s, true);
    __syncthreads();
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const Interpod ip = use_ipa ? interpod_pod(P, j, P.ipa_total) : Interpod{0, false, false, false, false};
    const bool sp_filter = use_spread && sp.any_f;
    if (sp_filter) spread_filter_stats(P, sp, j, s, team);
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
      const uint8_t fl = filter_node(P, b, j, n, s, sp, ip, sp_filter, true, b * P.F * N);
      S.ok_out[b * N + n] = (fl & FL_OK) ? 1 : 0;
    }
    __syncthreads();  // the next row restages the constraints and the domains
  }
}

// ---- E2: the raw scores ------------------------------------------------------

__global__ void __launch_bounds__(E_THREADS) score_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_stage(smem_raw, P, S);
  StageTeam team;
  const long long N = P.N;
  const bool use_spread = P.s_row[SPREAD] >= 0;
  const bool use_ipa = P.s_row[INTERPOD] >= 0;
  const bool use_samples = P.s_row[NODENUMBER] >= 0 || P.dp_n > 0;
  for (long long b = blockIdx.x; b < S.B; b += gridDim.x) {
    const long long j = P.pindex[b];
    if (P.s_row[IMAGE] >= 0) image_weights(P, j, s);
    if (use_spread) stage_pod_spread(P, j, s, true);
    for (long long n = threadIdx.x; n < N; n += blockDim.x)
      s.flags[n] = node_flags(P, j, n) | (S.ok_in[b * N + n] ? FL_OK : 0);
    __syncthreads();
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const Interpod ip = use_ipa ? interpod_pod(P, j, P.ipa_total) : Interpod{0, false, false, false, false};
    if (use_spread && sp.has_score) spread_score_stats(P, sp, j, s, team, false);
    const long long rowS = b * P.S * N;
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
      const uint8_t fl = s.flags[n];
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
    __syncthreads();  // the next row rewrites the flags, weights and domains
  }
}

// ---- E3: the normalizes ------------------------------------------------------

__global__ void __launch_bounds__(E_THREADS) normalize_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_stage(smem_raw, P, S);
  StageTeam team;
  const long long N = P.N;
  const bool use_spread = P.s_row[SPREAD] >= 0;
  long long* out = static_cast<long long*>(S.out);
  for (long long b = blockIdx.x; b < S.B; b += gridDim.x) {
    const long long j = P.pindex[b];
    if (use_spread) stage_pod_spread(P, j, s, false);
    __syncthreads();
    const Spread sp = use_spread ? spread_pod(P, j, s.con) : Spread{s.con, false, false, false};
    const long long rowS = b * P.S * N;
    const long long* in = S.in + rowS;
    NormExtrema ex;  // eval_pod_team's, over the given raw scores
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
      const bool ok = S.ok_in[b * N + n] != 0;
      if (P.s_row[TAINT] >= 0) ex.taint(static_cast<int>(in[P.s_row[TAINT] * N + n]), ok);
      if (P.s_row[AFFINITY] >= 0) ex.affinity(static_cast<int>(in[P.s_row[AFFINITY] * N + n]), ok);
      if (use_spread) ex.spread(static_cast<int>(in[P.s_row[SPREAD] * N + n]), ok && spread_scoreable(P, sp, n));
      if (P.s_row[INTERPOD] >= 0) ex.interpod(static_cast<int>(in[P.s_row[INTERPOD] * N + n]), ok);
    }
    ex.reduce(team, s);
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
      const bool ok = S.ok_in[b * N + n] != 0;
      for (long long r = 0; r < P.S; ++r) out[rowS + r * N + n] = in[r * N + n];  // no normalize
      if (P.s_row[TAINT] >= 0) {
        const long long i = P.s_row[TAINT] * N + n;
        out[rowS + i] = ex.taint_norm(static_cast<int>(in[i]));
      }
      if (P.s_row[AFFINITY] >= 0) {
        const long long i = P.s_row[AFFINITY] * N + n;
        out[rowS + i] = ex.affinity_norm(in[i]);
      }
      if (use_spread) {
        const long long i = P.s_row[SPREAD] * N + n;
        out[rowS + i] = ex.spread_norm(P, sp, n, [&] { return static_cast<int>(in[i]); });
      }
      if (P.s_row[INTERPOD] >= 0) {
        const long long i = P.s_row[INTERPOD] * N + n;
        out[rowS + i] = ex.interpod_norm(P, ok, [&] { return static_cast<int>(in[i]); });
      }
    }
    __syncthreads();  // the next row restages the constraints
  }
}

// ---- E4: the visit window, and the selection with its commit -------------------

// One pod, one block: the visit window of plugin_chain.cuh over ok_in.
__global__ void __launch_bounds__(E_THREADS) window_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_stage(smem_raw, P, S);
  StageTeam team;
  team.T = blockDim.x;
  const long long N = P.N;
  const long long nr = max(P.n_real, 1LL);
  const long long start = *S.start;
  const long long sm = floormod(start, nr);
  for (long long n = threadIdx.x; n < N; n += blockDim.x) s.flags[n] = S.ok_in[n] ? FL_OK : 0;
  __syncthreads();
  const Spread none_sp{s.con, false, false, false};
  const Interpod none_ip{0, false, false, false, false};
  const long long thr = visit_window<false>(P, 0, 0, s, none_sp, none_ip, false, team, sm);
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    const bool visited = n < P.n_real && floormod(n - sm, nr) <= thr;
    S.ok_out[n] = (S.ok_in[n] && visited) ? 1 : 0;
    if (S.visited != nullptr) S.visited[n] = visited;
  }
  __syncthreads();  // every thread has read the start
  // Padding pods never ran a cycle upstream: no rotation.
  if (threadIdx.x == 0 && P.pvalid[0]) *S.start = static_cast<int32_t>(floormod(start + thr + 1, nr));
}

__global__ void __launch_bounds__(E_THREADS) select_stage_kernel(const ChainParams P, const StageParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_stage(smem_raw, P, S);
  StageTeam team;
  const long long N = P.N;
  for (long long b = blockIdx.x; b < S.B; b += gridDim.x) {
    const long long rowS = b * S.S * N;
    unsigned long long best = 0ULL;
    for (long long n = threadIdx.x; n < N; n += blockDim.x) {
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
    if (threadIdx.x == 0) S.selected[b] = sel;
    if (S.commit && sel >= 0) commit_pod(P, b, sel, team);
    __syncthreads();  // the next row reuses the reduction slots
  }
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

}  // namespace ksim

// Launches stage `stage` (ksim::Stage) on `grid` blocks of E_THREADS on the
// caller's stream (the window and the committing selection on one block).
// Returns a CUDA error code; a refused launch is an error.
extern "C" int ksim_chain_stages(int stage, const ksim::ChainParams* params, const ksim::StageParams* sp,
                                 void* stream, long long grid) {
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
  const long long smem = stage_smem_bytes(*params);
  cudaError_t err = allow_stage_smem(kernel, stage, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), E_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*params, *sp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" long long ksim_stage_params_size() { return sizeof(ksim::StageParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
