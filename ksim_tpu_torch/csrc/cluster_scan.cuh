// The sequential-commit scan on a thread-block cluster, for sm_90a: the
// body of kernels A (schedule_scan.cu) and C (schedule_sampled.cu), and
// the team kernel D (replay_segment.cu) evaluates its pods with.
//
// The scan is sequential across pods, not across nodes, so one pod's node
// axis is spread over a cluster of Cs blocks (Cs = 16 where one such
// cluster fits on the card, else 8: launch_cluster_scan) on Cs SMs, and
// the cluster walks the pods in order.
//
// Node ownership.  The padded node axis is cut into chunks of 32 nodes,
// dealt round robin over the cluster's ranks: chunk c belongs to rank
// c % Cs, as that block's local chunk c / Cs.  Block slot li (local chunk
// li / 32, lane li % 32) is node ((li / 32) * Cs + rank) * 32 + li % 32,
// and thread t owns the slots t, t + blockDim.x, ...  So each round of a
// node loop (every thread one slot) covers one cluster tile, T = Cs *
// blockDim.x nodes of index order, spread evenly over the blocks, which
// kernel C's visit walks a tile at a time (plugin_chain.cuh
// visit_window).  The helper that mirrors this on the host is
// kernels/chain.py block_nodes.  Each block's shared memory holds only
// its own slots' per-node values, about N / Cs of them, so the node
// bound of one block's shared memory grows about Cs times.
//
// Reductions.  Each reduction of the chain is a block partial written to
// the block's own shared-memory slot, a cluster barrier (barrier.cluster
// arrive.release / wait.acquire, via cooperative_groups), then every
// block reading all Cs partials through distributed shared memory
// (map_shared_rank) and combining them: integer sums, minima and maxima,
// so every block holds the same value and no broadcast follows.  The
// slots alternate by parity: a block writes slot s again only two
// reductions later, after a barrier that every reader of the last use
// reached once done reading.  PodTopologySpread's per-domain arrays work
// the same way: each block's atomics land in its own partial array (its
// shared memory, or its rank's rows of the global scratch), and after a
// cluster barrier each block sums all partials into its own combined
// array (ClusterTeam::combine).  The cluster-wide scalars are replicated:
// every block computes the pod's image weights, keeps a copy of
// InterPodAffinity's term totals and kernel C's rotating start, and
// updates them identically (every block knows `best` and the pod); rank
// 0 writes them back at the end.
//
// The commit.  Only the thread that owns a node reads or writes its
// carried rows (node state and plugin carries), in the chain and in the
// commit (commit_pod: the owner of `best` applies the pod's rows; the
// InterPodAffinity domain update is each thread's own nodes).  So a
// carried row is written and later read by one thread, in program order,
// and needs no barrier; the copies of the term totals are thread 0's
// writes, published to the block by the next pod's first block barrier;
// and the block partials of the next pod are written only after two
// cluster barriers (the pod's extrema and its selection) that every
// reader of this pod's partials passed first.  No block leaves the kernel
// before the final cluster barrier, so no block's shared memory goes
// away while another may read it.
//
// Under record="selection" a padding pod records -1 and nothing else
// (no chain, no barrier), and the chain skips the pairs the record never
// holds (plugin_chain.cuh eval_pod_team).
//
// What bounds it: latency.  With one node slot per thread, a pod takes as
// long as one node's chain (its filters and scores: dozens of dependent
// loads over the vocabulary rows) plus about three cluster barriers (four
// for kernel C), each waiting for the cluster's slowest block; halving
// the nodes per SM (8 blocks to 16) gains little.  The scan stays
// sequential over pods.

#pragma once

#include <cooperative_groups.h>

#include "plugin_chain.cuh"

namespace ksim {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;
constexpr int MAX_THREADS = 1024;

// Threads per block: one node slot each for N / Cs nodes, at least a warp.
__host__ __device__ inline int cluster_threads(long long N, int cs) {
  const long long per = (N + cs - 1) / cs;
  const long long t = ((per + 31) / 32) * 32;
  return static_cast<int>(t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t);
}

// Node slots per block: whole cluster tiles of Cs * threads nodes.
__host__ __device__ inline long long cluster_slots(long long N, int cs, int threads) {
  const long long tile = static_cast<long long>(cs) * threads;
  return (N + tile - 1) / tile * threads;
}

__host__ __device__ inline long long cluster_smem_bytes(const ChainParams& P, long long slots) {
  return align8(3 * 4 * slots + slots) + 8 * P.I + 8 * 33 + 8 * 2 +
         4 * (33 * RED_MAX + SCAN_INTS + 2 * RED_MAX + 2 * 32 + 2 * 32 + P.T2) +
         static_cast<long long>(sizeof(SpreadCon)) * P.MC + (P.sp_smem ? 2 * 4 * domain_ints(P) : 0);
}

// One cluster is the team: see the header comment.
struct ClusterTeam {
  static constexpr bool kCluster = true;
  unsigned rank, size;
  long long L;  // node slots per block
  long long T;  // nodes per cluster tile
  int parity = 0;  // the reduction slots in use
  long long start = 0;  // kernel C's rotating start
  long long barriers = 0;  // cluster barriers so far
  int32_t* tot = nullptr;  // this block's copy of the term totals
  // Block 0's thread 0 times the phases of each pod (clock64 cycles).
  bool timer = false;
  int phase = PH_COMMIT;
  long long t_last = 0;
  long long cycles[NPHASES] = {};

  __device__ long long slots(const ChainParams&) const { return L; }
  __device__ long long node(long long li) const {
    return ((((li >> 5) * size) + rank) << 5) | (li & 31);
  }
  __device__ bool owns(long long n) const {
    const long long c = n >> 5;
    return static_cast<unsigned>(c % size) == rank &&
           ((((c / size) << 5) | (n & 31)) % blockDim.x) == threadIdx.x;
  }
  // This block holds node n (one of its threads owns it).
  __device__ bool holds(long long n) const { return static_cast<unsigned>((n >> 5) % size) == rank; }
  __device__ bool leader() const { return rank == 0; }
  __device__ void mark(int next) {
    if (!timer) return;
    const long long now = clock64();
    cycles[phase] += now - t_last;
    t_last = now;
    phase = next;
  }
  __device__ const int32_t* ipa_total(const ChainParams& P) const { return P.ipa_total != nullptr ? tot : nullptr; }
  __device__ uint8_t node_flags(const ChainParams& P, long long j, long long n) const {
    return ksim::node_flags(P, j, n);
  }

  __device__ void sync() {
    cg::this_cluster().sync();
    ++barriers;
  }

  __device__ void reduce(int* v, const int* op, int K, Smem& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int k = 0; k < K; ++k) {
      int x = v[k];
      for (int o = 16; o > 0; o >>= 1) x = red_op(x, __shfl_xor_sync(0xffffffffu, x, o), op[k]);
      if (lane == 0) s.red[warp * RED_MAX + k] = x;
    }
    __syncthreads();
    int* slot = s.cred + parity * RED_MAX;
    if (static_cast<int>(threadIdx.x) < K) {
      const int k = threadIdx.x;
      int x = s.red[k];
      for (int w = 1; w < nw; ++w) x = red_op(x, s.red[w * RED_MAX + k], op[k]);
      slot[k] = x;
    }
    sync();
    if (static_cast<int>(threadIdx.x) < K) {
      const int k = threadIdx.x;
      cg::cluster_group cl = cg::this_cluster();
      int x = 0;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q) {
        if (q < static_cast<int>(size)) {
          const int y = cl.map_shared_rank(slot, q)[k];
          x = q == 0 ? y : red_op(x, y, op[k]);
        }
      }
      s.red[32 * RED_MAX + k] = x;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) v[k] = s.red[32 * RED_MAX + k];
    parity ^= 1;
  }

  __device__ unsigned long long max_u64(unsigned long long v, Smem& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = warp_max_u64(v);
    if (lane == 0) s.red64[warp] = v;
    __syncthreads();
    if (warp == 0) {
      unsigned long long x = lane < nw ? s.red64[lane] : 0ULL;
      x = warp_max_u64(x);
      if (lane == 0) s.cred64[parity] = x;
    }
    sync();
    if (warp == 0) {
      cg::cluster_group cl = cg::this_cluster();
      unsigned long long x = lane < static_cast<int>(size) ? cl.map_shared_rank(s.cred64 + parity, lane)[0] : 0ULL;
      x = warp_max_u64(x);
      if (lane == 0) s.red64[32] = x;
    }
    __syncthreads();
    parity ^= 1;
    return s.red64[32];
  }

  // Sums (presence and registration parts: maxima) every block's partial
  // per-domain arrays of parts [first, first + nparts) into this block's
  // combined ones, for the non-singleton constraints in [c0, c1) with
  // flag `kind`.
  __device__ void combine(const ChainParams& P, const Spread& sp, Smem& s, unsigned kind, int first, int nparts,
                          int c0, int c1) {
    cg::cluster_group cl = cg::this_cluster();
    const long long di = domain_ints(P);
    for (int c = c0; c < c1; ++c) {
      const SpreadCon& con = sp.con[c];
      if (!(con.flags & kind) || (con.flags & CF_SINGLE)) continue;
      for (int part = first; part < first + nparts; ++part) {
        const bool is_max = part == F_PRES || part == S_REG;
        const long long base = (part * P.MC + c) * P.DMAX;
        for (long long d = threadIdx.x; d < con.dsize; d += blockDim.x) {
          int acc = 0;
#pragma unroll
          for (int q = 0; q < MAX_CLUSTER; ++q) {
            if (q < static_cast<int>(size)) {
              // The global scratch is read past L1: its rows were
              // written on other SMs.
              const int x = P.sp_smem ? cl.map_shared_rank(s.dom, q)[base + d]
                                      : __ldcg(P.sp_scratch + q * 2 * di + base + d);
              acc = is_max ? max(acc, x) : wrap_add(acc, x);
            }
          }
          s.domc[base + d] = acc;
        }
      }
    }
  }

  __device__ void domains(const ChainParams& P, const Spread& sp, Smem& s, unsigned kind, int first, int nparts,
                          int c0, int c1) {
    sync();
    combine(P, sp, s, kind, first, nparts, c0, c1);
    __syncthreads();
  }

  __device__ void domains_after_reduce(const ChainParams& P, const Spread& sp, Smem& s, unsigned kind, int part,
                                       int c0, int c1) {
    combine(P, sp, s, kind, part, 1, c0, c1);
    __syncthreads();
  }

  __device__ void commit_total(const ChainParams& P, const int32_t* db, long long base) {
    if (threadIdx.x == 0)
      for (long long t = 0; t < P.T2; ++t)
        if (db[t] >= 0) tot[t] += P.ipa_qm[base + t];
  }

  // One step of kernel C's visit walk, in cluster tile `tile`: `f` is
  // this thread's node's bit (feasible and in the step).  Sets `count` to
  // the bits set over the cluster, and returns the need-th set bit's node
  // in visit order when need <= count, else -1.  Visit order is index
  // order, rotated at node `rot` when rot >= 0 (the bits from rot on
  // first, then those before it).  The tile's chunks in index order are
  // warp-major, rank-minor: chunk (w, q) is block q's warp w.  Each block
  // writes its warps' counts and ballots, and after one cluster barrier
  // every block scans all Cs * warps counts and reads the ballots that
  // hold the answer: every block gets the same node, with no second
  // exchange.
  __device__ long long piece_find(bool f, long long tile, long long need, Smem& s, long long& count, long long rot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    int* wc = s.wcnt + parity * 32;
    unsigned* wm = s.wmask + parity * 32;
    if (lane == 0) {
      wc[warp] = __popc(m);
      wm[warp] = m;
    }
    sync();
    cg::cluster_group cl = cg::this_cluster();
    const int J = nw * static_cast<int>(size);
    const bool mine = static_cast<int>(threadIdx.x) < J;
    const int jw = threadIdx.x / size, jq = threadIdx.x % size;
    const long long chunk = (tile * nw + jw) * size + jq;  // this thread's chunk (when mine)
    const int val = mine ? cl.map_shared_rank(wc, jq)[jw] : 0;
    // Inclusive block scan of val in thread order (= chunk order).
    int x = val;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s.scan[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nw ? s.scan[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      if (lane < nw) s.scan[lane] = t;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? s.scan[warp - 1] : 0);
    const int total = s.scan[nw - 1];
    long long g = need;  // the wanted bit's rank in index order
    if (rot >= 0) {
      if (mine && chunk == (rot >> 5)) {  // the bits before rot
        const unsigned below = cl.map_shared_rank(wm, jq)[jw] & ((1u << (rot & 31)) - 1u);
        s.scan[41] = incl - val + __popc(below);
      }
      __syncthreads();
      const long long before = s.scan[41], after = total - before;
      g = need <= after ? before + need : need - after;
    }
    if (mine && val > 0 && incl - val < g && g <= incl) {
      unsigned mm = cl.map_shared_rank(wm, jq)[jw];
      for (long long r = g - (incl - val); r > 1; --r) mm &= mm - 1;  // drop the lower set bits
      s.scan[40] = static_cast<int>(chunk * 32 + (__ffs(mm) - 1));
    }
    __syncthreads();
    count = total;
    parity ^= 1;
    return need <= total ? s.scan[40] : -1;
  }
};

// The team over a node axis of N (padded) nodes.
__device__ inline ClusterTeam make_cluster_team(long long N) {
  cg::cluster_group cl = cg::this_cluster();
  ClusterTeam team;
  team.rank = cl.block_rank();
  team.size = cl.num_blocks();
  team.T = static_cast<long long>(team.size) * blockDim.x;
  team.L = (N + team.T - 1) / team.T * blockDim.x;
  return team;
}

// The cluster layout of Smem (cluster_smem_bytes): 8-byte words first.
__device__ inline Smem carve_cluster(unsigned char* base, const ChainParams& P, const ClusterTeam& team) {
  const long long L = team.L;
  const long long di = domain_ints(P);
  Smem s;
  s.raw_taint = reinterpret_cast<int32_t*>(base);
  s.raw_aff = s.raw_taint + L;
  s.partial = s.raw_aff + L;
  s.flags = reinterpret_cast<uint8_t*>(s.partial + L);
  s.imgw = reinterpret_cast<double*>(base + align8(3 * 4 * L + L));
  s.red64 = reinterpret_cast<unsigned long long*>(s.imgw + P.I);
  s.cred64 = s.red64 + 33;
  s.red = reinterpret_cast<int*>(s.cred64 + 2);
  s.scan = s.red + 33 * RED_MAX;
  s.cred = s.scan + SCAN_INTS;
  s.wcnt = s.cred + 2 * RED_MAX;
  s.wmask = reinterpret_cast<unsigned*>(s.wcnt + 2 * 32);
  s.ipa_tot = reinterpret_cast<int32_t*>(s.wmask + 2 * 32);
  s.con = reinterpret_cast<SpreadCon*>(s.ipa_tot + P.T2);
  if (P.sp_smem) {
    s.dom = reinterpret_cast<int*>(s.con + P.MC);
  } else {
    s.dom = P.sp_scratch + team.rank * 2 * di;  // [MAX_CLUSTER, 2 * di]: partial, combined
  }
  s.domc = s.dom + di;
  return s;
}

// The scan, built for blocks of up to MAXT threads (each thread may hold
// 64K / MAXT registers, at most 255).  stats (optional, int64 [2 +
// NPHASES]) receives the cluster barriers and the pods evaluated, as
// block 0 counted them, then block 0's clock64 cycles in each Phase of
// the pods (plugin_chain.cuh), its waits at the barriers included.
template <bool SAMPLED, int MAXT>
__global__ void __launch_bounds__(MAXT, 1) cluster_scan_kernel(const ChainParams P, long long* stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ClusterTeam team = make_cluster_team(P.N);
  Smem s = carve_cluster(smem_raw, P, team);
  team.tot = s.ipa_tot;
  team.timer = stats != nullptr && team.rank == 0 && threadIdx.x == 0;
  if (team.timer) team.t_last = clock64();
  if (P.ipa_total != nullptr)
    for (long long t = threadIdx.x; t < P.T2; t += blockDim.x) s.ipa_tot[t] = P.ipa_total[t];
  if constexpr (SAMPLED) team.start = *P.samp_start;
  const bool selection = P.record == 0;
  long long evaluated = 0;
  for (long long p = 0; p < P.Pc; ++p) {
    if (selection && !P.pvalid[p]) {
      if (team.rank == 0 && threadIdx.x == 0) P.selected[p] = -1;
      continue;
    }
    const int best = eval_pod_team<SAMPLED, false>(P, p, s, team, nullptr, -1);
    ++evaluated;
    if (team.rank == 0 && threadIdx.x == 0) P.selected[p] = best;
    if (best >= 0) commit_pod(P, p, best, team);
  }
  team.sync();  // every block has read every input it reads at the start
  if (team.rank == 0 && threadIdx.x == 0) {
    if (P.ipa_total != nullptr)
      for (long long t = 0; t < P.T2; ++t) P.ipa_total[t] = s.ipa_tot[t];
    if constexpr (SAMPLED) *P.samp_start = static_cast<int32_t>(team.start);
    if (stats != nullptr) {
      stats[0] = team.barriers;
      stats[1] = evaluated;
      team.mark(PH_COMMIT);
      for (int i = 0; i < NPHASES; ++i) stats[2 + i] = team.cycles[i];
    }
  }
}

// Launches the scan on one cluster.  cluster = 0 takes 16 blocks where the
// occupancy query finds room for one such cluster, else 8; threads = 0
// takes cluster_threads.  Blocks of up to 512 threads run the kernel
// built for 512 (twice the registers per thread of the 1024 build).
// info (int64 [3]) receives the cluster size, the threads per block and
// the shared memory per block.  Returns a CUDA error code (0 on success);
// a refused launch is an error, never a smaller launch.
template <bool SAMPLED>
inline int launch_cluster_scan(const ChainParams* params, void* stream, int cluster, int threads, long long* stats,
                               long long* info) {
  const ChainParams& P = *params;
  if (cluster < 0 || cluster > MAX_CLUSTER || threads < 0 || threads > MAX_THREADS || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(ChainParams, long long*) = nullptr;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const int sizes[2] = {16, 8};
  for (int i = 0; i < 2; ++i) {
    const int cs = cluster > 0 ? cluster : sizes[i];
    const int nt = threads > 0 ? threads : cluster_threads(P.N, cs);
    const long long smem = cluster_smem_bytes(P, cluster_slots(P.N, cs, nt));
    kernel = nt <= MAX_THREADS / 2 ? cluster_scan_kernel<SAMPLED, MAX_THREADS / 2>
                                   : cluster_scan_kernel<SAMPLED, MAX_THREADS>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(nt, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    info[0] = cs;
    info[1] = nt;
    info[2] = smem;
    if (cluster > 0) break;
    int fits = 0;
    if (cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size the card refuses: try the next
      fits = 0;
    }
    if (fits >= 1) break;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, P, stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ksim
