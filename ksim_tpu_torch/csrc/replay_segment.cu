// Kernel D: the device-resident churn replay, K scheduling steps per
// launch, for sm_90a; one thread-block cluster per lane.
//
// Replaces ksim_tpu/engine/replay.py _segment_body (replay.py:492-1173),
// the program behind _segment_fn (:1204) and _segment_fn_nodonate (:1215),
// its lane-stacked form _fleet_segment_fn (:1244) and
// _fleet_segment_fn_nodonate (:1277) (the body vmapped over S lanes,
// _fleet_segment_impl :1226), and _derive_interpod (:459,
// derive_interpod.cuh).  Per active step k:
//
//   1. events: pod deletes subtract the pod's rows from its bound node's
//      carried state, node drains zero the node's rows and requeue its
//      pods, node creates and pod creates switch rows on (replay.py:578-627,
//      :821-827);
//   2. the flush (capped remaining backoff) and the pass counter (:828-841);
//   3. the attempted queue: pending, alive, not backed off, in universe
//      (= queue sort) order, the first min(eligible, cap, Q), by a
//      block-wide prefix count; idx padded with P and sel with -1, as the
//      reference's scatter (:843-862);
//   4. InterPodAffinity's domain view from the node-local counts (row 6);
//   5. the pods: plugin_chain.cuh eval_pod_team (the whole default
//      profile), selectHost by the max total and the minimal canonical rank
//      ev.rank[k] (:942-951), and commit_pod; record="full" writes each
//      attempt's reason codes, raw scores and finals at row k * Q + q
//      (:953-962);
//   6. DefaultPreemption (:963-1091): the pass is replayed in queue order
//      against the live view (the pre-pass state, this pass's binds so
//      far, the victims removed so far), and each failed attempt that
//      may preempt, with a pod of lower priority bound somewhere, runs
//      the victim search
//      (_preempt_search, :628-788): candidate nodes in live name order,
//      the filter chain re-checked at each candidate with its victims'
//      rows taken off, the reprieve loop in MoreImportantPod order, and
//      pickOneNodeForPreemption's lexicographic choice;
//   7. step end: the bound pods' term rows into the node-local counts, the
//      backoff bookkeeping (:1121-1143), the step's outputs (:1144-1161).
//
// Inactive steps (tail padding) write the skip branch's outputs (:794-812)
// and leave the state alone.  The carry never leaves the device: the state
// tensors are written in place (the wrapper passes fresh copies, which is
// also why the donating and non-donating jit entries of the reference are
// one launch here).
//
// Design: each lane is one persistent thread-block cluster of Cs blocks
// (cluster_scan.cuh ClusterTeam), looping over steps and, inside a step,
// over the attempted pods; one pod's node axis is spread over the cluster
// as in kernels A and C, and its reductions cross the cluster through
// distributed shared memory.  A solo launch is one cluster, 16 blocks where
// the occupancy query finds room, else 8, with its SegmentParams by value
// (the kernel's parameter space); a fleet launch runs cluster c as lane c,
// every block copying lane c's SegmentParams (every pointer the lane
// writes is its own; const and ev are shared and read-only) from a device
// array into shared memory, at the largest Cs of {16, 8, 4, 2} at which
// every lane's cluster is resident at once.  Lanes never synchronise with
// each other.  The reference psum-reduces its search gate over lanes only
// to keep lax.cond's predicate unbatched under vmap; here each cluster
// replays its own lane's pass and searches where that lane's attempts
// need it.
//
// Who writes what.  Node rows (the carried node state, the node-local
// term counts, the step carries, the preemption snapshots, the view) are
// written only by the block that holds the node (ClusterTeam::holds): by
// the owning thread in the chain, the commit, the drains, the resets and
// the snapshots, and by any thread of that block (integer atomics or one
// thread per field) for the pod deletes and the victim search's row
// shifts, ordered by block barriers.  Pod rows (alive, bound, attempts,
// retry_at, nominated), the queue, the pass's selections and the victim
// search's bookkeeping (vcnt, the candidate and victim lists, the pick)
// are the cluster leader's (rank 0); the other blocks read bound[], the
// queue and the selections from global memory past L1 (__ldcg) after a
// cluster barrier, and the search lists from the leader's shared memory.
// So every value one block writes and another reads crosses a
// barrier.cluster arrive.release / wait.acquire and is read at L2 or
// through distributed shared memory; no block leaves the kernel while
// another may still read its shared memory (the closing cluster barrier).
//
// Under record="selection" the chain does no work the record never holds
// (no filter on an invalid node, no score on an infeasible one:
// plugin_chain.cuh eval_pod_team).  What bounds it: latency, as kernel A
// -- one node's chain plus about three cluster barriers per attempt, the
// attempts sequential within a lane; lanes run side by side, one cluster
// each, on the card's SMs.

#include "derive_interpod.cuh"

namespace ksim {

// The victim search's bounds (kernels/replay_segment.py MAX_CANDIDATES,
// MAX_VICTIMS): the candidate nodes one search examines and the victims
// one candidate may need.
constexpr int MAX_CAND = 16;
constexpr int MAX_VIC = 8;

// Every field is 8 bytes wide (the structs embedded are too): the ctypes
// mirror in kernels/replay_segment.py has no padding to agree on.
struct SegmentParams {
  // The chain over the universe: pindex is arange(P), the node state
  // pointers are the carried state below, the carries are the step's
  // working carries (the InterPodAffinity view is derive's output).
  // record="full": bits_out / raw_out / final_out are [K * Q, F|S, N].
  ChainParams chain;
  DeriveParams derive;  // loc_* = ip_* below; out = the chain's view
  // Carried state, written in place.
  uint8_t* valid;  // [N] (== chain.nvalid)
  uint8_t* alive;  // [P]
  int32_t* bound;  // [P]
  int32_t* attempts;  // [P]
  int32_t* retry_at;  // [P]
  uint8_t* nominated;  // [P]
  int32_t* spread;  // [N, SS] PodTopologySpread's counts (== chain.sp_counts when enabled)
  int32_t* ip_cnt;  // [N, T2] node-local
  int32_t* ip_eat;  // [N, T2]
  int32_t* ip_vw;  // [N, T2]
  int32_t* pass_count;  // [1]
  // The step-local carries' values at a step's start (NodePorts and the
  // volume family: the reference re-initializes them every step).
  const int32_t* ports_init;  // [N, V]
  const int32_t* attached_init;  // [N, VV]
  const int32_t* rwop_init;  // [N, RW]
  const int32_t* disk_any_init;  // [N, DD]
  const int32_t* disk_rw_init;  // [N, DD]
  // Events, leading axis K; index lists padded with -1.
  const int32_t* ev_pc;  // [K, Wpc] pod creates
  const int32_t* ev_pd;  // [K, Wpd] pod deletes
  const int32_t* ev_nc;  // [K, Wnc] node creates
  const int32_t* ev_nd;  // [K, Wnd] node deletes
  const int32_t* ev_rank;  // [K, N] canonical slot, INT_MAX when dead
  const uint8_t* ev_flush;  // [K]
  const uint8_t* ev_active;  // [K]
  // Outputs.
  int32_t* out_sel;  // [K, Q]
  int32_t* out_idx;  // [K, Q]
  int32_t* out_scheduled;  // [K]
  int32_t* out_unsched;  // [K]
  int32_t* out_eligible;  // [K]
  int32_t* out_pass;  // [K]
  int32_t* out_pending;  // [K]
  // [1] runs of derive_interpod() for a step's view (one per active step
  // and lane), added here on the card: the launch accounting of row 6,
  // which has no launch of its own on this path.  The victim search's
  // re-derivations are not counted.
  int32_t* derive_runs;
  // DefaultPreemption (preempt != 0).
  const int32_t* priority;  // [P]
  const int32_t* imp_order;  // [P] universe row of MoreImportantPod rank r, -1 past the universe
  const int32_t* start_rank;  // [P]
  const uint8_t* preempt_ok;  // [P]
  const uint8_t* resolv;  // [resolv_f, resolv_w] record="full": reason code resolvable by preemption, per filter
  const int32_t* ev_name_rank;  // [K, N] live name order, INT_MAX off the live set
  const int32_t* ev_want;  // [K] upstream's candidate count
  int32_t* snap_req;  // [N, R] the pre-pass state the searches replay from
  int32_t* snap_nz;  // [N, R]
  int32_t* snap_pc;  // [N]
  int32_t* snap_spread;  // [N, SS]
  int32_t* name_order;  // [N] node of live name rank r, -1 past the live set
  int32_t* vcnt;  // [N] lower-priority pods bound per node (the leader's)
  int32_t* out_nom;  // [K, Q] nominated node, -1
  int32_t* out_vic;  // [K, Q, VE] victim rows in reprieve order, -1
  uint8_t* out_over;  // [K] a search past the bounds
  long long K, Q, cap, P;
  long long Wpc, Wpd, Wnc, Wnd;
  long long max_backoff, flush_cap, shift_cap;
  long long preempt, CE, VE, empty_start_rank, resolv_f, resolv_w;
};

// One victim search's working set.  The leader fills the lists and the
// pick; the other blocks copy what they need of them from its shared
// memory after a cluster barrier.
struct SearchSmem {
  int cand[MAX_CAND];  // candidate nodes, in name order
  int vrows[MAX_VIC];  // the current candidate's victims, in importance order
  int is_c[MAX_CAND];  // the preemptor fits with every victim removed
  int maxp[MAX_CAND];  // pickOneNode's keys
  int sump[MAX_CAND];
  int cnt[MAX_CAND];
  int est[MAX_CAND];
  int nrank[MAX_CAND];
  int vic[MAX_CAND][MAX_VIC];  // victim rows (-1 = reprieved or none)
  int n_exam;  // nodes the search would examine (over the bound: overflow)
  int n_on;  // lower-priority pods on the current candidate
  int chosen;  // the picked candidate, -1
};

__host__ __device__ inline long long align16(long long x) { return (x + 15) & ~15LL; }

// Dynamic shared memory per block of a cs-block cluster of nt threads: the
// chain's cluster layout, then row 6's scratch.
__host__ __device__ inline long long segment_smem_bytes(const SegmentParams& S, int cs, int nt) {
  return cluster_smem_bytes(S.chain, cluster_slots(S.chain.N, cs, nt)) + derive_smem_bytes(S.derive);
}

// The lanes kernel's static shared memory (the larger of the two): its
// lane's params and the search's, each 16-byte aligned.
__host__ __device__ inline long long segment_static_smem() {
  return align16(sizeof(SegmentParams)) + align16(sizeof(SearchSmem));
}

__device__ inline bool leader_thread(const ClusterTeam& team) { return team.rank == 0 && threadIdx.x == 0; }

// This block's copy of the leader's shared array a[0..n); after a cluster
// barrier that follows the leader's writes, and before one that precedes
// its next.  The caller orders the copy against its readers.
__device__ inline void from_leader(int* a, int n, const ClusterTeam& team) {
  if (team.rank == 0) return;
  const int* src = cg::this_cluster().map_shared_rank(a, 0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = src[i];
}

// Step events on the node rows this block holds (replay.py:578-627).  Pod
// deletes take the pod's rows off its bound node (the rows of several
// deletes may meet on one node: integer atomics, inside the node's block);
// bound[] is the leader's, read past L1 after the step's opening cluster
// barrier.  Then each owner zeroes its drained nodes' rows and switches
// its created nodes on (drains first, as the reference), and, with
// preemption, clears its entry of the live name order.
__device__ inline void node_events(const SegmentParams& S, long long k, const ClusterTeam& team) {
  const ChainParams& C = S.chain;
  const long long N = C.N, R = C.R, T2 = C.T2, SS = C.SS;
  for (long long e = threadIdx.x; e < S.Wpd; e += blockDim.x) {
    const int j = S.ev_pd[k * S.Wpd + e];
    if (j < 0) continue;
    const int b = __ldcg(S.bound + j);
    if (b < 0 || !team.holds(b)) continue;
    for (long long r = 0; r < R; ++r) {
      atomicSub(&C.requested[b * R + r], C.preq[j * R + r]);
      atomicSub(&C.nz_requested[b * R + r], C.pnz[j * R + r]);
    }
    atomicSub(&C.pod_count[b], 1);
    for (long long c = 0; c < SS; ++c)
      if (C.sp_sel_match[j * SS + c]) atomicSub(&S.spread[b * SS + c], 1);
    for (long long t = 0; t < T2; ++t) {
      if (C.ipa_qm[j * T2 + t]) atomicSub(&S.ip_cnt[b * T2 + t], 1);
      atomicSub(&S.ip_eat[b * T2 + t], C.ipa_eat[j * T2 + t]);
      atomicSub(&S.ip_vw[b * T2 + t], C.ipa_vw[j * T2 + t]);
    }
  }
  __syncthreads();  // every delete has left its node before a drain clears it
  const int32_t* nd = S.ev_nd + k * S.Wnd;
  const int32_t* nc = S.ev_nc + k * S.Wnc;
  for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= N) continue;
    if (S.preempt) S.name_order[n] = -1;
    bool gone = false, made = false;
    for (long long e = 0; e < S.Wnd; ++e) gone = gone || nd[e] == n;
    for (long long e = 0; e < S.Wnc; ++e) made = made || nc[e] == n;
    if (gone) {
      S.valid[n] = 0;
      for (long long r = 0; r < R; ++r) {
        C.requested[n * R + r] = 0;
        C.nz_requested[n * R + r] = 0;
      }
      C.pod_count[n] = 0;
      for (long long c = 0; c < SS; ++c) S.spread[n * SS + c] = 0;
      for (long long t = 0; t < T2; ++t) {
        S.ip_cnt[n * T2 + t] = 0;
        S.ip_eat[n * T2 + t] = 0;
        S.ip_vw[n * T2 + t] = 0;
      }
    }
    if (made) S.valid[n] = 1;
  }
}

// The step-local carries back to their values at a step's start, each
// node's rows by their owner.
__device__ inline void reset_step_carries(const SegmentParams& S, const ClusterTeam& team) {
  const ChainParams& C = S.chain;
  for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= C.N) continue;
    if (C.port_counts != nullptr)
      for (long long v = 0; v < C.V; ++v) C.port_counts[n * C.V + v] = S.ports_init[n * C.V + v];
    if (C.attached != nullptr)
      for (long long v = 0; v < C.VV; ++v) C.attached[n * C.VV + v] = S.attached_init[n * C.VV + v];
    if (C.rwop != nullptr) {
      for (long long r = 0; r < C.RW; ++r) C.rwop[n * C.RW + r] = S.rwop_init[n * C.RW + r];
      for (long long d = 0; d < C.DD; ++d) {
        C.disk_any[n * C.DD + d] = S.disk_any_init[n * C.DD + d];
        C.disk_rw[n * C.DD + d] = S.disk_rw_init[n * C.DD + d];
      }
    }
  }
}

// Block-wide stable compaction: the first `limit` indices i in [0, n) with
// pred(i), in order, into out[]; every thread gets the count of all of them.
template <class Pred>
__device__ inline long long block_compact(long long n, long long limit, int* out, Smem& s, Pred pred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  long long running = 0;
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const bool f = i < n && pred(i);
    const unsigned mask = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s.scan[warp] = __popc(mask);
    __syncthreads();
    int below = 0, tile = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = s.scan[w];
      if (w < warp) below += c;
      tile += c;
    }
    const long long pos = running + below + __popc(mask & ((1u << lane) - 1u));
    if (f && pos < limit) out[pos] = static_cast<int>(i);
    __syncthreads();
    running += tile;
  }
  return running;
}

// The leader's part of step k's events (pod deletes, the requeue of
// drained nodes' pods, pod creates), the flush from the pre-pass count
// pc0, and the attempted queue into out_idx[k]; returns (eligible,
// attempted) to every thread of the leader's block.
__device__ inline int2 pod_events_and_queue(const SegmentParams& S, long long k, int pc0, int pc, bool any_valid,
                                            Smem& s) {
  for (long long e = threadIdx.x; e < S.Wpd; e += blockDim.x) {
    const int j = S.ev_pd[k * S.Wpd + e];
    if (j < 0) continue;
    S.alive[j] = 0;
    S.bound[j] = -1;
  }
  __syncthreads();  // deletes' bound = -1 before the requeue reads bound
  const int32_t* nd = S.ev_nd + k * S.Wnd;
  if (S.Wnd > 0) {
    for (long long j = threadIdx.x; j < S.P; j += blockDim.x) {
      const int b = S.bound[j];
      if (!S.alive[j] || b < 0) continue;
      bool gone = false;
      for (long long e = 0; e < S.Wnd; ++e) gone = gone || nd[e] == b;
      if (gone) S.bound[j] = -1;
    }
  }
  __syncthreads();  // the requeue has read alive[] before a create writes it
  for (long long e = threadIdx.x; e < S.Wpc; e += blockDim.x) {
    const int j = S.ev_pc[k * S.Wpc + e];
    if (j >= 0) S.alive[j] = 1;
  }
  // The flush caps existing entries' remaining wait, from the pre-pass count.
  if (S.ev_flush[k])
    for (long long j = threadIdx.x; j < S.P; j += blockDim.x) {
      const int a = S.attempts[j];
      if (a > 0) S.retry_at[j] = min(S.retry_at[j], pc0 + min(a - 1, static_cast<int>(S.flush_cap)));
    }
  int32_t* idx = S.out_idx + k * S.Q;
  int32_t* sel = S.out_sel + k * S.Q;
  for (long long q = threadIdx.x; q < S.Q; q += blockDim.x) {
    idx[q] = static_cast<int32_t>(S.P);
    sel[q] = -1;
    if (S.preempt) {
      S.out_nom[k * S.Q + q] = -1;
      for (long long v = 0; v < S.VE; ++v) S.out_vic[(k * S.Q + q) * S.VE + v] = -1;
    }
  }
  if (S.preempt && threadIdx.x == 0) S.out_over[k] = 0;
  __syncthreads();
  const long long limit = any_valid ? min(S.cap, S.Q) : 0;
  const long long running = block_compact(S.P, limit, idx, s, [&](long long j) {
    const bool in_backoff = S.attempts[j] > 0 && S.retry_at[j] >= pc;
    return S.alive[j] && S.bound[j] < 0 && !in_backoff;
  });
  const int eligible = any_valid ? static_cast<int>(running) : 0;
  return make_int2(eligible, static_cast<int>(min(static_cast<long long>(eligible), limit)));
}

// The leader's outputs of an inactive step.
__device__ inline void inactive_step(const SegmentParams& S, long long k, int pc) {
  for (long long q = threadIdx.x; q < S.Q; q += blockDim.x) {
    S.out_idx[k * S.Q + q] = static_cast<int32_t>(S.P);
    S.out_sel[k * S.Q + q] = -1;
    if (S.preempt) {
      S.out_nom[k * S.Q + q] = -1;
      for (long long v = 0; v < S.VE; ++v) S.out_vic[(k * S.Q + q) * S.VE + v] = -1;
    }
  }
  if (threadIdx.x == 0) {
    S.out_scheduled[k] = 0;
    S.out_unsched[k] = 0;
    S.out_eligible[k] = 0;
    S.out_pass[k] = pc;
    S.out_pending[k] = 0;
    if (S.preempt) S.out_over[k] = 0;
  }
}

// ---- DefaultPreemption ------------------------------------------------------

// A recorded element of the given width, sign-extended, read past L1 (the
// block that holds the node wrote it).
__device__ inline long long load_int_cg(const void* base, long long idx, long long size) {
  switch (size) {
    case 1: return __ldcg(static_cast<const signed char*>(base) + idx);
    case 2: return __ldcg(static_cast<const short*>(base) + idx);
    case 4: return __ldcg(static_cast<const int*>(base) + idx);
    default: return __ldcg(static_cast<const long long*>(base) + idx);
  }
}

// The rows of pods rows[0..count) (those of `mask` that are >= 0) added
// to node n's carried state with `sign`: a bind (+1), or victims taken off
// (-1) and put back (+1).  Run by the block that holds n, one thread per
// field; the caller orders it.
__device__ inline void shift_rows(const SegmentParams& S, long long n, const int* rows, int count,
                                  unsigned mask, int sign, bool with_nz) {
  const ChainParams& C = S.chain;
  const long long R = C.R, SS = C.SS, T2 = C.T2;
  const long long fields = 2 * R + SS + 3 * T2;
  for (long long f = threadIdx.x; f < fields; f += blockDim.x) {
    int sum = 0;
    for (int v = 0; v < count; ++v) {
      const long long j = rows[v];
      if (!((mask >> v) & 1u) || j < 0) continue;
      if (f < R) sum += C.preq[j * R + f];
      else if (f < 2 * R) sum += C.pnz[j * R + f - R];
      else if (f < 2 * R + SS) sum += C.sp_sel_match[j * SS + f - 2 * R];
      else if (f < 2 * R + SS + T2) sum += C.ipa_qm[j * T2 + f - 2 * R - SS];
      else if (f < 2 * R + SS + 2 * T2) sum += C.ipa_eat[j * T2 + f - 2 * R - SS - T2];
      else sum += C.ipa_vw[j * T2 + f - 2 * R - SS - 2 * T2];
    }
    sum *= sign;
    if (f < R) C.requested[n * R + f] += sum;
    else if (f < 2 * R) { if (with_nz) C.nz_requested[n * R + f - R] += sum; }
    else if (f < 2 * R + SS) S.spread[n * SS + f - 2 * R] += sum;
    else if (f < 2 * R + SS + T2) S.ip_cnt[n * T2 + f - 2 * R - SS] += sum;
    else if (f < 2 * R + SS + 2 * T2) S.ip_eat[n * T2 + f - 2 * R - SS - T2] += sum;
    else S.ip_vw[n * T2 + f - 2 * R - SS - 2 * T2] += sum;
  }
  if (threadIdx.x == 0) {
    int cnt = 0;
    for (int v = 0; v < count; ++v) cnt += (((mask >> v) & 1u) && rows[v] >= 0) ? 1 : 0;
    C.pod_count[n] += sign * cnt;
  }
}

// Does pod j pass every filter at node n with the victims vrows[mask]
// taken off n?  The inter-pod view and the spread statistics are
// recomputed over the modified state by the whole cluster, the filters run
// on n's owner thread, and the answer reaches every block through one
// cluster reduction (replay.py eval_fit, :670-699).
__device__ inline bool eval_fit(const SegmentParams& S, long long j, long long n, unsigned mask, Smem& s,
                                ClusterTeam& team, SearchSmem& ps, int32_t* dscr) {
  const ChainParams& C = S.chain;
  if (team.holds(n)) shift_rows(S, n, ps.vrows, MAX_VIC, mask, -1, false);
  __syncthreads();
  derive_interpod(S.derive, team, dscr, s.ipa_tot);
  const bool use_spread = C.f_row[SPREAD] >= 0 || C.s_row[SPREAD] >= 0;
  if (use_spread) {
    for (long long i = threadIdx.x; i < domain_ints(C); i += blockDim.x) s.dom[i] = 0;
    stage_spread(C, j, s.con);
  }
  __syncthreads();
  const Spread sp = use_spread ? spread_pod(C, j, s.con) : Spread{s.con, false, false, false};
  const bool use_ipa = C.f_row[INTERPOD] >= 0 || C.s_row[INTERPOD] >= 0;
  const Interpod ip = use_ipa ? interpod_pod(C, j, team.ipa_total(C)) : Interpod{0, false, false, false, false};
  const bool sp_filter = C.f_row[SPREAD] >= 0 && sp.any_f;
  if (sp_filter) spread_filter_stats(C, sp, j, s, team);
  int fit[1] = {0};
  const int op_max[1] = {RMAX};
  if (team.owns(n)) fit[0] = (filter_node(C, j, j, n, s, sp, ip, sp_filter, false, 0) & FL_OK) != 0;
  team.reduce(fit, op_max, 1, s);
  if (team.holds(n)) shift_rows(S, n, ps.vrows, MAX_VIC, mask, +1, false);
  __syncthreads();
  return fit[0] != 0;
}

// Is node n a candidate for attempt row `row` by its reason codes
// (record="full": the first failing filter's code must be resolvable)?
__device__ inline bool resolvable(const SegmentParams& S, long long row, long long n) {
  const ChainParams& C = S.chain;
  if (C.record != 2) return true;
  for (long long f = 0; f < C.F; ++f) {
    const long long code = load_int_cg(C.bits_out, (row * C.F + f) * C.N + n, C.bits_size);
    if (code != 0) {
      const long long b = min(max(code, 0LL), S.resolv_w - 1);
      return S.resolv[f * S.resolv_w + b] != 0;
    }
  }
  return false;
}

// The victim search for attempt (k, q) of pod j against the live view;
// writes out_nom / out_vic / out_over and, on a nomination, takes the
// victims off the live view (replay.py _preempt_search, :628-788).
__device__ inline void preempt_search(const SegmentParams& S, long long k, long long q, long long j, Smem& s,
                                      ClusterTeam& team, SearchSmem& ps, int32_t* dscr) {
  const ChainParams& C = S.chain;
  const long long N = C.N;
  const int prio = S.priority[j];
  const long long row = k * S.Q + q;
  if (team.rank == 0) {
    for (long long n = threadIdx.x; n < N; n += blockDim.x) S.vcnt[n] = 0;
    __syncthreads();
    for (long long p = threadIdx.x; p < S.P; p += blockDim.x)
      if (S.alive[p] && S.bound[p] >= 0 && S.priority[p] < prio) atomicAdd(&S.vcnt[S.bound[p]], 1);
    __syncthreads();
    // The live name order, valid[] and the reason codes were written by
    // the blocks that hold the nodes: read past L1.
    const long long n_exam = block_compact(N, S.CE, ps.cand, s, [&](long long r) {
      const int n = __ldcg(S.name_order + r);
      return n >= 0 && S.vcnt[n] > 0 && __ldcg(S.valid + n) && resolvable(S, row, n);
    });
    if (threadIdx.x == 0) ps.n_exam = static_cast<int>(n_exam);
  }
  team.sync();
  from_leader(ps.cand, MAX_CAND, team);
  from_leader(&ps.n_exam, 1, team);
  __syncthreads();
  bool over = ps.n_exam > S.CE;
  const int n_cand = static_cast<int>(min(static_cast<long long>(ps.n_exam), S.CE));
  for (int i = 0; i < n_cand; ++i) {
    const int n = ps.cand[i];
    if (team.rank == 0) {
      if (threadIdx.x < MAX_VIC) ps.vrows[threadIdx.x] = -1;
      __syncthreads();
      const long long n_on = block_compact(S.P, S.VE, ps.vrows, s, [&](long long r) {
        const int p = S.imp_order[r];
        return p >= 0 && S.alive[p] && S.bound[p] == n && S.priority[p] < prio;
      });
      // block_compact wrote universe ranks: map them to rows.
      if (threadIdx.x < MAX_VIC && ps.vrows[threadIdx.x] >= 0) ps.vrows[threadIdx.x] = S.imp_order[ps.vrows[threadIdx.x]];
      if (threadIdx.x == 0) ps.n_on = static_cast<int>(n_on);
    }
    team.sync();
    from_leader(ps.vrows, MAX_VIC, team);
    from_leader(&ps.n_on, 1, team);
    __syncthreads();
    over = over || ps.n_on > S.VE;
    const int nv = static_cast<int>(min(static_cast<long long>(ps.n_on), S.VE));
    const unsigned all = nv >= 32 ? 0xffffffffu : ((1u << nv) - 1u);
    const bool fit0 = eval_fit(S, j, n, all, s, team, ps, dscr);
    unsigned removed = all, vic = 0u;
    for (int v = 0; v < nv; ++v) {
      const unsigned test = removed & ~(1u << v);
      if (eval_fit(S, j, n, test, s, team, ps, dscr)) removed = test;  // reprieved
      else vic |= 1u << v;
    }
    if (leader_thread(team)) {
      int maxp = INT_MIN, cnt = 0;
      unsigned sum = 0;  // WRAP: the reference's int32 sum
      for (int v = 0; v < nv; ++v) {
        if (!((vic >> v) & 1u)) continue;
        const int pv = S.priority[ps.vrows[v]];
        maxp = max(maxp, pv);
        sum += static_cast<unsigned>(pv);
        cnt += 1;
      }
      int est = static_cast<int>(S.empty_start_rank);
      if (cnt > 0) {
        est = INT_MAX;
        for (int v = 0; v < nv; ++v)
          if (((vic >> v) & 1u) && S.priority[ps.vrows[v]] == maxp) est = min(est, S.start_rank[ps.vrows[v]]);
      }
      ps.is_c[i] = fit0;
      ps.maxp[i] = maxp;
      ps.sump[i] = static_cast<int>(sum);
      ps.cnt[i] = cnt;
      ps.est[i] = est;
      ps.nrank[i] = S.ev_name_rank[k * N + n];
      for (int v = 0; v < MAX_VIC; ++v) ps.vic[i][v] = (v < nv && ((vic >> v) & 1u)) ? ps.vrows[v] : -1;
    }
    __syncthreads();  // thread 0 has read vrows before the next candidate's
  }
  // pickOneNodeForPreemption: the first `want` fitting candidates in
  // discovery order, narrowed by (min max victim priority, min priority
  // sum, min count, max earliest start, min name rank), then the first.
  if (leader_thread(team)) {
    bool keep[MAX_CAND];
    int found = 0;
    for (int i = 0; i < n_cand; ++i) {
      keep[i] = ps.is_c[i] && found < S.ev_want[k];
      found += ps.is_c[i] ? 1 : 0;
    }
    const int* keys[5] = {ps.maxp, ps.sump, ps.cnt, ps.est, ps.nrank};
    for (int c = 0; c < 5; ++c) {
      const bool take_min = c != 3;
      int tgt = take_min ? INT_MAX : INT_MIN;
      for (int i = 0; i < n_cand; ++i)
        if (keep[i]) tgt = take_min ? min(tgt, keys[c][i]) : max(tgt, keys[c][i]);
      for (int i = 0; i < n_cand; ++i) keep[i] = keep[i] && keys[c][i] == tgt;
    }
    int chosen = -1;
    for (int i = n_cand - 1; i >= 0; --i)
      if (keep[i]) chosen = i;
    ps.chosen = chosen;
    S.out_nom[row] = chosen >= 0 ? ps.cand[chosen] : -1;
    for (long long v = 0; v < S.VE; ++v) S.out_vic[row * S.VE + v] = chosen >= 0 ? ps.vic[chosen][v] : -1;
    if (over) S.out_over[k] = 1;
  }
  team.sync();
  from_leader(&ps.chosen, 1, team);
  from_leader(&ps.vic[0][0], MAX_CAND * MAX_VIC, team);
  __syncthreads();
  const int chosen = ps.chosen;
  if (chosen < 0) return;
  const int nom = ps.cand[chosen];
  if (team.holds(nom)) shift_rows(S, nom, ps.vic[chosen], MAX_VIC, 0xffffffffu, -1, true);
  if (team.rank == 0) {
    if (threadIdx.x < MAX_VIC) {
      const int r = ps.vic[chosen][threadIdx.x];
      if (r >= 0) {
        S.alive[r] = 0;
        S.bound[r] = -1;
      }
    }
    if (threadIdx.x == 0) S.nominated[j] = 1;
  }
  __syncthreads();
}

// After the pass's chain: the pass again, in queue order, against the
// live view (this pass's binds so far, the victims removed so far), with
// the victim search for each failed attempt that may preempt and has a
// pod of lower priority bound somewhere.  The carried state ends as the
// post-pass live view: binds, victims and nominations applied.
__device__ inline void preempt_pass(const SegmentParams& S, long long k, int n_att, Smem& s, ClusterTeam& team,
                                    SearchSmem& ps, int32_t* dscr) {
  const ChainParams& C = S.chain;
  const long long R = C.R, SS = C.SS;
  const int32_t* idx = S.out_idx + k * S.Q;
  const int32_t* sel = S.out_sel + k * S.Q;
  const int op_max[1] = {RMAX};
  // Back to the pre-pass state (the chain committed into it) and the
  // step-start carries, each node by its owner.
  for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
    const long long n = team.node(li);
    if (n >= C.N) continue;
    for (long long r = 0; r < R; ++r) {
      C.requested[n * R + r] = S.snap_req[n * R + r];
      C.nz_requested[n * R + r] = S.snap_nz[n * R + r];
    }
    C.pod_count[n] = S.snap_pc[n];
    for (long long c = 0; c < SS; ++c) S.spread[n * SS + c] = S.snap_spread[n * SS + c];
  }
  reset_step_carries(S, team);
  team.sync();  // the leader's selections are out
  for (int q = 0; q < n_att; ++q) {
    const int j = __ldcg(idx + q);
    const int best = __ldcg(sel + q);
    if (best >= 0) {
      if (team.holds(best)) shift_rows(S, best, &j, 1, 1u, +1, true);
      if (leader_thread(team)) {
        S.bound[j] = best;
        S.nominated[j] = 0;
      }
      __syncthreads();
      continue;
    }
    if (!S.preempt_ok[j]) continue;
    const int prio = S.priority[j];
    int lower[1] = {0};
    if (team.rank == 0)
      for (long long p = threadIdx.x; p < S.P; p += blockDim.x)
        if (S.alive[p] && S.bound[p] >= 0 && S.priority[p] < prio) lower[0] = 1;
    team.reduce(lower, op_max, 1, s);
    if (lower[0]) preempt_search(S, k, q, j, s, team, ps, dscr);
  }
}

// Step end (the leader's): the pod rows of the pass's binds (done already
// when preempt_pass replayed the pass), the backoff of the failed
// attempts, the step's outputs.
__device__ inline void step_end(const SegmentParams& S, long long k, int n_att, int eligible, int pc, Smem& s) {
  const int32_t* idx = S.out_idx + k * S.Q;
  const int32_t* sel = S.out_sel + k * S.Q;
  __syncthreads();  // thread 0's selections
  int w[2] = {0, 0};  // scheduled, pending after
  for (long long qq = threadIdx.x; qq < n_att; qq += blockDim.x) {
    const int j = idx[qq];
    const int b = sel[qq];
    if (b >= 0) {
      if (!S.preempt) {
        S.bound[j] = b;
        S.nominated[j] = 0;
      }
      S.attempts[j] = 0;
      S.retry_at[j] = 0;
      w[0] += 1;
    } else if (S.nominated[j]) {
      S.attempts[j] = 0;
      S.retry_at[j] = 0;
    } else {
      const int a = S.attempts[j];
      const int delay = min(1 << min(a, static_cast<int>(S.shift_cap)), static_cast<int>(S.max_backoff));
      S.attempts[j] = a + 1;
      S.retry_at[j] = pc + delay;
    }
  }
  __syncthreads();
  for (long long j = threadIdx.x; j < S.P; j += blockDim.x) w[1] += (S.alive[j] && S.bound[j] < 0) ? 1 : 0;
  const int sum_op[2] = {RSUM, RSUM};
  block_reduce(w, sum_op, 2, s.red);
  if (threadIdx.x == 0) {
    S.out_scheduled[k] = w[0];
    S.out_unsched[k] = n_att - w[0];
    S.out_eligible[k] = eligible;
    S.out_pass[k] = pc;
    S.out_pending[k] = w[1];
  }
}

// One lane on one cluster.  stats (optional, int64 [2 + NPHASES]): the
// cluster barriers and the attempts evaluated, as the grid's block 0
// counted them, then its clock64 cycles in each Phase.
__device__ inline void segment_body(const SegmentParams& S, unsigned char* smem_raw, SearchSmem& ps,
                                    long long* stats) {
  const ChainParams& C = S.chain;
  ClusterTeam team = make_cluster_team(C.N);
  Smem s = carve_cluster(smem_raw, C, team);
  team.tot = s.ipa_tot;
  int32_t* dscr = reinterpret_cast<int32_t*>(smem_raw + cluster_smem_bytes(C, team.L));
  team.timer = stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (team.timer) team.t_last = clock64();
  const long long N = C.N, R = C.R, SS = C.SS, T2 = C.T2;
  const bool leader = team.rank == 0;
  const bool full = C.record == 2;
  const int op_max[1] = {RMAX};
  const int op_max2[2] = {RMAX, RMAX};
  long long evaluated = 0;
  int pc = *S.pass_count;  // every thread of every block holds the counter
  for (long long k = 0; k < S.K; ++k) {
    if (!S.ev_active[k]) {
      if (leader) inactive_step(S, k, pc);
      continue;
    }
    team.mark(PH_EVENTS);
    team.sync();  // the leader's pod rows of the last step are out
    node_events(S, k, team);
    int v[1] = {0};  // any valid node
    for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
      const long long n = team.node(li);
      if (n < N && S.valid[n]) v[0] = 1;
    }
    team.reduce(v, op_max, 1, s);  // also: every delete has read bound[]
    // The pass counts only when a node exists.
    team.mark(PH_QUEUE);
    const int pc0 = pc;
    pc += v[0] ? 1 : 0;
    int q[2] = {0, 0};  // eligible, attempted: the leader's, to every block
    if (leader) {
      const int2 r = pod_events_and_queue(S, k, pc0, pc, v[0] != 0, s);
      q[0] = r.x;
      q[1] = r.y;
    }
    team.reduce(q, op_max2, 2, s);  // also publishes out_idx[k]
    const int n_att = q[1];
    if (S.preempt) {
      // The pre-pass state the searches replay from, and the live name
      // order of this step's nodes (its -1 entries cleared before the
      // last cluster barrier).
      for (long long li = threadIdx.x; li < team.L; li += blockDim.x) {
        const long long n = team.node(li);
        if (n >= N) continue;
        for (long long r = 0; r < R; ++r) {
          S.snap_req[n * R + r] = C.requested[n * R + r];
          S.snap_nz[n * R + r] = C.nz_requested[n * R + r];
        }
        S.snap_pc[n] = C.pod_count[n];
        for (long long c = 0; c < SS; ++c) S.snap_spread[n * SS + c] = S.spread[n * SS + c];
        const int r = S.ev_name_rank[k * N + n];
        if (r >= 0 && r < N) S.name_order[r] = static_cast<int>(n);
      }
    }
    reset_step_carries(S, team);
    team.mark(PH_DERIVE);
    derive_interpod(S.derive, team, dscr, s.ipa_tot);
    if (leader_thread(team)) atomicAdd(S.derive_runs, 1);
    // The pods, in queue order.  Without preemption a bind's term rows go
    // into its node's local counts now (nothing reads them before the
    // next step's view); with it preempt_pass replays the binds.
    const int32_t* idx = S.out_idx + k * S.Q;
    const int32_t* rank = S.ev_rank + k * N;
    for (int qq = 0; qq < n_att; ++qq) {
      const int j = __ldcg(idx + qq);
      const int best = eval_pod_team<false, true>(C, j, s, team, rank, full ? k * S.Q + qq : -1);
      ++evaluated;
      if (leader_thread(team)) S.out_sel[k * S.Q + qq] = best;
      if (best < 0) continue;
      commit_pod(C, j, best, team);
      if (!S.preempt && team.owns(best))
        for (long long t = 0; t < T2; ++t) {
          S.ip_cnt[best * T2 + t] += C.ipa_qm[j * T2 + t];
          S.ip_eat[best * T2 + t] += C.ipa_eat[j * T2 + t];
          S.ip_vw[best * T2 + t] += C.ipa_vw[j * T2 + t];
        }
    }
    team.mark(PH_SEARCH);
    if (S.preempt) preempt_pass(S, k, n_att, s, team, ps, dscr);
    team.mark(PH_STEP_END);
    if (leader) step_end(S, k, n_att, q[0], pc, s);
  }
  team.sync();  // no block leaves while another may read its shared memory
  if (leader_thread(team)) *S.pass_count = pc;
  if (team.timer) {  // the grid's block 0 alone: lane 0's leader
    team.mark(PH_STEP_END);
    stats[0] = team.barriers;
    stats[1] = evaluated;
    for (int i = 0; i < NPHASES; ++i) stats[2 + i] = team.cycles[i];
  }
}

// One lane: the params by value, in the kernel's parameter space.  Built
// for blocks of up to MAXT threads (each thread may hold 64K / MAXT
// registers, at most 255).
template <int MAXT>
__global__ void __launch_bounds__(MAXT, 1) replay_segment_kernel(const SegmentParams S, long long* stats) {
  __shared__ SearchSmem ps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  segment_body(S, smem_raw, ps, stats);
}

// Lanes: cluster c runs lane c, each block from its own copy of lanes[c]
// in shared memory.
template <int MAXT>
__global__ void __launch_bounds__(MAXT, 1) replay_segment_lanes_kernel(const SegmentParams* __restrict__ lanes,
                                                                      long long* stats) {
  __shared__ __align__(16) SegmentParams S;
  __shared__ SearchSmem ps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long lane = blockIdx.x / cg::this_cluster().num_blocks();
  const long long* src = reinterpret_cast<const long long*>(lanes + lane);
  long long* dst = reinterpret_cast<long long*>(&S);
  for (long long i = threadIdx.x; i < static_cast<long long>(sizeof(SegmentParams) / 8); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  segment_body(S, smem_raw, ps, stats);
}

// Row 6 alone: one block (a cluster of one) derives the view from the
// local counts.
__global__ void __launch_bounds__(1024, 1) derive_interpod_kernel(const DeriveParams D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ClusterTeam team = make_cluster_team(D.N);
  int32_t* tot = reinterpret_cast<int32_t*>(smem_raw);
  derive_interpod(D, team, tot + D.T2, tot);
}

inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, long long blocks, int cs, int nt,
                           long long smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <class Kernel>
inline cudaError_t prepare(Kernel kernel, long long smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// The kernel of a pair (k_half for blocks of up to MAX_THREADS / 2
// threads, k_full above) that a block of nt threads runs.
template <class Kernel>
inline Kernel pick_kernel(Kernel k_half, Kernel k_full, int nt) {
  return nt <= MAX_THREADS / 2 ? k_half : k_full;
}

// How many cs-block clusters of nt threads (0: cluster_threads) the card
// holds resident at once, by its occupancy query; 0 where it refuses the
// shape (shared memory over the limit, say).  kernels/replay_segment.py
// choose_cluster picks the launch's size from these answers.
template <class Kernel>
inline int segment_fits(Kernel k_half, Kernel k_full, const SegmentParams& S, long long n_lanes, int cs,
                        int threads) {
  if (cs < 1 || cs > MAX_CLUSTER || threads < 0 || threads > MAX_THREADS || threads % 32 != 0 || n_lanes < 1)
    return 0;
  const int nt = threads > 0 ? threads : cluster_threads(S.chain.N, cs);
  const long long smem = segment_smem_bytes(S, cs, nt);
  Kernel kernel = pick_kernel(k_half, k_full, nt);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, n_lanes * cs, cs, nt, smem, nullptr);
  int fits = 0;
  if (prepare(kernel, smem) != cudaSuccess || cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a shape the card refuses: it holds no lane
    return 0;
  }
  return fits;
}

// Launches n_lanes clusters of `cluster` blocks of `threads` threads
// (0: cluster_threads).  info (int64 [3]) receives the cluster size, the
// threads per block and the dynamic shared memory per block.  Returns a
// CUDA error code (0 on success); a refused launch is an error, never a
// smaller launch.
template <class Kernel, class Arg>
inline int launch_segment(Kernel k_half, Kernel k_full, const SegmentParams& S, Arg arg, long long n_lanes,
                          cudaStream_t stream, int cluster, int threads, long long* stats, long long* info) {
  if (cluster < 1 || cluster > MAX_CLUSTER || threads < 0 || threads > MAX_THREADS || threads % 32 != 0 ||
      n_lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = threads > 0 ? threads : cluster_threads(S.chain.N, cluster);
  const long long smem = segment_smem_bytes(S, cluster, nt);
  Kernel kernel = pick_kernel(k_half, k_full, nt);
  info[0] = cluster;
  info[1] = nt;
  info[2] = smem;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, n_lanes * cluster, cluster, nt, smem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, arg, stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ksim

// `host` is lane 0's SegmentParams (the one lane's, passed by value, when
// `lanes` is null), `lanes` the device copy of every lane's.  cluster,
// threads, stats and info as launch_segment.
extern "C" int ksim_replay_segment(const ksim::SegmentParams* host, const ksim::SegmentParams* lanes,
                                   long long n_lanes, void* stream, int cluster, int threads, long long* stats,
                                   long long* info) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == nullptr)
    return ksim::launch_segment(ksim::replay_segment_kernel<ksim::MAX_THREADS / 2>,
                                ksim::replay_segment_kernel<ksim::MAX_THREADS>, *host, *host, 1, s, cluster,
                                threads, stats, info);
  return ksim::launch_segment(ksim::replay_segment_lanes_kernel<ksim::MAX_THREADS / 2>,
                              ksim::replay_segment_lanes_kernel<ksim::MAX_THREADS>, *host, lanes, n_lanes, s,
                              cluster, threads, stats, info);
}

// segment_fits for the solo kernel (lanes = 0) or the lanes kernel.
extern "C" int ksim_segment_fits(const ksim::SegmentParams* host, int lanes, long long n_lanes, int cs,
                                 int threads) {
  if (lanes == 0)
    return ksim::segment_fits(ksim::replay_segment_kernel<ksim::MAX_THREADS / 2>,
                              ksim::replay_segment_kernel<ksim::MAX_THREADS>, *host, n_lanes, cs, threads);
  return ksim::segment_fits(ksim::replay_segment_lanes_kernel<ksim::MAX_THREADS / 2>,
                            ksim::replay_segment_lanes_kernel<ksim::MAX_THREADS>, *host, n_lanes, cs, threads);
}

extern "C" int ksim_derive_interpod(const ksim::DeriveParams* params, void* stream) {
  const long long smem = 4 * params->T2 + ksim::derive_smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(ksim::derive_interpod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ksim::cluster_config(cfg, attr, 1, 1, ksim::MAX_THREADS, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, ksim::derive_interpod_kernel, *params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }
extern "C" long long ksim_segment_params_size() { return sizeof(ksim::SegmentParams); }
extern "C" long long ksim_derive_params_size() { return sizeof(ksim::DeriveParams); }
extern "C" long long ksim_segment_static_smem() { return ksim::segment_static_smem(); }
// Dynamic shared memory per block of a cs-block cluster of nt threads
// (kernels/replay_segment.py mirrors it).
extern "C" long long ksim_segment_smem(const ksim::SegmentParams* host, int cs, int nt) {
  return ksim::segment_smem_bytes(*host, cs, nt);
}

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
