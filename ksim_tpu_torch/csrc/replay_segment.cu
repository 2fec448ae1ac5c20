// Kernel D: the device-resident churn replay, K scheduling steps per
// launch, for sm_90a; one block per lane.
//
// Replaces ksim_tpu/engine/replay.py _segment_body (replay.py:492-1173),
// the program behind _segment_fn (:1204) and _segment_fn_nodonate (:1215),
// its lane-stacked form _fleet_segment_fn (:1244) and
// _fleet_segment_fn_nodonate (:1277) (the body vmapped over S lanes,
// _fleet_segment_impl :1226), and _derive_interpod (:459,
// derive_interpod.cuh).  Per active step k:
//
//   1. events: pod deletes subtract the pod's rows from its bound node's
//      carried state (integer atomics), node drains zero the node's rows
//      and requeue its pods, node creates and pod creates switch rows on
//      (replay.py:578-627, :821-827);
//   2. the flush (capped remaining backoff) and the pass counter (:828-841);
//   3. the attempted queue: pending, alive, not backed off, in universe
//      (= queue sort) order, the first min(eligible, cap, Q), by a
//      block-wide prefix count; idx padded with P and sel with -1, as the
//      reference's scatter (:843-862);
//   4. InterPodAffinity's domain view from the node-local counts (row 6);
//   5. the pods: plugin_chain.cuh eval_pod (the whole default profile),
//      selectHost by the max total and the minimal canonical rank
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
// Design: one persistent block of 1024 threads per lane (thread t owns
// nodes t, t + 1024, ...), looping over steps and, inside a step, over the
// attempted pods.  A solo launch takes its SegmentParams by value (the
// kernel's parameter space); a fleet launch runs one block per lane, block
// b copying lane b's SegmentParams (every pointer the lane writes is its
// own; const and ev are shared and read-only) from a device array into
// shared memory, and never synchronises with another block.  The
// reference psum-reduces its search gate over lanes only to keep
// lax.cond's predicate unbatched under vmap; here each block replays its
// own lane's pass and searches where that lane's attempts need it.
// Pod-axis work (requeue, flush, the queue) is strided over the
// block; event lists are short and take one thread per entry.  What bounds
// it: the chain, as kernel A (P_attempted x N pod-node pairs of a few
// hundred operations, sequential across pods, one SM per lane); lanes run
// side by side on the card's 132 SMs.

#include "derive_interpod.cuh"
#include "plugin_chain.cuh"

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
  int32_t* vcnt;  // [N] lower-priority pods bound per node
  int32_t* out_nom;  // [K, Q] nominated node, -1
  int32_t* out_vic;  // [K, Q, VE] victim rows in reprieve order, -1
  uint8_t* out_over;  // [K] a search past the bounds
  long long K, Q, cap, P;
  long long Wpc, Wpd, Wnc, Wnd;
  long long max_backoff, flush_cap, shift_cap;
  long long preempt, CE, VE, empty_start_rank, resolv_f, resolv_w;
};

// One victim search's working set.
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
  int fit;  // eval_fit's answer
};

__host__ __device__ inline long long segment_smem_bytes(const SegmentParams& S) {
  return smem_bytes(S.chain) + derive_smem_bytes(S.derive);
}

// Step events: deletes, drains + requeue, creates (replay.py:578-627).
__device__ inline void apply_events(const SegmentParams& S, long long k) {
  const ChainParams& C = S.chain;
  const long long N = C.N, R = C.R, T2 = C.T2, SS = C.SS;
  // Pod deletes: subtract the pod's rows from its bound node (the rows of
  // several deletes may meet on one node: integer atomics).
  for (long long e = threadIdx.x; e < S.Wpd; e += blockDim.x) {
    const int j = S.ev_pd[k * S.Wpd + e];
    if (j < 0) continue;
    const int b = S.bound[j];
    if (b >= 0) {
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
  }
  __syncthreads();  // every delete read its bound node before any clears it
  for (long long e = threadIdx.x; e < S.Wpd; e += blockDim.x) {
    const int j = S.ev_pd[k * S.Wpd + e];
    if (j < 0) continue;
    S.alive[j] = 0;
    S.bound[j] = -1;
  }
  // Node drains: each owner clears its drained nodes' rows.
  const int32_t* nd = S.ev_nd + k * S.Wnd;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    bool gone = false;
    for (long long e = 0; e < S.Wnd; ++e) gone = gone || nd[e] == n;
    if (!gone) continue;
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
  __syncthreads();  // deletes' bound = -1 before the requeue reads bound
  // Drained nodes' pods go back to the queue.
  if (S.Wnd > 0) {
    for (long long j = threadIdx.x; j < S.P; j += blockDim.x) {
      const int b = S.bound[j];
      if (!S.alive[j] || b < 0) continue;
      bool gone = false;
      for (long long e = 0; e < S.Wnd; ++e) gone = gone || nd[e] == b;
      if (gone) S.bound[j] = -1;
    }
  }
  for (long long e = threadIdx.x; e < S.Wnc; e += blockDim.x) {
    const int n = S.ev_nc[k * S.Wnc + e];
    if (n >= 0) S.valid[n] = 1;
  }
  for (long long e = threadIdx.x; e < S.Wpc; e += blockDim.x) {
    const int j = S.ev_pc[k * S.Wpc + e];
    if (j >= 0) S.alive[j] = 1;
  }
  __syncthreads();
}

// The step-local carries back to their values at a step's start.
__device__ inline void reset_step_carries(const SegmentParams& S) {
  const ChainParams& C = S.chain;
  const long long N = C.N;
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
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

// The attempted queue of step k into out_idx[k]; returns (eligible, attempted).
__device__ inline int2 build_queue(const SegmentParams& S, long long k, int pc, bool any_valid, Smem& s) {
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
  const long long limit = any_valid ? min(S.cap, S.Q) : 0;
  const long long running = block_compact(S.P, limit, idx, s, [&](long long j) {
    const bool in_backoff = S.attempts[j] > 0 && S.retry_at[j] >= pc;
    return S.alive[j] && S.bound[j] < 0 && !in_backoff;
  });
  const int eligible = any_valid ? static_cast<int>(running) : 0;
  return make_int2(eligible, static_cast<int>(min(static_cast<long long>(eligible), limit)));
}

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

// A recorded element of the given width, sign-extended.
__device__ inline long long load_int(const void* base, long long idx, long long size) {
  switch (size) {
    case 1: return static_cast<const int8_t*>(base)[idx];
    case 2: return static_cast<const int16_t*>(base)[idx];
    case 4: return static_cast<const int32_t*>(base)[idx];
    default: return static_cast<const int64_t*>(base)[idx];
  }
}

// The rows of pods rows[0..count) (those of `mask` that are >= 0) added
// to node n's carried state with `sign`: a bind (+1), or victims taken off
// (-1) and put back (+1).  One thread per field; the caller orders it.
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
// taken off n?  The spread statistics and the inter-pod view are
// recomputed over the modified state (replay.py eval_fit, :670-699).
__device__ inline bool eval_fit(const SegmentParams& S, long long j, long long n, unsigned mask, Smem& s,
                                int32_t* dsmem, SearchSmem& ps) {
  const ChainParams& C = S.chain;
  shift_rows(S, n, ps.vrows, MAX_VIC, mask, -1, false);
  __syncthreads();
  derive_interpod(S.derive, dsmem);  // ends with a barrier
  const bool use_spread = C.f_row[SPREAD] >= 0 || C.s_row[SPREAD] >= 0;
  if (use_spread)
    for (long long i = threadIdx.x; i < domain_ints(C); i += blockDim.x) s.dom[i] = 0;
  __syncthreads();
  const Spread sp = use_spread ? spread_pod(C, j) : Spread{0, 0u, 0u, false};
  const bool use_ipa = C.f_row[INTERPOD] >= 0 || C.s_row[INTERPOD] >= 0;
  const Interpod ip = use_ipa ? interpod_pod(C, j) : Interpod{0, false, false, false, false};
  int min_match[MAX_MC];
  const bool sp_filter = C.f_row[SPREAD] >= 0 && sp.active_f != 0;
  if (sp_filter) spread_filter_stats(C, sp, j, s, min_match);
  if (threadIdx.x == 0) ps.fit = (filter_node(C, j, j, n, s, sp, ip, min_match, sp_filter, false, 0) & FL_OK) != 0;
  __syncthreads();
  const bool fit = ps.fit != 0;
  shift_rows(S, n, ps.vrows, MAX_VIC, mask, +1, false);
  __syncthreads();
  return fit;
}

// Is node n a candidate for attempt row `row` by its reason codes
// (record="full": the first failing filter's code must be resolvable)?
__device__ inline bool resolvable(const SegmentParams& S, long long row, long long n) {
  const ChainParams& C = S.chain;
  if (C.record != 2) return true;
  for (long long f = 0; f < C.F; ++f) {
    const long long code = load_int(C.bits_out, (row * C.F + f) * C.N + n, C.bits_size);
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
                                      int32_t* dsmem, SearchSmem& ps) {
  const ChainParams& C = S.chain;
  const long long N = C.N;
  const int prio = S.priority[j];
  for (long long n = threadIdx.x; n < N; n += blockDim.x) S.vcnt[n] = 0;
  __syncthreads();
  for (long long p = threadIdx.x; p < S.P; p += blockDim.x)
    if (S.alive[p] && S.bound[p] >= 0 && S.priority[p] < prio) atomicAdd(&S.vcnt[S.bound[p]], 1);
  __syncthreads();
  const long long row = k * S.Q + q;
  const long long n_exam = block_compact(N, S.CE, ps.cand, s, [&](long long r) {
    const int n = S.name_order[r];
    return n >= 0 && S.vcnt[n] > 0 && S.valid[n] && resolvable(S, row, n);
  });
  bool over = n_exam > S.CE;
  const int n_cand = static_cast<int>(min(n_exam, S.CE));
  for (int i = 0; i < n_cand; ++i) {
    const int n = ps.cand[i];
    if (threadIdx.x < MAX_VIC) ps.vrows[threadIdx.x] = -1;
    __syncthreads();
    const long long n_on = block_compact(S.P, S.VE, ps.vrows, s, [&](long long r) {
      const int p = S.imp_order[r];
      return p >= 0 && S.alive[p] && S.bound[p] == n && S.priority[p] < prio;
    });
    // block_compact wrote universe ranks: map them to rows.
    if (threadIdx.x < MAX_VIC && ps.vrows[threadIdx.x] >= 0) ps.vrows[threadIdx.x] = S.imp_order[ps.vrows[threadIdx.x]];
    __syncthreads();
    over = over || n_on > S.VE;
    const int nv = static_cast<int>(min(n_on, S.VE));
    const unsigned all = nv >= 32 ? 0xffffffffu : ((1u << nv) - 1u);
    const bool fit0 = eval_fit(S, j, n, all, s, dsmem, ps);
    unsigned removed = all, vic = 0u;
    for (int v = 0; v < nv; ++v) {
      const unsigned test = removed & ~(1u << v);
      if (eval_fit(S, j, n, test, s, dsmem, ps)) removed = test;  // reprieved
      else vic |= 1u << v;
    }
    if (threadIdx.x == 0) {
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
    __syncthreads();
  }
  // pickOneNodeForPreemption: the first `want` fitting candidates in
  // discovery order, narrowed by (min max victim priority, min priority
  // sum, min count, max earliest start, min name rank), then the first.
  if (threadIdx.x == 0) {
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
    ps.fit = chosen;
    S.out_nom[row] = chosen >= 0 ? ps.cand[chosen] : -1;
    for (long long v = 0; v < S.VE; ++v) S.out_vic[row * S.VE + v] = chosen >= 0 ? ps.vic[chosen][v] : -1;
    if (over) S.out_over[k] = 1;
  }
  __syncthreads();
  const int chosen = ps.fit;
  if (chosen < 0) return;
  const int nom = ps.cand[chosen];
  shift_rows(S, nom, ps.vic[chosen], MAX_VIC, 0xffffffffu, -1, true);
  if (threadIdx.x < MAX_VIC) {
    const int r = ps.vic[chosen][threadIdx.x];
    if (r >= 0) {
      S.alive[r] = 0;
      S.bound[r] = -1;
    }
  }
  if (threadIdx.x == 0) S.nominated[j] = 1;
  __syncthreads();
}

// After the pass's chain: the pass again, in queue order, against the
// live view (this pass's binds so far, the victims removed so far), with
// the victim search for each failed attempt that may preempt and has a
// pod of lower priority bound somewhere.  The carried state ends as the
// post-pass live view: binds, victims and nominations applied.
__device__ inline void preempt_pass(const SegmentParams& S, long long k, int n_att, Smem& s, int32_t* dsmem,
                                    SearchSmem& ps) {
  const ChainParams& C = S.chain;
  const long long N = C.N, R = C.R, SS = C.SS;
  const int32_t* idx = S.out_idx + k * S.Q;
  const int32_t* sel = S.out_sel + k * S.Q;
  const int op_max[1] = {RMAX};
  // Back to the pre-pass state (the chain committed into it) and the
  // step-start carries.
  for (long long n = threadIdx.x; n < N; n += blockDim.x) {
    for (long long r = 0; r < R; ++r) {
      C.requested[n * R + r] = S.snap_req[n * R + r];
      C.nz_requested[n * R + r] = S.snap_nz[n * R + r];
    }
    C.pod_count[n] = S.snap_pc[n];
    for (long long c = 0; c < SS; ++c) S.spread[n * SS + c] = S.snap_spread[n * SS + c];
  }
  reset_step_carries(S);
  __syncthreads();
  for (int q = 0; q < n_att; ++q) {
    const int j = idx[q];
    const int best = sel[q];
    if (best >= 0) {
      shift_rows(S, best, &j, 1, 1u, +1, true);
      if (threadIdx.x == 0) {
        S.bound[j] = best;
        S.nominated[j] = 0;
      }
      __syncthreads();
      continue;
    }
    if (!S.preempt_ok[j]) continue;
    const int prio = S.priority[j];
    int lower[1] = {0};
    for (long long p = threadIdx.x; p < S.P; p += blockDim.x)
      if (S.alive[p] && S.bound[p] >= 0 && S.priority[p] < prio) lower[0] = 1;
    block_reduce(lower, op_max, 1, s.red);
    if (lower[0]) preempt_search(S, k, q, j, s, dsmem, ps);
  }
}

__device__ inline void segment_body(const SegmentParams& S, unsigned char* smem_raw, SearchSmem& ps) {
  const ChainParams& C = S.chain;
  Smem s = carve(smem_raw, C);
  int32_t* dsmem = reinterpret_cast<int32_t*>(smem_raw + smem_bytes(C));
  const long long N = C.N, R = C.R, SS = C.SS, T2 = C.T2;
  const bool full = C.record == 2;
  int pc = *S.pass_count;  // every thread holds the counter
  for (long long k = 0; k < S.K; ++k) {
    if (!S.ev_active[k]) {
      inactive_step(S, k, pc);
      continue;
    }
    apply_events(S, k);
    // The flush caps existing entries' remaining wait, from the pre-pass
    // count; the pass counts only when a node exists.
    const bool flush = S.ev_flush[k];
    int v[2] = {0, 0};  // any valid node, pending after (below)
    const int op[2] = {RMAX, RSUM};
    for (long long j = threadIdx.x; j < S.P; j += blockDim.x) {
      const int a = S.attempts[j];
      if (flush && a > 0) S.retry_at[j] = min(S.retry_at[j], pc + min(a - 1, static_cast<int>(S.flush_cap)));
    }
    for (long long n = threadIdx.x; n < N; n += blockDim.x) v[0] = v[0] || S.valid[n];
    block_reduce(v, op, 1, s.red);
    const bool any_valid = v[0] != 0;
    pc += any_valid ? 1 : 0;
    const int2 q = build_queue(S, k, pc, any_valid, s);
    if (S.preempt) {
      // The pre-pass state the searches replay from, and the live name
      // order of this step's nodes.
      for (long long n = threadIdx.x; n < N; n += blockDim.x) {
        for (long long r = 0; r < R; ++r) {
          S.snap_req[n * R + r] = C.requested[n * R + r];
          S.snap_nz[n * R + r] = C.nz_requested[n * R + r];
        }
        S.snap_pc[n] = C.pod_count[n];
        for (long long c = 0; c < SS; ++c) S.snap_spread[n * SS + c] = S.spread[n * SS + c];
        S.name_order[n] = -1;
      }
      if (threadIdx.x == 0) S.out_over[k] = 0;
      __syncthreads();
      for (long long n = threadIdx.x; n < N; n += blockDim.x) {
        const int r = S.ev_name_rank[k * N + n];
        if (r >= 0 && r < N) S.name_order[r] = static_cast<int>(n);
      }
    }
    reset_step_carries(S);
    derive_interpod(S.derive, dsmem);
    if (threadIdx.x == 0) atomicAdd(S.derive_runs, 1);
    // The pods, in queue order.
    const int32_t* idx = S.out_idx + k * S.Q;
    const int32_t* rank = S.ev_rank + k * N;
    for (int qq = 0; qq < q.y; ++qq) {
      const long long j = idx[qq];
      const int best = eval_pod<true>(C, j, s, rank, full ? k * S.Q + qq : -1);
      if (threadIdx.x == 0) S.out_sel[k * S.Q + qq] = best;
      if (best >= 0) commit_pod(C, j, best);
    }
    __syncthreads();
    if (S.preempt) preempt_pass(S, k, q.y, s, dsmem, ps);
    // Step end: binds into the node-local counts and the pod rows (done
    // already when preempt_pass replayed the pass); the backoff of the
    // failed attempts.
    int w[2] = {0, 0};  // scheduled, pending after
    for (long long qq = threadIdx.x; qq < q.y; qq += blockDim.x) {
      const int j = idx[qq];
      const int b = S.out_sel[k * S.Q + qq];
      if (b >= 0) {
        if (!S.preempt) {
          for (long long t = 0; t < T2; ++t) {
            if (C.ipa_qm[j * T2 + t]) atomicAdd(&S.ip_cnt[b * T2 + t], 1);
            atomicAdd(&S.ip_eat[b * T2 + t], C.ipa_eat[j * T2 + t]);
            atomicAdd(&S.ip_vw[b * T2 + t], C.ipa_vw[j * T2 + t]);
          }
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
      S.out_unsched[k] = q.y - w[0];
      S.out_eligible[k] = q.x;
      S.out_pass[k] = pc;
      S.out_pending[k] = w[1];
    }
  }
  if (threadIdx.x == 0) *S.pass_count = pc;
}

// One lane: the params by value, in the kernel's parameter space.
__global__ void __launch_bounds__(1024, 1) replay_segment_kernel(const SegmentParams S) {
  __shared__ SearchSmem ps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  segment_body(S, smem_raw, ps);
}

// S lanes: block b runs lane b from its own copy of lanes[b] in shared
// memory.
__global__ void __launch_bounds__(1024, 1) replay_segment_lanes_kernel(const SegmentParams* __restrict__ lanes) {
  __shared__ __align__(16) SegmentParams S;
  __shared__ SearchSmem ps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long* src = reinterpret_cast<const long long*>(lanes + blockIdx.x);
  long long* dst = reinterpret_cast<long long*>(&S);
  for (long long i = threadIdx.x; i < static_cast<long long>(sizeof(SegmentParams) / 8); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  segment_body(S, smem_raw, ps);
}

// Row 6 alone: one block derives the view from the local counts.
__global__ void __launch_bounds__(1024, 1) derive_interpod_kernel(const DeriveParams D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  derive_interpod(D, reinterpret_cast<int32_t*>(smem_raw));
}

}  // namespace ksim

// `host` is lane 0's SegmentParams (the one lane's, passed by value, when
// `lanes` is null), `lanes` the device copy of every lane's.
extern "C" int ksim_replay_segment(const ksim::SegmentParams* host, const ksim::SegmentParams* lanes,
                                   long long n_lanes, void* stream) {
  const long long smem = ksim::segment_smem_bytes(*host);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lanes == nullptr) {
    err = cudaFuncSetAttribute(ksim::replay_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ksim::replay_segment_kernel<<<1, 1024, smem, s>>>(*host);
  } else {
    err = cudaFuncSetAttribute(ksim::replay_segment_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ksim::replay_segment_lanes_kernel<<<static_cast<unsigned>(n_lanes), 1024, smem, s>>>(lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksim_derive_interpod(const ksim::DeriveParams* params, void* stream) {
  const long long smem = ksim::derive_smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(
      ksim::derive_interpod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::derive_interpod_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(*params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }
extern "C" long long ksim_segment_params_size() { return sizeof(ksim::SegmentParams); }
extern "C" long long ksim_derive_params_size() { return sizeof(ksim::DeriveParams); }
// The lanes kernel's static shared memory (the larger): its lane's
// params and the search's.
extern "C" long long ksim_segment_static_smem() {
  return sizeof(ksim::SegmentParams) + sizeof(ksim::SearchSmem);
}

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
