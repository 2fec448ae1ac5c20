// Kernel D: the device-resident churn replay, K scheduling steps per
// launch, for sm_90a.
//
// Replaces ksim_tpu/engine/replay.py _segment_body (replay.py:492-1173),
// the program behind _segment_fn (:1204) and _segment_fn_nodonate (:1215),
// in the record="selection", preemption-free form, and _derive_interpod
// (:459, derive_interpod.cuh).  Per active step k:
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
//      ev.rank[k] (:942-951), and commit_pod;
//   6. step end: the bound pods' term rows into the node-local counts, the
//      backoff bookkeeping (:1121-1143), the step's outputs (:1144-1161).
//
// Inactive steps (tail padding) write the skip branch's outputs (:794-812)
// and leave the state alone.  The carry never leaves the device: the state
// tensors are written in place (the wrapper passes fresh copies, which is
// also why the donating and non-donating jit entries of the reference are
// one launch here).
//
// Design: kernel A's single persistent block of 1024 threads (thread t owns
// nodes t, t + 1024, ...), looping over steps and, inside a step, over the
// attempted pods.  Pod-axis work (requeue, flush, the queue) is strided
// over the block; event lists are short and take one thread per entry.
// What bounds it: the chain, as kernel A (P_attempted x N pod-node pairs
// of a few hundred operations, sequential across pods, one SM).

#include "derive_interpod.cuh"
#include "plugin_chain.cuh"

namespace ksim {

// Every field is 8 bytes wide (the structs embedded are too): the ctypes
// mirror in kernels/replay_segment.py has no padding to agree on.
struct SegmentParams {
  // The chain over the universe: pindex is arange(P), the node state
  // pointers are the carried state below, the carries are the step's
  // working carries (the InterPodAffinity view is derive's output).
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
  // [1] runs of derive_interpod() (one per active step), added here on
  // the card: the launch accounting of row 6, which has no launch of its
  // own on this path.
  int32_t* derive_runs;
  long long K, Q, cap, P;
  long long Wpc, Wpd, Wnc, Wnd;
  long long max_backoff, flush_cap, shift_cap;
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

// The attempted queue of step k into out_idx[k]; returns (eligible, attempted).
__device__ inline int2 build_queue(const SegmentParams& S, long long k, int pc, bool any_valid, Smem& s) {
  int32_t* idx = S.out_idx + k * S.Q;
  int32_t* sel = S.out_sel + k * S.Q;
  for (long long q = threadIdx.x; q < S.Q; q += blockDim.x) {
    idx[q] = static_cast<int32_t>(S.P);
    sel[q] = -1;
  }
  const long long limit = min(S.cap, S.Q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  long long running = 0;
  for (long long base = 0; base < S.P; base += blockDim.x) {
    const long long j = base + threadIdx.x;
    bool elig = false;
    if (j < S.P) {
      const bool in_backoff = S.attempts[j] > 0 && S.retry_at[j] >= pc;
      elig = S.alive[j] && S.bound[j] < 0 && !in_backoff;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, elig);
    if (lane == 0) s.scan[warp] = __popc(mask);
    __syncthreads();
    int below = 0, tile = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = s.scan[w];
      if (w < warp) below += c;
      tile += c;
    }
    const long long pos = running + below + __popc(mask & ((1u << lane) - 1u));
    if (elig && any_valid && pos < limit) idx[pos] = static_cast<int32_t>(j);
    __syncthreads();
    running += tile;
  }
  const int eligible = any_valid ? static_cast<int>(running) : 0;
  return make_int2(eligible, static_cast<int>(min(static_cast<long long>(eligible), limit)));
}

__device__ inline void inactive_step(const SegmentParams& S, long long k, int pc) {
  for (long long q = threadIdx.x; q < S.Q; q += blockDim.x) {
    S.out_idx[k * S.Q + q] = static_cast<int32_t>(S.P);
    S.out_sel[k * S.Q + q] = -1;
  }
  if (threadIdx.x == 0) {
    S.out_scheduled[k] = 0;
    S.out_unsched[k] = 0;
    S.out_eligible[k] = 0;
    S.out_pass[k] = pc;
    S.out_pending[k] = 0;
  }
}

__global__ void __launch_bounds__(1024, 1) replay_segment_kernel(const SegmentParams S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ChainParams& C = S.chain;
  Smem s = carve(smem_raw, C);
  int32_t* dsmem = reinterpret_cast<int32_t*>(smem_raw + smem_bytes(C));
  const long long T2 = C.T2;
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
    for (long long n = threadIdx.x; n < C.N; n += blockDim.x) v[0] = v[0] || S.valid[n];
    block_reduce(v, op, 1, s.red);
    const bool any_valid = v[0] != 0;
    pc += any_valid ? 1 : 0;
    const int2 q = build_queue(S, k, pc, any_valid, s);
    reset_step_carries(S);
    derive_interpod(S.derive, dsmem);
    if (threadIdx.x == 0) atomicAdd(S.derive_runs, 1);
    // The pods, in queue order.
    const int32_t* idx = S.out_idx + k * S.Q;
    const int32_t* rank = S.ev_rank + k * C.N;
    for (int qq = 0; qq < q.y; ++qq) {
      const long long j = idx[qq];
      const int best = eval_pod<false, true>(C, j, s, rank);
      if (threadIdx.x == 0) S.out_sel[k * S.Q + qq] = best;
      if (best >= 0) commit_pod(C, j, best);
    }
    __syncthreads();
    // Step end: binds into the node-local counts and the pod rows;
    // the backoff of the failed attempts.
    int w[2] = {0, 0};  // scheduled, pending after
    for (long long qq = threadIdx.x; qq < q.y; qq += blockDim.x) {
      const int j = idx[qq];
      const int b = S.out_sel[k * S.Q + qq];
      if (b >= 0) {
        for (long long t = 0; t < T2; ++t) {
          if (C.ipa_qm[j * T2 + t]) atomicAdd(&S.ip_cnt[b * T2 + t], 1);
          atomicAdd(&S.ip_eat[b * T2 + t], C.ipa_eat[j * T2 + t]);
          atomicAdd(&S.ip_vw[b * T2 + t], C.ipa_vw[j * T2 + t]);
        }
        S.bound[j] = b;
        S.nominated[j] = 0;
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

// Row 6 alone: one block derives the view from the local counts.
__global__ void __launch_bounds__(1024, 1) derive_interpod_kernel(const DeriveParams D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  derive_interpod(D, reinterpret_cast<int32_t*>(smem_raw));
}

}  // namespace ksim

extern "C" int ksim_replay_segment(const ksim::SegmentParams* params, void* stream) {
  const long long smem = ksim::segment_smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(
      ksim::replay_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::replay_segment_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(*params);
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

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
