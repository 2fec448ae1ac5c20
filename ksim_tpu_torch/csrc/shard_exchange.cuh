// The exchange between node shards, for sm_90a: the step that kernels A,
// B and C add to each node-axis reduction when a device mesh splits the
// node axis over tp shards (ksim_tpu_torch/engine/sharding.py,
// kernels/sharded.py).  It stands where the reference's GSPMD inserts an
// all-reduce over ICI (ksim_tpu/engine/sharding.py).
//
// Shard r holds the global nodes [r * N / tp, (r + 1) * N / tp) and runs
// its own team (A, C: a thread-block cluster; B: each block of its
// persistent grid).  A team first reduces over its own nodes as it does
// unsharded; then its publisher (A, C: cluster rank 0's block; B: the
// block) writes that partial into its slot of every shard's exchange
// buffer, with the exchange's epoch as the slot's flag: the payload
// stores, a block barrier, a system-scope fence, then a release store of
// the flag (st.release.sys).  Thread 0 then spins with ld.acquire.sys
// until every shard's slot in its own buffer carries the epoch.  A and C
// hand its verdict to the cluster's other blocks through a cluster
// barrier (the block's barrier in B), after which every block reads the
// payloads (ld.cv, never a stale L1 line) and combines them in shard
// order.  The combines are integer sums, minima and maxima and the packed
// (total, inverted global node index) maximum of the selection, so a
// sharded launch gives the unsharded one's results byte for byte.
//
// Buffers.  Shard q's buffer holds, per team slot g (B: the block's index
// in its shard's grid; A, C: 0), XS_RING rings of nshards slots of 1 +
// slot_words 64-bit words (the flag, then the payload).  Exchange number
// seq of team g lands in ring seq % XS_RING.  A slot is written again
// only XS_RING exchanges later, after its writer collected every shard's
// next exchanges; each of those passed, on every shard, a barrier that
// the readers of this slot reached only when done reading (an exchange
// without an in-team barrier before its publish always follows one with
// it), so no payload is overwritten while it is read.  The epoch is
// (gen << 32) | seq, gen a per-launch number from the host: a flag left
// by an earlier launch never matches, and no buffer needs clearing.
//
// No hang.  A spin gives up after spin_cycles clock64() cycles (about one
// second): the shard writes its error words (the kind of exchange, the
// shard it waited for, the exchange number, itself) and its team goes
// dead: from then on it publishes and waits no more, its reductions keep
// their in-team values and its selections find no node, and the kernel
// leaves at the end of the pod.  The wrapper reads the error words after
// the launch and raises, naming the shard and the reduction.
#pragma once

#include <cuda_runtime.h>

namespace ksim {

constexpr int MAX_SHARDS = 16;
constexpr int XS_RING = 4;

// What an exchange carries (the error words name it).
enum XsKind : int { XS_REDUCE = 1, XS_SELECT = 2, XS_DOMAINS = 3, XS_VISIT = 4 };

// One shard's view of its group's exchange (device memory, one per shard;
// the ctypes mirror is kernels/sharded.py ShardExchange).
struct ShardExchange {
  unsigned long long* buf[MAX_SHARDS];  // shard q's buffer (its device's memory)
  long long* err;  // this shard's error words [4]: kind, awaited shard, exchange, this shard
  long long shard, nshards;
  long long gen;  // the launch's number (the high half of every epoch)
  long long spin_cycles;  // a spin's bound in clock64() cycles
  long long silent;  // a shard that never publishes (the no-hang check), -1 for none
  long long slot_words;  // payload words of one slot
  long long blocks;  // team slots per buffer
};

__device__ inline unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One team's link to its group.  x == nullptr: unsharded (every call
// below is then skipped by the teams).
struct ShardLink {
  const ShardExchange* x = nullptr;
  long long g = 0;  // the team's slot in every buffer
  unsigned seq = 1;  // the next exchange's number
  bool dead = false;

  __device__ bool on() const { return x != nullptr && !dead; }
  __device__ unsigned long long epoch() const {
    return (static_cast<unsigned long long>(x->gen) << 32) | seq;
  }
  // Shard `owner`'s slot for shard `from` in this exchange.
  __device__ unsigned long long* slot(long long owner, long long from) const {
    const long long ns = x->nshards, w = 1 + x->slot_words;
    return x->buf[owner] + ((g * XS_RING + (seq % XS_RING)) * ns + from) * w;
  }
  // Shard `from`'s payload in this shard's buffer, as 32-bit words.
  __device__ const unsigned* payload(long long from) const {
    return reinterpret_cast<const unsigned*>(slot(x->shard, from) + 1);
  }
  __device__ unsigned word(long long from, long long i) const { return __ldcv(payload(from) + i); }

  // Every thread of the publishing block: n words of src into this
  // shard's slot of every shard's buffer, then (thread 0) the flags.
  __device__ void publish(const unsigned* src, long long n) const {
    const bool quiet = x->silent == x->shard;
    if (!quiet)
      for (long long q = 0; q < x->nshards; ++q) {
        unsigned* dst = reinterpret_cast<unsigned*>(slot(q, x->shard) + 1);
        for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
      }
    __syncthreads();
    if (threadIdx.x == 0 && !quiet) {
      __threadfence_system();
      for (long long q = 0; q < x->nshards; ++q) st_release_sys(slot(q, x->shard), epoch());
    }
  }

  // Thread 0: waits for every shard's flag of this exchange in this
  // shard's buffer; false (after writing the error words) past the bound.
  __device__ bool wait(int kind) const {
    const unsigned long long e = epoch();
    for (long long q = 0; q < x->nshards; ++q) {
      const unsigned long long* f = slot(x->shard, q);
      const long long t0 = clock64();
      while (ld_acquire_sys(f) != e) {
        if (clock64() - t0 > x->spin_cycles) {
          if (atomicCAS(reinterpret_cast<unsigned long long*>(x->err), 0ULL,
                        static_cast<unsigned long long>(kind)) == 0ULL) {
            x->err[1] = q;
            x->err[2] = seq;
            x->err[3] = x->shard;
            __threadfence_system();
          }
          return false;
        }
      }
    }
    return true;
  }
};

// Peer access from the current device to `peer` (shards on distinct
// GPUs write into each other's buffers); already enabled counts as done.
inline int enable_peer_access(int peer) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev == peer) return 0;
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(err);
}

// The current device's SM clock in kHz (a spin's bound in cycles).
inline int clock_khz() {
  int dev = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) != cudaSuccess) return 0;
  return khz;
}

}  // namespace ksim
