// Kernel A: the sequential-commit scheduling scan, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._schedule_fn (core.py:788-816):
// a lax.scan over the pod queue that runs the plugin chain for each pod,
// selects a node, and commits the pod into the node state
// (plugins/base.py NodeStateView.commit) and the plugins' carries
// (NodePorts, NodeVolumeLimits, VolumeRestrictions, PodTopologySpread,
// InterPodAffinity).
//
// Design: ONE persistent block of 1024 threads loops over the pods of its
// chunk inside the kernel, so the carried state never leaves the device
// between pods and no pod costs a launch.  Thread t owns nodes t, t + 1024,
// ...; it alone reads and writes those nodes' carried rows, so the commit
// of the chosen node is its owner's plain stores, seen by that same thread
// at the next pod (InterPodAffinity's domain-wide commit is each thread's
// own nodes; the cluster-wide term total is thread 0's and is published
// by the next pod's first barrier).  Per pod: the phases of
// plugin_chain.cuh eval_pod, then the commit.
//
// What bounds it: the work is P x N pod-node pairs of integer (and, in
// exact mode, float64) operations — a few hundred per pair for the
// default profile — against bytes that are read once per pod from L2:
// the per-node state and vocab rows.  The scan is sequential across pods,
// so one block on one SM carries all of it: the card's bound (all SMs) is
// far below what one SM reaches.  Spreading a pod's node axis over a
// thread-block cluster with DSMEM reductions is the next step.

#include "plugin_chain.cuh"

namespace ksim {

__global__ void __launch_bounds__(1024, 1) schedule_scan_kernel(const ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve(smem_raw, P);
  scan_pods<false>(P, s);
}

}  // namespace ksim

extern "C" int ksim_schedule_scan(const ksim::ChainParams* params, void* stream) {
  const long long smem = ksim::smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(
      ksim::schedule_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::schedule_scan_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(*params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
