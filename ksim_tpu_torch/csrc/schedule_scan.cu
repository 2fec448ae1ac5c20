// Kernel A: the sequential-commit scheduling scan, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._schedule_fn (core.py:788-816):
// a lax.scan over the pod queue that runs the plugin chain for each pod,
// selects a node, and commits the pod into the node state
// (plugins/base.py NodeStateView.commit) and the plugins' carries
// (NodePorts, NodeVolumeLimits, VolumeRestrictions, PodTopologySpread,
// InterPodAffinity).
//
// Design: one persistent thread-block cluster loops over the pods of its
// chunk inside the kernel, so the carried state never leaves the device
// between pods and no pod costs a launch; each pod's node axis is spread
// over the cluster's blocks, its reductions cross the cluster through
// distributed shared memory (cluster_scan.cuh, which also says why the
// commit needs no barrier of its own).  Per pod: the phases of
// plugin_chain.cuh eval_pod_team, then the commit.  Under
// record="selection" a padding pod costs nothing, and the chain skips
// invalid nodes and the scores of infeasible ones.
//
// What bounds it: the work is P x N pod-node pairs of integer (and, in
// exact mode, float64) operations -- a few hundred per pair for the
// default profile -- against bytes that are read once per pod from L2:
// the per-node state and vocab rows.  The scan is sequential across pods,
// so one cluster (8 or 16 SMs) carries all of it, and each pod waits for
// the latency of one node's chain and of its cluster barriers
// (cluster_scan.cuh): the card's bound (all SMs) is far below what one
// cluster reaches.

#include "cluster_scan.cuh"

extern "C" int ksim_schedule_scan(const ksim::ChainParams* params, void* stream, int cluster, int threads,
                                  long long* stats, long long* info) {
  return ksim::launch_cluster_scan<false>(params, stream, cluster, threads, stats, info);
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
