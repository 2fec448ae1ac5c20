// Kernel C: the sequential-commit scan with percentageOfNodesToScore
// sampling, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._schedule_sampled_fn
// (core.py:750-786) and _sample_visited (core.py:717-748): the scan of
// kernel A in which each pod visits the real nodes in index order from a
// rotating start and stops at its k-th feasible node (upstream
// schedule_one.go findNodesThatPassFilters + numFeasibleNodesToFind, as
// the deterministic sequential visit).  Scores, normalizes and selectHost
// run over the visited feasible nodes only; the start advances by the
// nodes visited, for valid pods only, and is carried through the scan.
//
// Design: kernel A's cluster scan (cluster_scan.cuh), with the visit
// window as one more step of each pod (plugin_chain.cuh visit_window):
// the window is walked a cluster tile at a time in visit order, each
// piece's feasible nodes counted per warp and scanned across the cluster
// (ClusterTeam::piece_find) until the piece that holds the k-th; positions
// are distinct, so no tie needs breaking, and the top_k of the reference
// becomes integer counting.  Under record="selection" the filters run on
// the visited nodes alone, and the scores on the sampled feasible ones
// (PodTopologySpread's and InterPodAffinity's statistics still cover
// every node, as the reference's do); under record="full" every node is
// filtered and scored, since the records hold them all.
//
// What bounds it: as kernel A, plus one cluster barrier per piece of the
// walk; under record="selection" the chain runs on the visited share of
// the node axis.

#include "cluster_scan.cuh"

extern "C" int ksim_schedule_sampled(const ksim::ChainParams* params, void* stream, int cluster, int threads,
                                     long long* stats, long long* info) {
  return ksim::launch_cluster_scan<true>(params, stream, cluster, threads, stats, info);
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
