// Kernel C: the sequential-commit scan with percentageOfNodesToScore
// sampling, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._schedule_sampled_fn
// (core.py:750-786) and _sample_visited (core.py:717-748): the scan of
// kernel A in which each pod, after running every filter on every node,
// visits the real nodes in index order from a rotating start and stops
// at its k-th feasible node (upstream schedule_one.go
// findNodesThatPassFilters + numFeasibleNodesToFind, as the deterministic
// sequential visit).  Scores, normalizes and selectHost run over the
// visited feasible nodes only; the start advances by the nodes visited,
// for valid pods only, and is carried through the scan in device memory.
//
// Design: kernel A's persistent block (plugin_chain.cuh scan_pods), with
// one more phase per pod after the filters (sample_window): a block sum of
// the feasible nodes before the start and in all, then a tile-by-tile
// prefix count over index order (a warp ballot and popcount per tile) that
// finds the node whose rotated feasible rank is k.  Positions are
// distinct, so no tie needs breaking; the top_k of the reference becomes
// integer counting.
//
// What bounds it: as kernel A, plus N / 1024 tiles of two barriers each
// per pod for the prefix count.  Sequential across pods: one SM.

#include "plugin_chain.cuh"

namespace ksim {

__global__ void __launch_bounds__(1024, 1) schedule_sampled_kernel(const ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve(smem_raw, P);
  scan_pods<true>(P, s);
}

}  // namespace ksim

extern "C" int ksim_schedule_sampled(const ksim::ChainParams* params, void* stream) {
  const long long smem = ksim::smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(
      ksim::schedule_sampled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::schedule_sampled_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(*params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
