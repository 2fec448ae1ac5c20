// Kernel B: batch evaluation of the plugin chain, for sm_90a.
//
// Replaces ksim_tpu/engine/core.py _Program._batch_eval (core.py:669-685),
// the body of _batch_fn (core.py:687-690, one program per pod chunk) and
// _batch_fused_fn (core.py:692-715, the whole pod axis in one program):
// every pod of a chunk against the FIXED node state, with no commit.
//
// Design: one block of 256 threads per pod (grid = the pod chunk).  The
// block runs the same chain as kernel A (plugin_chain.cuh eval_pod) against
// the carries as they stand, with the same in-block reductions and
// records, then writes the pod's selection.  The pods are independent, so
// the grid fills every SM; each block has its own slice of the
// per-domain scratch (shared memory, or a global buffer for large keys).
//
// What bounds it: P x N pairs of integer / float64 operations, a few
// hundred per pair for this profile; the inputs (node state, vocab rows)
// are small and stay in L2, and in the recording modes the outputs
// ([P, S, N] finals, [P, F, N] reason codes) are the bytes that count.

#include "plugin_chain.cuh"

namespace ksim {

__global__ void __launch_bounds__(256) batch_eval_kernel(const ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve(smem_raw, P);
  const long long p = blockIdx.x;
  const int best = eval_pod(P, p, s);
  if (threadIdx.x == 0) P.selected[p] = best;
}

}  // namespace ksim

extern "C" int ksim_batch_eval(const ksim::ChainParams* params, void* stream) {
  if (params->Pc == 0) return 0;
  const long long smem = ksim::smem_bytes(*params);
  cudaError_t err = cudaFuncSetAttribute(
      ksim::batch_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksim::batch_eval_kernel<<<static_cast<unsigned int>(params->Pc), 256, smem,
                            static_cast<cudaStream_t>(stream)>>>(*params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ksim_params_size() { return sizeof(ksim::ChainParams); }

extern "C" const char* ksim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
