// K4: sparse multiplicative update of the bf16 EXP3 arm-weight state,
// state[idx] *= mult, where duplicate indices compose multiplicatively.
//
// Replaces bliss_gnn_tpu/ops/exp3_pallas.py exp3_apply_streaming (kernel
// body _apply_kernel). The TPU streamed the whole [L, R, 128] state through
// VMEM tile by tile (about 690 MB read and written per step at Reddit
// scale) because it had no fast sparse read-modify-write, and it skipped
// updates past a fixed run window. Here only the touched entries move.
//
// Bound: bytes. Each update reads a 4-byte index and a 4-byte factor, and
// each distinct touched entry is read and written once (2 + 2 bytes). The
// caller sorts the indices (torch.sort) and permutes the factors; then one
// thread per sorted position checks whether it starts a run of equal
// indices. Only a run's first thread works: it multiplies the run's
// factors in f32 and writes the bf16 entry once, so no atomics are needed
// and duplicates of any multiplicity compose (no overflow exists).
// Indices outside [0, limit) are no-op slots and are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void exp3_apply_kernel(__nv_bfloat16* __restrict__ state,
                                  const int32_t* __restrict__ s_idx,
                                  const float* __restrict__ s_mult, int64_t u,
                                  int32_t limit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t k = s_idx[i];
    if (k < 0 || k >= limit) continue;
    if (i > 0 && s_idx[i - 1] == k) continue;  // not the start of its run
    float p = s_mult[i];
    for (int64_t j = i + 1; j < u && s_idx[j] == k; ++j) p *= s_mult[j];
    state[k] = __float2bfloat16(__bfloat162float(state[k]) * p);
  }
}

}  // namespace

// state: flat bf16 [limit]; s_idx: int32 [u] sorted ascending; s_mult: f32
// [u] permuted with it. Updates state in place. Returns cudaGetLastError().
extern "C" int bliss_exp3_apply(void* state, const void* s_idx,
                                const void* s_mult, long long u, int limit,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u > 0) {
    const int threads = 256;
    long long blocks = (u + threads - 1) / threads;
    if (blocks > 8192) blocks = 8192;
    exp3_apply_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(state), static_cast<const int32_t*>(s_idx),
        static_cast<const float*>(s_mult), (int64_t)u, (int32_t)limit);
  }
  return (int)cudaGetLastError();
}
