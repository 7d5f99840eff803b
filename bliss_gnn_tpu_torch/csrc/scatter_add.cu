// K1: scatter-add of a 1-D f32 payload, out[keys[i]] += vals[i].
//
// Replaces bliss_gnn_tpu/ops/scatter_pallas.py banked_scatter_add (kernel
// body _kernel). On the TPU the accumulator sat in VMEM as 16 banks so that
// consecutive read-modify-writes pipelined; Hopper has hardware f32 atomics
// in L2, so the banks are not needed.
//
// Bound: bytes. Each valid element reads a 4-byte key and a 4-byte value,
// and each output is written once; there is one add per element, far below
// the card's arithmetic rate. The design keeps the byte count at that
// minimum: a grid-stride loop reads keys and values once, coalesced, stops
// at the caller's device-side n_valid (no host sync), and issues no atomic
// for a zero value. Masked slots carry value 0 at key 0 (the repo's masking
// convention), so skipping zeros also removes the contention those slots
// would cause on out[0].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

__global__ void scatter_add_f32_kernel(const int32_t* __restrict__ keys,
                                       const float* __restrict__ vals,
                                       float* __restrict__ out, int64_t n,
                                       const int32_t* __restrict__ n_valid,
                                       int32_t n_out) {
  const int64_t nv = valid_prefix(n, n_valid);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const float v = vals[i];
    const int32_t k = keys[i];
    if (v != 0.0f && k >= 0 && k < n_out) atomicAdd(out + k, v);
  }
}

}  // namespace

// out[n_out] = 0; out[keys[i]] += vals[i] for i < min(n, *n_valid).
// n_valid may be null (all n elements). Returns cudaGetLastError().
extern "C" int bliss_scatter_add_f32(const void* keys, const void* vals,
                                     void* out, long long n,
                                     const void* n_valid, int n_out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_out, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 8192) blocks = 8192;
    scatter_add_f32_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
        static_cast<float*>(out), (int64_t)n,
        static_cast<const int32_t*>(n_valid), (int32_t)n_out);
  }
  return (int)cudaGetLastError();
}
