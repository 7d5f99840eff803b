// The rate ceiling under K1's unsorted route (bliss_gnn_tpu_torch/csrc/
// scatter_add.cu): the same number of red.global.add.f32 to the same
// addresses as K1 on its inputs, with no payload to load. Built and timed by
// tools/kernel_probe.py k1; not part of the port.
//
// keys: out[n_out] = 0, then for i < *n_valid one red.add of 1.0 at
// out[keys[i]] (keys in range); the keys are read, the values are not.
// hash: the same count of red.adds, to addresses hashed from i into
// [0, n_out); nothing is read but n_valid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__global__ void ceiling_keys_kernel(const int32_t* __restrict__ keys,
                                    float* __restrict__ out, int64_t n,
                                    const int32_t* __restrict__ n_valid,
                                    int32_t n_out) {
  int64_t nv = *n_valid;
  nv = nv < 0 ? 0 : (nv < n ? nv : n);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const int32_t k = keys[i];
    if (k >= 0 && k < n_out) red_add(out + k, 1.0f);
  }
}

__global__ void ceiling_hash_kernel(float* __restrict__ out, int64_t n,
                                    const int32_t* __restrict__ n_valid,
                                    int32_t n_out) {
  int64_t nv = *n_valid;
  nv = nv < 0 ? 0 : (nv < n ? nv : n);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    uint32_t h = (uint32_t)i * 2654435761u;  // Knuth's multiplicative hash
    h ^= h >> 15;
    red_add(out + (h % (uint32_t)n_out), 1.0f);
  }
}

}  // namespace

// kind 0: keys; kind 1: hash. The launch shape is K1's unsorted route's
// scalar one: 256 threads, ceil(n / 256) blocks, at most 8192.
extern "C" int k1_atomic_ceiling(int kind, const void* keys, void* out,
                                 long long n, const void* n_valid, int n_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_out, s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  if (kind == 0)
    ceiling_keys_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<float*>(out),
        (int64_t)n, nv, (int32_t)n_out);
  else
    ceiling_hash_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<float*>(out), (int64_t)n, nv, (int32_t)n_out);
  return (int)cudaGetLastError();
}
