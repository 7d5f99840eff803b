// K3: row segment-sum out[S, F] = sum over rows e < n_valid of data[e, :]
// into row ids[e], accumulated in f32, returned in the input dtype.
//
// Replaces bliss_gnn_tpu/ops/segsum_pallas.py onehot_segment_sum (kernel
// body _fwd_kernel). The TPU built a one-hot [S, tile] matrix per edge tile
// and ran it through the MXU, because it had no fast scatter; its cost grew
// with S. Hopper adds into memory with f32 atomics, whose cost does not
// depend on S.
//
// Bound: bytes. Each valid row reads F payload values and one id, and each
// output row is written once; one add per payload value is far below the
// card's arithmetic rate. One warp takes one edge row: the id is loaded
// once per warp, the lanes read the row coalesced and add it into an f32
// scratch [S, F] with atomicAdd (which stays in L2: S*F*4 bytes is about
// 4 MB on the main path). Zero values issue no atomic, so masked rows and
// ReLU zeros cost no read-modify-write. A second pass casts the scratch to
// bf16. Ids need not be sorted (the gather backward into the src table
// sends unsorted ids); ids outside [0, S) add nothing. Any F works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void segsum_accumulate_kernel(const T* __restrict__ data,
                                         const int32_t* __restrict__ ids,
                                         int64_t e, int32_t f,
                                         const int32_t* __restrict__ n_valid,
                                         int32_t s, float* __restrict__ acc) {
  const int64_t nv = valid_prefix(e, n_valid);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < nv; r += n_warps) {
    const int32_t id = ids[r];
    if (id < 0 || id >= s) continue;  // uniform across the warp
    const T* row = data + r * (int64_t)f;
    float* dst = acc + (int64_t)id * f;
    for (int32_t c = lane; c < f; c += 32) {
      const float v = to_f32(row[c]);
      if (v != 0.0f) atomicAdd(dst + c, v);
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16(src[i]);
}

long long grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return blocks > 8192 ? 8192 : blocks;
}

}  // namespace

// dtype 0: data and out are f32, acc is unused (out accumulates directly).
// dtype 1: data and out are bf16, acc is an f32 scratch of s*f entries.
// n_valid may be null. Returns cudaGetLastError().
extern "C" int bliss_segment_sum(const void* data, int dtype, const void* ids,
                                 long long e, int f, const void* n_valid,
                                 int s, void* acc, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  float* sum = static_cast<float*>(dtype == 0 ? out : acc);
  const long long n_out = (long long)s * f;
  cudaError_t err = cudaMemsetAsync(sum, 0, sizeof(float) * (size_t)n_out, st);
  if (err != cudaSuccess) return (int)err;
  if (e > 0 && f > 0) {
    const int threads = 256;
    const long long blocks = grid_for(e * 32, threads);
    if (dtype == 0)
      segsum_accumulate_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
          static_cast<const float*>(data), static_cast<const int32_t*>(ids),
          (int64_t)e, (int32_t)f, static_cast<const int32_t*>(n_valid),
          (int32_t)s, sum);
    else
      segsum_accumulate_kernel<__nv_bfloat16>
          <<<(unsigned)blocks, threads, 0, st>>>(
              static_cast<const __nv_bfloat16*>(data),
              static_cast<const int32_t*>(ids), (int64_t)e, (int32_t)f,
              static_cast<const int32_t*>(n_valid), (int32_t)s, sum);
  }
  if (dtype == 1 && n_out > 0) {
    const int threads = 256;
    f32_to_bf16_kernel<<<(unsigned)grid_for(n_out, threads), threads, 0, st>>>(
        sum, static_cast<__nv_bfloat16*>(out), (int64_t)n_out);
  }
  return (int)cudaGetLastError();
}
