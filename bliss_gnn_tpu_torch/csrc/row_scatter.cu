// K5: wide-row scatter-add out[S, F] (f32) += data[e, :] into row ids[e],
// for rows e < n_valid, accumulated in f32. F must be a multiple of 4.
//
// Replaces bliss_gnn_tpu/ops/rowscatter_pallas.py banked_row_scatter_add
// (kernel body _kernel). The TPU kept `banks` copies of one 128-lane output
// tile resident in VMEM and walked the edges in order, rotating banks so
// that consecutive read-modify-writes into one dst row could pipeline; it
// streamed the payload as f32 because bf16 single-row slices do not tile.
// Hopper adds into device memory with atomics resolved in L2, so there are
// no banks and no resident accumulator: every edge row is independent.
//
// Bound: bytes. Each valid row reads its F payload values once (2 bytes
// each for bf16) and one id; the f32 output (S*F*4 bytes, 15 MB at
// S = 3712, F = 1024: it stays in the 50 MB L2) is zeroed and written.
// What limits the kernel in practice is the L2's atomic throughput, so the
// design spends as few atomic instructions as it can: one warp per edge
// row (grid-stride over rows, the id read once per warp), each lane owning
// four contiguous columns, loaded as one 8-byte (bf16) or 16-byte (f32)
// vector and added with one float4 atomicAdd (Hopper, global memory). A
// warp instruction thus adds 128 contiguous floats (512 bytes) and
// F = 1024 takes eight. A lane whose four values are all zero (masked
// rows, ELU and dropout zeros) issues none. Ids outside [0, S) add
// nothing and need not be sorted (the gather backward sends src-table ids
// in edge order). The atomics' layout matters more than the loads': eight
// columns per lane (one 16-byte bf16 load) with eight scalar atomics puts
// a warp instruction's 32 addresses 32 bytes apart, and that layout
// measured 6x K3's time on the same inputs on an H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

// four contiguous payload values as floats
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void row_scatter_kernel(const T* __restrict__ data,
                                   const int32_t* __restrict__ ids, int64_t e,
                                   int32_t f,
                                   const int32_t* __restrict__ n_valid,
                                   int32_t s, float* __restrict__ out) {
  const int64_t nv = valid_prefix(e, n_valid);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < nv; r += n_warps) {
    const int32_t id = ids[r];
    if (id < 0 || id >= s) continue;  // uniform across the warp
    const T* row = data + r * (int64_t)f;
    float* dst = out + (int64_t)id * f;
    for (int32_t c = lane * 4; c < f; c += 128) {
      const float4 v = load4(row + c);
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(dst + c), v);
    }
  }
}

long long grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return blocks > 8192 ? 8192 : blocks;
}

}  // namespace

// dtype 0: data is f32; dtype 1: data is bf16. out is f32 [s, f], zeroed
// here. f % 4 == 0 and a 16-byte aligned data base keep every vector
// aligned.
// n_valid may be null. Returns cudaGetLastError().
extern "C" int bliss_row_scatter_add(const void* data, int dtype,
                                     const void* ids, long long e, int f,
                                     const void* n_valid, int s, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || f % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)s * f, st);
  if (err != cudaSuccess) return (int)err;
  if (e > 0 && f > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)grid_for(e * 32, threads);
    const int32_t* id = static_cast<const int32_t*>(ids);
    const int32_t* nv = static_cast<const int32_t*>(n_valid);
    float* o = static_cast<float*>(out);
    if (dtype == 0)
      row_scatter_kernel<float><<<blocks, threads, 0, st>>>(
          static_cast<const float*>(data), id, (int64_t)e, (int32_t)f, nv,
          (int32_t)s, o);
    else
      row_scatter_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(data), id, (int64_t)e,
          (int32_t)f, nv, (int32_t)s, o);
  }
  return (int)cudaGetLastError();
}
