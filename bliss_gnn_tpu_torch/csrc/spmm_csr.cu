// K6: full-graph SpMM over the CSC (dst-sorted) arrays,
// out[d, :] = sum over edges e into d of w_e * x[src_e, :], f32 output.
//
// Replaces bliss_gnn_tpu/ops/spmm_pallas.py banded_spmm / banded_spmm_packed
// / hybrid_spmm (bodies _spmm_kernel, _spmm_kernel_packed,
// _dense_block_kernel, _dense_block_kernel_packed). Those four are TPU
// layouts of this one function: the TPU could not gather rows fast, so it
// cut the edges into (src band, dst window) tiles, kept a band of x
// resident in VMEM and summed each tile through one-hot MXU contractions,
// with bf16 pair packing and a dense-block variant for hub windows. Hopper
// gathers rows from L2 and device memory directly, so the kernel reads the
// CSC arrays as they are: no layout build, no padding.
//
// Bound: the compulsory bytes (x read once, the CSC arrays, the f32
// output) and the adds (E * F) are both small; what the kernel really
// moves is one x row per edge (E * F * 2 bytes for bf16, 59 GB at Reddit
// scale and F = 256), mostly from L2 and device memory. Design: one block
// of four warps per dst row. The warps take 32-edge batches of the row in
// turn: a batch's src ids (and weights) are read coalesced, one per lane,
// and broadcast with shuffles; every lane then reads its 16 bytes (8 bf16
// or 4 f32) of the src row and adds into registers, so a hub row of 21k
// edges is split four ways and an F = 256 bf16 row is one coalesced warp
// load. The four partial sums meet in shared memory and the row is
// written once: no atomics, the same sum on every run. Any F works (F not
// a multiple of the vector width reads one value per lane, in 32-column
// chunks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 1, "bf16 loads are 8-wide or scalar");
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  } else {
    static_assert(VEC == 1, "f32 loads are 4-wide or scalar");
    v[0] = *p;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(const T* __restrict__ x, int32_t f,
                const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ src,
                const float* __restrict__ w, float* __restrict__ out) {
  __shared__ float part[kWarps][32 * VEC];
  const int64_t row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t e0 = indptr[row];
  const int64_t e1 = indptr[row + 1];
  for (int32_t c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int32_t col = c0 + lane * VEC;
    const bool active = col < f;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int64_t b = e0 + 32 * warp; b < e1; b += 32 * kWarps) {
      const int64_t e = b + lane;
      int32_t s_l = 0;
      float w_l = 1.0f;
      if (e < e1) {
        s_l = src[e];
        if (w != nullptr) w_l = w[e];
      }
      const int cnt = (int)(e1 - b < 32 ? e1 - b : 32);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int32_t s = __shfl_sync(kFull, s_l, j);
        const float wj = __shfl_sync(kFull, w_l, j);
        if (active) {
          float v[VEC];
          load_vec<VEC>(x + (int64_t)s * f + col, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[warp][lane * VEC + i] = acc[i];
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * VEC; t += blockDim.x) {
      if (c0 + t < f) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) sum += part[k][t];
        out[row * f + c0 + t] = sum;
      }
    }
    __syncthreads();
  }
}

template <typename T, int VEC>
void launch(const void* x, int f, const void* indptr, const void* src,
            const void* w, int n, void* out, cudaStream_t st) {
  spmm_csr_kernel<T, VEC><<<(unsigned)n, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), (int32_t)f,
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src),
      static_cast<const float*>(w), static_cast<float*>(out));
}

}  // namespace

// dtype 0: x is f32; dtype 1: x is bf16. x is [n_rows_x, f] with a 16-byte
// aligned base; indptr int32 [n + 1]; src int32; w f32 per edge or null
// (unit weights). out is f32 [n, f]. Returns cudaGetLastError().
extern "C" int bliss_spmm_csr(const void* x, int dtype, int f,
                              const void* indptr, const void* src,
                              const void* w, int n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || f <= 0) return (int)cudaGetLastError();
  if (dtype == 1) {
    if (f % 8 == 0)
      launch<__nv_bfloat16, 8>(x, f, indptr, src, w, n, out, st);
    else
      launch<__nv_bfloat16, 1>(x, f, indptr, src, w, n, out, st);
  } else {
    if (f % 4 == 0)
      launch<float, 4>(x, f, indptr, src, w, n, out, st);
    else
      launch<float, 1>(x, f, indptr, src, w, n, out, st);
  }
  return (int)cudaGetLastError();
}
