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
// CSC arrays as they are: no layout build.
//
// Bound: the compulsory bytes (x read once, the CSC arrays, the f32
// output) and the adds (E * F) are both small; what the kernel really
// moves is one x row per edge (E * F * 2 bytes for bf16, 59 GB at Reddit
// scale and F = 256). At F = 256 the table (119 MB) is more than twice the
// 50 MB L2, so most of those rows would come from device memory.
//
// Design: column slices. The caller cuts the columns into slices whose
// part of x fits in L2 (64 bf16 columns, 29.8 MB at Reddit scale) and
// launches this entry once per slice on one stream, so the slices run one
// after the other and each slice's rows are served from L2 after their
// first read. Inside a slice a block of four warps takes
// one dst row; the warps take 32-edge batches of the row in turn, read a
// batch's src ids (and weights) coalesced and broadcast them by shuffle.
// A slice row is g 16-byte vectors (g <= 32); a warp holds 32 / g lane
// groups and each group reads its own edge's slice row, so one warp load
// instruction folds 32 / g edges (4 at 64 bf16 columns, 5 at 48), and
// eight such loads are in flight per lane. The groups' and warps' partial
// sums meet in shared memory once per row, in a fixed order, and each
// output column is written once: no atomics, the same bits on every call.
// The caller pads rows whose width is not a whole number of 16-byte
// vectors (F = 41 -> 48 bf16 columns), so every load is a full vector.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 8;  // row loads in flight per lane
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;  // elements per 16-byte vector
  __device__ static void cvt(const uint4& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void cvt(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

// One column slice [c0, c0 + g * V) of every dst row; x rows are ld
// elements apart (ld and c0 multiples of V), out is [n, f].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmm_slice_kernel(const T* __restrict__ x, int64_t ld, int32_t c0, int32_t g,
                  int32_t f, const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ src,
                  const float* __restrict__ w, float* __restrict__ out) {
  constexpr int V = Vec<T>::kN;
  __shared__ float part[kWarps][32 * V];
  const int64_t row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = 32 / g;         // edges per warp load instruction
  const int grp = lane / g;     // == p on the idle lanes past p * g
  const int sub = lane - grp * g;
  const bool on = grp < p;
  const int64_t e0 = indptr[row];
  const int64_t e1 = indptr[row + 1];
  const T* xs = x + c0 + sub * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int64_t b = e0 + 32 * warp; b < e1; b += 32 * kWarps) {
    const int64_t e = b + lane;
    int32_t s_l = 0;
    float w_l = 1.0f;
    if (e < e1) {
      s_l = __ldcs(src + e);
      if (w != nullptr) w_l = __ldcs(w + e);
    }
    const int cnt = (int)(e1 - b < 32 ? e1 - b : 32);
    for (int j = 0; j < cnt; j += p * kUnroll) {
      uint4 raw[kUnroll];
      float wj[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * p + grp;
        const bool ok = on && jj < cnt;
        const int32_t s = __shfl_sync(kFull, s_l, jj & 31);
        const float wv = __shfl_sync(kFull, w_l, jj & 31);
        wj[u] = ok ? wv : 0.0f;
        raw[u] = ok ? __ldg(reinterpret_cast<const uint4*>(xs + (int64_t)s * ld))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[V];
        Vec<T>::cvt(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wj[u], v[i], acc[i]);
      }
    }
  }
  // lane (group q, sub s) holds columns s * V .. s * V + V - 1 of the
  // slice, at lane * V = q * g * V + s * V
#pragma unroll
  for (int i = 0; i < V; ++i) part[warp][lane * V + i] = acc[i];
  __syncthreads();
  const int width = g * V;
  for (int t = threadIdx.x; t < width; t += blockDim.x) {
    if (c0 + t >= f) continue;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      for (int q = 0; q < p; ++q) sum += part[k][q * width + t];
    __stcs(out + row * f + c0 + t, sum);
  }
}

template <typename T>
int launch_slice(const void* x, int f, long long ld, int c0, int cols,
                 const void* indptr, const void* src, const void* w, int n,
                 void* out, cudaStream_t st) {
  constexpr int V = Vec<T>::kN;
  if (ld % V != 0 || c0 % V != 0 || c0 < 0 || cols <= 0 || cols > 32 * V ||
      c0 + cols > f || ld < (long long)((f + V - 1) / V) * V)
    return (int)cudaErrorInvalidValue;
  const int g = (cols + V - 1) / V;  // vectors per slice row
  spmm_slice_kernel<T><<<(unsigned)n, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), (int64_t)ld, (int32_t)c0, (int32_t)g,
      (int32_t)f, static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(src), static_cast<const float*>(w),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: x is f32; dtype 1: x is bf16. x holds rows of ld elements (a
// multiple of the 16-byte vector: 4 f32, 8 bf16; at least f rounded up to
// it; columns past f are read but not used) from a 16-byte aligned base;
// indptr int32 [n + 1]; src int32; w f32 per edge or null (unit weights).
// out is f32 [n, f]. One launch: columns [c0, c0 + cols) of out, c0 a
// multiple of the vector, cols at most 32 vectors. The caller launches the
// slices one after the other on one stream. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside those limits.
extern "C" int bliss_spmm_csr(const void* x, int dtype, int f, long long ld,
                              int c0, int cols, const void* indptr,
                              const void* src, const void* w, int n,
                              void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || f <= 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return launch_slice<__nv_bfloat16>(x, f, ld, c0, cols, indptr, src, w, n,
                                       out, st);
  return launch_slice<float>(x, f, ld, c0, cols, indptr, src, w, n, out, st);
}
