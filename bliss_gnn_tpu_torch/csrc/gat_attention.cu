// K7: full-graph GATv2 attention over the CSC (dst-sorted) arrays. Per dst
// d and head h, with logits e = sum_O(leakyrelu(f[src] + f[d]) * attn[h]):
//     out[d, h, :] = sum over edges into d of softmax_d(e) * f[src, h, :]
// in f32; a dst with no in-edges gives 0 (denominator clamped to FLT_MIN).
//
// Replaces bliss_gnn_tpu/ops/gat_pallas.py banded_gat_attention and
// banded_gat_attention_packed (bodies _gat_kernel, _gat_kernel_packed).
// Like them it makes one sweep with an online softmax: a running max M, a
// running denominator and the weighted feature sum in M's frame, rescaled
// by exp(M - M') when the max grows. The TPU carried that state per
// (window, band) tile of a padded layout and read dst operands through
// one-hot MXU contractions; here each (dst, head) owns its state in
// registers and reads the CSC arrays as they are.
//
// Bound: operations per edge and head, about 7 * O f32 operations (add,
// leaky ReLU, the attn product and its sum, then rescale and accumulate)
// plus two exponentials; the compulsory bytes (features once, CSC arrays,
// output) are far smaller, but each edge reads one src row of H * O
// features, mostly from L2 and device memory. Design: one warp per
// (dst, head), so the O-wide logit is a warp reduction and no state is
// shared. The dst features and attn stay in registers; each lane owns 8
// bf16 (or 4 f32) contiguous columns per 16-byte load, or one column per
// 32-column chunk when O is not a multiple of the vector (O = 41). Src ids
// are read 32 at a time, coalesced, and broadcast by shuffle; edges fold
// in groups of four, whose row loads and reductions are independent, so
// one max update and one rescale serve four edges.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;  // edges folded per online-softmax update

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// NCH column chunks of 32 * VEC per warp: O <= 32 * VEC * NCH
template <typename T, int VEC, int NCH>
__global__ void gat_attention_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ attn,
                                     int32_t h, int32_t o, float slope,
                                     const int32_t* __restrict__ indptr,
                                     const int32_t* __restrict__ src,
                                     int64_t n, float* __restrict__ out) {
  constexpr int K = VEC * NCH;
  const int lane = threadIdx.x & 31;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (item >= n * h) return;  // uniform across the warp
  const int64_t d = item / h;
  const int32_t hd = (int32_t)(item % h);
  const int64_t row = (int64_t)h * o;  // features per node
  const int64_t off = (int64_t)hd * o;

  bool act[NCH];
  float fd[K], at[K], acc[K];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int32_t col = c * 32 * VEC + lane * VEC;
    act[c] = col < o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      fd[c * VEC + i] = 0.0f;
      at[c * VEC + i] = 0.0f;
      acc[c * VEC + i] = 0.0f;
    }
    if (act[c]) {
      load_vec<VEC>(feat + d * row + off + col, fd + c * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) at[c * VEC + i] = attn[off + col + i];
    }
  }

  float m = -INFINITY;
  float den = 0.0f;
  const int64_t e0 = indptr[d];
  const int64_t e1 = indptr[d + 1];
  for (int64_t b = e0; b < e1; b += 32) {
    const int32_t s_l = b + lane < e1 ? src[b + lane] : 0;
    const int cnt = (int)(e1 - b < 32 ? e1 - b : 32);
    for (int j = 0; j < cnt; j += kGroup) {
      float fs[kGroup][K];
      float p[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool ok = j + u < cnt;
        const int32_t s = __shfl_sync(kFull, s_l, ok ? j + u : 0);
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) fs[u][c * VEC + i] = 0.0f;
          if (ok && act[c]) {
            load_vec<VEC>(feat + (int64_t)s * row + off + c * 32 * VEC +
                              lane * VEC,
                          fs[u] + c * VEC);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float z = fs[u][c * VEC + i] + fd[c * VEC + i];
              part = fmaf(z >= 0.0f ? z : slope * z, at[c * VEC + i], part);
            }
          }
        }
        p[u] = part;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) p[u] = warp_sum(p[u]);
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (j + u < cnt) m_new = fmaxf(m_new, p[u]);
      const float scale = expf(m - m_new);  // 0 while m is -inf
      den *= scale;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] *= scale;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (j + u < cnt) {
          const float wgt = expf(p[u] - m_new);
          den += wgt;
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k] = fmaf(wgt, fs[u][k], acc[k]);
        }
      }
      m = m_new;
    }
  }
  const float inv = 1.0f / fmaxf(den, FLT_MIN);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (!act[c]) continue;
    float* dst = out + d * row + off + c * 32 * VEC + lane * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = acc[c * VEC + i] * inv;
  }
}

template <typename T, int VEC, int NCH>
void launch(const void* feat, const void* attn, int h, int o, float slope,
            const void* indptr, const void* src, long long n, void* out,
            cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (n * h * 32 + threads - 1) / threads;
  gat_attention_kernel<T, VEC, NCH><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const T*>(feat), static_cast<const float*>(attn),
      (int32_t)h, (int32_t)o, slope, static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(src), (int64_t)n, static_cast<float*>(out));
}

template <typename T, int VEC>
int launch_chunks(const void* feat, const void* attn, int h, int o,
                  float slope, const void* indptr, const void* src,
                  long long n, void* out, cudaStream_t st) {
  const int nch = (o + 32 * VEC - 1) / (32 * VEC);
  if (nch == 1)
    launch<T, VEC, 1>(feat, attn, h, o, slope, indptr, src, n, out, st);
  else if (nch == 2)
    launch<T, VEC, 2>(feat, attn, h, o, slope, indptr, src, n, out, st);
  else if (nch <= 4)
    launch<T, VEC, 4>(feat, attn, h, o, slope, indptr, src, n, out, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: feat is f32; dtype 1: feat is bf16. feat [n, h, o] with a
// 16-byte aligned base; attn f32 [h, o]; indptr int32 [n + 1]; src int32.
// out is f32 [n, h, o]. O may be at most 128 when it is not a multiple of
// the vector width (8 bf16, 4 f32), else 32 * 4 * that width. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an O past that limit.
extern "C" int bliss_gat_attention(const void* feat, int dtype, int h, int o,
                                   const void* attn, float slope,
                                   const void* indptr, const void* src,
                                   long long n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || h <= 0 || o <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return o % 8 == 0
               ? launch_chunks<__nv_bfloat16, 8>(feat, attn, h, o, slope,
                                                 indptr, src, n, out, st)
               : launch_chunks<__nv_bfloat16, 1>(feat, attn, h, o, slope,
                                                 indptr, src, n, out, st);
  return o % 4 == 0 ? launch_chunks<float, 4>(feat, attn, h, o, slope, indptr,
                                              src, n, out, st)
                    : launch_chunks<float, 1>(feat, attn, h, o, slope, indptr,
                                              src, n, out, st);
}
