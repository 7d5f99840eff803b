// K7: full-graph GATv2 attention over the CSC (dst-sorted) arrays. Per dst
// d and head h, with logits e = sum_O(leakyrelu(f[src] + f[d]) * attn[h]):
//     out[d, h, :] = sum over edges into d of softmax_d(e) * f[src, h, :]
// in f32; a dst with no in-edges gives 0 (denominator clamped to FLT_MIN).
//
// Replaces bliss_gnn_tpu/ops/gat_pallas.py banded_gat_attention and
// banded_gat_attention_packed (bodies _gat_kernel, _gat_kernel_packed).
// Like them it makes one sweep with an online softmax: a running max M, a
// running denominator and the weighted feature sum in M's frame, rescaled
// by 2^(M - M') when the max grows. The TPU carried that state per
// (window, band) tile of a padded layout and read dst operands through
// one-hot MXU contractions; here the state lives in registers and the
// kernel reads the CSC arrays as they are.
//
// Bound: every edge reads one src row of H * O features and does a few
// operations per feature; the compulsory bytes are far smaller. At (H, O)
// = (4, 256) the table (477 MB) is ten times the L2 and each head's logit
// needs all O columns, so the rows come from device memory; at (1, 41)
// the table fits in L2. With the rows in flight (below), both shapes were
// bound by instructions (the (4, 256) kernel ran as fast with every row
// in L2), so the arithmetic per feature is cut to the least:
//   - leakyrelu(z) = c1 z + c2 |z| (c1 = (1 + s) / 2, c2 = (1 - s) / 2),
//     and the dst's own term c1 sum(a f[d]) is the same for all of a dst's
//     edges, so it drops out of the softmax: per feature one add (z), two
//     fused multiply-adds (|z| is an operand modifier) and the weighted
//     sum's fma, plus the bf16 -> f32 conversion;
//   - logits in base 2 (log2 e folded into the attention weights), so each
//     exponential is one exp2;
//   - the running sum is rescaled only when some lane's max grew.
//
// Design: a block per dst (and per group of up to 8 heads), a warp per
// head and edge split. A head's O columns (padded by the caller to whole
// 16-byte vectors) are cut among g lanes (a power of two), nv vectors
// each (8 bf16 columns a vector); a warp holds 32 / g lane groups, each
// on its own edge: at (4, 256) 16 lanes of 2 vectors and 2 edges a step,
// at (1, 41) 4 lanes of up to 2 vectors and 8 edges a step, so a logit is
// a 4- or 2-step shuffle reduction. Each warp keeps a ring of 8 KB in
// shared memory, filled with cp.async 16 bytes at a time (the head's part
// of a src row), 4 to 16 steps ahead of the edges it reduces: row requests
// stay in flight while earlier edges are reduced, and the H warps of a dst
// ask for the same row at about the same time. A lane only reads the bytes
// it copied, so the ring needs no barrier. Where the heads leave room in
// the block's 8 warps, each head gets up to four (splits) that take turns
// on the row's 32-edge batches, so a hub row of 21,000 edges is shared by
// two warps per head at (4, 256) and four at (1, 41). At the end the
// groups' states merge by shuffles and the splits' through shared memory,
// always in the same order: M = max m_i, den = sum den_i 2^(m_i - M), acc
// likewise. No atomics: the same bits on every call.
//
// Partial outputs (optional, for combining the softmax over several CSC
// slices of one dst's edges, as the ring inference of
// parallel/edgeshard.py does): per (dst, head) the max M of the natural
// logits and the denominator sum exp(e - M) (-inf and 0 for a dst with no
// edges). The kernel's M is in base 2 and leaves out the dst's own term
// c1 sum(attn f[d]); the written max adds it back and converts, and the
// denominator is the same in either frame. Slices combine exactly as the
// splits' states do above.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRingBytes = 8192;  // per warp
constexpr int kMaxWarps = 8;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;  // elements per 16-byte vector
  __device__ static void cvt(const uint4& r, float* v) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (m, den, acc) <- the merge of itself and (m2, den2, acc2), base 2
template <int K>
__device__ __forceinline__ void merge(float& m, float& den, float* acc,
                                      float m2, float den2,
                                      const float* acc2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  const float a = exp2f(m - mx);  // 0 for an empty side
  const float b = exp2f(m2 - mx);
  den = den * a + den2 * b;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = acc[k] * a + acc2[k] * b;
  m = mx;
}

// G lanes per (edge, head), NV 16-byte vectors per lane: lane sub of a
// group holds vectors sub, sub + G, ... of the head's row, so each copy
// instruction reads G contiguous vectors. feat rows hold h * op elements.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_attention_kernel(const T* __restrict__ feat,
                     const float* __restrict__ attn, int32_t h, int32_t op,
                     int32_t o, float slope, int32_t hb, int32_t splits,
                     const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ src, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ den_out) {
  constexpr int V = Vec<T>::kN;
  constexpr int K = V * NV;               // columns per lane
  constexpr int P = 32 / G;               // edges per step
  constexpr int SPB = G;                  // steps per 32-edge batch
  constexpr int U = 4 / NV;               // steps per online-softmax fold
  constexpr int SLOT = 512 * NV;          // bytes per step and warp
  constexpr int R = kRingBytes / SLOT;    // ring depth in steps
  static_assert(R % U == 0 && R >= U, "ring holds whole folds");
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hw = warp % hb;
  const int split = warp / hb;
  const int head = blockIdx.y * hb + hw;
  const bool live = head < h;
  const int64_t d = blockIdx.x;
  const int grp = lane / G;
  const int sub = lane % G;
  const int64_t row = (int64_t)h * op;
  const int64_t hoff = (int64_t)(live ? head : 0) * op;
  unsigned char* ring = smem + (size_t)warp * kRingBytes;

  // logit (base 2, less the dst's own term) = sum ca (|z| + r f_src) when
  // c2 != 0; sum ca f_src when the slope is 1 (leakyrelu is then linear)
  const float c1 = 0.5f * (1.0f + slope);
  const float c2 = 0.5f * (1.0f - slope);
  const float cw = (c2 != 0.0f ? c2 : c1) * kLog2e;
  const float k_abs = c2 != 0.0f ? 1.0f : 0.0f;
  const float r = c2 != 0.0f ? c1 / c2 : 1.0f;

  bool act[NV];
  float fd[K], ca[K], acc[K];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * G + sub) * V;
    act[j] = live && col < op;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      fd[j * V + i] = 0.0f;
      ca[j * V + i] = 0.0f;
      acc[j * V + i] = 0.0f;
    }
    if (act[j]) {
      Vec<T>::cvt(__ldg(reinterpret_cast<const uint4*>(feat + d * row +
                                                        hoff + col)),
                  fd + j * V);
#pragma unroll
      for (int i = 0; i < V; ++i)
        ca[j * V + i] = cw * __ldg(attn + hoff + col + i);
    }
  }

  const int32_t deg = indptr[d + 1] - indptr[d];
  const int32_t* srcd = src + indptr[d];
  // this warp's edges: batches split, split + splits, ... of 32 edges; in
  // step t of a batch group grp takes edge t * P + grp of the batch
  int steps = 0;
  if (live && deg > 32 * split) {
    const int span = 32 * splits;
    const int nb = (deg - 32 * split + span - 1) / span;
    int last = deg - span * (nb - 1) - 32 * split;
    if (last > 32) last = 32;  // edges in the last batch
    steps = (nb - 1) * SPB + (last + P - 1) / P;
  }
  // offset in the dst's edges of step t's edge for this lane's group
  auto edge_of = [&](int t) -> int {
    return 32 * (splits * (t / SPB) + split) + (t % SPB) * P + grp;
  };

  int id_batch = -1;
  int32_t ids = 0;
  auto request = [&](int t) {
    if (t < steps && t / SPB != id_batch) {
      id_batch = t / SPB;
      const int eb = 32 * (splits * id_batch + split);
      ids = eb + lane < deg ? __ldg(srcd + eb + lane) : 0;
    }
    const int32_t s = __shfl_sync(kFull, ids, (t % SPB) * P + grp);
    const bool ok = t < steps && edge_of(t) < deg;
    const T* rowp = feat + (int64_t)s * row + hoff + sub * V;
    unsigned char* slot = ring + (t % R) * SLOT + lane * 16;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      cp_async16(slot + j * 512, ok && act[j] ? rowp + j * G * V : feat,
                 ok && act[j]);
    cp_commit();
  };

  // steps is warp-uniform, so every lane runs the same shuffles
#pragma unroll 1
  for (int t = 0; t < R; ++t) request(t);
  float m = -INFINITY;
  float den = 0.0f;
#pragma unroll 1
  for (int t = 0; t < steps; t += U) {
    cp_wait<R - U>();
    float fs[U][K];
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned char* slot = ring + ((t + u) % R) * SLOT + lane * 16;
      float pa = 0.0f, ps = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Vec<T>::cvt(*reinterpret_cast<const uint4*>(slot + j * 512),
                    fs[u] + j * V);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float f = fs[u][j * V + i];
          pa = fmaf(ca[j * V + i], fabsf(f + fd[j * V + i]), pa);
          ps = fmaf(ca[j * V + i], f, ps);
        }
      }
      p[u] = fmaf(k_abs, pa, r * ps);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        p[u] += __shfl_xor_sync(kFull, p[u], off);
      if (t + u >= steps || edge_of(t + u) >= deg) p[u] = -INFINITY;
      m_new = fmaxf(m_new, p[u]);
    }
    if (__any_sync(kFull, m_new > m)) {  // rare once the max has settled
      const float scale = m_new == -INFINITY ? 1.0f : exp2f(m - m_new);
      den *= scale;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] *= scale;
      m = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float wgt = p[u] == -INFINITY ? 0.0f : exp2f(p[u] - m);
      den += wgt;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(wgt, fs[u][k], acc[k]);
    }
#pragma unroll 1
    for (int u = 0; u < U; ++u) request(t + R + u);
  }
  cp_wait<0>();
  __syncwarp();  // every lane's copies have landed: the ring is free

  // the groups' states, merged by shuffles (group 0 ends with the sum)
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float den2 = __shfl_xor_sync(kFull, den, off);
    float acc2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc2[k] = __shfl_xor_sync(kFull, acc[k], off);
    merge<K>(m, den, acc, m2, den2, acc2);
  }

  // the splits' states, through the (drained) rings, in split order
  if (splits > 1) {
    float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int k = 0; k < K; ++k) mine[k * 32 + lane] = acc[k];
    if (lane == 0) {
      mine[K * 32] = m;
      mine[K * 32 + 1] = den;
    }
    __syncthreads();
    if (split != 0) return;
    for (int s = 1; s < splits; ++s) {
      const float* other = reinterpret_cast<const float*>(
          smem + (size_t)(warp + s * hb) * kRingBytes);
      float acc2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc2[k] = other[k * 32 + lane];
      merge<K>(m, den, acc, other[K * 32], other[K * 32 + 1], acc2);
    }
  }
  if (m_out != nullptr) {
    // the dst's own logit term, sum over the head's columns of ca * fd,
    // reduced over the G lanes of a group (all groups hold the same)
    float own = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) own = fmaf(ca[k], fd[k], own);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      own += __shfl_xor_sync(kFull, own, off);
    if (live && lane == 0) {
      // own is cw sum(attn fd); the base-2 logit adds c1 log2e sum(attn fd)
      const float m2 = m + own * (c1 * kLog2e / cw);
      m_out[d * h + head] = m == -INFINITY ? -INFINITY : m2 / kLog2e;
      den_out[d * h + head] = den;
    }
  }
  if (!live || grp != 0) return;
  const float inv = 1.0f / fmaxf(den, FLT_MIN);
  float* dst = out + (d * h + head) * (int64_t)o;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * G + sub) * V;
    if (!act[j] || col >= o) continue;
    if (o % 4 == 0 && col + V <= o) {  // whole 16-byte aligned vectors
#pragma unroll
      for (int i = 0; i < V; i += 4)
        __stcs(reinterpret_cast<float4*>(dst + col + i),
               make_float4(acc[j * V + i] * inv, acc[j * V + i + 1] * inv,
                           acc[j * V + i + 2] * inv,
                           acc[j * V + i + 3] * inv));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < o) dst[col + i] = acc[j * V + i] * inv;
    }
  }
}

template <typename T, int G, int NV>
int launch(const void* feat, const void* attn, int h, int op, int o,
           float slope, int splits, const void* indptr, const void* src,
           long long n, void* out, void* m_out, void* den_out,
           cudaStream_t st) {
  const int hb = h < kMaxWarps ? h : kMaxWarps;
  if (splits < 1 || hb * splits > kMaxWarps) return (int)cudaErrorInvalidValue;
  const int warps = hb * splits;
  auto kern = gat_attention_kernel<T, G, NV>;
  // the attribute is per device: set it on each card's first launch
  // (before any CUDA-graph capture of that card's calls)
  static bool opted_in[kMaxDevices] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return (int)err;
  if (card < 0 || card >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[card]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxWarps * kRingBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[card] = true;
  }
  const dim3 grid((unsigned)n, (unsigned)((h + hb - 1) / hb));
  kern<<<grid, warps * 32, (size_t)warps * kRingBytes, st>>>(
      static_cast<const T*>(feat), static_cast<const float*>(attn),
      (int32_t)h, (int32_t)op, (int32_t)o, slope, (int32_t)hb,
      (int32_t)splits, static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(src), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(den_out));
  return (int)cudaGetLastError();
}

// the lane layout for a head row of `vecs` 16-byte vectors: one vector a
// lane for a single vector, four past 64, else two
template <typename T>
int launch_width(const void* feat, const void* attn, int h, int op, int o,
                 float slope, int splits, const void* indptr,
                 const void* src, long long n, void* out, void* m_out,
                 void* den_out, cudaStream_t st) {
  constexpr int V = Vec<T>::kN;
  const int vecs = op / V;
#define BLISS_GAT(G, NV)                                                    \
  return launch<T, G, NV>(feat, attn, h, op, o, slope, splits, indptr, src, \
                          n, out, m_out, den_out, st)
  if (vecs <= 1) BLISS_GAT(1, 1);
  if (vecs <= 2) BLISS_GAT(1, 2);
  if (vecs <= 4) BLISS_GAT(2, 2);
  if (vecs <= 8) BLISS_GAT(4, 2);
  if (vecs <= 16) BLISS_GAT(8, 2);
  if (vecs <= 32) BLISS_GAT(16, 2);
  if (vecs <= 64) BLISS_GAT(32, 2);
  BLISS_GAT(32, 4);
#undef BLISS_GAT
}

}  // namespace

// dtype 0: feat is f32; dtype 1: feat is bf16. feat [n, h, op] with a
// 16-byte aligned base, op a multiple of the 16-byte vector (4 f32, 8
// bf16) and at most 128 vectors, columns o..op-1 zero; attn f32 [h, op],
// zero past o; indptr int32 [n + 1]; src int32. out is f32 [n, h, o].
// splits: warps per head that share a dst's edges (heads per block times
// splits at most 8). m_out and den_out, f32 [n, h], are both null or both
// set (the partial outputs, see the note at the top). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside those
// limits.
extern "C" int bliss_gat_attention(const void* feat, int dtype, int h, int op,
                                   int o, const void* attn, float slope,
                                   int splits, const void* indptr,
                                   const void* src, long long n, void* out,
                                   void* m_out, void* den_out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || h <= 0 || o <= 0 || o > op ||
      op % vec != 0 || op > 128 * vec || (m_out == nullptr) != (den_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(feat, attn, h, op, o, slope, splits,
                                       indptr, src, n, out, m_out, den_out,
                                       st);
  return launch_width<float>(feat, attn, h, op, o, slope, splits, indptr,
                             src, n, out, m_out, den_out, st);
}
