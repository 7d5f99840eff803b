// K7: full-graph GATv2 attention over the CSC (dst-sorted) arrays. Per dst
// d and head h, with logits e = sum_O(leakyrelu(f[src] + f[d]) * attn[h]):
//     out[d, h, :] = sum over edges into d of softmax_d(e) * f[src, h, :]
// in f32; a dst with no in-edges gives 0 (denominator clamped to FLT_MIN).
//
// Replaces bliss_gnn_tpu/ops/gat_pallas.py banded_gat_attention and
// banded_gat_attention_packed (bodies _gat_kernel, _gat_kernel_packed).
// Like them it folds each dst's edges into an online softmax: a running
// max M, a running denominator and the weighted feature sum in M's frame,
// rescaled by 2^(M - M') when the max grows. The TPU carried that state per
// (window, band) tile of a padded layout and read dst operands through
// one-hot MXU contractions; here the state lives in registers while a
// warp walks a dst's edges of one src range.
//
// Bound: every edge reads the head's part of one src row (O features) and
// does a few operations per feature; the compulsory bytes are far smaller.
// At (H, O) = (4, 256) bf16 the table (477 MB) is ten times the 50 MB L2,
// so a walk over all of a dst's edges reads its src rows from device
// memory: 235 GB a call, 70 ms at 3.35 TB/s; a block per dst with all its
// heads ran at 97 % of that (72 ms), and at 57.9 ms with every row in L2.
// Walking one (head, src range) at a time to keep the rows in L2 did not
// pay as a block per (dst, head) and range: each block's start (offsets,
// ids, then rows: dependent loads) and end (drain, merge) made it 75 ms in
// one range and 5 ms more for each range added (H100 measurements of
// earlier designs of this kernel). So:
//   - a warp streams a chunk: the dsts of a range are cut into chunks of
//     about CHUNK_EDGES edges (16,384; a small kernel finds the cuts), and
//     a warp walks its chunk's edges through its ring without a break at
//     a dst's end: the ring is never drained and refilled per dst. Ids and
//     offsets come in batches of 32 a warp; a dst's own row rides in the
//     ring with its first step (fd slots). A block is one warp: a warp
//     that ends early frees its slot, where eight warps a block waited for
//     the block's longest chunk (97 against 78 ms at (4, 256)).
//   - src ranges: the srcs are cut into R contiguous ranges whose head
//     slices (span rows of O features of one head) stay under a budget (the
//     wrapper's range_count: R = 2 at (4, 256) bf16, 1 at (1, 41)), and the
//     wrapper's plan lists each dst's edges range by range: the edges of
//     dst d from range r are ids[ptr[r n + d] .. ptr[r n + d + 1]), src = r
//     * span + id (ops/gat_attention.py range_plan; 16-bit ids where a
//     range holds at most 2^16 srcs). A caller with no plan passes its CSC
//     as the one range (R = 1). One pass a range, its blocks over (chunk,
//     head), head-major; each pass writes the range's partial state (max,
//     denominator, unnormalised sum) and a combine kernel merges the ranges
//     in order. With one range the pass writes the result itself.
//   - leakyrelu(z) = c1 z + c2 |z| (c1 = (1 + s) / 2, c2 = (1 - s) / 2),
//     and the dst's own term c1 sum(a f[d]) is the same for all of a dst's
//     edges, so it drops out of the softmax: per feature one add (z), two
//     fused multiply-adds (|z| is an operand modifier) and the weighted
//     sum's fma, plus the bf16 -> f32 conversion. The src's own term is
//     summed in the edge loop: a table of it per (src, head), copied into
//     the ring beside each row, saved one fma a feature and cost more (a
//     fourth copy a step): 70.97 against 68.66 ms at (4, 256).
//   - logits in base 2 (log2 e folded into the attention weights), so each
//     exponential is one exp2; the running sum is rescaled only when some
//     lane's max grew.
//
// Design of a pass: a block per chunk, one warp. A head's O columns
// (padded by the caller to whole 16-byte vectors) are cut among g lanes (a
// power of two), nv vectors each (8 bf16 columns a vector); a warp holds
// 32 / g lane groups, each on its own edge of the same dst: at (4, 256) 16
// lanes of 2 vectors and 2 edges a step, at (1, 41) 4 lanes of up to 2
// vectors and 8 edges a step, so a logit is a 4- or 2-step shuffle
// reduction. A dst takes whole folds of steps (the last masked past its
// edges). Each warp keeps a ring of 8 KB in shared memory, filled with
// cp.async 16 bytes at a time (the head's part of a src row), 4 to 16 steps
// ahead of the edges it reduces. A lane only reads the bytes it copied, so
// the ring needs no barrier. At a dst's end the groups' states merge by
// shuffles, always in the same order: M = max m_i, den = sum den_i 2^(m_i -
// M), acc likewise; the combine merges the ranges in range order. No
// atomics: the same bits on every call.
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
constexpr int kRingBytes = 8192;  // per warp: the rows of the ring's steps
constexpr int kWarps = 1;  // warps a block, each on a chunk of its own
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

// The logit's weights for a negative slope s: ca = cw * attn per column,
// k_abs the weight of sum ca |z|, r that of sum ca f_src.
struct Coef {
  float c1, cw, k_abs, r;
  __device__ explicit Coef(float slope) {
    c1 = 0.5f * (1.0f + slope);
    const float c2 = 0.5f * (1.0f - slope);
    // logit (base 2, less the dst's own term) = sum ca (|z| + r f_src)
    // when c2 != 0; sum ca f_src when the slope is 1 (leakyrelu is linear)
    cw = (c2 != 0.0f ? c2 : c1) * kLog2e;
    k_abs = c2 != 0.0f ? 1.0f : 0.0f;
    r = c2 != 0.0f ? c1 / c2 : 1.0f;
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

__device__ __forceinline__ int32_t load_id(const int32_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ int32_t load_id(const uint16_t* p) {
  return (int32_t)__ldcs(reinterpret_cast<const unsigned short*>(p));
}

// The chunks of one pass: chunk c of range r holds the dsts [starts[r][c],
// starts[r][c + 1]), cut where the range's edge offsets (ptr + r n, n + 1
// of them) pass c / chunks of its edges, so chunks carry about as many
// edges each (a dst with more spans several cuts and leaves chunks empty).
__global__ void gat_attention_kernel_chunks(const int32_t* __restrict__ ptr,
                                            int64_t n, int32_t ranges,
                                            int32_t chunks,
                                            int32_t* __restrict__ starts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ranges * (chunks + 1)) return;
  const int64_t r = i / (chunks + 1);
  const int64_t c = i % (chunks + 1);
  if (c == chunks) {
    starts[i] = (int32_t)n;
    return;
  }
  const int32_t* p = ptr + r * n;
  const int64_t lo = p[0];
  const int64_t target = lo + ((int64_t)p[n] - lo) * c / chunks;
  int64_t a = 0, b = n;  // the first d with p[d] >= target
  while (a < b) {
    const int64_t mid = (a + b) / 2;
    if (p[mid] < target)
      a = mid + 1;
    else
      b = mid;
  }
  starts[i] = (int32_t)a;
}

// One pass: the edges of one src range (ptr: its [n + 1] offsets into ids;
// src = base + id) for one head, a warp a chunk of dsts. The warp streams
// the chunk's steps through its ring without a break at a dst's end: a dst
// takes ceil(deg / P) steps of P edges (a lane group an edge), rounded up to
// whole folds of U steps, and the dst's own row rides in the ring with its
// first step. At a dst's end the groups' states merge and group 0 writes
// them: with `single` (one range) the normalised row, and the partial max
// (natural frame) and denominator where m_out is set; else the range's
// partial state, the unnormalised sum, the base-2 max and the denominator.
// G lanes per (edge, head), NV 16-byte vectors per lane: lane sub of a
// group holds vectors sub, sub + G, ... of the head's row, so each copy
// instruction reads G contiguous vectors. feat rows hold h * op elements.
template <typename T, typename I, int G, int NV>
struct Pass {
  static constexpr int V = Vec<T>::kN;
  static constexpr int K = V * NV;              // columns per lane
  static constexpr int P = 32 / G;              // edges per step
  static constexpr int U = 4 / NV;              // steps per online-softmax fold
  static constexpr int SLOT = 512 * NV;         // bytes per step and warp
  static constexpr int RING = kRingBytes / SLOT;  // ring depth in steps
  static constexpr int FDS = RING / U;  // dst rows in flight at most
  static constexpr int WARP_BYTES = kRingBytes + FDS * SLOT;
  static_assert(RING % U == 0 && RING >= U, "ring holds whole folds");
};

// 16 warps an SM (128 registers a thread), 8 where four vectors a lane
// fill the shared memory
template <typename T, typename I, int G, int NV>
__global__ void __launch_bounds__(kWarps * 32, (NV == 4 ? 8 : 16) / kWarps)
gat_attention_kernel(const T* __restrict__ feat,
                     const float* __restrict__ attn, int32_t h, int32_t op,
                     int32_t o, float slope, const int32_t* __restrict__ ptr,
                     const I* __restrict__ ids, int32_t base,
                     const int32_t* __restrict__ starts, int32_t chunks,
                     int32_t single, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ den_out) {
  using S = Pass<T, I, G, NV>;
  constexpr int V = S::V, K = S::K, P = S::P, U = S::U, SLOT = S::SLOT;
  constexpr int RING = S::RING, FDS = S::FDS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= chunks) return;
  const int32_t d_beg = starts[chunk];
  const int32_t d_end = starts[chunk + 1];
  if (d_beg >= d_end) return;  // warp-uniform from here on
  const int head = blockIdx.y;
  const int grp = lane / G;
  const int sub = lane % G;
  const int64_t row = (int64_t)h * op;
  const int64_t hoff = (int64_t)head * op;
  unsigned char* ring = smem + (size_t)warp * S::WARP_BYTES;
  unsigned char* fds = ring + kRingBytes;
  const Coef c(slope);
  const int32_t e_end = ptr[d_end];  // past the chunk's last edge

  bool act[NV];
  float ca[K];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * G + sub) * V;
    act[j] = col < op;
#pragma unroll
    for (int i = 0; i < V; ++i)
      ca[j * V + i] = act[j] ? c.cw * __ldg(attn + hoff + col + i) : 0.0f;
  }

  // a dst's edge offset and in-degree, from a batch of 32 offsets a lane
  // holds (lane l: ptr[pb + l]), loaded again every 31 dsts
  auto dst_span = [&](int32_t d, int32_t& pb, int32_t& pv, int32_t& b,
                      int32_t& deg) {
    if (d - pb > 30) {
      pb = d;
      pv = ptr[min(pb + lane, d_end)];
    }
    b = __shfl_sync(kFull, pv, d - pb);
    deg = __shfl_sync(kFull, pv, d - pb + 1) - b;
  };
  auto steps_of = [&](int32_t deg) {
    return (deg + P * U - 1) / (P * U) * U;
  };

  // the request cursor: step rk of rn of dst rd (edges rbase..+rdeg), its
  // row in fd slot rf; ids from a batch of 32 (lane l: the id of edge ib + l)
  int32_t rd = d_beg - 1, rbase = 0, rdeg = 0, rk = 0, rn = 0;
  int32_t rpb = -64, rpv = 0, ib = -64, iv = 0;  // no batch yet
  int rf = -1, rt = 0;
  auto rq_next = [&]() {  // the chunk's next dst with edges
    do {
      if (++rd >= d_end) return;
      dst_span(rd, rpb, rpv, rbase, rdeg);
    } while (rdeg == 0);
    rk = 0;
    rn = steps_of(rdeg);
    rf = (rf + 1) % FDS;
  };
  auto request = [&]() {
    if (rd < d_end) {
      const int32_t e0 = rbase + rk * P;  // the step's first edge
      // a fold's padding past the dst's last edge reads no id: the batch
      // stays on the edges of the steps that have some
      if (rk * P < rdeg && e0 + P > ib + 32) {
        ib = e0;
        iv = ib + lane < e_end ? base + load_id(ids + ib + lane) : 0;
      }
      const int32_t s = __shfl_sync(kFull, iv, e0 - ib + grp);
      const bool ok = rk * P + grp < rdeg;
      const T* rowp = feat + (int64_t)s * row + hoff + sub * V;
      unsigned char* slot = ring + (rt % RING) * SLOT + lane * 16;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        cp_async16(slot + j * 512, ok && act[j] ? rowp + j * G * V : feat,
                   ok && act[j]);
      if (rk == 0) {  // the dst's own row, for every group
        const T* own = feat + (int64_t)rd * row + hoff + sub * V;
        unsigned char* fslot = fds + rf * SLOT + lane * 16;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          cp_async16(fslot + j * 512, act[j] ? own + j * G * V : feat,
                     act[j]);
      }
      if (++rk == rn) rq_next();
    }
    cp_commit();
    ++rt;
  };

  float fd[K], acc[K];
  float m = -INFINITY;
  float den = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fd[k] = 0.0f;
    acc[k] = 0.0f;
  }

  // a dst's result from the merged state, group 0's lanes
  auto write = [&](int32_t d) {
    float own = 0.0f;
    if (single && m_out != nullptr) {
      // the dst's own logit term, sum over the head's columns of ca * fd,
      // reduced over the G lanes of a group
#pragma unroll
      for (int k = 0; k < K; ++k) own = fmaf(ca[k], fd[k], own);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        own += __shfl_xor_sync(kFull, own, off);
    }
    if (grp != 0) return;
    const int64_t hd = (int64_t)d * h + head;
    float scale = 1.0f;  // a range's partial sum stays unnormalised
    if (single) {
      scale = 1.0f / fmaxf(den, FLT_MIN);
      if (m_out != nullptr && lane == 0) {
        // own is cw sum(attn fd); the base-2 logit adds c1 log2e sum(attn
        // fd)
        const float m2 = m + own * (c.c1 * kLog2e / c.cw);
        m_out[hd] = m == -INFINITY ? -INFINITY : m2 / kLog2e;
        den_out[hd] = den;
      }
    } else if (lane == 0) {
      m_out[hd] = m;
      den_out[hd] = den;
    }
    float* dst = out + hd * (int64_t)o;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (j * G + sub) * V;
      if (!act[j] || col >= o) continue;
      if (o % 4 == 0 && col + V <= o) {  // whole 16-byte aligned vectors
#pragma unroll
        for (int i = 0; i < V; i += 4)
          __stcs(reinterpret_cast<float4*>(dst + col + i),
                 make_float4(acc[j * V + i] * scale,
                             acc[j * V + i + 1] * scale,
                             acc[j * V + i + 2] * scale,
                             acc[j * V + i + 3] * scale));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (col + i < o) dst[col + i] = acc[j * V + i] * scale;
      }
    }
  };

  // the compute cursor: step ck of cn of dst cd (cdeg edges), its row in
  // fd slot cf; the dsts with no edges before it get the empty result
  // (one range; a range's pass leaves them to the combine)
  int32_t cd = d_beg - 1, cdeg = 0, ck = 0, cn = 0;
  int32_t cpb = -64, cpv = 0;
  int cf = -1, ct = 0;
  auto cp_next = [&]() {
    for (;;) {
      if (++cd >= d_end) return;
      int32_t b;
      dst_span(cd, cpb, cpv, b, cdeg);
      if (cdeg > 0) break;
      if (single) write(cd);  // m = -inf, den = 0, acc = 0
    }
    ck = 0;
    cn = steps_of(cdeg);
    cf = (cf + 1) % FDS;
  };

  rq_next();
#pragma unroll 1
  for (int i = 0; i < RING; ++i) request();
  cp_next();
  // cd, ck and cn are warp-uniform, so every lane runs the same shuffles
#pragma unroll 1
  for (; cd < d_end;) {
    cp_wait<RING - U>();
    if (ck == 0) {  // the dst's own row landed with its first step
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Vec<T>::cvt(*reinterpret_cast<const uint4*>(fds + cf * SLOT +
                                                    lane * 16 + j * 512),
                    fd + j * V);
    }
    float fs[U][K];
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned char* slot =
          ring + ((ct + u) % RING) * SLOT + lane * 16;
      float pa = 0.0f, ps = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Vec<T>::cvt(*reinterpret_cast<const uint4*>(slot + j * 512),
                    fs[u] + j * V);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          pa = fmaf(ca[j * V + i], fabsf(fs[u][j * V + i] + fd[j * V + i]),
                    pa);
          ps = fmaf(ca[j * V + i], fs[u][j * V + i], ps);
        }
      }
      p[u] = fmaf(c.k_abs, pa, c.r * ps);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        p[u] += __shfl_xor_sync(kFull, p[u], off);
      if ((ck + u) * P + grp >= cdeg) p[u] = -INFINITY;
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
    for (int u = 0; u < U; ++u) request();
    ct += U;
    ck += U;
    if (ck == cn) {  // the dst's last fold
      // the groups' states, merged by shuffles (group 0 ends with the sum)
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
        const float m2 = __shfl_xor_sync(kFull, m, off);
        const float den2 = __shfl_xor_sync(kFull, den, off);
        float acc2[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc2[k] = __shfl_xor_sync(kFull, acc[k], off);
        merge<K>(m, den, acc, m2, den2, acc2);
      }
      write(cd);
      m = -INFINITY;
      den = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
      cp_next();
    }
  }
  cp_wait<0>();
}

// The ranges' partial states merged in range order, a warp per (dst,
// head): out the normalised row; m_out (natural frame) and den_out where
// set. A range without edges into the dst is skipped.
template <typename T>
__global__ void __launch_bounds__(256)
gat_attention_kernel_combine(const T* __restrict__ feat,
                             const float* __restrict__ attn, float slope,
                             int32_t h, int32_t op, int32_t o, int64_t n,
                             int32_t ranges, const int32_t* __restrict__ ptr,
                             const float* __restrict__ pm,
                             const float* __restrict__ pden,
                             const float* __restrict__ pacc,
                             float* __restrict__ out,
                             float* __restrict__ m_out,
                             float* __restrict__ den_out) {
  const int64_t w = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (w >= n * h) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int64_t d = w / h;
  const int64_t nh = n * h;
  auto has = [&](int r) {
    return ptr[(int64_t)r * n + d + 1] > ptr[(int64_t)r * n + d];
  };
  float mx = -INFINITY;
  for (int r = 0; r < ranges; ++r)
    if (has(r)) mx = fmaxf(mx, pm[r * nh + w]);
  float den = 0.0f;
  for (int r = 0; r < ranges; ++r)
    if (has(r)) den += pden[r * nh + w] * exp2f(pm[r * nh + w] - mx);
  const float inv = 1.0f / fmaxf(den, FLT_MIN);
  for (int col = lane; col < o; col += 32) {
    float a = 0.0f;
    for (int r = 0; r < ranges; ++r)
      if (has(r))
        a = fmaf(__ldcs(pacc + (r * nh + w) * o + col),
                 exp2f(pm[r * nh + w] - mx), a);
    __stcs(out + w * o + col, a * inv);
  }
  if (m_out == nullptr) return;
  const Coef c(slope);
  const T* f = feat + w * op;
  const float* a = attn + (w % h) * op;
  float own = 0.0f;  // cw sum(attn fd), as the passes' own term
  for (int col = lane; col < o; col += 32)
    own = fmaf(c.cw * a[col], static_cast<float>(f[col]), own);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    own += __shfl_xor_sync(kFull, own, off);
  if (lane == 0) {
    m_out[w] = mx == -INFINITY
                   ? -INFINITY
                   : (mx + own * (c.c1 * kLog2e / c.cw)) / kLog2e;
    den_out[w] = den;
  }
}

struct Args {
  const void* feat;
  const float* attn;
  float slope;
  int h, op, o;
  const int32_t* ptr;
  const void* ids;
  int ranges, span, chunks;
  long long n;
  float *pm, *pden, *pacc;
  int32_t* starts;
  float *out, *m_out, *den_out;
  cudaStream_t st;
};

// the chunks, a pass a range in range order on the stream, then the
// combine
template <typename T, typename I, int G, int NV>
int launch(const Args& a) {
  using S = Pass<T, I, G, NV>;
  auto kern = gat_attention_kernel<T, I, G, NV>;
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
                               kWarps * S::WARP_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[card] = true;
  }
  const T* feat = static_cast<const T*>(a.feat);
  const long long bounds = (long long)a.ranges * (a.chunks + 1);
  gat_attention_kernel_chunks<<<(unsigned)((bounds + 255) / 256), 256, 0,
                                a.st>>>(a.ptr, a.n, a.ranges, a.chunks,
                                        a.starts);
  const bool single = a.ranges == 1;
  const dim3 grid((unsigned)((a.chunks + kWarps - 1) / kWarps),
                  (unsigned)a.h);
  for (int r = 0; r < a.ranges; ++r) {
    const long long part = (long long)r * a.n * a.h;
    kern<<<grid, kWarps * 32, (size_t)kWarps * S::WARP_BYTES, a.st>>>(
        feat, a.attn, a.h, a.op, a.o, a.slope,
        a.ptr + (long long)r * a.n, static_cast<const I*>(a.ids),
        r * a.span, a.starts + (long long)r * (a.chunks + 1), a.chunks,
        single, single ? a.out : a.pacc + part * a.o,
        single ? a.m_out : a.pm + part, single ? a.den_out : a.pden + part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!single) {
    const long long warps = a.n * a.h;
    gat_attention_kernel_combine<T><<<(unsigned)((warps + 7) / 8), 256, 0,
                                      a.st>>>(
        feat, a.attn, a.slope, a.h, a.op, a.o, a.n, a.ranges, a.ptr, a.pm,
        a.pden, a.pacc, a.out, a.m_out, a.den_out);
  }
  return (int)cudaGetLastError();
}

// the lane layout for a head row of `vecs` 16-byte vectors: one vector a
// lane for a single vector, four past 64, else two
template <typename T, typename I>
int launch_width(const Args& a) {
  constexpr int V = Vec<T>::kN;
  const int vecs = a.op / V;
  if (vecs <= 1) return launch<T, I, 1, 1>(a);
  if (vecs <= 2) return launch<T, I, 1, 2>(a);
  if (vecs <= 4) return launch<T, I, 2, 2>(a);
  if (vecs <= 8) return launch<T, I, 4, 2>(a);
  if (vecs <= 16) return launch<T, I, 8, 2>(a);
  if (vecs <= 32) return launch<T, I, 16, 2>(a);
  if (vecs <= 64) return launch<T, I, 32, 2>(a);
  return launch<T, I, 32, 4>(a);
}

template <typename T>
int launch_ids(const Args& a, int id_bytes) {
  if (id_bytes == 2) return launch_width<T, uint16_t>(a);
  return launch_width<T, int32_t>(a);
}

}  // namespace

// dtype 0: feat is f32; dtype 1: feat is bf16. feat [n_src, h, op] with a
// 16-byte aligned base, op a multiple of the 16-byte vector (4 f32, 8
// bf16) and at most 128 vectors, columns o..op-1 zero; attn f32 [h, op],
// zero past o. The edges: `ranges` src ranges of `span` srcs; ptr int32
// [ranges * n + 1], the edges of dst d from range r at ptr[r n + d] ..
// ptr[r n + d + 1] of ids (int32, or uint16 for id_bytes 2), each src less
// r * span; one range is a plain CSC (ptr its indptr, ids its srcs).
// Scratch: starts int32 [ranges, chunks + 1] (the chunks a pass's warps
// take, `chunks` at least 1); when ranges > 1 the
// partial states pm and pden f32 [ranges, n, h] and pacc f32 [ranges, n,
// h, o]. out is f32 [n, h, o]. m_out and den_out, f32 [n, h], are both
// null or both set (the partial outputs, see the note at the top). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside those
// limits.
extern "C" int bliss_gat_attention(
    const void* feat, int dtype, int h, int op, int o, const void* attn,
    float slope, const void* ptr, const void* ids, int id_bytes, int ranges,
    int span, int chunks, long long n, void* starts, void* pm, void* pden,
    void* pacc, void* out, void* m_out, void* den_out, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || h <= 0 || o <= 0 || o > op ||
      op % vec != 0 || op > 128 * vec || ranges < 1 || chunks < 1 ||
      (id_bytes != 2 && id_bytes != 4) || starts == nullptr ||
      (ranges > 1 && (pm == nullptr || pden == nullptr || pacc == nullptr)) ||
      (m_out == nullptr) != (den_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const Args a{feat, static_cast<const float*>(attn), slope, h, op, o,
               static_cast<const int32_t*>(ptr), ids, ranges, span, chunks,
               n, static_cast<float*>(pm),
               static_cast<float*>(pden), static_cast<float*>(pacc),
               static_cast<int32_t*>(starts), static_cast<float*>(out),
               static_cast<float*>(m_out), static_cast<float*>(den_out),
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return launch_ids<__nv_bfloat16>(a, id_bytes);
  return launch_ids<float>(a, id_bytes);
}
