// GATv2's per-edge attention on a sampled block, forward and backward,
// bounded by the block's valid prefix [0, *n_valid) read on the card.
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA
// (bliss_gnn_tpu/models/layers.py GATv2Conv), as it leaves the Poisson fixed
// point (csrc/poisson_scale.cu). On the card PyTorch ran them as a dozen
// elementwise passes over the block's padded capacity [E_cap, H * O]: the
// gathered src and dst rows, their sum, the leaky ReLU, its product with
// attn, the messages, and each one's backward. Here each pass reads the
// projected rows f = feat2 [n_src, H * O] where an edge needs them and
// writes only the per-edge rows that the segment sums (K5, or K3 for
// narrow rows) read, for valid edges; every other per-edge tensor is
// [E_cap, H].
//
// The block's promise: ids_dst = where(e_mask, e_dst, 0) is non-decreasing
// on the valid prefix (the promise the sorted segment sums take), so the
// edges of one dst are one run of slots. A slot is live when it lies in
// the prefix and e_mask holds; other slots add nothing and read 0 in the
// [E_cap, H] outputs; the row outputs are written 0 on the dead slots of
// the prefix and not at all past it (the sums stop at n_valid). Ids are
// clamped into their tables.
//
// Bound: bytes. At GATv2's layer 0 (H * O = 1024 bf16, ~60,000 valid edges
// of ~100,000 slots) every kernel reads a 2 KB src row per edge (the 16 MB
// feat2 stays in L2) and the row-writing ones write 2 or 4 KB per edge; a
// few operations per value are far below the card's rate.
//
// Kernels (a warp takes a tile of 32 consecutive slots; lane j owns slot j
// of its tile, loads its ids and [H] values, and the warp walks the tile's
// live edges one at a time, each lane holding VEC columns of each of up to
// KMAX 16-byte chunks of the row; a dst's rows are loaded once per run):
//   logits:     e = sum_O attn * leaky(f[src] + f[dst]): the sum of the
//               rows, its leaky ReLU and each product rounded to the compute
//               dtype where PyTorch rounds them (the GAT reward divides a
//               logit by its dst's sum, which amplifies a rounding, so the
//               card keeps the CPU's), summed in f32 and rounded once;
//   runs, fold: per-dst reductions over [E, H] values by edge tiles, as K5's
//               sorted route: a run inside a tile is finished there, a run
//               crossing tiles leaves carry records that the fold combines
//               in tile order; forward: the softmax's max and denominator
//               (an online pair), backward: sum a * da;
//   softmax:    a = exp(e - max) / denominator, f32, rounded once;
//   messages:   msg = f[src] * a_drop (one rounding);
//   msg_grad:   d a_drop = sum_O g[dst] * f[src] (f32, rounded once);
//   grad:       d_logit = a (da - sum_dst a da) + de, dz = d_logit attn
//               leaky'(z), d_el = a_drop g[dst] + dz, d_er = dz (one
//               rounding each), and per block the partial sum of d_logit *
//               leaky(z) for attn's gradient;
//   attn_reduce: those partials summed in block order.
// No atomics on values: the same bits on every call.
#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // tiles of 32 slots a block
constexpr int kThreads = kWarps * 32;
constexpr int kHMax = 8;       // heads
constexpr int kRowMax = 1024;  // H * O
constexpr int kReduceWarps = 8;
constexpr int32_t kPastEnd = INT_MAX;

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  const int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

__device__ __forceinline__ int32_t clamp_id(int32_t i, int32_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// VEC values of a row: their raw load, f32 values and store.
template <typename T, int VEC>
struct Pack {  // VEC == 1: one value, any alignment
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static Raw zero() { return from_f<T>(0.0f); }
  __device__ static void unpack(Raw r, float* f) { f[0] = to_f(r); }
  __device__ static void store(T* p, const float* f) { *p = from_f<T>(f[0]); }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(Raw r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __bfloat1622float2(h[i]);
      f[2 * i] = q.x;
      f[2 * i + 1] = q.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Pack<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(Raw r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// A lane's columns: chunk k starts at column (k * 32 + lane) * VEC and lies
// in head hd[k] (O % VEC == 0, so a chunk never straddles two heads).
template <int VEC, int KMAX>
struct Cols {
  int c[KMAX];
  int hd[KMAX];
  bool on[KMAX];
  __device__ Cols(int lane, int ho, int o) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      c[k] = (k * 32 + lane) * VEC;
      on[k] = c[k] < ho;
      hd[k] = on[k] ? c[k] / o : 0;
    }
  }
};

template <typename T, int VEC, int KMAX>
__device__ __forceinline__ void load_row(typename Pack<T, VEC>::Raw* raw, const T* row,
                                         const Cols<VEC, KMAX>& cols) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    raw[k] = cols.on[k] ? Pack<T, VEC>::load(row + cols.c[k]) : Pack<T, VEC>::zero();
}

// x[hd] for a head index known only at run time, from registers
__device__ __forceinline__ float pick(const float* x, int hd) {
  float v = x[0];
#pragma unroll
  for (int h = 1; h < kHMax; ++h) v = hd == h ? x[h] : v;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The per-dst reductions as pairs (m, s). Mode 0: the softmax's running max
// m and denominator s = sum exp(x - m); an empty pair has s = 0. Mode 1: a
// plain sum in m (s unused). Both combines are commutative, so a butterfly
// leaves the same bits in every lane.
template <int MODE>
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  if (MODE == 1) {
    m += m2;
    return;
  }
  if (s2 == 0.0f) return;
  if (s == 0.0f) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// a's f32 value before its rounding: the softmax kernel's and the backward's
template <typename T>
__device__ __forceinline__ float softmax_at(T e, const float* st) {
  return expf(to_f(e) - st[0]) / fmaxf(st[1], FLT_MIN);
}

// -- logits ---------------------------------------------------------------
template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    gat_edge_logits_kernel(const T* __restrict__ feat, int32_t n_src, int32_t n_dst,
                           int32_t ho, int32_t o, int32_t h_n,
                           const int32_t* __restrict__ e_src,
                           const int32_t* __restrict__ ids_dst,
                           const uint8_t* __restrict__ e_mask, int64_t e_cap,
                           const int32_t* __restrict__ n_valid,
                           const T* __restrict__ attn, float slope,
                           T* __restrict__ e_out) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= e_cap) return;
  const int64_t nv = valid_prefix(e_cap, n_valid);
  const int64_t r = r0 + lane;
  const bool live = r < nv && e_mask[r] != 0;
  const int32_t src = live ? clamp_id(e_src[r], n_src) : 0;
  const int32_t dst = live ? clamp_id(ids_dst[r], n_dst) : 0;
  float mine[kHMax];
#pragma unroll
  for (int h = 0; h < kHMax; ++h) mine[h] = 0.0f;
  unsigned todo = __ballot_sync(kFull, live);
  if (todo) {
    const Cols<VEC, KMAX> cols(lane, ho, o);
    float at[KMAX][VEC];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (cols.on[k]) {
        P::unpack(P::load(attn + cols.c[k]), at[k]);
      } else {
        for (int v = 0; v < VEC; ++v) at[k][v] = 0.0f;
      }
    }
    typename P::Raw drow[KMAX];
    int32_t cur = -1;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t s = __shfl_sync(kFull, src, j);
      const int32_t d = __shfl_sync(kFull, dst, j);
      if (d != cur) {
        load_row<T, VEC, KMAX>(drow, feat + (int64_t)d * ho, cols);
        cur = d;
      }
      typename P::Raw srow[KMAX];
      load_row<T, VEC, KMAX>(srow, feat + (int64_t)s * ho, cols);
      float part[kHMax];
#pragma unroll
      for (int h = 0; h < kHMax; ++h) part[h] = 0.0f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!cols.on[k]) continue;
        float fs[VEC], fd[VEC];
        P::unpack(srow[k], fs);
        P::unpack(drow[k], fd);
        float p = 0.0f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float z = rnd<T>(fs[v] + fd[v]);
          p += rnd<T>(at[k][v] * rnd<T>(z > 0.0f ? z : z * slope));
        }
#pragma unroll
        for (int h = 0; h < kHMax; ++h) part[h] += cols.hd[k] == h ? p : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < kHMax; ++h) {
        if (h >= h_n) break;
        const float t = warp_sum(part[h]);
        if (lane == j) mine[h] = to_f(from_f<T>(t));
      }
    }
  }
  if (r < e_cap)
    for (int h = 0; h < h_n; ++h) e_out[r * h_n + h] = from_f<T>(mine[h]);
}

// -- per-dst reductions by edge tiles, and their fold ----------------------
// Mode 0: (max, denominator) of the live logits e. Mode 1: sum a * da, a
// recomputed from e and mode 0's pairs (stats). Finished runs go to out
// [n_dst, H, 2]; a tile's first run, when it began in an earlier tile, and
// its last, when it goes on into the next, to carry records: c_int[3t] head
// key (-1: none), c_int[3t + 1] 1 when the head run goes on into tile t + 1,
// c_int[3t + 2] tail key (-1: none); c_val[((2t + side) * H + h) * 2 ...]
// their pairs (side 0 head, 1 tail).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    gat_edge_runs_kernel(const int32_t* __restrict__ ids_dst,
                         const uint8_t* __restrict__ e_mask, int64_t e_cap,
                         const int32_t* __restrict__ n_valid, int32_t n_dst,
                         int32_t h_n, const T* __restrict__ e_in,
                         const float* __restrict__ stats,
                         const T* __restrict__ da, float* __restrict__ out,
                         int32_t* __restrict__ c_int, float* __restrict__ c_val) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t r0 = t * 32;
  const int64_t nv = valid_prefix(e_cap, n_valid);
  if (r0 >= nv) return;  // the fold reads the records of the prefix's tiles
  const int n_rows = nv - r0 < 32 ? (int)(nv - r0) : 32;
  const int64_t r = r0 + lane;
  const bool in = lane < n_rows;
  const bool live = in && e_mask[r] != 0;
  auto key_at = [&](int64_t i) { return e_mask[i] ? clamp_id(ids_dst[i], n_dst) : 0; };
  const int32_t key = in ? key_at(r) : kPastEnd;
  float m[kHMax], s[kHMax];
#pragma unroll
  for (int h = 0; h < kHMax; ++h) {
    m[h] = MODE == 0 ? -INFINITY : 0.0f;
    s[h] = 0.0f;
    if (h >= h_n || !live) continue;
    if (MODE == 0) {
      m[h] = to_f(e_in[r * h_n + h]);
      s[h] = 1.0f;
    } else {
      const float a = softmax_at(e_in[r * h_n + h], stats + ((int64_t)key * h_n + h) * 2);
      m[h] = a * to_f(da[r * h_n + h]);
    }
  }
  // inclusive scan of each run (keys are non-decreasing over the lanes)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t k2 = __shfl_up_sync(kFull, key, off);
    const bool take = lane >= off && k2 == key;
#pragma unroll
    for (int h = 0; h < kHMax; ++h) {
      const float m2 = __shfl_up_sync(kFull, m[h], off);
      const float s2 = __shfl_up_sync(kFull, s[h], off);
      if (take && h < h_n) combine<MODE>(m[h], s[h], m2, s2);
    }
  }
  const int32_t first_key = __shfl_sync(kFull, key, 0);
  const int32_t last_key = __shfl_sync(kFull, key, n_rows - 1);
  const int32_t next_in_tile = __shfl_down_sync(kFull, key, 1);
  const int32_t key_before = r0 > 0 ? key_at(r0 - 1) : kPastEnd;
  const int32_t next_key = r0 + 32 < nv ? key_at(r0 + 32) : kPastEnd;
  const bool open_left = r0 > 0 && key_before == first_key;
  const bool open_right = next_key == last_key;
  const bool head_set = open_left;
  const bool tail_set = open_right && !(open_left && first_key == last_key);
  if (lane == 0) {
    if (!head_set) c_int[3 * t] = -1;
    if (!tail_set) c_int[3 * t + 2] = -1;
  }
  const bool run_end = in && (lane == n_rows - 1 || next_in_tile != key);
  if (!run_end) return;
  float* dst_pair;
  if (key == first_key && open_left) {
    c_int[3 * t] = key;
    c_int[3 * t + 1] = key == last_key && open_right;
    dst_pair = c_val + (2 * t) * h_n * 2;
  } else if (key == last_key && open_right) {
    c_int[3 * t + 2] = key;
    dst_pair = c_val + (2 * t + 1) * h_n * 2;
  } else {
    dst_pair = out + (int64_t)key * h_n * 2;
  }
#pragma unroll
  for (int h = 0; h < kHMax; ++h) {
    if (h >= h_n) break;
    dst_pair[2 * h] = m[h];
    dst_pair[2 * h + 1] = s[h];
  }
}

// A warp per tile that starts a run crossing tiles: its tail pair and the
// head pairs of the tiles after it, up to the tile where the run stops,
// combined lane by lane then by a butterfly, written once.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    gat_edge_fold_kernel(const int32_t* __restrict__ c_int,
                         const float* __restrict__ c_val, int64_t e_cap,
                         const int32_t* __restrict__ n_valid, int32_t h_n,
                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_tiles = (valid_prefix(e_cap, n_valid) + 31) / 32;
  if (t >= n_tiles) return;
  const int32_t key = c_int[3 * t + 2];
  if (key < 0) return;
  int64_t end = n_tiles - 1;
  for (int64_t b = t + 1; b < n_tiles; b += 32) {
    const int64_t u = b + lane;
    const unsigned stop = __ballot_sync(kFull, u < n_tiles && c_int[3 * u + 1] == 0);
    if (stop) {
      end = b + __ffs(stop) - 1;
      break;
    }
  }
  float m[kHMax], s[kHMax];
#pragma unroll
  for (int h = 0; h < kHMax; ++h) {
    m[h] = MODE == 0 ? -INFINITY : 0.0f;
    s[h] = 0.0f;
    if (lane == 0 && h < h_n) {
      m[h] = c_val[((2 * t + 1) * h_n + h) * 2];
      s[h] = c_val[((2 * t + 1) * h_n + h) * 2 + 1];
    }
  }
  for (int64_t u = t + 1 + lane; u <= end; u += 32)
#pragma unroll
    for (int h = 0; h < kHMax; ++h)
      if (h < h_n)
        combine<MODE>(m[h], s[h], c_val[((2 * u) * h_n + h) * 2],
                      c_val[((2 * u) * h_n + h) * 2 + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int h = 0; h < kHMax; ++h) {
      const float m2 = __shfl_xor_sync(kFull, m[h], off);
      const float s2 = __shfl_xor_sync(kFull, s[h], off);
      if (h < h_n) combine<MODE>(m[h], s[h], m2, s2);
    }
  if (lane == 0)
    for (int h = 0; h < h_n; ++h) {
      out[((int64_t)key * h_n + h) * 2] = m[h];
      out[((int64_t)key * h_n + h) * 2 + 1] = s[h];
    }
}

// -- softmax --------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    gat_edge_softmax_kernel(const int32_t* __restrict__ ids_dst,
                            const uint8_t* __restrict__ e_mask, int64_t e_cap,
                            const int32_t* __restrict__ n_valid, int32_t n_dst,
                            int32_t h_n, const T* __restrict__ e_in,
                            const float* __restrict__ stats, T* __restrict__ a_out) {
  const int64_t nv = valid_prefix(e_cap, n_valid);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < e_cap; r += step) {
    const bool live = r < nv && e_mask[r] != 0;
    const int32_t d = live ? clamp_id(ids_dst[r], n_dst) : 0;
    for (int h = 0; h < h_n; ++h)
      a_out[r * h_n + h] = from_f<T>(
          live ? softmax_at(e_in[r * h_n + h], stats + ((int64_t)d * h_n + h) * 2) : 0.0f);
  }
}

// -- messages -------------------------------------------------------------
template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    gat_edge_messages_kernel(const T* __restrict__ feat, int32_t n_src, int32_t ho,
                             int32_t o, int32_t h_n, const int32_t* __restrict__ e_src,
                             const uint8_t* __restrict__ e_mask, int64_t e_cap,
                             const int32_t* __restrict__ n_valid,
                             const T* __restrict__ a_drop, T* __restrict__ msg) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  const int64_t nv = valid_prefix(e_cap, n_valid);
  if (r0 >= nv) return;
  const int n_rows = nv - r0 < 32 ? (int)(nv - r0) : 32;
  const int64_t r = r0 + lane;
  const bool live = lane < n_rows && e_mask[r] != 0;
  const int32_t src = live ? clamp_id(e_src[r], n_src) : 0;
  float av[kHMax];
#pragma unroll
  for (int h = 0; h < kHMax; ++h) av[h] = live && h < h_n ? to_f(a_drop[r * h_n + h]) : 0.0f;
  const Cols<VEC, KMAX> cols(lane, ho, o);
  for (int j = 0; j < n_rows; ++j) {
    T* row = msg + (r0 + j) * ho;
    float aj[kHMax];
#pragma unroll
    for (int h = 0; h < kHMax; ++h) aj[h] = __shfl_sync(kFull, av[h], j);
    const bool lj = __shfl_sync(kFull, live, j);
    const int32_t s = __shfl_sync(kFull, src, j);
    typename P::Raw srow[KMAX];
    if (lj) load_row<T, VEC, KMAX>(srow, feat + (int64_t)s * ho, cols);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (!cols.on[k]) continue;
      float f[VEC];
      if (lj) {
        P::unpack(srow[k], f);
        const float a = pick(aj, cols.hd[k]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) f[v] *= a;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) f[v] = 0.0f;
      }
      P::store(row + cols.c[k], f);
    }
  }
}

// -- the messages' backward: d a_drop ---------------------------------------
template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    gat_edge_msg_grad_kernel(const T* __restrict__ feat, int32_t n_src, int32_t n_dst,
                             int32_t ho, int32_t o, int32_t h_n,
                             const int32_t* __restrict__ e_src,
                             const int32_t* __restrict__ ids_dst,
                             const uint8_t* __restrict__ e_mask, int64_t e_cap,
                             const int32_t* __restrict__ n_valid,
                             const T* __restrict__ g, T* __restrict__ d_a) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= e_cap) return;
  const int64_t nv = valid_prefix(e_cap, n_valid);
  const int64_t r = r0 + lane;
  const bool live = r < nv && e_mask[r] != 0;
  const int32_t src = live ? clamp_id(e_src[r], n_src) : 0;
  const int32_t dst = live ? clamp_id(ids_dst[r], n_dst) : 0;
  float mine[kHMax];
#pragma unroll
  for (int h = 0; h < kHMax; ++h) mine[h] = 0.0f;
  unsigned todo = __ballot_sync(kFull, live);
  if (todo) {
    const Cols<VEC, KMAX> cols(lane, ho, o);
    typename P::Raw grow[KMAX];
    int32_t cur = -1;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t s = __shfl_sync(kFull, src, j);
      const int32_t d = __shfl_sync(kFull, dst, j);
      if (d != cur) {
        load_row<T, VEC, KMAX>(grow, g + (int64_t)d * ho, cols);
        cur = d;
      }
      typename P::Raw srow[KMAX];
      load_row<T, VEC, KMAX>(srow, feat + (int64_t)s * ho, cols);
      float part[kHMax];
#pragma unroll
      for (int h = 0; h < kHMax; ++h) part[h] = 0.0f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!cols.on[k]) continue;
        float fs[VEC], fg[VEC];
        P::unpack(srow[k], fs);
        P::unpack(grow[k], fg);
        float p = 0.0f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) p += fs[v] * fg[v];
#pragma unroll
        for (int h = 0; h < kHMax; ++h) part[h] += cols.hd[k] == h ? p : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < kHMax; ++h) {
        if (h >= h_n) break;
        const float t = warp_sum(part[h]);
        if (lane == j) mine[h] = t;
      }
    }
  }
  if (r < e_cap)
    for (int h = 0; h < h_n; ++h) d_a[r * h_n + h] = from_f<T>(mine[h]);
}

// -- the logits' and the messages' row gradients, attn's partials ---------
template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    gat_edge_grad_kernel(const T* __restrict__ feat, int32_t n_src, int32_t n_dst,
                         int32_t ho, int32_t o, int32_t h_n,
                         const int32_t* __restrict__ e_src,
                         const int32_t* __restrict__ ids_dst,
                         const uint8_t* __restrict__ e_mask, int64_t e_cap,
                         const int32_t* __restrict__ n_valid,
                         const T* __restrict__ attn, float slope,
                         const T* __restrict__ e_in, const float* __restrict__ stats,
                         const float* __restrict__ sums, const T* __restrict__ da,
                         const T* __restrict__ de, const T* __restrict__ g,
                         const T* __restrict__ a_drop, T* __restrict__ d_el,
                         T* __restrict__ d_er, float* __restrict__ attn_part) {
  using P = Pack<T, VEC>;
  __shared__ float red[kWarps][kRowMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  const int64_t nv = valid_prefix(e_cap, n_valid);
  if ((int64_t)blockIdx.x * kWarps * 32 >= nv) return;  // no partial: past the prefix
  const Cols<VEC, KMAX> cols(lane, ho, o);
  float dat[KMAX][VEC];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) dat[k][v] = 0.0f;
  if (r0 < nv) {
    const int n_rows = nv - r0 < 32 ? (int)(nv - r0) : 32;
    const int64_t r = r0 + lane;
    const bool live = lane < n_rows && e_mask[r] != 0;
    const int32_t src = live ? clamp_id(e_src[r], n_src) : 0;
    const int32_t dst = live ? clamp_id(ids_dst[r], n_dst) : 0;
    float dl[kHMax], ad[kHMax];
#pragma unroll
    for (int h = 0; h < kHMax; ++h) {
      dl[h] = ad[h] = 0.0f;
      if (!live || h >= h_n) continue;
      const int64_t i = r * h_n + h, q = (int64_t)dst * h_n + h;
      const float a = softmax_at(e_in[i], stats + 2 * q);
      dl[h] = a * (to_f(da[i]) - sums[2 * q]) + (de != nullptr ? to_f(de[i]) : 0.0f);
      if (a_drop != nullptr) ad[h] = to_f(a_drop[i]);
    }
    float at[KMAX][VEC];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (cols.on[k]) {
        P::unpack(P::load(attn + cols.c[k]), at[k]);
      } else {
        for (int v = 0; v < VEC; ++v) at[k][v] = 0.0f;
      }
    }
    typename P::Raw drow[KMAX], grow[KMAX];
    int32_t cur = -1;
    for (int j = 0; j < n_rows; ++j) {
      const int64_t at_row = (r0 + j) * ho;
      const bool lj = __shfl_sync(kFull, live, j);
      float dlj[kHMax], adj[kHMax];
#pragma unroll
      for (int h = 0; h < kHMax; ++h) {
        dlj[h] = __shfl_sync(kFull, dl[h], j);
        adj[h] = __shfl_sync(kFull, ad[h], j);
      }
      const int32_t s = __shfl_sync(kFull, src, j);
      const int32_t d = __shfl_sync(kFull, dst, j);
      typename P::Raw srow[KMAX];
      if (lj) {
        if (d != cur) {
          load_row<T, VEC, KMAX>(drow, feat + (int64_t)d * ho, cols);
          if (g != nullptr) load_row<T, VEC, KMAX>(grow, g + (int64_t)d * ho, cols);
          cur = d;
        }
        load_row<T, VEC, KMAX>(srow, feat + (int64_t)s * ho, cols);
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!cols.on[k]) continue;
        float el[VEC], er[VEC];
        if (lj) {
          float fs[VEC], fd[VEC], fg[VEC];
          P::unpack(srow[k], fs);
          P::unpack(drow[k], fd);
          if (g != nullptr) P::unpack(grow[k], fg);
          const float dlh = pick(dlj, cols.hd[k]), adh = pick(adj, cols.hd[k]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float z = fs[v] + fd[v];
            const bool pos = z > 0.0f;
            const float dz = dlh * at[k][v] * (pos ? 1.0f : slope);
            dat[k][v] += dlh * (pos ? z : z * slope);
            er[v] = dz;
            el[v] = g != nullptr ? adh * fg[v] + dz : dz;
          }
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) el[v] = er[v] = 0.0f;
        }
        P::store(d_el + at_row + cols.c[k], el);
        P::store(d_er + at_row + cols.c[k], er);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (cols.on[k])
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][cols.c[k] + v] = dat[k][v];
  __syncthreads();
  for (int c = threadIdx.x; c < ho; c += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w][c];
    attn_part[(int64_t)blockIdx.x * ho + c] = acc;
  }
}

// attn's gradient: the grad kernel's block partials (the blocks that held
// prefix slots) summed in block order; a block per 32 columns, its warps
// striding the partial rows, then their sums in warp order.
template <typename T>
__global__ void __launch_bounds__(kReduceWarps * 32)
    gat_edge_attn_reduce_kernel(const float* __restrict__ attn_part, int64_t e_cap,
                                const int32_t* __restrict__ n_valid, int32_t ho,
                                T* __restrict__ out) {
  __shared__ float sh[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = (int64_t)kWarps * 32;
  const int64_t n_part = (valid_prefix(e_cap, n_valid) + per - 1) / per;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (c < ho)
    for (int64_t b = warp; b < n_part; b += kReduceWarps) acc += attn_part[b * ho + c];
  sh[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || c >= ho) return;
  float sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kReduceWarps; ++w) sum += sh[w][lane];
  out[c] = from_f<T>(sum);
}

// -- launch helpers ---------------------------------------------------------
unsigned tile_blocks(long long e_cap) {
  const long long per = (long long)kWarps * 32;
  const long long b = (e_cap + per - 1) / per;
  return (unsigned)(b < 1 ? 1 : b);
}

bool heads_ok(int ho, int o, int h) {
  return o > 0 && h > 0 && h <= kHMax && ho == h * o && ho <= kRowMax;
}

// Calls LAUNCH(T, VEC, KMAX) for the row layout the arguments allow: 16-byte
// vectors when the rows (and a head's columns) are whole vectors and
// aligned, single values otherwise, with as few chunks a lane as cover H * O.
#define GAT_EDGE_DISPATCH(dtype, ho, o, aligned, LAUNCH)                           \
  do {                                                                              \
    if ((dtype) == 1 && (aligned) && (ho) % 8 == 0 && (o) % 8 == 0) {              \
      if ((ho) <= 256) LAUNCH(__nv_bfloat16, 8, 1);                                 \
      else LAUNCH(__nv_bfloat16, 8, 4);                                             \
    } else if ((dtype) == 0 && (aligned) && (ho) % 4 == 0 && (o) % 4 == 0) {       \
      if ((ho) <= 256) LAUNCH(float, 4, 2);                                         \
      else LAUNCH(float, 4, 8);                                                     \
    } else if ((dtype) == 1) {                                                      \
      if ((ho) <= 64) LAUNCH(__nv_bfloat16, 1, 2);                                  \
      else LAUNCH(__nv_bfloat16, 1, 32);                                            \
    } else {                                                                        \
      if ((ho) <= 64) LAUNCH(float, 1, 2);                                          \
      else LAUNCH(float, 1, 32);                                                    \
    }                                                                               \
  } while (0)

}  // namespace

// Kernel F: the logits e (T [e_cap, h]), the per-dst pairs stats (f32
// [n_dst, h, 2]: max and denominator; rows of dsts with no live edge are
// not written) and the softmax a (T [e_cap, h]); e and a read 0 on every
// slot that is not live. c_int (int32 [3 n_tiles]) and c_val (f32 [4 h
// n_tiles]), n_tiles = 4 * tile_blocks(e_cap), are the reduce's scratch.
// dtype 0: f32, 1: bf16; aligned: feat's rows are whole 16-byte vectors at a
// 16-byte aligned address. Returns cudaGetLastError().
extern "C" int bliss_gat_edge_scores(const void* feat, int dtype, int aligned, int n_src,
                                     int n_dst, int ho, int o, int h, const void* e_src,
                                     const void* ids_dst, const void* e_mask,
                                     long long e_cap, const void* n_valid,
                                     const void* attn, float slope, void* e_out,
                                     void* stats, void* a_out, void* c_int, void* c_val,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!heads_ok(ho, o, h) || n_src < 1 || n_dst < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = tile_blocks(e_cap);
  const int32_t* es = static_cast<const int32_t*>(e_src);
  const int32_t* ed = static_cast<const int32_t*>(ids_dst);
  const uint8_t* em = static_cast<const uint8_t*>(e_mask);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
#define LOGITS(T, VEC, KMAX)                                                        \
  gat_edge_logits_kernel<T, VEC, KMAX><<<blocks, kThreads, 0, st>>>(                \
      static_cast<const T*>(feat), n_src, n_dst, ho, o, h, es, ed, em, e_cap, nv,   \
      static_cast<const T*>(attn), slope, static_cast<T*>(e_out))
  GAT_EDGE_DISPATCH(dtype, ho, o, aligned, LOGITS);
#undef LOGITS
  float* sp = static_cast<float*>(stats);
  int32_t* ci = static_cast<int32_t*>(c_int);
  float* cv = static_cast<float*>(c_val);
  if (dtype == 1) {
    const __nv_bfloat16* e = static_cast<const __nv_bfloat16*>(e_out);
    gat_edge_runs_kernel<__nv_bfloat16, 0><<<blocks, kThreads, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, e, nullptr, nullptr, sp, ci, cv);
    gat_edge_fold_kernel<0><<<blocks, kThreads, 0, st>>>(ci, cv, e_cap, nv, h, sp);
    gat_edge_softmax_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, e, sp, static_cast<__nv_bfloat16*>(a_out));
  } else {
    const float* e = static_cast<const float*>(e_out);
    gat_edge_runs_kernel<float, 0><<<blocks, kThreads, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, e, nullptr, nullptr, sp, ci, cv);
    gat_edge_fold_kernel<0><<<blocks, kThreads, 0, st>>>(ci, cv, e_cap, nv, h, sp);
    gat_edge_softmax_kernel<float><<<blocks, 256, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, e, sp, static_cast<float*>(a_out));
  }
  return (int)cudaGetLastError();
}

// Kernel M: msg (T [e_cap, ho]) = feat[e_src] * a_drop per head on the live
// slots, 0 on the prefix's other slots, not written past it. aligned: feat
// and msg as in bliss_gat_edge_scores. Returns cudaGetLastError().
extern "C" int bliss_gat_edge_messages(const void* feat, int dtype, int aligned, int n_src,
                                       int ho, int o, int h, const void* e_src,
                                       const void* e_mask, long long e_cap,
                                       const void* n_valid, const void* a_drop, void* msg,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!heads_ok(ho, o, h) || n_src < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = tile_blocks(e_cap);
#define MESSAGES(T, VEC, KMAX)                                                      \
  gat_edge_messages_kernel<T, VEC, KMAX><<<blocks, kThreads, 0, st>>>(              \
      static_cast<const T*>(feat), n_src, ho, o, h,                                 \
      static_cast<const int32_t*>(e_src), static_cast<const uint8_t*>(e_mask),      \
      e_cap, static_cast<const int32_t*>(n_valid),                                  \
      static_cast<const T*>(a_drop), static_cast<T*>(msg))
  GAT_EDGE_DISPATCH(dtype, ho, o, aligned, MESSAGES);
#undef MESSAGES
  return (int)cudaGetLastError();
}

// The messages' backward: d_a (T [e_cap, h]) = per head sum_O g[dst] *
// feat[src] on the live slots, 0 elsewhere; g is T [n_dst, ho]. Returns
// cudaGetLastError().
extern "C" int bliss_gat_edge_msg_grad(const void* feat, int dtype, int aligned, int n_src,
                                       int n_dst, int ho, int o, int h, const void* e_src,
                                       const void* ids_dst, const void* e_mask,
                                       long long e_cap, const void* n_valid, const void* g,
                                       void* d_a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!heads_ok(ho, o, h) || n_src < 1 || n_dst < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = tile_blocks(e_cap);
#define MSG_GRAD(T, VEC, KMAX)                                                      \
  gat_edge_msg_grad_kernel<T, VEC, KMAX><<<blocks, kThreads, 0, st>>>(              \
      static_cast<const T*>(feat), n_src, n_dst, ho, o, h,                          \
      static_cast<const int32_t*>(e_src), static_cast<const int32_t*>(ids_dst),     \
      static_cast<const uint8_t*>(e_mask), e_cap,                                   \
      static_cast<const int32_t*>(n_valid), static_cast<const T*>(g),               \
      static_cast<T*>(d_a))
  GAT_EDGE_DISPATCH(dtype, ho, o, aligned, MSG_GRAD);
#undef MSG_GRAD
  return (int)cudaGetLastError();
}

// Kernel F's backward with the messages' row gradient folded in: from the
// forward's e and stats and the cotangents da (T [e_cap, h]), de (T [e_cap,
// h] or null), g (T [n_dst, ho] or null) with a_drop (T [e_cap, h], null
// with g), the rows d_el and d_er (T [e_cap, ho]: live slots, 0 on the
// prefix's other slots, not written past it) and d_attn (T [ho]). sums (f32
// [n_dst, h, 2]), c_int, c_val (as bliss_gat_edge_scores) and attn_part
// (f32 [tile_blocks(e_cap), ho]) are scratch. Returns cudaGetLastError().
extern "C" int bliss_gat_edge_grad(const void* feat, int dtype, int aligned, int n_src,
                                   int n_dst, int ho, int o, int h, const void* e_src,
                                   const void* ids_dst, const void* e_mask, long long e_cap,
                                   const void* n_valid, const void* attn, float slope,
                                   const void* e_in, const void* stats, const void* da,
                                   const void* de, const void* g, const void* a_drop,
                                   void* d_el, void* d_er, void* d_attn, void* sums,
                                   void* c_int, void* c_val, void* attn_part,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!heads_ok(ho, o, h) || n_src < 1 || n_dst < 1 || (dtype != 0 && dtype != 1) ||
      (g == nullptr) != (a_drop == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = tile_blocks(e_cap);
  const int32_t* es = static_cast<const int32_t*>(e_src);
  const int32_t* ed = static_cast<const int32_t*>(ids_dst);
  const uint8_t* em = static_cast<const uint8_t*>(e_mask);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  const float* sp = static_cast<const float*>(stats);
  float* sm = static_cast<float*>(sums);
  int32_t* ci = static_cast<int32_t*>(c_int);
  float* cv = static_cast<float*>(c_val);
  float* part = static_cast<float*>(attn_part);
  if (dtype == 1)
    gat_edge_runs_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, static_cast<const __nv_bfloat16*>(e_in), sp,
        static_cast<const __nv_bfloat16*>(da), sm, ci, cv);
  else
    gat_edge_runs_kernel<float, 1><<<blocks, kThreads, 0, st>>>(
        ed, em, e_cap, nv, n_dst, h, static_cast<const float*>(e_in), sp,
        static_cast<const float*>(da), sm, ci, cv);
  gat_edge_fold_kernel<1><<<blocks, kThreads, 0, st>>>(ci, cv, e_cap, nv, h, sm);
#define GRAD(T, VEC, KMAX)                                                          \
  gat_edge_grad_kernel<T, VEC, KMAX><<<blocks, kThreads, 0, st>>>(                  \
      static_cast<const T*>(feat), n_src, n_dst, ho, o, h, es, ed, em, e_cap, nv,   \
      static_cast<const T*>(attn), slope, static_cast<const T*>(e_in), sp, sm,      \
      static_cast<const T*>(da), static_cast<const T*>(de),                         \
      static_cast<const T*>(g), static_cast<const T*>(a_drop), static_cast<T*>(d_el), \
      static_cast<T*>(d_er), part)
  GAT_EDGE_DISPATCH(dtype, ho, o, aligned, GRAD);
#undef GRAD
  const unsigned cols = (unsigned)((ho + 31) / 32);
  if (dtype == 1)
    gat_edge_attn_reduce_kernel<__nv_bfloat16><<<cols, kReduceWarps * 32, 0, st>>>(
        part, e_cap, nv, ho, static_cast<__nv_bfloat16*>(d_attn));
  else
    gat_edge_attn_reduce_kernel<float><<<cols, kReduceWarps * 32, 0, st>>>(
        part, e_cap, nv, ho, static_cast<float*>(d_attn));
  return (int)cudaGetLastError();
}
