// K3: row segment-sum out[S, F] = sum over rows e < n_valid of data[e, :]
// into row ids[e], accumulated in f32, returned in the input dtype.
//
// Replaces bliss_gnn_tpu/ops/segsum_pallas.py onehot_segment_sum (kernel
// body _fwd_kernel). The TPU built a one-hot [S, tile] matrix per edge tile
// and ran it through the MXU, because it had no fast scatter; its cost grew
// with S. Hopper takes two routes whose cost does not depend on S.
//
// Bound: bytes. Each valid row reads F payload values and one id, and each
// output row is written once; one add per payload value is far below the
// card's arithmetic rate.
//
// Ids sorted on the valid prefix (the block aggregations by dst): a reduce
// by key with no atomics, no scratch of the output's size, and the same
// bits on every call. Rows of one id are summed in f32 registers, in row
// order, and each output row is written once in the output dtype, so it is
// rounded once; rows that no id names read 0.
//
// Rows of whole 16-byte vectors (F = 256): a warp takes a tile of 64
// consecutive rows; a lane owns VEC contiguous columns, one 16-byte load
// per row (8 bf16 or 4 f32: at F = 256 bf16 the warp reads a whole row in
// one instruction), and keeps 8 rows' loads in flight. A run of rows that
// lies wholly inside the tile is written directly; the tile's first run,
// when it began in an earlier tile, and its last, when it goes on into the
// next, go to an f32 carry record, and a second launch folds each run's
// records in tile order and writes the row. Tiles are cut by edge rows, not
// by output rows, so a hub row spreads over many warps. Rows that no id
// names are written as 0 by the tile whose ids step over them, and those
// after the last id by the whole grid.
//
// Narrow rows (F = 41 bf16: 82-byte rows start at every 2-byte offset, so
// neither 16- nor 4-byte loads line up; an unaligned view): on the main
// path only the output layer's aggregation, about 1,800 rows into 256, so
// the time is the launch and the longest chain of dependent loads, which a
// run of many rows (a dst that keeps many edges) lengthens when one warp
// sums it. One launch, a block of 4 warps per output row: they find its run
// of rows in the sorted ids with a 128-way search (at the output layer two
// steps of 4 loads a lane for each end of the run, the first issued with
// n_valid's load) and share it, 32 rows at once, a lane owning a column
// (two at once: lane and lane + 32). Every row, empty or not, is written by
// its own block, so there are no carries and no zeroing passes. (At that
// shape on an H100 a block of 4 warps took 0.0043 ms, of 8 warps 0.0048,
// one warp per output row 0.0069: tools/kernel_probe.py k3.)
//
// The sorted route also takes a permutation: position r reads payload row
// perm[r] (row r when perm is null). That is the unsorted route that gives
// the same bits on every call: K5's counting sort (csrc/row_scatter.cu)
// orders the ids first, stably, and this reduce walks them in that order.
//
// Unsorted ids (the gather backward into the src table): f32 atomics into a
// scratch [S, Fp], Fp = F rounded up to 4 (after a memset), then a cast
// kernel of its own. One warp per row, each lane owning four contiguous
// columns added with one float4 atomicAdd; a lane whose four values are
// zero (masked rows, ReLU zeros) issues none. Columns past F (F = 41) read
// 0. f32 payloads with F % 4 == 0 accumulate straight into the output, with
// no cast. Ids outside [0, S) add nothing on either route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps per block of the sorted route, 16-byte rows (tiles and fold): on
// an H100 one warp a block took 0.0231 ms on the layer-0 aggregation, 2
// 0.0235, 4 0.0236, 8 0.0260 (tools/kernel_probe.py k3)
constexpr int kWarps = 1;
constexpr int kNarrowWarps = 4;  // warps per block (per output row), narrow rows
constexpr int32_t kPastEnd = INT_MAX;
constexpr int kTileRows = 64;   // rows per warp tile, 16-byte rows

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
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC contiguous columns of one row: a raw load, its f32 sum, its store
template <typename T, int VEC>
struct Cols;

template <>
struct Cols<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(float* acc, Raw r) {
    acc[0] += r.x; acc[1] += r.y; acc[2] += r.z; acc[3] += r.w;
  }
  __device__ static void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void add(float* acc, Raw r) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __bfloat1622float2(h[i]);
      acc[2 * i] += q.x;
      acc[2 * i + 1] += q.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// VEC f32 carry values
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* acc) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}
template <int VEC>
__device__ __forceinline__ void add_f32(float* acc, const float* p) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    acc[i] += q.x; acc[i + 1] += q.y; acc[i + 2] += q.z; acc[i + 3] += q.w;
  }
}

// Zeros over rows [lo, hi) of out [*, f], written by threads i, i + step,
// ... of the caller's group with 16-byte stores (f is a multiple of VEC, so
// rows are whole vectors).
template <typename T, int VEC>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int64_t lo,
                                          int64_t hi, int32_t f, int64_t i,
                                          int64_t step) {
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t j = lo * (f / VEC) + i; j < hi * (f / VEC); j += step) o[j] = z;
}

// Carry records of tile t: ints[3t] head key (-1: none), ints[3t + 1] 1
// when the head run goes on into tile t + 1, ints[3t + 2] tail key (-1:
// none); vals[(2t) * f ...] and vals[(2t + 1) * f ...] their f32 partial
// rows. A tail record starts a run that crosses tiles; the head records of
// the tiles after it continue it.
//
// One warp's tile of rows [r0, r0 + 64) of the valid prefix [0, nv): the
// tile's ids and its neighbours' are loaded at once, then the rows in
// batches of 8, all loads of a batch in flight. Position r reads payload
// row perm[r] (r when perm is null).
template <typename T, int VEC>
__device__ __forceinline__ void segsum_tile(
    const T* __restrict__ data, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ perm, int64_t r0,
    int64_t nv, int32_t f, int32_t s, T* __restrict__ out,
    int32_t* __restrict__ c_int, float* __restrict__ c_val, int64_t tile,
    int lane) {
  using C = Cols<T, VEC>;
  constexpr int kBatch = 8;  // rows whose loads are in flight
  const int64_t r1 = r0 + kTileRows < nv ? r0 + kTileRows : nv;
  const int n_rows = (int)(r1 - r0);
  const int32_t key_lo = lane < n_rows ? ids[r0 + lane] : kPastEnd;
  const int32_t key_hi = 32 + lane < n_rows ? ids[r0 + 32 + lane] : kPastEnd;
  // the tile's payload rows, shuffled out as the keys are
  const int64_t row_lo =
      perm != nullptr && lane < n_rows ? perm[r0 + lane] : r0 + lane;
  const int64_t row_hi = perm != nullptr && 32 + lane < n_rows
                             ? perm[r0 + 32 + lane]
                             : r0 + 32 + lane;
  const int32_t key_before = r0 > 0 ? ids[r0 - 1] : kPastEnd;
  const int32_t next_key = r1 < nv ? ids[r1] : kPastEnd;
  auto row_key = [&](int j) {  // j uniform across the warp
    return j < 32 ? __shfl_sync(kFull, key_lo, j)
                  : __shfl_sync(kFull, key_hi, j - 32);
  };
  auto row_at = [&](int j) {  // j uniform across the warp
    return j < 32 ? __shfl_sync(kFull, row_lo, j)
                  : __shfl_sync(kFull, row_hi, j - 32);
  };
  const int32_t first_key = row_key(0);
  const int32_t last_key = row_key(n_rows - 1);
  const bool open_left = r0 > 0 && key_before == first_key;
  const bool open_right = next_key == last_key;
  const bool first_in = first_key >= 0 && first_key < s;
  const bool last_in = last_key >= 0 && last_key < s;
  const bool head_set = open_left && first_in;
  const bool tail_set = open_right && last_in && !(open_left && first_key == last_key);
  if (lane == 0) {
    if (!head_set) c_int[3 * tile] = -1;
    if (!tail_set) c_int[3 * tile + 2] = -1;
  }

  // rows stepped over between neighbouring ids are empty: zeros (those
  // after the last id are written by the whole grid)
  auto zero_gap = [&](int32_t a, int32_t b) {  // rows (a, b), clamped
    if (a < b) {
      const int64_t lo = (int64_t)a + 1 > 0 ? (int64_t)a + 1 : 0;
      const int64_t hi = b < s ? b : s;
      if (lo < hi) zero_rows<T, VEC>(out, lo, hi, f, lane, 32);
    }
  };
  if (r0 == 0) zero_gap(-1, first_key);
  for (int j = 1; j < n_rows; ++j) zero_gap(row_key(j - 1), row_key(j));
  if (r1 < nv) zero_gap(last_key, next_key);

  for (int c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool live = col < f;
    float acc[VEC];
    auto zero_acc = [&]() {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    };
    // a run that ends here: a carry record or a direct write
    auto emit = [&](int32_t key) {
      if (key < 0 || key >= s) return;
      float* carry = nullptr;
      if (key == first_key && open_left) {
        if (lane == 0 && c0 == 0) {
          c_int[3 * tile] = key;
          c_int[3 * tile + 1] = key == last_key && open_right;
        }
        carry = c_val + (2 * tile) * f;
      } else if (key == last_key && open_right) {
        if (lane == 0 && c0 == 0) c_int[3 * tile + 2] = key;
        carry = c_val + (2 * tile + 1) * f;
      }
      if (!live) return;
      if (carry) store_f32<VEC>(carry + col, acc);
      else C::store(out + (int64_t)key * f + col, acc);
    };
    zero_acc();
    int32_t cur = first_key;
    for (int jb = 0; jb < n_rows; jb += kBatch) {
      typename C::Raw raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t row = perm != nullptr
                                ? row_at(jb + u < n_rows ? jb + u : 0)
                                : r0 + jb + u;
        raw[u] = (jb + u < n_rows && live) ? C::load(data + row * f + col)
                                           : C::zero();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (jb + u < n_rows) {
          const int32_t key = row_key(jb + u);
          if (key != cur) {
            emit(cur);
            zero_acc();
            cur = key;
          }
          C::add(acc, raw[u]);
        }
      }
    }
    emit(cur);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_sorted_kernel(const T* __restrict__ data,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ perm, int64_t e, int32_t f,
                         const int32_t* __restrict__ n_valid, int32_t s,
                         T* __restrict__ out, int32_t* __restrict__ c_int,
                         float* __restrict__ c_val) {
  const int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t nv = valid_prefix(e, n_valid);
  const int32_t last = nv > 0 ? ids[nv - 1] : -1;  // loaded with the tile's
  const int64_t r0 = tile * kTileRows;
  if (r0 < nv)  // the whole warp takes the tile, or none of it
    segsum_tile<T, VEC>(data, ids, perm, r0, nv, f, s, out, c_int, c_val, tile,
                        threadIdx.x & 31);
  // the rows after the last id (all of them when nv is 0) are empty: the
  // whole grid writes their zeros
  const int64_t lo = last < 0 ? 0 : (last < s ? (int64_t)last + 1 : s);
  zero_rows<T, VEC>(out, lo, s, f,
                    (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                    (int64_t)gridDim.x * blockDim.x);
}

// One warp per tile that starts a run crossing tiles: its tail row plus the
// head rows of the tiles after it, in tile order, written once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_fold_kernel(const int32_t* __restrict__ c_int,
                       const float* __restrict__ c_val, int64_t e, int32_t f,
                       const int32_t* __restrict__ n_valid,
                       T* __restrict__ out) {
  using C = Cols<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_tiles = (valid_prefix(e, n_valid) + kTileRows - 1) / kTileRows;
  if (tile >= n_tiles) return;
  const int32_t key = c_int[3 * tile + 2];
  if (key < 0) return;
  for (int c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool col_live = col < f;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    if (col_live) add_f32<VEC>(acc, c_val + (2 * tile + 1) * f + col);
    for (int64_t b = tile + 1;; b += 32) {
      const int64_t t = b + lane;
      const bool cont = t < n_tiles && c_int[3 * t + 1] != 0;
      const unsigned stop = __ballot_sync(kFull, !cont);
      int take = stop ? __ffs(stop) : 32;  // tiles of this run here
      if (b + take > n_tiles) take = (int)(n_tiles - b);
      if (col_live) {
#pragma unroll 4
        for (int j = 0; j < take; ++j)
          add_f32<VEC>(acc, c_val + (2 * (b + j)) * f + col);
      }
      if (stop) break;
    }
    if (col_live) C::store(out + (int64_t)key * f + col, acc);
  }
}

// One step of the whole warp's search for the first row of [base, base +
// n) whose id is not below key, rows at or past nv counting as not below:
// 128 evenly spaced probes at once, 4 contiguous ones a lane; the answer
// lies between the last probe below key and the next, so the range shrinks
// 128-fold a step. The probes' loads depend on base and n only, so the
// first step's go out with n_valid's, before nv is known.
constexpr int kProbes = 4;  // probes a lane
struct Probe {
  int32_t id[kProbes];
};

__device__ __forceinline__ Probe probe_load(const int32_t* __restrict__ ids,
                                            int64_t base, int64_t n, int lane) {
  const int64_t step = (n + 32 * kProbes - 1) / (32 * kProbes);
  Probe p;
#pragma unroll
  for (int t = 0; t < kProbes; ++t) {
    const int64_t j = ((int64_t)lane * kProbes + t) * step;
    p.id[t] = n > 0 && j < n ? ids[base + j] : kPastEnd;
  }
  return p;
}

__device__ __forceinline__ void probe_narrow(const Probe& p, int32_t key,
                                             int64_t nv, int64_t& base,
                                             int64_t& n, int lane) {
  if (n <= 0) return;  // n is uniform across the warp
  const int64_t step = (n + 32 * kProbes - 1) / (32 * kProbes);
  int c = 0;  // probes below key: a prefix of them, the ids being sorted
#pragma unroll
  for (int t = 0; t < kProbes; ++t) {
    const int64_t j = ((int64_t)lane * kProbes + t) * step;
    c += __popc(__ballot_sync(kFull, base + j < nv && j < n && p.id[t] < key));
  }
  const int64_t end = base + n < nv ? base + n : nv;
  if (c == 0) {
    n = 0;
  } else {
    const int64_t lo = base + (c - 1) * step + 1;
    const int64_t hi = base + c * step < end ? base + c * step : end;
    base = lo;  // lo <= hi: probe c - 1 lies below end
    n = hi - lo;
  }
}

// Narrow rows: one block per output row d. Each warp finds the run of rows
// whose id is d, [lo, hi), by searching for d and d + 1 at once (2 steps at
// the output layer's 4,608 rows; the warps load the same probes). Warp w
// sums rows lo + 8w + 8 kNarrowWarps k + [0, 8) in order, 8 rows' loads in
// flight, a lane owning columns lane and lane + 32; warp 0 adds the warps'
// sums in warp order and writes the row once, empty ones as 0. Position r
// reads payload row perm[r] (r when perm is null).
template <typename T>
__global__ void __launch_bounds__(kNarrowWarps * 32)
    segsum_narrow_kernel(const T* __restrict__ data,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ perm, int64_t e, int32_t f,
                         const int32_t* __restrict__ n_valid, int32_t s,
                         T* __restrict__ out) {
  constexpr int kBatch = 8;                        // rows a warp loads at once
  constexpr int kStride = kNarrowWarps * kBatch;   // rows the block loads at once
  __shared__ float part[kNarrowWarps][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t d = blockIdx.x;
  int64_t lo = 0, n_lo = e, hi = 0, n_hi = e;
  Probe p_lo = probe_load(ids, lo, n_lo, lane);  // issued with n_valid's load
  Probe p_hi = probe_load(ids, hi, n_hi, lane);
  const int64_t nv = valid_prefix(e, n_valid);
  for (;;) {
    probe_narrow(p_lo, (int32_t)d, nv, lo, n_lo, lane);
    probe_narrow(p_hi, (int32_t)d + 1, nv, hi, n_hi, lane);
    if (n_lo <= 0 && n_hi <= 0) break;
    p_lo = probe_load(ids, lo, n_lo, lane);
    p_hi = probe_load(ids, hi, n_hi, lane);
  }
  for (int32_t c0 = 0; c0 < f; c0 += 64) {
    const int32_t c = c0 + lane;
    float acc[2] = {0.0f, 0.0f};
    for (int64_t r = lo + warp * kBatch; r < hi; r += kStride) {
      float v[2][kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t row =
            perm != nullptr && r + u < hi ? (int64_t)perm[r + u] : r + u;
#pragma unroll
        for (int p = 0; p < 2; ++p)
          v[p][u] = r + u < hi && c + 32 * p < f
                        ? to_f32(data[row * f + c + 32 * p])
                        : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r + u < hi) {
          acc[0] += v[0][u];
          acc[1] += v[1][u];
        }
    }
    part[warp][lane] = acc[0];
    part[warp][lane + 32] = acc[1];
    __syncthreads();
    if (warp == 0) {
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < kNarrowWarps; ++w) {
        sum[0] += part[w][lane];
        sum[1] += part[w][lane + 32];
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (c + 32 * p < f) out[d * f + c + 32 * p] = from_f32<T>(sum[p]);
    }
    __syncthreads();  // part is read before the next column pass writes it
  }
}

template <typename T, bool kVec4>
__global__ void segsum_atomic_kernel(const T* __restrict__ data,
                                     const int32_t* __restrict__ ids,
                                     int64_t e, int32_t f, int32_t fp,
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
    float* dst = acc + (int64_t)id * fp;
    for (int32_t c = lane * 4; c < f; c += 128) {
      float4 v;
      if constexpr (kVec4) {
        if constexpr (std::is_same<T, float>::value) {
          v = *reinterpret_cast<const float4*>(row + c);
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float2 a = __bfloat1622float2(h[0]);
          const float2 b = __bfloat1622float2(h[1]);
          v = make_float4(a.x, a.y, b.x, b.y);
        }
      } else {  // F % 4 != 0 or an unaligned view: scalar reads
        v.x = to_f32(row[c]);
        v.y = c + 1 < f ? to_f32(row[c + 1]) : 0.0f;
        v.z = c + 2 < f ? to_f32(row[c + 2]) : 0.0f;
        v.w = c + 3 < f ? to_f32(row[c + 3]) : 0.0f;
      }
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(dst + c), v);
    }
  }
}

template <typename T>
__global__ void cast_rows_kernel(const float* __restrict__ src, int32_t fp,
                                 T* __restrict__ dst, int32_t f, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = from_f32<T>(src[(i / f) * fp + i % f]);
}

long long grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return blocks > 8192 ? 8192 : blocks;
}

unsigned sorted_grid(long long e, int rows) {
  const long long blocks = ((e + rows - 1) / rows + kWarps - 1) / kWarps;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// One launch of the sorted route: K = 0 the tiles (the narrow kernel when
// VEC is 1), K = 1 the fold (VEC > 1 only)
template <int K, typename T, int VEC>
void launch_sorted(const void* data, const void* ids, const void* perm,
                   long long e, int f,
                   const void* n_valid, int s, void* out, void* c_int,
                   void* c_val, cudaStream_t st) {
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  if constexpr (VEC == 1) {
    if constexpr (K == 0)
      if (s > 0)
        segsum_narrow_kernel<T><<<(unsigned)s, kNarrowWarps * 32, 0, st>>>(
          static_cast<const T*>(data), static_cast<const int32_t*>(ids),
          static_cast<const int32_t*>(perm), (int64_t)e, (int32_t)f, nv,
          (int32_t)s, static_cast<T*>(out));
  } else if constexpr (K == 0) {
    segsum_sorted_kernel<T, VEC><<<sorted_grid(e, kTileRows), kWarps * 32, 0, st>>>(
        static_cast<const T*>(data), static_cast<const int32_t*>(ids),
        static_cast<const int32_t*>(perm), (int64_t)e, (int32_t)f, nv,
        (int32_t)s, static_cast<T*>(out), static_cast<int32_t*>(c_int),
        static_cast<float*>(c_val));
  } else {
    segsum_fold_kernel<T, VEC><<<sorted_grid(e, kTileRows), kWarps * 32, 0, st>>>(
        static_cast<const int32_t*>(c_int), static_cast<const float*>(c_val),
        (int64_t)e, (int32_t)f, nv, static_cast<T*>(out));
  }
}

// Checks the arguments of a sorted-route launch and dispatches on the dtype
// and the column layout.
template <int K>
int launch_sorted_kind(const void* data, int dtype, const void* ids,
                       const void* perm, long long e, int f,
                       const void* n_valid, int s,
                       void* out, void* c_int, void* c_val, int vec,
                       cudaStream_t st) {
  if (n_valid == nullptr || f < 1 || (dtype != 0 && dtype != 1) ||
      (vec != 1 && (vec != (dtype == 0 ? 4 : 8) || f % vec != 0)) ||
      (K == 1 && vec == 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    launch_sorted<K, float, 4>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, st);
  else if (dtype == 0)
    launch_sorted<K, float, 1>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, st);
  else if (vec == 8)
    launch_sorted<K, __nv_bfloat16, 8>(data, ids, perm, e, f, n_valid, s, out, c_int,
                                       c_val, st);
  else
    launch_sorted<K, __nv_bfloat16, 1>(data, ids, perm, e, f, n_valid, s, out, c_int,
                                       c_val, st);
  return (int)cudaGetLastError();
}

template <typename T>
void launch_atomic(const void* data, const void* ids, long long e, int f,
                   int fp, const void* n_valid, int s, float* acc, int vec4,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)grid_for(e * 32, 256);
  const T* d = static_cast<const T*>(data);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  if (vec4)
    segsum_atomic_kernel<T, true><<<blocks, 256, 0, st>>>(
        d, id, (int64_t)e, (int32_t)f, (int32_t)fp, nv, (int32_t)s, acc);
  else
    segsum_atomic_kernel<T, false><<<blocks, 256, 0, st>>>(
        d, id, (int64_t)e, (int32_t)f, (int32_t)fp, nv, (int32_t)s, acc);
}

}  // namespace

// Unsorted ids, the first kernel: out (or acc) = 0, then the float4 atomics.
// dtype 0: data and out are f32; dtype 1: bf16. acc is an f32 scratch [s,
// fp] (fp = f rounded up to 4), to be cast into out by
// bliss_segment_sum_cast, or null when dtype is 0 and fp == f (out
// accumulates directly and there is no cast). vec4: f % 4 == 0 and data
// aligned to four values. n_valid may be null. Returns cudaGetLastError().
extern "C" int bliss_segment_sum(const void* data, int dtype, const void* ids,
                                 long long e, int f, const void* n_valid,
                                 int s, void* acc, int fp, void* out, int vec4,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || fp % 4 != 0 || fp < f ||
      (acc == nullptr && (dtype != 0 || fp != f)))
    return (int)cudaErrorInvalidValue;
  float* sum = static_cast<float*>(acc == nullptr ? out : acc);
  const long long n_acc = (long long)s * fp;
  cudaError_t err = cudaMemsetAsync(sum, 0, sizeof(float) * (size_t)n_acc, st);
  if (err != cudaSuccess) return (int)err;
  if (e > 0 && f > 0) {
    if (dtype == 0)
      launch_atomic<float>(data, ids, e, f, fp, n_valid, s, sum, vec4, st);
    else
      launch_atomic<__nv_bfloat16>(data, ids, e, f, fp, n_valid, s, sum,
                                   vec4, st);
  }
  return (int)cudaGetLastError();
}

// Unsorted ids, the second kernel: out[s, f] = acc[s, :f] in out's dtype
// (dtype as above). Returns cudaGetLastError().
extern "C" int bliss_segment_sum_cast(const void* acc, int fp, void* out,
                                      int dtype, int s, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || fp < f) return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)s * f;
  if (n_out > 0) {
    const unsigned blocks = (unsigned)grid_for(n_out, 256);
    const float* src = static_cast<const float*>(acc);
    if (dtype == 0)
      cast_rows_kernel<float><<<blocks, 256, 0, st>>>(
          src, fp, static_cast<float*>(out), f, (int64_t)n_out);
    else
      cast_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          src, fp, static_cast<__nv_bfloat16*>(out), f, (int64_t)n_out);
  }
  return (int)cudaGetLastError();
}

// Ids non-decreasing on [0, *n_valid): every run of rows written once in
// the output dtype; no atomics, no memset. n_valid must not be null. vec: 8
// (bf16) or 4 (f32) when rows are whole 16-byte vectors (f a multiple of
// vec, data 16-byte aligned), else 1 (the narrow kernel: one launch, no
// scratch, c_int and c_val unused). With vec > 1 this is the first of two
// launches: runs that cross tiles are left as f32 carry records in c_int
// (int32 [3 * n_tiles]) and c_val (f32 [2 * n_tiles * f]), n_tiles =
// ceil(e / 64) (at least 1), for bliss_segment_sum_fold. perm (int32 [e],
// may be null): position r sums payload row perm[r], ids[r] its key.
// Returns cudaGetLastError().
extern "C" int bliss_segment_sum_sorted(const void* data, int dtype,
                                        const void* ids, const void* perm,
                                        long long e, int f,
                                        const void* n_valid, int s, void* out,
                                        void* c_int, void* c_val,
                                        long long n_tiles, int vec,
                                        void* stream) {
  const long long need = (e + kTileRows - 1) / kTileRows;
  if (vec > 1 && n_tiles < (need < 1 ? 1 : need))
    return (int)cudaErrorInvalidValue;
  return launch_sorted_kind<0>(data, dtype, ids, perm, e, f, n_valid, s, out,
                               c_int, c_val, vec,
                               static_cast<cudaStream_t>(stream));
}

// Second launch of the sorted route for vec > 1: folds each run of rows
// that crosses tiles into its output row, in tile order, rounded once. The
// arguments are the first launch's. Returns cudaGetLastError().
extern "C" int bliss_segment_sum_fold(const void* c_int, const void* c_val,
                                      int dtype, long long e, int f,
                                      const void* n_valid, void* out, int vec,
                                      void* stream) {
  return launch_sorted_kind<1>(nullptr, dtype, nullptr, nullptr, e, f, n_valid,
                               0, out,
                               const_cast<void*>(c_int),
                               const_cast<void*>(c_val), vec,
                               static_cast<cudaStream_t>(stream));
}
