// K5: wide-row scatter-add out[S, F] = sum over rows e < n_valid of
// data[e, :] into row ids[e], accumulated in f32 and written in the output
// dtype (f32 or bf16), each output value rounded once. Ids outside [0, S)
// add nothing; rows that no id names read 0.
//
// Replaces bliss_gnn_tpu/ops/rowscatter_pallas.py banked_row_scatter_add
// (kernel body _kernel). The TPU kept `banks` copies of one 128-lane output
// tile resident in VMEM and walked the edges in order, rotating banks so
// that consecutive read-modify-writes into one dst row could pipeline. Hopper
// has no such resident accumulator, and adding into device memory with
// atomics runs at the L2's rate of atomic adds (the first design here: one
// float4 atomic per lane, 0.18-0.23 ms on the GATv2 layer-0 block on an
// H100, whatever the order of the ids). So both routes here are a reduce by key
// with no atomics on the payload.
//
// Bound: bytes. Each valid row reads F payload values (2 KB at F = 1024
// bf16) and one id, and each output row is written once; one add per
// payload value is far below the card's arithmetic rate.
//
// Ids sorted on the valid prefix (the GATv2 message sum and the er-gather
// backward, by dst): a block of 128 threads takes a tile of consecutive
// edge rows, one contiguous span of memory (128 rows of 2 KB = 256 KB). A
// thread owns one 16-byte column vector of the row (8 bf16 or 4 f32
// columns; 128 threads cover F = 1024 bf16 in one pass), keeps 8 rows'
// loads in flight and sums them in f32 registers. All threads walk the same
// rows, so a change of key is uniform across the block: the block then
// writes the finished output row once, 16 bytes a thread. A run of rows
// that lies wholly inside the tile is written directly; the tile's first
// run, when it began in an earlier tile, and its last, when it goes on into
// the next, go to f32 carry rows, and a second launch folds each run's
// carries in tile order and writes the row. Tiles are cut by edge rows, not
// by output rows, so a hub (hundreds of edges into one dst) spreads over
// many blocks. Rows that no id names are written as 0 by the tile whose ids
// step over them, and those after the last id by the whole grid: nothing
// memsets the output. The sums come in a fixed order, so two calls give the
// same bits.
//
// Unsorted ids (the el-gather backward, src ids in edge order): sort first,
// by a counting sort written here, then the same reduce reading row perm[i]
// instead of row i; each row is still one contiguous read. Three launches
// build the permutation: count the keys (global atomics on S int counters,
// after a memset) with the exclusive scan in the same launch (the last block
// to finish takes it), place each edge index (an atomic cursor per key),
// then order each key's edge indices ascending (a warp per key ranks them:
// O(n^2 / 32) for a key repeated n times, and src keys repeat at most 20-27
// times on the GATv2 layer-0 block). The placement's order within a key
// varies from call to call, the ordering step removes that: the permutation
// is the stable one, and this route too gives the same bits on every call.
// The scratch (counts, offsets, and three E-int arrays) comes from the
// wrapper. On that block on an H100 this route took 0.083 ms against 0.166
// for the first design's atomics and the cast after them
// (tools/kernel_probe.py k5 on both trees).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;   // threads of a reduce block
constexpr int kMaxTile = 256;   // largest tile of edge rows a block takes
constexpr int kBatch = 8;       // rows whose loads are in flight
constexpr int kFoldCols = 8;    // f32 columns a fold thread owns
constexpr int32_t kPastEnd = INT_MAX;

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

// 16 bytes of one payload row: VEC values, their raw load and f32 sum
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void add(float* acc, Raw r) {
    acc[0] += r.x; acc[1] += r.y; acc[2] += r.z; acc[3] += r.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void add(float* acc, Raw r) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __bfloat1622float2(h[i]);
      acc[2 * i] += q.x;
      acc[2 * i + 1] += q.y;
    }
  }
};

// N f32 sums stored as N output values (N a multiple of 4), rounded once
template <int N>
__device__ __forceinline__ void store_out(float* p, const float* acc) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* acc) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    uint2 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
    h[0] = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    h[1] = __floats2bfloat162_rn(acc[i + 2], acc[i + 3]);
    *reinterpret_cast<uint2*>(p + i) = r;
  }
}

template <int N>
__device__ __forceinline__ void add_f32(float* acc, const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    acc[i] += q.x; acc[i + 1] += q.y; acc[i + 2] += q.z; acc[i + 3] += q.w;
  }
}

// Zeros over rows [lo, hi) of out [*, f] in 16-byte stores by threads i,
// i + step, ... (rows are whole 16-byte vectors: f % 8 == 0).
template <typename O>
__device__ __forceinline__ void zero_rows(O* __restrict__ out, int64_t lo,
                                          int64_t hi, int32_t f, int64_t i,
                                          int64_t step) {
  constexpr int kPer = 16 / sizeof(O);
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t j = lo * (f / kPer) + i; j < hi * (f / kPer); j += step) o[j] = z;
}

// Carry records of tile t: ints[3t] head key (-1: none), ints[3t + 1] 1
// when the head run goes on into tile t + 1, ints[3t + 2] tail key (-1:
// none); vals[(2t) * f ...] and vals[(2t + 1) * f ...] their f32 partial
// rows. A tail record starts a run that crosses tiles; the head records of
// the tiles after it continue it.
//
// One block per tile of rows [r0, r0 + tile_rows) of the valid prefix [0,
// nv) of ids (sorted); the payload row of position r is perm[r], or r when
// perm is null. The grid also zeroes the output rows after the last id.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    rowsum_tiles_kernel(const T* __restrict__ data,
                        const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ perm, int64_t e,
                        int32_t f, const int32_t* __restrict__ n_valid,
                        int32_t s, int32_t tile_rows, O* __restrict__ out,
                        int32_t* __restrict__ c_int, float* __restrict__ c_val) {
  using V = Vec<T>;
  constexpr int VEC = V::kN;
  __shared__ int32_t sh_key[kMaxTile];
  __shared__ int64_t sh_row[kMaxTile];
  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t nv = valid_prefix(e, n_valid);
  const int32_t last = nv > 0 ? ids[nv - 1] : -1;
  const int64_t r0 = tile * tile_rows;
  if (r0 < nv) {  // uniform across the block
    const int64_t r1 = r0 + tile_rows < nv ? r0 + tile_rows : nv;
    const int n_rows = (int)(r1 - r0);
    for (int j = tid; j < n_rows; j += kThreads) {
      sh_key[j] = ids[r0 + j];
      sh_row[j] = perm != nullptr ? (int64_t)perm[r0 + j] : r0 + j;
    }
    const int32_t key_before = r0 > 0 ? ids[r0 - 1] : kPastEnd;
    const int32_t next_key = r1 < nv ? ids[r1] : kPastEnd;
    __syncthreads();
    const int32_t first_key = sh_key[0];
    const int32_t last_key = sh_key[n_rows - 1];
    const bool open_left = r0 > 0 && key_before == first_key;
    const bool open_right = next_key == last_key;
    const bool first_in = first_key >= 0 && first_key < s;
    const bool last_in = last_key >= 0 && last_key < s;
    const bool head_set = open_left && first_in;
    const bool tail_set =
        open_right && last_in && !(open_left && first_key == last_key);
    if (tid == 0) {
      if (!head_set) c_int[3 * tile] = -1;
      if (!tail_set) c_int[3 * tile + 2] = -1;
    }

    // rows stepped over between neighbouring ids are empty: zeros
    auto zero_gap = [&](int32_t a, int32_t b) {  // rows (a, b), clamped
      if (a < b) {
        const int64_t lo = (int64_t)a + 1 > 0 ? (int64_t)a + 1 : 0;
        const int64_t hi = b < s ? b : s;
        if (lo < hi) zero_rows<O>(out, lo, hi, f, tid, kThreads);
      }
    };
    if (r0 == 0) zero_gap(-1, first_key);
    for (int j = 1; j < n_rows; ++j) zero_gap(sh_key[j - 1], sh_key[j]);
    if (r1 < nv) zero_gap(last_key, next_key);

    for (int c0 = 0; c0 < f; c0 += kThreads * VEC) {
      const int col = c0 + tid * VEC;
      const bool live = col < f;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      // a run that ends here: a carry row or a direct write
      auto emit = [&](int32_t key) {
        if (key < 0 || key >= s) return;
        float* carry = nullptr;
        if (key == first_key && open_left) {
          if (tid == 0 && c0 == 0) {
            c_int[3 * tile] = key;
            c_int[3 * tile + 1] = key == last_key && open_right;
          }
          carry = c_val + (2 * tile) * f;
        } else if (key == last_key && open_right) {
          if (tid == 0 && c0 == 0) c_int[3 * tile + 2] = key;
          carry = c_val + (2 * tile + 1) * f;
        }
        if (!live) return;
        if (carry) store_out<VEC>(carry + col, acc);
        else store_out<VEC>(out + (int64_t)key * f + col, acc);
      };
      int32_t cur = first_key;
      for (int jb = 0; jb < n_rows; jb += kBatch) {
        typename V::Raw raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (jb + u < n_rows && live)
            raw[u] = V::load(data + sh_row[jb + u] * f + col);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (jb + u < n_rows) {
            const int32_t key = sh_key[jb + u];
            if (key != cur) {
              emit(cur);
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
              cur = key;
            }
            if (live) V::add(acc, raw[u]);
          }
        }
      }
      emit(cur);
    }
  }
  // the rows after the last id (all of them when nv is 0) are empty: the
  // whole grid writes their zeros
  const int64_t lo = last < 0 ? 0 : (last < s ? (int64_t)last + 1 : s);
  zero_rows<O>(out, lo, s, f, (int64_t)blockIdx.x * kThreads + tid,
               (int64_t)gridDim.x * kThreads);
}

// One block per tile that starts a run crossing tiles: its tail row plus the
// head rows of the tiles after it, in tile order, written once.
template <typename O>
__global__ void __launch_bounds__(kThreads)
    rowsum_fold_kernel(const int32_t* __restrict__ c_int,
                       const float* __restrict__ c_val, int64_t e, int32_t f,
                       const int32_t* __restrict__ n_valid, int32_t tile_rows,
                       O* __restrict__ out) {
  __shared__ int64_t stop_at;
  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t n_tiles = (valid_prefix(e, n_valid) + tile_rows - 1) / tile_rows;
  if (tile >= n_tiles) return;
  const int32_t key = c_int[3 * tile + 2];
  if (key < 0) return;
  // the run's last tile: the first after this one whose head run stops
  int64_t end = n_tiles - 1;
  for (int64_t b = tile + 1; b < n_tiles; b += kThreads) {
    if (tid == 0) stop_at = INT64_MAX;
    __syncthreads();
    const int64_t t = b + tid;
    if (t < n_tiles && c_int[3 * t + 1] == 0) atomicMin(
        reinterpret_cast<unsigned long long*>(&stop_at), (unsigned long long)t);
    __syncthreads();
    const int64_t found = stop_at;
    __syncthreads();
    if (found != INT64_MAX) {
      end = found;
      break;
    }
  }
  for (int c0 = 0; c0 < f; c0 += kThreads * kFoldCols) {
    const int col = c0 + tid * kFoldCols;
    if (col >= f) break;
    float acc[kFoldCols];
#pragma unroll
    for (int i = 0; i < kFoldCols; ++i) acc[i] = 0.0f;
    add_f32<kFoldCols>(acc, c_val + (2 * tile + 1) * f + col);
#pragma unroll 4
    for (int64_t t = tile + 1; t <= end; ++t)
      add_f32<kFoldCols>(acc, c_val + (2 * t) * f + col);
    store_out<kFoldCols>(out + (int64_t)key * f + col, acc);
  }
}

// Counting sort, step 1, with step 2 in the same launch: counts[k] = ids of
// the valid prefix equal to k, then the last block to finish (a ticket in
// counts[s]) takes the exclusive scan: offsets[k] = sum of counts[< k], for
// k in [0, s]; offsets[s] is the number of edges placed.
constexpr int kCountThreads = 256;
constexpr int kScanPer = 8;  // counts a thread sums per pass
__global__ void __launch_bounds__(kCountThreads)
    count_scan_kernel(const int32_t* __restrict__ ids, int64_t e,
                      const int32_t* __restrict__ n_valid, int32_t s,
                      int32_t* __restrict__ counts,
                      int32_t* __restrict__ offsets) {
  constexpr int kWarps = kCountThreads / 32;
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t carry_in;
  __shared__ bool last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t nv = valid_prefix(e, n_valid);
  const int64_t step = (int64_t)gridDim.x * kCountThreads;
  for (int64_t i = (int64_t)blockIdx.x * kCountThreads + tid; i < nv;
       i += step) {
    const int32_t k = ids[i];
    if (k >= 0 && k < s) atomicAdd(counts + k, 1);
  }
  __threadfence();  // this block's counts land before its ticket
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(counts + s, 1) == (int32_t)gridDim.x - 1;
    carry_in = 0;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int64_t base = 0; base < s; base += kCountThreads * kScanPer) {
    const int64_t k0 = base + (int64_t)tid * kScanPer;
    int32_t v[kScanPer];
    int32_t mine = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      v[i] = k0 + i < s ? __ldcg(counts + k0 + i) : 0;
      mine += v[i];
    }
    int32_t incl = mine;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int32_t before = carry_in;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    int32_t run = before + incl - mine;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      if (k0 + i < s) offsets[k0 + i] = run;
      run += v[i];
    }
    __syncthreads();  // every thread has read carry_in and warp_sum
    if (tid == kCountThreads - 1) carry_in = run;
    __syncthreads();
  }
  if (tid == 0) offsets[s] = carry_in;
}

// Step 3: each valid edge index i with key k in [0, s) goes to a free slot
// of k's range; counts[k] counts down to 0 as the slots fill. keys[slot] =
// k. The order within a range is the atomics' and varies.
__global__ void place_kernel(const int32_t* __restrict__ ids, int64_t e,
                             const int32_t* __restrict__ n_valid, int32_t s,
                             const int32_t* __restrict__ offsets,
                             int32_t* __restrict__ counts,
                             int32_t* __restrict__ slots,
                             int32_t* __restrict__ keys) {
  const int64_t nv = valid_prefix(e, n_valid);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += step) {
    const int32_t k = ids[i];
    if (k < 0 || k >= s) continue;
    const int32_t at = offsets[k] + atomicSub(counts + k, 1) - 1;
    slots[at] = (int32_t)i;
    keys[at] = k;
  }
}

// Step 4, a warp per key: the key's edge indices (distinct) in ascending
// order, each written at its rank, so the permutation is the stable one.
constexpr int kOrderWarps = 8;
__global__ void __launch_bounds__(kOrderWarps * 32)
    order_kernel(const int32_t* __restrict__ offsets, int32_t s,
                 const int32_t* __restrict__ slots,
                 int32_t* __restrict__ perm) {
  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * kOrderWarps + (threadIdx.x >> 5);
  if (k >= s) return;
  const int64_t lo = offsets[k];
  const int64_t n = offsets[k + 1] - lo;
  for (int64_t a = 0; a < n; a += 32) {
    const int32_t v = a + lane < n ? slots[lo + a + lane] : kPastEnd;
    int32_t rank = 0;
    for (int64_t b = 0; b < n; b += 32) {
      const int32_t w = b == a ? v : (b + lane < n ? slots[lo + b + lane] : kPastEnd);
#pragma unroll
      for (int j = 0; j < 32; ++j) rank += __shfl_sync(kFull, w, j) < v;
    }
    if (a + lane < n) perm[lo + rank] = v;
  }
}

long long grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return blocks > 8192 ? 8192 : blocks;
}

long long tiles_for(long long e, int tile_rows) {
  const long long t = (e + tile_rows - 1) / tile_rows;
  return t < 1 ? 1 : t;
}

template <typename T, typename O>
void launch_tiles(const void* data, const void* ids, const void* perm,
                  long long e, int f, const void* n_valid, int s, void* out,
                  void* c_int, void* c_val, int tile_rows, cudaStream_t st) {
  rowsum_tiles_kernel<T, O><<<(unsigned)tiles_for(e, tile_rows), kThreads, 0, st>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(perm), (int64_t)e, (int32_t)f,
      static_cast<const int32_t*>(n_valid), (int32_t)s, (int32_t)tile_rows,
      static_cast<O*>(out), static_cast<int32_t*>(c_int),
      static_cast<float*>(c_val));
}

bool shape_ok(int dtype, int out_dtype, int f, int tile_rows) {
  return (dtype == 0 || dtype == 1) && (out_dtype == 0 || out_dtype == 1) &&
         f > 0 && f % 8 == 0 && tile_rows >= 1 && tile_rows <= kMaxTile;
}

}  // namespace

// The reduce's first launch over keys ids[0, *n_valid) (non-decreasing; the
// valid prefix is all of e when n_valid is null), reading payload row
// perm[r] for position r (r when perm is null). dtype / out_dtype 0: f32,
// 1: bf16. f % 8 == 0, data and out 16-byte aligned. Runs that cross tiles
// are left as f32 carry records in c_int (int32 [3 * n_tiles]) and c_val
// (f32 [2 * n_tiles * f]), n_tiles = ceil(e / tile_rows) (at least 1), for
// bliss_row_scatter_fold. Returns cudaGetLastError().
extern "C" int bliss_row_scatter_tiles(const void* data, int dtype,
                                       const void* ids, const void* perm,
                                       long long e, int f, const void* n_valid,
                                       int s, void* out, int out_dtype,
                                       void* c_int, void* c_val,
                                       long long n_tiles, int tile_rows,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(dtype, out_dtype, f, tile_rows) || n_tiles < tiles_for(e, tile_rows))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0)
    launch_tiles<float, float>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, tile_rows, st);
  else if (dtype == 0)
    launch_tiles<float, __nv_bfloat16>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, tile_rows, st);
  else if (out_dtype == 0)
    launch_tiles<__nv_bfloat16, float>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, tile_rows, st);
  else
    launch_tiles<__nv_bfloat16, __nv_bfloat16>(data, ids, perm, e, f, n_valid, s, out, c_int, c_val, tile_rows, st);
  return (int)cudaGetLastError();
}

// The reduce's second launch: folds each run of rows that crosses tiles into
// its output row, in tile order, rounded once. The arguments are the first
// launch's. Returns cudaGetLastError().
extern "C" int bliss_row_scatter_fold(const void* c_int, const void* c_val,
                                      long long e, int f, const void* n_valid,
                                      void* out, int out_dtype, int tile_rows,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(0, out_dtype, f, tile_rows)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)tiles_for(e, tile_rows);
  const int32_t* ci = static_cast<const int32_t*>(c_int);
  const float* cv = static_cast<const float*>(c_val);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  if (out_dtype == 0)
    rowsum_fold_kernel<float><<<blocks, kThreads, 0, st>>>(
        ci, cv, (int64_t)e, (int32_t)f, nv, (int32_t)tile_rows,
        static_cast<float*>(out));
  else
    rowsum_fold_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        ci, cv, (int64_t)e, (int32_t)f, nv, (int32_t)tile_rows,
        static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// Counting sort, steps 1 and 2 in one launch: counts (int32 [s + 1]) = 0,
// then the count of each key of ids[0, *n_valid) in [0, s) (counts[s] is
// the blocks' ticket), and offsets (int32 [s + 1]) their exclusive scan,
// offsets[s] the total. n_valid may be null. Returns cudaGetLastError().
extern "C" int bliss_row_scatter_count(const void* ids, long long e,
                                       const void* n_valid, int s,
                                       void* counts, void* offsets,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int32_t) * ((size_t)s + 1), st);
  if (err != cudaSuccess) return (int)err;
  count_scan_kernel<<<(unsigned)grid_for(e, kCountThreads), kCountThreads, 0,
                      st>>>(
      static_cast<const int32_t*>(ids), (int64_t)e,
      static_cast<const int32_t*>(n_valid), (int32_t)s,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(offsets));
  return (int)cudaGetLastError();
}

// Step 3: slots and keys (int32 [e] each; the first offsets[s] are written)
// hold each placed edge index and its key, grouped by key; counts is spent
// (left at 0). The arguments are steps 1 and 2's. Returns
// cudaGetLastError().
extern "C" int bliss_row_scatter_place(const void* ids, long long e,
                                       const void* n_valid, int s,
                                       const void* offsets, void* counts,
                                       void* slots, void* keys, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1) return (int)cudaErrorInvalidValue;
  place_kernel<<<(unsigned)grid_for(e, 256), 256, 0, st>>>(
      static_cast<const int32_t*>(ids), (int64_t)e,
      static_cast<const int32_t*>(n_valid), (int32_t)s,
      static_cast<const int32_t*>(offsets), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(slots), static_cast<int32_t*>(keys));
  return (int)cudaGetLastError();
}

// Step 4: perm (int32 [e]; the first offsets[s] are written) = slots with
// each key's edge indices in ascending order. Returns cudaGetLastError().
extern "C" int bliss_row_scatter_order(const void* offsets, int s,
                                       const void* slots, void* perm,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((s + kOrderWarps - 1) / kOrderWarps);
  order_kernel<<<blocks, kOrderWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(offsets), (int32_t)s,
      static_cast<const int32_t*>(slots), static_cast<int32_t*>(perm));
  return (int)cudaGetLastError();
}
