// K1: scatter-add of a 1-D f32 payload, out[keys[i]] += vals[i].
//
// Replaces bliss_gnn_tpu/ops/scatter_pallas.py banked_scatter_add (kernel
// body _kernel). On the TPU the accumulator sat in VMEM as 16 banks so that
// consecutive read-modify-writes pipelined. Hopper takes two routes.
//
// Unsorted keys (the importance sum by src candidate, GCN's out-degrees):
// hardware f32 atomics in L2. Bound: bytes on paper (each valid element
// reads a 4-byte key and a 4-byte value, each output is written once), in
// practice the L2's rate of atomics to random addresses: on an H100 the
// same red.global.add.f32s with no payload loads take as long
// (tools/kernel_probe.py k1). A grid-stride loop reads keys and values
// once, coalesced, stops at the caller's device-side n_valid (no host
// sync), and issues no atomic for a zero value: masked slots carry value 0
// at key 0, so skipping zeros also removes the contention those slots would
// cause on out[0].
//
// Keys sorted on the valid prefix (the per-dst sums of a block, whose edges
// are dst-sorted, and the per-seed sums of frontier chunks): a reduce by key
// in one launch, with no atomics, no memset, no scratch, and the same bits
// on every call. At the main path's sizes (16k-60k keys) it is bound by
// latency, not bytes: the launch and each warp's chain of dependent steps.
// So a warp takes a short tile, 128 keys, 4 consecutive per lane read as
// one 16-byte load (scalar loads where the arrays are not 16-byte aligned
// and in the lane that holds n_valid; on an H100 the block sums took 1.4x
// as long with 2 per lane, 2.5x with 1 and 1.6x with 16, by
// tools/kernel_probe.py k1), and issues every load of the tile at once. Each lane sums the runs of equal keys in its 4; a segmented scan
// over the lanes (shuffles, a fixed order) joins the runs that cross lanes.
// A run is written once, by the warp whose tile holds its first key: a run
// that goes on past the tile's end is finished by that warp, which reads on
// (the 32 keys after the tile, loaded with it, then 128 a step) until the
// key changes; a tile whose first run began earlier leaves it to that warp.
// At 8 bytes a key a run of a few thousand keys costs its owner a few
// steps, so a carry fold's second launch is not worth it; a hub row that
// holds most keys costs one warp one step per 128 of them. Rows that no key
// names are written as 0 by the tile whose keys step over them, and those
// after the last key by the whole grid.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                // warps per block, sorted route
constexpr int kPerLane = 4;              // keys per lane
constexpr int kTile = 32 * kPerLane;     // keys per warp tile
constexpr int32_t kPastEnd = INT_MAX;    // key of the slots past n_valid

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

__global__ void scatter_add_f32_kernel(const int32_t* __restrict__ keys,
                                       const float* __restrict__ vals,
                                       float* __restrict__ out, int64_t n,
                                       const int32_t* __restrict__ n_valid,
                                       int32_t n_out) {
  const int64_t nv = valid_prefix(n, n_valid);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const float v = vals[i];
    const int32_t k = keys[i];
    if (v != 0.0f && k >= 0 && k < n_out) atomicAdd(out + k, v);
  }
}

// One lane's kPerLane keys and values from p0: 16-byte loads when all are
// valid and the arrays aligned, else scalar loads; past nv, key kPastEnd
// and value 0.
template <bool kVec>
__device__ __forceinline__ void load_lane(const int32_t* __restrict__ keys,
                                          const float* __restrict__ vals,
                                          int64_t p0, int64_t nv,
                                          int32_t (&k)[kPerLane],
                                          float (&v)[kPerLane]) {
  if (kVec && kPerLane % 4 == 0 && p0 + kPerLane <= nv) {
    const int4* kp = reinterpret_cast<const int4*>(keys + p0);
    const float4* vp = reinterpret_cast<const float4*>(vals + p0);
#pragma unroll
    for (int j = 0; j < kPerLane / 4; ++j) {
      const int4 a = kp[j];
      const float4 b = vp[j];
      k[4 * j] = a.x; k[4 * j + 1] = a.y; k[4 * j + 2] = a.z; k[4 * j + 3] = a.w;
      v[4 * j] = b.x; v[4 * j + 1] = b.y; v[4 * j + 2] = b.z; v[4 * j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const bool live = p0 + j < nv;
      k[j] = live ? keys[p0 + j] : kPastEnd;
      v[j] = live ? vals[p0 + j] : 0.0f;
    }
  }
}

// Zeros over out[lo, hi) of every lane, written by the whole warp, one
// lane's range after another.
__device__ __forceinline__ void warp_zero(float* __restrict__ out, int64_t lo,
                                          int64_t hi, int lane) {
  unsigned pending = __ballot_sync(kFull, lo < hi);
  while (pending) {
    const int src = __ffs(pending) - 1;
    const int64_t a = __shfl_sync(kFull, lo, src);
    const int64_t b = __shfl_sync(kFull, hi, src);
    for (int64_t i = a + lane; i < b; i += 32) out[i] = 0.0f;
    pending &= pending - 1;
  }
}

// One warp's tile [t0, t0 + 128) of the valid prefix [0, nv). Every load
// is issued at once: the tile's keys and values, the key before the tile,
// and the 32 keys and values after it, where most runs that go on past the
// tile end; the tile's boundary keys then come from shuffles.
template <bool kVec>
__device__ __forceinline__ void sorted_tile(const int32_t* __restrict__ keys,
                                            const float* __restrict__ vals,
                                            int64_t t0, int64_t nv,
                                            int32_t n_out,
                                            float* __restrict__ out,
                                            int lane) {
  const int64_t t1 = t0 + kTile < nv ? t0 + kTile : nv;
  const int64_t p0 = t0 + (int64_t)lane * kPerLane;
  int32_t k[kPerLane];
  float v[kPerLane];
  load_lane<kVec>(keys, vals, p0, nv, k, v);
  const int32_t key_before = t0 > 0 ? keys[t0 - 1] : kPastEnd;
  const int64_t q = t1 + lane;  // t1 < nv only when the tile is whole
  const bool q_live = t1 < nv && q < nv;
  const int32_t k_after = q_live ? keys[q] : kPastEnd;
  const float v_after = q_live ? vals[q] : 0.0f;

  int32_t lane_last = INT_MIN;  // the lane's last valid key (they are sorted)
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (p0 + j < nv) lane_last = k[j];
  const int32_t first_key = __shfl_sync(kFull, k[0], 0);
  const int32_t last_key = __reduce_max_sync(kFull, lane_last);
  const bool open_left = t0 > 0 && key_before == first_key;
  const int32_t next_key = __shfl_sync(kFull, k_after, 0);
  const bool open_right = next_key == last_key;
  // this warp finishes the tile's last run past the tile's end
  const bool reads_on = open_right && last_key >= 0 && last_key < n_out &&
                        !(open_left && first_key == last_key);

  // a run that ends here, with its total over the tile: written once, left
  // to the warp that holds its first key, or (the run that goes on) kept
  float tail = 0.0f;
  auto emit = [&](int32_t key, float s) {
    if (key < 0 || key >= n_out || (key == first_key && open_left)) return;
    if (key == last_key && open_right) tail = s;
    else out[key] = s;
  };

  // rows stepped over between two neighbouring keys are empty: zeros (those
  // after the last key are written by the whole grid)
  const int32_t prev_lane_last = __shfl_up_sync(kFull, k[kPerLane - 1], 1);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    int64_t lo = n_out, hi = n_out;
    int32_t before = j > 0 ? k[j - 1] : prev_lane_last;
    const bool step = j > 0 || lane > 0 || t0 == 0;
    if (j == 0 && lane == 0) before = -1;  // rows before the first key
    if (step && p0 + j < nv && before < k[j]) {
      lo = (int64_t)before + 1 > 0 ? (int64_t)before + 1 : 0;
      hi = k[j] < n_out ? k[j] : n_out;
    }
    warp_zero(out, lo, hi, lane);
  }
  {  // from the tile's last key to the next tile's first
    int64_t lo = n_out, hi = n_out;
    if (lane == 31 && t1 < nv && k[kPerLane - 1] < next_key) {
      lo = (int64_t)k[kPerLane - 1] + 1 > 0 ? (int64_t)k[kPerLane - 1] + 1 : 0;
      hi = next_key < n_out ? next_key : n_out;
    }
    warp_zero(out, lo, hi, lane);
  }

  // runs inside the lane; middle runs are whole and are written here
  float head = 0.0f, cur = 0.0f;
  int32_t cur_key = k[0];
  bool multi = false;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (k[j] != cur_key) {
      if (multi) emit(cur_key, cur);
      else head = cur;
      multi = true;
      cur_key = k[j];
      cur = 0.0f;
    }
    cur += v[j];
  }
  const int32_t lane_first = k[0];
  // segmented inclusive scan of the lanes' last runs, in a fixed order
  const int32_t up_last = __shfl_up_sync(kFull, cur_key, 1);
  float scan = cur;
  int starts = multi || lane == 0 || up_last != lane_first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float s_up = __shfl_up_sync(kFull, scan, o);
    const int f_up = __shfl_up_sync(kFull, starts, o);
    if (lane >= o) {
      if (!starts) scan = s_up + scan;
      starts = starts | f_up;
    }
  }
  const float carry_in = __shfl_up_sync(kFull, scan, 1);
  const int32_t down_first = __shfl_down_sync(kFull, lane_first, 1);
  const bool ends_here = lane == 31 || down_first != cur_key;
  if (multi) {
    // the lane's first run ends inside it; its last may go on
    emit(lane_first, (lane > 0 && up_last == lane_first ? carry_in : 0.0f) + head);
    if (ends_here) emit(cur_key, cur);
  } else if (ends_here) {
    emit(cur_key, scan);
  }

  if (!reads_on) return;
  // the last run goes on past the tile (it ends at lane 31): first the 32
  // keys after the tile, already loaded, then 128 a step, each step's part
  // of the run summed in a fixed order
  float acc = __shfl_sync(kFull, tail, 31);
  const bool in_run = k_after == last_key;
  float part = in_run ? v_after : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
  acc += __shfl_sync(kFull, part, 0);
  if (__ballot_sync(kFull, in_run) == kFull) {
    for (int64_t c = t1 + 32; c < nv; c += kTile) {
      load_lane<kVec>(keys, vals, c + (int64_t)lane * kPerLane, nv, k, v);
      part = 0.0f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) part += k[j] == last_key ? v[j] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
      acc += __shfl_sync(kFull, part, 0);
      const int64_t c1 = c + kTile < nv ? c + kTile : nv;
      if (keys[c1 - 1] != last_key) break;  // the run ends in this step
    }
  }
  if (lane == 0) out[last_key] = acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    scatter_add_sorted_kernel(const int32_t* __restrict__ keys,
                              const float* __restrict__ vals, int64_t n,
                              const int32_t* __restrict__ n_valid,
                              int32_t n_out, float* __restrict__ out) {
  const int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t nv = valid_prefix(n, n_valid);
  const int32_t last = nv > 0 ? keys[nv - 1] : -1;  // loaded with the tile's
  if (tile * kTile < nv)  // the whole warp takes the tile, or none of it
    sorted_tile<kVec>(keys, vals, tile * kTile, nv, n_out, out,
                      threadIdx.x & 31);
  // the rows after the last key (all of them when nv is 0) are empty: the
  // whole grid writes their zeros
  const int64_t lo = last < 0 ? 0 : (last < n_out ? (int64_t)last + 1 : n_out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = lo + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride)
    out[i] = 0.0f;
}

unsigned sorted_grid(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Unsorted keys: out[n_out] = 0; out[keys[i]] += vals[i] for i < min(n,
// *n_valid). n_valid may be null (all n elements). Returns
// cudaGetLastError().
extern "C" int bliss_scatter_add_f32(const void* keys, const void* vals,
                                     void* out, long long n,
                                     const void* n_valid, int n_out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_out, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 8192) blocks = 8192;
    scatter_add_f32_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
        static_cast<float*>(out), (int64_t)n,
        static_cast<const int32_t*>(n_valid), (int32_t)n_out);
  }
  return (int)cudaGetLastError();
}

// The same sum with keys non-decreasing on [0, *n_valid): one launch, no
// atomics, no memset, every output written once. n_valid must not be null.
// vec: keys and vals are 16-byte aligned. Returns cudaGetLastError().
extern "C" int bliss_scatter_add_sorted_f32(const void* keys, const void* vals,
                                            void* out, long long n,
                                            const void* n_valid, int n_out,
                                            int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_valid == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = sorted_grid(n);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const float* v = static_cast<const float*>(vals);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  float* o = static_cast<float*>(out);
  if (vec)
    scatter_add_sorted_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        k, v, (int64_t)n, nv, (int32_t)n_out, o);
  else
    scatter_add_sorted_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        k, v, (int64_t)n, nv, (int32_t)n_out, o);
  return (int)cudaGetLastError();
}
