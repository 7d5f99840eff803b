// The sampler's Poisson fixed point (sampling/samplers.py, the Poisson
// kinds; its plain version is ops/poisson.py poisson_scale_plain): the
// scale c with sum over the candidates of min(c * q_j, 1) ~= num, found by
// at most `iters` rescalings c <- c * num / s, then the inclusion
// probabilities p_j = min(c * q_j, 1), seeds forced to 1, every slot 1
// when the layer has n <= num candidates, masked slots 0.
//
// Replaces no TPU kernel: the JAX package leaves the loop to XLA. On the
// card the plain version is ~19 small PyTorch operations an iteration, 50
// iterations, one layer after another: ~2,900 nodes of the replayed step's
// CUDA graph, each a microsecond of launch latency, to reduce under 1 MB
// (on an H100 the Reddit-shaped three-layer step's graph fell from 4,255
// nodes to 1,378 with this kernel). Here one launch does the whole loop
// and its epilogue.
//
// Design. A cluster of K blocks of 1024 threads; block r owns the slice
// [r * per, (r + 1) * per) of the candidates. Each iteration every block
// sums min(q * c, 1) over its slice (one partial a thread in a fixed slot
// order, then warp shuffles, then the block), publishes the block's partial
// in its shared memory and crosses one cluster barrier; then every warp
// reads the K partials through distributed shared memory and adds them in
// rank order. So every thread of every block holds the same bits of s, c
// and `done`, they leave the loop at the same iteration, and two calls
// give the same bits (no atomics). The partial slot alternates by
// iteration parity, so one barrier an iteration suffices: a block writes a
// slot again only after every block has passed the barrier that follows
// its reads of it.
//
// Where the slice lives is chosen by the wrapper from c_cap alone
// (ops/poisson.py poisson_route): in shared memory, loaded once with the
// mask folded in (each thread keeps its own slots' mask bits in a 64-bit
// register), when it fits (one block up to 57,344 candidates, a cluster
// of 16 up to 917,504); beyond that 16 blocks run the same loop and read
// q and the mask from global memory (L2) every iteration.
//
// The arithmetic follows the plain version statement by statement, in
// f32: s = sum_mask min(q * c, 1); ratio = min(s, num) / max(s, num,
// 1e-30); hit = ratio >= eps; c stays on a hit or when s <= 0, else c =
// (c * num) / max(s, 1e-30). On a hit c is frozen for good, so the loop
// ends there: the plain version's c. When s <= 0 without a hit, c stays
// and every later iteration would read the same s, so the loop ends too.
// Clamps are written `x > 1 ? 1 : x`, so a NaN passes as torch.clamp
// passes it. Only the order of the f32 sum differs from the plain version.
// iters_out[0] is the iteration at which the hit came (0-based), `iters`
// if none did.
//
// Bound: c_cap * 6 bytes read once (q f32, mask and is_seed u8), c_cap * 4
// written; per iteration one reduce of the on-chip slice and one cluster
// barrier, a few microseconds.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// the most candidates a block holds in shared memory: 56 a thread, 229,376
// bytes of the H100's 232,448 a block may opt into (ops/poisson.py)
constexpr int kSlotsPerThread = 56;
constexpr int kSliceMax = kThreads * kSlotsPerThread;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float min1(float x) { return x > 1.f ? 1.f : x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kStreamed>
__global__ void __launch_bounds__(kThreads, 1)
    poisson_scale_kernel(const float* __restrict__ prob,
                         const uint8_t* __restrict__ mask,
                         const uint8_t* __restrict__ is_seed,
                         const int* __restrict__ n_cand, float* __restrict__ p,
                         int* __restrict__ iters_out, int c_cap, int per,
                         int num, float eps, int iters) {
  extern __shared__ float slice[];  // the shared-memory route's slots
  __shared__ float warp_part[kWarps];
  __shared__ float part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int begin = rank * per;
  const int len = max(min(begin + per, c_cap) - begin, 0);
  const int nj = (len + kThreads - 1) / kThreads;  // slots of this thread
  const float numf = static_cast<float>(num);

  // a thread reads back only the slots it wrote: no barrier needed
  unsigned long long bits = 0;
  if (!kStreamed) {
    for (int j = 0; j < nj; ++j) {
      const int i = t + j * kThreads;
      if (i < len) {
        const bool m = mask[begin + i] != 0;
        slice[i] = m ? prob[begin + i] : 0.f;
        bits |= static_cast<unsigned long long>(m) << j;
      }
    }
  }

  float c = 1.f;
  int hit_at = iters;
  for (int it = 0; it < iters; ++it) {
    float acc = 0.f;
    if (kStreamed) {
      // both loads issued unconditionally, four slots ahead
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const int i = t + j * kThreads;
        if (i < len) {
          const float q = prob[begin + i];
          if (mask[begin + i]) acc += min1(q * c);
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        if ((bits >> j) & 1ull) acc += min1(slice[t + j * kThreads] * c);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      const float v = warp_sum(warp_part[lane]);
      if (lane == 0) part[it & 1] = v;
    }
    cluster.sync();
    // lane r fetches block r's partial; every lane adds them in rank order
    const float mine =
        lane < k ? *cluster.map_shared_rank(&part[it & 1], lane) : 0.f;
    float s = __shfl_sync(0xffffffffu, mine, 0);
    for (int r = 1; r < k; ++r) s += __shfl_sync(0xffffffffu, mine, r);

    const float lo = s > numf ? numf : s;
    float hi = s < numf ? numf : s;
    hi = hi < 1e-30f ? 1e-30f : hi;
    if (lo / hi >= eps) {
      hit_at = it;
      break;
    }
    if (s <= 0.f) break;
    c = c * numf / (s < 1e-30f ? 1e-30f : s);
  }
  // no block may leave while another can still read its partials
  cluster.sync();

  const bool all_one = n_cand[0] <= num;
  for (int j = 0; j < nj; ++j) {
    const int i = t + j * kThreads;
    if (i >= len) break;
    const int g = begin + i;
    bool m;
    float q;
    if (kStreamed) {
      m = mask[g] != 0;
      q = prob[g];
    } else {
      m = (bits >> j) & 1ull;
      q = slice[i];
    }
    float v = min1(q * c);
    if (is_seed[g] || all_one) v = 1.f;
    p[g] = m ? v : 0.f;
  }
  if (rank == 0 && t == 0) iters_out[0] = hit_at;
}

template <bool kStreamed>
cudaError_t launch(const float* prob, const uint8_t* mask,
                   const uint8_t* is_seed, const int* n_cand, float* p,
                   int* iters_out, int c_cap, int ctas, int num, float eps,
                   int iters, cudaStream_t stream) {
  auto kernel = poisson_scale_kernel<kStreamed>;
  // once per card: the shared-memory opt-in and clusters of 16
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStreamed ? 0 : kSliceMax * 4);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int per = (c_cap + ctas - 1) / ctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kStreamed ? 0 : static_cast<size_t>(per) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, prob, mask, is_seed, n_cand, p,
                            iters_out, c_cap, per, num, eps, iters);
}

}  // namespace

// prob f32 [c_cap], mask and is_seed bool [c_cap], n_cand int32 [1] (the
// layer's candidate count); writes p f32 [c_cap] and iters_out int32 [1].
// ctas in 1..16; streamed 0 needs ceil(c_cap / ctas) <= 57,344.
extern "C" int bliss_poisson_scale(void* prob, void* mask, void* is_seed,
                                   void* n_cand, void* p, void* iters_out,
                                   int c_cap, int ctas, int streamed, int num,
                                   float eps, int iters, void* stream) {
  if (ctas < 1 || ctas > kMaxCluster || c_cap < 0 ||
      (!streamed && (c_cap + ctas - 1) / ctas > kSliceMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(prob);
  auto m = static_cast<const uint8_t*>(mask);
  auto seed = static_cast<const uint8_t*>(is_seed);
  auto n = static_cast<const int*>(n_cand);
  auto out = static_cast<float*>(p);
  auto it = static_cast<int*>(iters_out);
  cudaError_t err =
      streamed ? launch<true>(q, m, seed, n, out, it, c_cap, ctas, num, eps,
                              iters, s)
               : launch<false>(q, m, seed, n, out, it, c_cap, ctas, num, eps,
                               iters, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
