// K4: sparse multiplicative update of the EXP3 arm-weight state (bf16 or
// f32), state[idx] *= mult, where duplicate indices compose
// multiplicatively.
//
// Replaces bliss_gnn_tpu/ops/exp3_pallas.py exp3_apply_streaming (kernel
// body _apply_kernel). The TPU streamed the whole [L, R, 128] state through
// VMEM tile by tile (about 690 MB read and written per step at Reddit
// scale) because it had no fast sparse read-modify-write; it needed each
// tile's updates as one contiguous run of a sorted stream, and it skipped
// updates past a fixed run window. Hopper has atomic read-modify-write on
// device memory, so here only the touched entries move and nothing is
// sorted.
//
// Bound: bytes. Each update slot reads a 4-byte index and a 4-byte factor,
// and each touched entry is read and written once (2 + 2 bytes). One thread
// per slot: a slot whose index lies in [0, limit) applies its factor to its
// bf16 entry with a 16-bit atomicCAS loop (read the bits, compute
// bf16(f32(old) * mult) rounded to nearest even, swap until no other slot
// got in between). Slots outside [0, limit) are no-ops. With distinct
// indices this is one f32 multiply and one rounding per entry, bit for bit
// the plain version's. An index repeated m times rounds after each of its
// m updates, in the hardware's order, as the TPU kernel's sequential
// in-tile update did: within m - 1 bf16 ulps of one rounding of the f32
// product. Nothing is ever skipped, so there is no overflow count.
//
// The f32 route (an f32 state, as the TPU kernel's body takes any dtype) is
// the same design at 32 bits: each slot runs a 32-bit atomicCAS loop on the
// entry's bits, computing old * mult in f32 with one rounding. Its bound is
// 8 bytes per slot plus 8 per touched entry; an index repeated m times is
// within m - 1 f32 ulps of one rounding of the product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void exp3_apply_kernel(unsigned short* state,
                                  const int32_t* __restrict__ idx,
                                  const float* __restrict__ mult, int64_t u,
                                  int32_t limit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t k = __ldg(idx + i);
    if (k < 0 || k >= limit) continue;
    const float f = __ldg(mult + i);
    unsigned short* p = state + k;
    unsigned short seen, old = __ldcg(p);
    do {
      seen = old;
      const float v = __bfloat162float(__ushort_as_bfloat16(seen)) * f;
      old = atomicCAS(p, seen, __bfloat16_as_ushort(__float2bfloat16_rn(v)));
    } while (old != seen);
  }
}

__global__ void exp3_apply_f32_kernel(unsigned int* state,
                                      const int32_t* __restrict__ idx,
                                      const float* __restrict__ mult,
                                      int64_t u, int32_t limit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t k = __ldg(idx + i);
    if (k < 0 || k >= limit) continue;
    const float f = __ldg(mult + i);
    unsigned int* p = state + k;
    unsigned int seen, old = __ldcg(p);
    do {
      seen = old;
      const float v = __fmul_rn(__uint_as_float(seen), f);
      old = atomicCAS(p, seen, __float_as_uint(v));
    } while (old != seen);
  }
}

template <typename T, typename W>
__device__ __forceinline__ T apply_product(T old, W prod);

template <>
__device__ __forceinline__ unsigned short apply_product(unsigned short old,
                                                        float prod) {
  const float v = __bfloat162float(__ushort_as_bfloat16(old)) * prod;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ unsigned int apply_product(unsigned int old,
                                                      double prod) {
  return __float_as_uint(
      __double2float_rn(__dmul_rn((double)__uint_as_float(old), prod)));
}

// s_idx: the flat indices sorted (stable); order: each sorted slot's place
// in the list, so mult[order[j]] is its factor.
template <typename T, typename W>
__global__ void exp3_apply_runs_kernel(T* state,
                                       const int32_t* __restrict__ s_idx,
                                       const int64_t* __restrict__ order,
                                       const float* __restrict__ mult,
                                       int64_t u, int32_t limit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t k = __ldg(s_idx + i);
    if (k < 0 || k >= limit) continue;
    if (i > 0 && __ldg(s_idx + i - 1) == k) continue;  // not a run's head
    W prod = (W)__ldg(mult + __ldg(order + i));
    for (int64_t j = i + 1; j < u && __ldg(s_idx + j) == k; ++j) {
      prod *= (W)__ldg(mult + __ldg(order + j));
    }
    state[k] = apply_product<T, W>(state[k], prod);
  }
}

long long grid_for(long long u, int threads) {
  long long blocks = (u + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 8192) blocks = 8192;
  return blocks;
}

}  // namespace

// state: flat bf16 [>= limit]; idx: int32 [u]; mult: f32 [u]. Updates state
// in place, in one launch (one block when u is 0). Returns
// cudaGetLastError().
extern "C" int bliss_exp3_apply(void* state, const void* idx, const void* mult,
                                long long u, int limit, void* stream) {
  const int threads = 256;
  exp3_apply_kernel<<<(unsigned)grid_for(u, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(state), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mult), (int64_t)u, (int32_t)limit);
  return (int)cudaGetLastError();
}

// The f32 route: state flat f32 [>= limit]; the other arguments and the
// return as bliss_exp3_apply.
extern "C" int bliss_exp3_apply_f32(void* state, const void* idx,
                                    const void* mult, long long u, int limit,
                                    void* stream) {
  const int threads = 256;
  exp3_apply_f32_kernel<<<(unsigned)grid_for(u, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(state), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mult), (int64_t)u, (int32_t)limit);
  return (int)cudaGetLastError();
}

// The repeats route (see the note at the top): s_idx int32 [u], the flat
// indices stable-sorted; order int64 [u], the sort's permutation; mult f32
// [u] in list order. One launch on a bf16 (f32: the _f32 entry) flat state;
// returns cudaGetLastError().
extern "C" int bliss_exp3_apply_runs(void* state, const void* s_idx,
                                     const void* order, const void* mult,
                                     long long u, int limit, void* stream) {
  const int threads = 256;
  exp3_apply_runs_kernel<unsigned short, float>
      <<<(unsigned)grid_for(u, threads), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<unsigned short*>(state),
          static_cast<const int32_t*>(s_idx),
          static_cast<const int64_t*>(order), static_cast<const float*>(mult),
          (int64_t)u, (int32_t)limit);
  return (int)cudaGetLastError();
}

extern "C" int bliss_exp3_apply_runs_f32(void* state, const void* s_idx,
                                         const void* order, const void* mult,
                                         long long u, int limit,
                                         void* stream) {
  const int threads = 256;
  exp3_apply_runs_kernel<unsigned int, double>
      <<<(unsigned)grid_for(u, threads), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<unsigned int*>(state),
          static_cast<const int32_t*>(s_idx),
          static_cast<const int64_t*>(order), static_cast<const float*>(mult),
          (int64_t)u, (int32_t)limit);
  return (int)cudaGetLastError();
}
