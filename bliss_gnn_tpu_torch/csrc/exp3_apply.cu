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
//
// The repeats route (several DP ranks' lists gathered, so a live index
// repeats, at most once a rank) must give every replica of the state the
// same bits: the product of each index's factors in list order, in the
// wide float (f32 for bf16, f64 for f32), applied with one rounding, as
// the plain version does. It is a group-by with no sort, in one memset and
// two launches over a hash table of T = next_pow2(2 u) slots, each a
// 64-bit (key, head) pair: the index and the list position of its latest
// slot:
//   insert  one thread per live slot: one 64-bit atomicCAS claims an empty
//           table slot (linear probing, a multiplicative hash) and sets
//           the head to its own position, or pushes its position onto
//           its key's list; it keeps the previous head as its link, so
//           each key's slots form a list, whose tail owns the key;
//   apply   each owner gathers its key's slots (at most S at S ranks)
//           into registers, sorts the positions with a small network,
//           loads the factors side by side, multiplies them in list order
//           in the wide float and writes the entry once.
// Bound: bytes, but small random accesses: the table (16 bytes a slot of
// the list at load <= 1/2) and the links stay in the 50 MB L2. The slot
// each key lands in depends on the card's order; the product does not,
// since it is taken in list order. The sorted route it replaced
// (stable torch.sort, then one thread per run) stays as
// bliss_exp3_apply_runs for the tests and the timings.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

constexpr uint32_t kHashMul = 0x9E3779B1u;  // Fibonacci hashing
constexpr unsigned long long kEmpty = ~0ULL;  // key -1, head -1
constexpr int kListRegs = 8;  // a key's slots gathered in registers

__device__ __forceinline__ int32_t key_of(unsigned long long e) {
  return (int32_t)(uint32_t)e;
}

__device__ __forceinline__ int32_t head_of(unsigned long long e) {
  return (int32_t)(uint32_t)(e >> 32);
}

// table: [T] (key, head) pairs packed in 64 bits, all kEmpty on entry;
// link: int32 [u]. A slot outside [0, limit) gets link -1; a live slot the
// previous head of its key's list (>= 0), or, for the key's owner (the
// first slot to arrive, the list's tail), -2 - its table slot. One 64-bit
// atomicCAS claims an empty slot and pushes the first position at once;
// a later slot of the key pushes itself with a CAS on the pair it saw.
__global__ void exp3_group_insert_kernel(unsigned long long* table,
                                         int32_t* link,
                                         const int32_t* __restrict__ idx,
                                         int64_t u, int32_t limit,
                                         int log2_t) {
  const uint32_t mask = (1u << log2_t) - 1u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t k = __ldg(idx + i);
    if (k < 0 || k >= limit) {
      link[i] = -1;
      continue;
    }
    const unsigned long long mine =
        ((unsigned long long)(uint32_t)i << 32) | (uint32_t)k;
    uint32_t h = ((uint32_t)k * kHashMul) >> (32 - log2_t);
    unsigned long long cur = kEmpty;
    for (;;) {
      const unsigned long long seen = atomicCAS(table + h, cur, mine);
      if (seen == cur) break;                       // claimed or pushed
      if (key_of(seen) == k) {                      // the key's head moved
        cur = seen;
      } else {                                      // another key's slot
        h = (h + 1) & mask;
        cur = kEmpty;
      }
    }
    const int32_t prev = head_of(cur);
    link[i] = prev >= 0 ? prev : -2 - (int32_t)h;
  }
}

__device__ __forceinline__ void order_pair(int32_t& a, int32_t& b) {
  const int32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

template <typename T, typename W>
__global__ void exp3_group_apply_kernel(T* state,
                                        const unsigned long long* table,
                                        const int32_t* __restrict__ link,
                                        const int32_t* __restrict__ idx,
                                        const float* __restrict__ mult,
                                        int64_t u) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < u;
       i += stride) {
    const int32_t own = __ldg(link + i);
    if (own >= -1) continue;  // a no-op slot, or not its key's owner
    // the entry's random read first, so that its latency overlaps the walk
    const int32_t k = __ldg(idx + i);
    const T old = state[k];
    int32_t j = head_of(__ldcg(table + (-2 - own)));
    // the key's slots (list positions) into registers, unsorted
    int32_t p[kListRegs];
#pragma unroll
    for (int t = 0; t < kListRegs; ++t) {
      p[t] = INT_MAX;
      if (j >= 0) {
        p[t] = j;
        j = __ldg(link + j);
      }
    }
    W prod = 1;
    if (j < 0) {
      // ascending by an odd-even transposition network, then the factors
      // (independent loads) multiplied in list order
#pragma unroll
      for (int r = 0; r < kListRegs; ++r) {
#pragma unroll
        for (int t = r & 1; t + 1 < kListRegs; t += 2) {
          order_pair(p[t], p[t + 1]);
        }
      }
      W f[kListRegs];
#pragma unroll
      for (int t = 0; t < kListRegs; ++t) {
        f[t] = p[t] == INT_MAX ? (W)1 : (W)__ldg(mult + p[t]);
      }
      prod = f[0];
#pragma unroll
      for (int t = 1; t < kListRegs; ++t) {
        if (p[t] != INT_MAX) prod *= f[t];
      }
    } else {
      // more slots than registers (more ranks than kListRegs): each pass
      // over the list takes the least position above the last one taken
      const int32_t first = head_of(__ldcg(table + (-2 - own)));
      for (int32_t last = -1;;) {
        int32_t next = INT_MAX;
        for (int32_t q = first; q >= 0; q = __ldg(link + q)) {
          if (q > last && q < next) next = q;
        }
        if (next == INT_MAX) break;
        const W f = (W)__ldg(mult + next);
        prod = last < 0 ? f : prod * f;
        last = next;
      }
    }
    state[k] = apply_product<T, W>(old, prod);
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

// The sorted repeats route that the group-by replaced, kept for the tests
// and the timings: s_idx int32 [u], the flat indices stable-sorted; order
// int64 [u], the sort's permutation; mult f32 [u] in list order. One
// launch on a bf16 (f32: the _f32 entry) flat state; returns
// cudaGetLastError().
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

// The group-by route (see the note at the top): idx int32 [u] and mult f32
// [u] in list order; scratch int32 [2 * 2^log2_t + u], 8-byte aligned (the
// table's 64-bit pairs, then the links), set here. One memset and two launches on a bf16 (f32: the
// _f32 entry) flat state; returns cudaGetLastError().
template <typename T, typename W>
int exp3_apply_groups(void* state, const void* idx, const void* mult,
                      void* scratch, long long u, int limit, int log2_t,
                      void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)grid_for(u, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* table = static_cast<unsigned long long*>(scratch);
  int32_t* link = reinterpret_cast<int32_t*>(table + (1LL << log2_t));
  cudaMemsetAsync(table, 0xff, (size_t)(1LL << log2_t) * sizeof(*table),
                  st);
  exp3_group_insert_kernel<<<blocks, threads, 0, st>>>(
      table, link, static_cast<const int32_t*>(idx), (int64_t)u,
      (int32_t)limit, log2_t);
  exp3_group_apply_kernel<T, W><<<blocks, threads, 0, st>>>(
      static_cast<T*>(state), table, link, static_cast<const int32_t*>(idx),
      static_cast<const float*>(mult), (int64_t)u);
  return (int)cudaGetLastError();
}

extern "C" int bliss_exp3_apply_groups(void* state, const void* idx,
                                       const void* mult, void* scratch,
                                       long long u, int limit, int log2_t,
                                       void* stream) {
  return exp3_apply_groups<unsigned short, float>(
      state, idx, mult, scratch, u, limit, log2_t, stream);
}

extern "C" int bliss_exp3_apply_groups_f32(void* state, const void* idx,
                                           const void* mult, void* scratch,
                                           long long u, int limit,
                                           int log2_t, void* stream) {
  return exp3_apply_groups<unsigned int, double>(
      state, idx, mult, scratch, u, limit, log2_t, stream);
}
