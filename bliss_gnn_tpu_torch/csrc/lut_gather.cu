// K2: table lookup out_t[i] = lut_t[idx[i]] for i < n_valid, 0 past it, for
// one to eight tables that share one index list.
//
// Replaces bliss_gnn_tpu/ops/gather_pallas.py lut_gather (kernel bodies
// _lut_gather_kernel and _lut_gather_kernel_mxusel; _lut_gather_kernel_roll
// computes the same function) and serves its grouped entry point
// maybe_lut_gather_multi. On the TPU the whole table sat in VMEM and a lane
// was picked out of each copied 128-wide row with a one-hot select, whose
// cost grew with every table extracted, so each table took its own pass.
// Here each thread loads its entries directly, through L2, and one launch
// serves every table of a group.
//
// Bound: bytes. Each valid id is read once (4 bytes) and serves every
// table: one entry read and one entry written per table; there is no
// arithmetic. Each thread takes four consecutive slots: one 16-byte load of
// their ids when the list is 16-byte aligned, then for each table four
// independent entry loads and one vector store of the four outputs (4, 8,
// 16 or 2 x 16 bytes). Entries move as raw bits of their width (1, 2, 4 or
// 8 bytes), so int32 values above 2^24 stay exact and a bool table travels
// as one byte per entry. The table loop is unrolled over the eight slots of
// the descriptor, which the kernel takes by value, so each table's width
// switch is uniform across the warp. n_valid is read on the device, so the
// caller needs no host sync; ids outside [0, n_t) read 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 8;

struct Tables {
  const void* lut[kMaxTables];
  void* out[kMaxTables];
  int64_t n[kMaxTables];
  int32_t width[kMaxTables];
  int32_t k;
};

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

// four entries to out[0..3]; out is aligned to four entries
__device__ __forceinline__ void store4(uint8_t* out, const uint8_t (&v)[4]) {
  *reinterpret_cast<uchar4*>(out) = make_uchar4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(uint16_t* out, const uint16_t (&v)[4]) {
  *reinterpret_cast<ushort4*>(out) = make_ushort4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(uint32_t* out, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(unsigned long long* out,
                                       const unsigned long long (&v)[4]) {
  reinterpret_cast<ulonglong2*>(out)[0] = make_ulonglong2(v[0], v[1]);
  reinterpret_cast<ulonglong2*>(out)[1] = make_ulonglong2(v[2], v[3]);
}

// slots base .. base + cnt - 1 of one table; j < 0 marks a dead slot
template <typename T>
__device__ __forceinline__ void gather4(const void* lut_v, void* out_v,
                                        int64_t n, const int32_t (&j)[4],
                                        int64_t base, int cnt) {
  const T* lut = static_cast<const T*>(lut_v);
  T* out = static_cast<T*>(out_v) + base;
  T v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = (j[q] >= 0 && j[q] < n) ? __ldg(lut + j[q]) : T(0);
  if (cnt == 4) {
    store4(out, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)  // unrolled: v stays in registers
      if (q < cnt) out[q] = v[q];
  }
}

__global__ void lut_gather_kernel(const Tables t,
                                  const int32_t* __restrict__ idx, int64_t m,
                                  const int32_t* __restrict__ n_valid,
                                  bool vec_ids) {
  const int64_t nv = valid_prefix(m, n_valid);
  const int64_t groups = (m + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t base = g * 4;
    const int cnt = m - base < 4 ? (int)(m - base) : 4;  // slots in range
    const int64_t ahead = nv - base;                     // valid of them
    const int live = ahead <= 0 ? 0 : (ahead < cnt ? (int)ahead : cnt);
    int32_t j[4] = {-1, -1, -1, -1};
    if (live == 4 && vec_ids) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(idx + base));
      j[0] = w.x; j[1] = w.y; j[2] = w.z; j[3] = w.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < live) j[q] = __ldg(idx + base + q);
    }
#pragma unroll
    for (int s = 0; s < kMaxTables; ++s) {
      if (s >= t.k) break;
      switch (t.width[s]) {
        case 1: gather4<uint8_t>(t.lut[s], t.out[s], t.n[s], j, base, cnt); break;
        case 2: gather4<uint16_t>(t.lut[s], t.out[s], t.n[s], j, base, cnt); break;
        case 4: gather4<uint32_t>(t.lut[s], t.out[s], t.n[s], j, base, cnt); break;
        default:
          gather4<unsigned long long>(t.lut[s], t.out[s], t.n[s], j, base, cnt);
      }
    }
  }
}

}  // namespace

// desc: k rows of four 64-bit host integers (table pointer, output pointer,
// table length, entry bytes in {1, 2, 4, 8}), 1 <= k <= 8. Each output holds
// m entries and is aligned to 32 bytes. n_valid may be null. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bad descriptor.
extern "C" int bliss_lut_gather(const long long* desc, int k, const void* idx,
                                long long m, const void* n_valid,
                                void* stream) {
  if (k < 1 || k > kMaxTables) return (int)cudaErrorInvalidValue;
  Tables t = {};
  for (int s = 0; s < k; ++s) {
    const long long* row = desc + 4 * s;
    const int w = (int)row[3];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)row[1] & 31) != 0) return (int)cudaErrorInvalidValue;
    t.lut[s] = reinterpret_cast<const void*>((uintptr_t)row[0]);
    t.out[s] = reinterpret_cast<void*>((uintptr_t)row[1]);
    t.n[s] = (int64_t)row[2];
    t.width[s] = w;
  }
  t.k = k;
  if (m <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = ((m + 3) / 4 + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  lut_gather_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int32_t*>(idx), (int64_t)m,
      static_cast<const int32_t*>(n_valid), ((uintptr_t)idx & 15) == 0);
  return (int)cudaGetLastError();
}
