// K2: table lookup out[i] = lut[idx[i]] for i < n_valid, 0 past it.
//
// Replaces bliss_gnn_tpu/ops/gather_pallas.py lut_gather (kernel bodies
// _lut_gather_kernel and _lut_gather_kernel_mxusel; _lut_gather_kernel_roll
// computes the same function). On the TPU the whole table sat in VMEM and a
// lane was picked out of each copied 128-wide row with a one-hot select;
// here each thread loads its entry directly, through L2.
//
// Bound: bytes. Each valid index reads 4 bytes of index and one table entry
// and writes one entry; there is no arithmetic. The entry is moved as raw
// bits of its width (1, 2, 4 or 8 bytes), so int32 values above 2^24 stay
// exact and a bool table travels as one byte per entry. The loop is
// grid-stride, coalesced on idx and out, and reads n_valid on the device so
// the caller needs no host sync. Indices outside [0, n_lut) read 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t valid_prefix(int64_t n, const int32_t* n_valid) {
  if (n_valid == nullptr) return n;
  int64_t v = *n_valid;
  return v < 0 ? 0 : (v < n ? v : n);
}

template <typename T>
__global__ void lut_gather_kernel(const T* __restrict__ lut, int64_t n_lut,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int64_t m,
                                  const int32_t* __restrict__ n_valid) {
  const int64_t nv = valid_prefix(m, n_valid);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    T v = T(0);
    if (i < nv) {
      const int32_t j = idx[i];
      if (j >= 0 && j < n_lut) v = lut[j];
    }
    out[i] = v;
  }
}

template <typename T>
void launch(const void* lut, long long n_lut, const void* idx, void* out,
            long long m, const void* n_valid, cudaStream_t s) {
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  lut_gather_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(lut), (int64_t)n_lut,
      static_cast<const int32_t*>(idx), static_cast<T*>(out), (int64_t)m,
      static_cast<const int32_t*>(n_valid));
}

}  // namespace

// elem_bytes selects the entry width (1, 2, 4 or 8). n_valid may be null.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another width.
extern "C" int bliss_lut_gather(const void* lut, long long n_lut,
                                int elem_bytes, const void* idx, void* out,
                                long long m, const void* n_valid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return (int)cudaGetLastError();
  switch (elem_bytes) {
    case 1: launch<uint8_t>(lut, n_lut, idx, out, m, n_valid, s); break;
    case 2: launch<uint16_t>(lut, n_lut, idx, out, m, n_valid, s); break;
    case 4: launch<uint32_t>(lut, n_lut, idx, out, m, n_valid, s); break;
    case 8: launch<uint64_t>(lut, n_lut, idx, out, m, n_valid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
