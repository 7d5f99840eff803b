// Device marks: one thread reads the card's nanosecond clock (%globaltimer)
// and writes it into a unit's stamp tensors.
//
// Replaces no TPU kernel: the JAX package timed its steps from the host
// (jax.profiler). It was added for utils/spans.py, so that a CUDA graph
// times its own phases: a mark launched while a step is captured becomes a
// node of the graph, ordered after the work captured before it on the
// stream, and every replay writes its stamps anew, where the step's
// metrics vector picks them up (no extra sync, no extra host call, per
// step at any chain length).
//
// slot < 0 writes the unit's base, the absolute clock, into base[0]; slot
// >= 0 writes the clock less the base into rel[slot] as a double: the
// differences stay far below 2^53 ns, so the f64 metrics vector holds them
// exactly, where the absolute clock would not. Bound: launch latency; one
// thread, 8 bytes read and written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mark_kernel(long long* base, double* rel, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (slot < 0) {
    base[0] = static_cast<long long>(now);
  } else {
    rel[slot] = static_cast<double>(static_cast<long long>(now) - base[0]);
  }
}

}  // namespace

extern "C" int bliss_mark(void* base, void* rel, int slot, void* stream) {
  mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(base), static_cast<double*>(rel), slot);
  return static_cast<int>(cudaGetLastError());
}
