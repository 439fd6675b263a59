// A step-split probe of the cluster recurrences, compiled in only with
// -DFLAPPIE_STEP_PROBE (step_split.py builds it; no shipped build defines
// it, so without the flag every macro below is empty and the kernels' SASS
// is their own).  Thread 0 of block 0 reads clock64() at the marks of each
// step and sums the cycles between consecutive marks into five buckets
// (wait, product, update, exchange, the rest); at the end of the walk it
// stores them, its total cycles, its total %globaltimer nanoseconds (the
// clock's rate) and the number of steps in flappie_probe_out, which
// flappie_step_probe copies to the host.
#pragma once

#ifdef FLAPPIE_STEP_PROBE

#include <cuda_runtime.h>

__device__ unsigned long long flappie_probe_out[8];

namespace flappie {
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace flappie

#define PROBE_INIT()                                                   \
  const bool probe_on = blockIdx.x == 0 && threadIdx.x == 0;           \
  unsigned long long probe_acc[5] = {0, 0, 0, 0, 0};                   \
  long long probe_t = clock64();                                       \
  const long long probe_t0 = probe_t;                                  \
  const unsigned long long probe_ns0 = flappie::probe_ns();
#define PROBE_MARK(i)                                                  \
  if (probe_on) {                                                      \
    const long long probe_now = clock64();                             \
    probe_acc[i] += (unsigned long long)(probe_now - probe_t);         \
    probe_t = probe_now;                                               \
  }
#define PROBE_END(steps)                                               \
  if (probe_on) {                                                      \
    for (int probe_i = 0; probe_i < 5; ++probe_i)                      \
      flappie_probe_out[probe_i] = probe_acc[probe_i];                 \
    flappie_probe_out[5] = (unsigned long long)(clock64() - probe_t0); \
    flappie_probe_out[6] = flappie::probe_ns() - probe_ns0;            \
    flappie_probe_out[7] = (unsigned long long)(steps);                \
  }

// The last probed launch's buckets into out[8]; returns the error code.
extern "C" int flappie_step_probe(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, flappie_probe_out, sizeof(flappie_probe_out));
}

#else

#define PROBE_INIT()
#define PROBE_MARK(i)
#define PROBE_END(steps)

#endif
