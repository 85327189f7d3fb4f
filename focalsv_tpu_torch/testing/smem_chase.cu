// A pointer chase through shared memory: one thread follows `steps`
// dependent 4-byte loads and reports the SM cycles and the nanoseconds they
// took.  testing/kernel_sweep.py builds it to measure one shared-memory
// load-to-use on the card, the unit of kernel B4's latency floor (a walk's
// dependent decisions times this).  A measuring tool: no part of the port
// calls it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int SLOTS = 1024;

__global__ void chase_kernel(int steps, long long* out) {
  __shared__ int next_slot[SLOTS];
  for (int x = threadIdx.x; x < SLOTS; x += blockDim.x)
    next_slot[x] = (x * 17 + 1) % SLOTS;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int p = 0;
  for (int s = 0; s < 64; ++s) p = next_slot[p];      // warm up
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) p = next_slot[p];
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  out[0] = c1 - c0;
  out[1] = (long long)(ns1 - ns0);
  out[2] = p;                                         // keeps the loads alive
}

}  // namespace

// out: three int64 on the device (cycles, nanoseconds, the last slot).
extern "C" int focalsv_smem_chase(void* out, int steps, void* stream) {
  chase_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      steps, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
