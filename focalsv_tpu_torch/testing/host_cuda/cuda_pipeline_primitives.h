// The asynchronous copies of cuda_pipeline_primitives.h for the CPU build of
// csrc/region_step.cu (see cuda_runtime.h beside it): a copy is done when it
// is issued, so commits and waits have nothing to do.  A race between a
// copy and its use cannot show here.
#pragma once
#include <cstring>

#include "cuda_runtime.h"

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  if (zfill) std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
