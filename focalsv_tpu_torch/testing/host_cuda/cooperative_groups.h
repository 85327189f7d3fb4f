// The cluster group of cooperative_groups for the CPU build of
// csrc/region_step.cu (see cuda_runtime.h beside it).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cl->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_rank; }
  unsigned num_blocks() const { return emu_cl->n; }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    return reinterpret_cast<T*>(
        emu_cl->smems[r] +
        (reinterpret_cast<unsigned char*>(p) - emu_cl->smems[emu_rank]));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
