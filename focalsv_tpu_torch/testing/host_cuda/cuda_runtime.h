// The part of the CUDA runtime that csrc/region_step.cu and csrc/pairhmm.cu
// use, for a build of those sources for the CPU with g++
// (testing/host_kernel.py).  The threads
// of a CTA are POSIX threads and __syncthreads a barrier; warp shuffles and
// ballots meet at a barrier of their warp; the CTAs of a cluster run
// together, each with its dynamic shared memory, and map each other's;
// atomics are the compiler's.  Shared memory starts filled with 0xA5.
// Clusters run one after another.  Build with -std=c++20
// -fno-extern-tls-init.
#pragma once
#include <pthread.h>

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>
#include <functional>
#include <tuple>

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};
struct alignas(8) int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                 cudaErrorLaunchFailure = 719 };
typedef enum cudaError cudaError_t;
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
                      cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributeNonPortableClusterSizeAllowed = 10 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
  char pad[64];
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ thread_local
#define __align__(n)

struct EmuWarp {
  std::barrier<> bar{32};
  unsigned long long v[32];
};
struct EmuBlock {
  std::barrier<>* bar;
  unsigned char* smem;
  EmuWarp* warps;
  std::atomic<int> orv{0};
};
struct EmuCluster {
  std::barrier<>* bar;
  std::vector<unsigned char*> smems;
  unsigned n;
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
inline thread_local EmuCluster* emu_cl;
inline thread_local unsigned emu_rank;
inline int emu_smem_optin = 232448;
inline int emu_sms = 132;
inline cudaError_t emu_last = cudaSuccess;
namespace {
thread_local unsigned char (*emu_smem_ref)[] = nullptr;
}
#define smem_raw (*emu_smem_ref)

inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  EmuBlock* b = emu_blk;
  b->bar->arrive_and_wait();
  if (p) b->orv.fetch_or(1);
  b->bar->arrive_and_wait();
  const int r = b->orv.load();
  b->bar->arrive_and_wait();
  if (threadIdx.x == 0) b->orv.store(0);
  b->bar->arrive_and_wait();
  return r;
}

inline EmuWarp& emu_warp() { return emu_blk->warps[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().bar.arrive_and_wait(); }
template <class T>
inline T emu_exchange(T v, int src) {
  EmuWarp& w = emu_warp();
  const unsigned lane = threadIdx.x & 31;
  unsigned long long raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  w.v[lane] = raw;
  w.bar.arrive_and_wait();
  raw = w.v[src];
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &raw, sizeof(T));
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const int lane = threadIdx.x & 31;
  const int s = lane - (int)d;
  return emu_exchange(v, s < (lane & ~(width - 1)) ? lane : s);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane ^ m);
}
inline unsigned __ballot_sync(unsigned, int p) {
  EmuWarp& w = emu_warp();
  const unsigned lane = threadIdx.x & 31;
  w.v[lane] = p ? 1 : 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)w.v[i] << i;
  w.bar.arrive_and_wait();
  return r;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned s) {
  const unsigned long long x = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((x << (s < 32 ? s : 32)) >> 32);
}
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }

template <class T> inline T atomicAdd(T* a, T v) { return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicOr(T* a, T v) { return __atomic_fetch_or(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicAnd(T* a, T v) { return __atomic_fetch_and(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicMax(T* a, T v) {
  T old = __atomic_load_n(a, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(a, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? emu_sms : emu_smem_optin;
  return cudaSuccess;
}
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};
template <class F> inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { cudaError_t e = emu_last; emu_last = cudaSuccess; return e; }

struct EmuThreadArg {
  std::function<void()>* body;
  EmuBlock* blk;
  EmuCluster* cl;
  unsigned rank, tid;
  dim3 bidx;
};
inline void* emu_thread_main(void* a) {
  EmuThreadArg* t = static_cast<EmuThreadArg*>(a);
  threadIdx = dim3(t->tid);
  blockIdx = t->bidx;
  emu_blk = t->blk;
  emu_cl = t->cl;
  emu_rank = t->rank;
  emu_smem_ref = reinterpret_cast<unsigned char (*)[]>(t->blk->smem);
  (*t->body)();
  return nullptr;
}

inline cudaError_t emu_launch(std::function<void()> body, dim3 grid, dim3 block,
                              size_t smem, unsigned nc) {
  if ((int)smem > emu_smem_optin || block.x > 1024 || grid.x % nc) {
    emu_last = cudaErrorInvalidValue;
    return emu_last;
  }
  gridDim = grid;
  blockDim = block;
  for (unsigned c0 = 0; c0 < grid.x; c0 += nc) {
    std::barrier<> cbar(nc * block.x);
    EmuCluster cl;
    cl.bar = &cbar;
    cl.n = nc;
    std::vector<EmuBlock> blks(nc);
    std::vector<std::barrier<>*> bars;
    std::vector<std::vector<EmuWarp>> warps(nc);
    for (unsigned r = 0; r < nc; ++r) {
      unsigned char* s = static_cast<unsigned char*>(std::malloc(smem + 16));
      std::memset(s, 0xA5, smem + 16);   // shared memory starts undefined
      cl.smems.push_back(s);
      bars.push_back(new std::barrier<>(block.x));
      blks[r].bar = bars.back();
      blks[r].smem = s;
      warps[r] = std::vector<EmuWarp>(block.x / 32);
      blks[r].warps = warps[r].data();
    }
    std::vector<EmuThreadArg> args(nc * block.x);
    std::vector<pthread_t> ths(nc * block.x);
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 512 << 10);
    for (unsigned r = 0; r < nc; ++r)
      for (unsigned t = 0; t < block.x; ++t) {
        EmuThreadArg& a = args[r * block.x + t];
        a.body = &body;
        a.blk = &blks[r];
        a.cl = &cl;
        a.rank = r;
        a.tid = t;
        a.bidx = dim3(c0 + r);
        if (pthread_create(&ths[r * block.x + t], &attr, emu_thread_main, &a)) {
          std::fprintf(stderr, "emu: pthread_create failed\n");
          std::abort();
        }
      }
    for (auto& th : ths) pthread_join(th, nullptr);
    pthread_attr_destroy(&attr);
    for (unsigned r = 0; r < nc; ++r) {
      std::free(cl.smems[r]);
      delete bars[r];
    }
  }
  return cudaSuccess;
}

template <class... E, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*f)(E...), A&&... args) {
  unsigned nc = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      nc = cfg->attrs[i].val.clusterDim.x;
  auto tup = std::make_tuple(E(args)...);
  return emu_launch([=] { std::apply(f, tup); }, cfg->gridDim, cfg->blockDim,
                    cfg->dynamicSmemBytes, nc);
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 66;
  return cudaSuccess;
}
