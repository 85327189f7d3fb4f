// Kernel B1: banded affine-gap global alignment of a batch of pairs, with the
// direction byte of every band cell.
//
// Replaces focalsv_tpu/ops/align_pallas.py::banded_align_batch_pallas (and
// its _kernel / _prefix_max_sublane).  It computes exactly what the plain
// version, focalsv_tpu_torch/ops/align.py::banded_align_batch, computes:
// scores (B,) int32 and, unless store_dirs is 0, dirs (B, Lq, W) uint8.
//
// Band coordinates: cell k of row i is target column j = i + d_lo + k.
//   diag = H_prev[k] + sub(q[i-1], t[j-1])
//   F    = max(H_prev[k+1] + open, F_prev[k+1] + ext)          (query gap)
//   G    = max(diag, F)
//   E    = max_{k'<k}(G[k'] - ext*k') + open - ext + ext*k      (target gap)
//   H    = max(G, E)
// The direction byte holds the H source in its low two bits (0 diag, 1 E,
// 2 F), 0b100 when E extends and 0b1000 when F extends.  The j == 0 column
// is F only.  The score is H at (q_len, t_len), or NEG off the band.
//
// Design: one thread block per pair, blockDim = min(round_up(W, 32), 1024),
// each thread owning W / blockDim contiguous band cells.  The band state
// (H and F double-buffered by row parity, plus G) lives in shared memory,
// 20 bytes a cell: 160 KB at W = 8192, dynamic above 48 KB.  Wider bands
// keep it in global scratch that the wrapper allocates.  Each row takes two
// passes over a thread's cells: the first computes G and the thread's
// partial prefix max, a block-wide scan (warp shuffles, then warp totals
// through shared memory) gives each thread the prefix of the cells before
// its own, and the second pass computes E, H and the direction byte and
// writes the direction bytes, coalesced across k.
//
// What bounds it on an H100: the dependent row loop, M sequential rows of
// two __syncthreads each, with a few dozen integer operations per cell in
// between; and the direction bytes, B * M * W of them written to device
// memory.  No tensor-core or TMA path applies to an integer DP.  This
// version is written to be right, not fast: several pairs per block, dirs
// fused with the traceback and rows kept in registers are later work.

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int SCAN_ID = INT_MIN;   // identity of the prefix max
constexpr int DIR_E_EXT = 0b100;
constexpr int DIR_F_EXT = 0b1000;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ int row0_h(int j0, int tn, int gap_open,
                                      int gap_extend) {
  if (j0 < 0 || j0 > tn) return NEG;
  return j0 == 0 ? 0 : gap_open + gap_extend * (j0 - 1);
}

// t[j - 1] as the plain version reads it: a negative index clamps to t[0],
// an index past the target reads the pad value 255
__device__ __forceinline__ int target_at(const uint8_t* tb, int Lt, int x) {
  x = x < 0 ? 0 : x;
  return x < Lt ? tb[x] : 255;
}

__global__ void __launch_bounds__(MAX_THREADS) banded_align_kernel(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
    const int32_t* __restrict__ q_len, const int32_t* __restrict__ t_len,
    const int32_t* __restrict__ d_lo, int32_t* __restrict__ scores,
    uint8_t* __restrict__ dirs, int32_t* __restrict__ gstate, int Lq, int Lt,
    int W, int cpt, int match, int mismatch, int gap_open, int gap_extend,
    int store_dirs) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_tot[MAX_THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* st = gstate != nullptr ? gstate + (size_t)b * 5 * W : smem;
  int32_t* hbuf[2] = {st, st + W};
  int32_t* fbuf[2] = {st + 2 * W, st + 3 * W};
  int32_t* g = st + 4 * W;

  const uint8_t* qb = q + (size_t)b * Lq;
  const uint8_t* tb = t + (size_t)b * Lt;
  const int qn = q_len[b];
  const int tn = t_len[b];
  const int dlo = d_lo[b];
  const int M = Lq;
  const int k0 = tid * cpt;
  const int k1 = min(k0 + cpt, W);
  const int k_end = tn - qn - dlo;

  // row 0
  for (int k = k0; k < k1; ++k) {
    hbuf[0][k] = row0_h(dlo + k, tn, gap_open, gap_extend);
    fbuf[0][k] = NEG;
  }
  if (tid == 0) {
    const bool captured = qn == 0 && k_end >= 0 && k_end < W;
    scores[b] = captured ? row0_h(dlo + k_end, tn, gap_open, gap_extend)
                         : NEG;
  }
  __syncthreads();

  // rows past q_len are off the band: no state to carry, dirs are 0
  const int rows = max(min(qn, M), 0);
  int cur = 0;
  for (int i = 1; i <= rows; ++i) {
    const int32_t* hp = hbuf[cur];
    const int32_t* fp = fbuf[cur];
    int32_t* hn = hbuf[cur ^ 1];
    int32_t* fn = fbuf[cur ^ 1];
    const int qc = qb[i - 1];
    const int jb = i + dlo;

    // pass 1: G of the own cells and their partial prefix max
    int agg = SCAN_ID;
    for (int k = k0; k < k1; ++k) {
      const int tc = target_at(tb, Lt, jb + k - 1);
      const int diag = hp[k] + ((qc == tc && qc < 4) ? match : mismatch);
      const int h_up = k + 1 < W ? hp[k + 1] : NEG;
      const int f_up = k + 1 < W ? fp[k + 1] : NEG;
      const int gk = max(diag, max(h_up + gap_open, f_up + gap_extend));
      g[k] = gk;
      agg = max(agg, gk - gap_extend * k);
    }

    // block-wide exclusive prefix max of the threads' partials
    int v = agg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = max(v, n);
    }
    int run = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) run = SCAN_ID;
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) run = max(run, warp_tot[w]);

    // pass 2: E, H, F and the direction bytes
    uint8_t* drow =
        store_dirs ? dirs + ((size_t)b * M + (i - 1)) * W : nullptr;
    for (int k = k0; k < k1; ++k) {
      const int j = jb + k;
      const int tc = target_at(tb, Lt, j - 1);
      const int diag = hp[k] + ((qc == tc && qc < 4) ? match : mismatch);
      const int h_up = k + 1 < W ? hp[k + 1] : NEG;
      const int f_up = k + 1 < W ? fp[k + 1] : NEG;
      const int f_open = h_up + gap_open;
      const int f_ext = f_up + gap_extend;
      const int f = max(f_open, f_ext);
      const int gk = g[k];
      const int a_shift = k == 0 ? NEG : run;
      run = max(run, gk - gap_extend * k);
      const int e = a_shift + (gap_open - gap_extend) + gap_extend * k;
      const int fbit = f_ext >= f_open ? DIR_F_EXT : 0;
      const bool jv = j >= 1 && j <= tn;
      const bool jz = j == 0;
      int h;
      int d;
      if (jv) {
        h = max(gk, e);
        d = (h == diag ? 0 : (h == e ? 1 : 2)) | fbit;
        const int g_left = k > 0 ? g[k - 1] : NEG;
        if (a_shift > g_left - gap_extend * (k - 1)) d |= DIR_E_EXT;
      } else if (jz) {
        h = f;
        d = 2 | fbit;
      } else {
        h = NEG;
        d = 0;
      }
      hn[k] = h;
      fn[k] = (jv || jz) ? f : NEG;
      if (store_dirs) drow[k] = (uint8_t)d;
      if (i == qn && k == k_end) scores[b] = h;
    }
    cur ^= 1;
    __syncthreads();
  }

  if (store_dirs) {
    uint8_t* z = dirs + ((size_t)b * M + rows) * W;
    const size_t n = (size_t)(M - rows) * W;
    if ((reinterpret_cast<uintptr_t>(z) & 15) == 0 && (n & 15) == 0) {
      uint4* z4 = reinterpret_cast<uint4*>(z);
      for (size_t x = tid; x < n / 16; x += blockDim.x)
        z4[x] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (size_t x = tid; x < n; x += blockDim.x) z[x] = 0;
    }
  }
}

}  // namespace

// Launches kernel B1 on `stream` and returns cudaGetLastError() (0 = ok).
// q (B, Lq) and t (B, Lt) uint8; q_len, t_len, d_lo (B,) int32; scores (B,)
// int32; dirs (B, Lq, W) uint8 (unused when store_dirs is 0).  `scratch`
// is null for bands whose state fits shared memory, else (B, 5 * W) int32.
extern "C" int focalsv_banded_align(
    const void* q, const void* t, const void* q_len, const void* t_len,
    const void* d_lo, void* scores, void* dirs, void* scratch, int B, int Lq,
    int Lt, int W, int match, int mismatch, int gap_open, int gap_extend,
    int store_dirs, void* stream) {
  if (B <= 0) return 0;
  const int threads = std::min(((W + 31) / 32) * 32, MAX_THREADS);
  const int cpt = (W + threads - 1) / threads;
  const size_t smem = scratch != nullptr ? 0 : (size_t)5 * W * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  banded_align_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(q_len), static_cast<const int32_t*>(t_len),
      static_cast<const int32_t*>(d_lo), static_cast<int32_t*>(scores),
      static_cast<uint8_t*>(dirs), static_cast<int32_t*>(scratch), Lq, Lt, W,
      cpt, match, mismatch, gap_open, gap_extend, store_dirs);
  return (int)cudaGetLastError();
}
