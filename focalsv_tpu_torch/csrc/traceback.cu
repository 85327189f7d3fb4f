// Kernel B4: the traceback of kernel B1's direction bytes on the card, so
// that the (Lq, W) dirs of a pair never cross to the host: only the op
// string does.
//
// Replaces focalsv_tpu/ops/align.py::traceback_device (a vmapped
// lax.while_loop that XLA compiles).  It computes exactly what the plain
// version, focalsv_tpu_torch/ops/align.py::traceback_device, computes: for
// every pair the op string of the walk from (q_len, t_len) back to (0, 0),
// in reverse order (0 = M, 1 = D, 2 = I, 255 = filler), ops (B, BUF) uint8
// with BUF = 2 * M + W + 8, and its length n (B,) int32.
//
// The walk, in band coordinates (cell k = j - i - d_lo of dirs row i - 1):
//   i == 0            emit D, j -= 1                       (forced)
//   j == 0            emit I, i -= 1                       (forced)
//   state H, diag     emit M, i -= 1, j -= 1               (k stays)
//   state H, else     state = the cell's H source, no op
//   state E           emit D, j -= 1 (k - 1), stay in E while the E-extend
//                     bit is set
//   state F           emit I, i -= 1 (k + 1), stay in F while the F-extend
//                     bit is set
// A cell off the band reads as 0 (diag).  The walk ends at (0, 0) or when
// the op string is full.
//
// What bounds it on an H100: neither bytes nor operations but latency.  A
// walk is up to 2 * M + W ops, and which cell comes next depends on the cell
// before, so the floor is the number of dependent decisions times one
// shared-memory load-to-use.  Design: one warp per pair, and the warp walks
// runs, not steps.  Each state's run is a straight line in band coordinates:
// M runs go up a column (k stays), D runs go left along a row, I runs go up
// the anti-diagonal (k + 1 a row).  Lane t reads the cell t steps ahead on
// that line; one __ballot_sync of "this cell continues the run" and one
// __ffs give the run's length, up to 32 ops a decision (64 for M runs, the
// common ones: each lane reads two cells 32 rows apart, and the two loads
// and ballots overlap), and lane t writes op n + t straight to the op
// string.  A run is cut where a lane's cell is
// outside the tile in shared memory, where i, j or the op string runs out,
// and at the band's edge (a cell off the band reads as 0).
//
// The tile: TILE_ROWS = 128 rows up from the walker's row, TILE_COLS = 64
// columns around its cell, in shared memory with a row stride of
// TILE_STRIDE = 80 bytes.  The walk goes up a row an op at most, so a tall
// narrow tile lasts longest for the bytes it costs: the copies are issued
// by the one warp that also walks, and their instructions are a third of
// the walk's time at 128 columns.  A stride equal to a multiple of 128
// bytes would put a column's 32 cells into one bank (a 32-way conflict on
// every M run).  The copies are cp.async of 16 bytes a lane, whose
// shared-memory address must be a multiple of 16, so the stride is one too,
// and a padding of 4 bytes (free of conflicts) is not to be had: it would
// need 4-byte copies, four times the copy instructions.  With 80 bytes (5
// units of 16) a column's 32 cells fall into 8 groups of banks, a 4-way
// conflict, a few cycles on a decision of some hundred; row reads broadcast
// and anti-diagonal reads spread likewise.
//
// Two tile buffers: when the walker enters a tile, the tile above it (the
// same columns re-centred on the walker) is requested with cp.async into
// the other buffer and waited for only when the walker leaves upwards.  A
// walker that leaves sideways (a long gap) loads the tile where it stands
// and waits for it.  Where W is not a multiple of 16 the copies are plain
// byte loads.  The forced tails (i == 0 or j == 0) and the 255 filler are
// written by the whole warp.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int DIR_H_MASK = 0b11;
constexpr int DIR_E_EXT = 0b100;
constexpr int DIR_F_EXT = 0b1000;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_ROWS = 128;
constexpr int TILE_COLS = 64;     // a multiple of 16
constexpr int TILE_STRIDE = 80;   // bytes a row in shared memory, see above
constexpr int TILE_LEFT = 24;     // columns kept to the left of the walker
// a lone warp on a scheduler walks fastest, and a batch is at most a few
// hundred pairs: one warp, one pair, one block
constexpr int WARPS_PER_BLOCK = 1;

__device__ __forceinline__ void cp_async16(uint8_t* smem, const uint8_t* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this lane has requested, then makes the warp's
// copies visible to all its lanes
__device__ __forceinline__ void tile_arrived() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// A tile of one pair's direction bytes in shared memory: dirs rows
// [r_lo, r_hi], columns [c_lo, c_lo + TILE_COLS).
struct Tile {
  uint8_t* buf;
  int r_lo, r_hi, c_lo;

  __device__ __forceinline__ bool holds(int r, int k) const {
    return r >= r_lo && r <= r_hi && k >= c_lo && k < c_lo + TILE_COLS;
  }
  __device__ __forceinline__ int at(int r, int k) const {
    return buf[(r - r_lo) * TILE_STRIDE + (k - c_lo)];
  }
  // Requests the tile whose last row is r, placed around cell k; returns at
  // once.  tile_arrived() must come before the first read.
  __device__ __forceinline__ void request(const uint8_t* db, int W, int r,
                                          int k, bool vec_ok, int lane) {
    r_hi = r;
    r_lo = max(r - TILE_ROWS + 1, 0);
    c_lo = max(k - TILE_LEFT, 0) & ~15;
    const int nrows = r_hi - r_lo + 1;
    if (vec_ok) {
      constexpr int UPR = TILE_COLS / 16;      // 16-byte units per row
      for (int u = lane; u < nrows * UPR; u += 32) {
        const int rr = u / UPR;
        const int cc = (u - rr * UPR) * 16;
        if (c_lo + cc < W)
          cp_async16(buf + rr * TILE_STRIDE + cc,
                     db + (size_t)(r_lo + rr) * W + c_lo + cc);
      }
      cp_async_commit();
    } else {
      for (int u = lane; u < nrows * TILE_COLS; u += 32) {
        const int rr = u / TILE_COLS;
        const int cc = u - rr * TILE_COLS;
        if (c_lo + cc < W)
          buf[rr * TILE_STRIDE + cc] = db[(size_t)(r_lo + rr) * W + c_lo + cc];
      }
    }
  }
};

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) traceback_kernel(
    const uint8_t* __restrict__ dirs, const int32_t* __restrict__ q_len,
    const int32_t* __restrict__ t_len, const int32_t* __restrict__ d_lo,
    uint8_t* __restrict__ ops, int32_t* __restrict__ n_out, int B, int M,
    int W, int BUF) {
  __shared__ __align__(16) uint8_t
      smem[WARPS_PER_BLOCK][2][TILE_ROWS * TILE_STRIDE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (b >= B) return;
  const uint8_t* db = dirs + (size_t)b * M * W;
  uint8_t* ob = ops + (size_t)b * BUF;
  const int dlo = d_lo[b];
  const bool vec_ok = (W % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(dirs) & 15) == 0;

  // i, j, n and state are the same in every lane: each lane derives them
  // from the ballots
  int i = q_len[b];
  int j = t_len[b];
  int state = 0;
  int n = 0;
  Tile cur{smem[warp][0], 0, -1, 0};    // the tile the walker stands in
  Tile next{smem[warp][1], 0, -1, 0};   // the tile requested ahead (empty)

  while (i > 0 && j > 0 && n < BUF) {
    const int k = j - i - dlo;
    const bool k_in = k >= 0 && k < W;
    if (k_in) {
      const int r = min(i - 1, M - 1);
      if (!cur.holds(r, k)) {
        tile_arrived();                 // the tile ahead, if one was asked for
        if (next.holds(r, k)) {
          const Tile was = cur;
          cur = next;
          next = was;
        } else {
          cur.request(db, W, r, k, vec_ok, lane);
          tile_arrived();
        }
        next.r_hi = -1;
        next.r_lo = 0;
        if (cur.r_lo > 0) next.request(db, W, cur.r_lo - 1, k, vec_ok, lane);
      }
    }

    if (state == 0) {
      // an M run: lane t looks at cells (i - t, j - t) and (i - 32 - t,
      // j - 32 - t), the same k: up to 64 ops a decision, and the second
      // load and ballot do not wait for the first
      const int it0 = i - lane;
      const int it1 = it0 - 32;
      const bool valid0 = it0 > 0 && j - lane > 0 && n + lane < BUF;
      const bool valid1 = it1 > 0 && j - 32 - lane > 0 && n + 32 + lane < BUF;
      bool avail0 = true, avail1 = true;
      int p0 = 0, p1 = 0;
      if (k_in) {
        const int rt0 = min(it0 - 1, M - 1);
        const int rt1 = min(it1 - 1, M - 1);
        avail0 = rt0 >= cur.r_lo && rt0 <= cur.r_hi;
        avail1 = rt1 >= cur.r_lo && rt1 <= cur.r_hi;
        if (valid0 && avail0) p0 = cur.at(rt0, k);
        if (valid1 && avail1) p1 = cur.at(rt1, k);
      }
      const bool known0 = valid0 && avail0;
      const bool known1 = valid1 && avail1;
      const int h0 = p0 & DIR_H_MASK;
      const int h1 = p1 & DIR_H_MASK;
      const unsigned go0 = __ballot_sync(FULL, known0 && h0 == 0);
      const unsigned go1 = __ballot_sync(FULL, known1 && h1 == 0);
      const int run = go0 != FULL ? __ffs(~go0) - 1
                                  : 32 + (go1 == FULL ? 32 : __ffs(~go1) - 1);
      // the cell that ended the run says where the walk turns to, unless
      // the run was cut (then the loop's head looks again)
      const int mine = run < 32 ? (known0 ? h0 : 0) : (known1 ? h1 : 0);
      const int turn = __shfl_sync(FULL, mine, run & 31);
      if (lane < run) ob[n + lane] = 0;
      if (32 + lane < run) ob[n + 32 + lane] = 0;
      n += run;
      i -= run;
      j -= run;
      if (run < 64) {
        if (turn == 3) break;           // no cell of B1 holds 3: stop
        state = turn;
      }
    } else if (state == 1) {
      // a D run: lane t looks at cell (i, j - t), k - t
      const int kt = k - lane;
      const bool valid = j - lane > 0 && n + lane < BUF;
      bool avail = true;
      int p = 0;
      if (kt >= 0 && kt < W) {
        const int r = min(i - 1, M - 1);
        avail = cur.holds(r, kt);
        if (valid && avail) p = cur.at(r, kt);
      }
      const bool known = valid && avail;
      const unsigned go = __ballot_sync(FULL, known && (p & DIR_E_EXT));
      const int first = go == FULL ? 32 : __ffs(~go) - 1;
      // the first cell without the extend bit still emits its D and ends
      // the gap, unless the run was cut there
      const bool ends = first < 32 && __shfl_sync(FULL, (int)known, first & 31);
      const int run = first + (ends ? 1 : 0);
      if (lane < run) ob[n + lane] = 1;
      n += run;
      j -= run;
      if (ends) state = 0;
    } else {
      // an I run: lane t looks at cell (i - t, j), k + t
      const int it = i - lane;
      const int kt = k + lane;
      const bool valid = it > 0 && n + lane < BUF;
      bool avail = true;
      int p = 0;
      if (kt >= 0 && kt < W) {
        const int rt = min(it - 1, M - 1);
        avail = valid && cur.holds(rt, kt);
        if (avail) p = cur.at(rt, kt);
      }
      const bool known = valid && avail;
      const unsigned go = __ballot_sync(FULL, known && (p & DIR_F_EXT));
      const int first = go == FULL ? 32 : __ffs(~go) - 1;
      const bool ends = first < 32 && __shfl_sync(FULL, (int)known, first & 31);
      const int run = first + (ends ? 1 : 0);
      if (lane < run) ob[n + lane] = 2;
      n += run;
      i -= run;
      if (ends) state = 0;
    }
  }
  tile_arrived();                       // no copy outlives the walk

  // forced tails: only deletions are left at i == 0, only insertions at
  // j == 0, as far as the op string has room
  int tail = 0;
  int code = 255;
  if (i <= 0 && j > 0) {
    tail = min(j, BUF - n);
    code = 1;
  } else if (j <= 0 && i > 0) {
    tail = min(i, BUF - n);
    code = 2;
  }
  tail = max(tail, 0);
  for (int x = lane; x < tail; x += 32) ob[n + x] = (uint8_t)code;
  n += tail;
  for (int x = n + lane; x < BUF; x += 32) ob[x] = 255;
  if (lane == 0) n_out[b] = n;
}

}  // namespace

// Launches kernel B4 on `stream` and returns cudaGetLastError() (0 = ok).
// dirs (B, M, W) uint8; q_len, t_len, d_lo (B,) int32; ops (B, BUF) uint8
// with BUF = 2 * M + W + 8; n (B,) int32.  Every byte of ops and n is
// written.
extern "C" int focalsv_traceback(const void* dirs, const void* q_len,
                                 const void* t_len, const void* d_lo,
                                 void* ops, void* n, int B, int M, int W,
                                 int BUF, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  traceback_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(q_len),
      static_cast<const int32_t*>(t_len), static_cast<const int32_t*>(d_lo),
      static_cast<uint8_t*>(ops), static_cast<int32_t*>(n), B, M, W, BUF);
  return (int)cudaGetLastError();
}
