// Kernels B2 and B3: the region step of a delta chunk (B2) and of a dense
// chunk (B3), one launch a chunk each.  Both are one template,
// region_step_kernel<Src>, whose source type says how a tile's column
// counts and the sites' allele bits are found: DeltaSrc from the events of
// a delta chunk, RowsSrc from the packed rows of a dense one.  Everything
// from the leader's strip merge on (site compaction, the allele bitplanes'
// purification, blocks, MEC, the reads' and sites' results), the het test
// and strip key, the dense track writer and the cluster exchange are the
// same functions in both.  B3 is described after B2, at RowsSrc.
//
// B2 replaces focalsv_tpu/parallel/region_step.py::phase_consensus_delta_flat
// (XLA code: _one_region_delta, _select_sites_strips_dynamic, _phase_core,
// the two haplotype votes, _flat_parts_rle and _flat_parts).  It computes
// the bytes of the plain version,
// focalsv_tpu_torch/parallel/region_step.py::phase_consensus_delta_flat_plain:
// the chunk's one uint8 buffer in wire.delta_flat_layout in, (G, bytes)
// uint8 in wire.flat_layout_rle (Drle > 0) or wire.flat_layout (Drle == 0)
// out.  Every knob of STEP_DEFAULTS is an argument.
//
// What bounds it on an H100: neither.  A HiFi chunk (G 64, R 64, L 16384)
// reads G * (L + 9R + 9Ds + 12Dd + 4) = 2.46 MB and writes 0.42 MB, under
// 1 us at 3.35 TB/s; its work is some 100 int32 operations a column and 10
// a (read, site) entry of each MEC round the data needs, about 0.006 ms at
// the 16.75 T int32 operations a second of the card (PERF.md counts what
// each chunk's data needs).  What it does take is latency: a chain of
// barriers per tile of columns, and MEC rounds that each wait on the last.
//
// Design: a cluster of nc CTAs of 512 threads a region (nc 1, 2 or 4,
// chosen from the chunk's size and the card's SM count), a grid of G * nc.
// Per region:
//  0. Events binned by tile.  A read's span start and end, a deletion run's
//     start and end and a substitution are each one 32-bit event (the read,
//     the kind, the column within its tile of 4096).  Each CTA takes a
//     contiguous range of tiles; a counting sort (a histogram over its
//     tiles, a scan, a scatter) puts each event of its range into its
//     tile's bucket, in shared memory where it fits, else in the wrapper's
//     scratch.  The events before the range give the CTA its starting span
//     and deletion counts, so no CTA waits on another's sweep.
//  1. Column sweep for the sites.  A tile's events go by shared atomics into
//     difference arrays (span, deletion, 5 substitution rows); each thread
//     reads and clears its 8 columns, one block scan of the (span,
//     deletion) pair gives the counts, then the het test.  Het columns
//     update their strip's best by one 64-bit atomicMax on a key (balance
//     bits, ~column, a0, a1) in the CTA's shared memory, so the highest
//     balance and, among equal balances, the lowest column win; the key
//     also carries the two alleles of the winning column.  After the sweep
//     the leader CTA takes the largest key of each strip over the cluster
//     (distributed shared memory).  Three barriers a tile.
//  2. The leader CTA alone, the others waiting at a cluster barrier:
//     compaction of the selected strips by a prefix count (the plain
//     version's stable argsort).
//  3. The allele matrix A as two bitplanes of S rows (sites) by R bits
//     (reads): "covered" and "minor".  A row is seeded from the reference
//     base and the read spans (a ballot a word), then substitutions and
//     deletion runs rewrite their reads' bits (a binary search of the
//     site columns, which are in ascending order).  Deletion runs come
//     after substitutions: DEL wins.  The planes share shared memory with
//     the sweeps' difference arrays when they fit (3 * S * R / 8 bytes with
//     the block masks below: 192 KB at R 1024 and S 512) and else live in
//     the wrapper's scratch, 3 * S * ceil(R / 32) words a region.
//  4. Purification over popcounts of plane pairs; a second compaction
//     (passed sites, then the sites that failed, then the empty slots, each
//     in slot order) reorders the rows.
//  5. Blocks (a scan of the links), the parity initialisation (a scan of
//     the flips) and the MEC rounds; read assignment and site summaries.
//  6. One vote sweep for both haplotypes, every CTA on its range again.
//     Each read's class (hp 0 votes in both, hp 1 in the first, hp 2 in
//     the second, an invalid read in none) weights its events by 1, 65536
//     or 65537: every difference array holds the two haplotypes' counts as
//     the two 16-bit halves of one int32 (R < 32768), so one pass and one
//     scan of a packed pair serve both tracks.  The tracks are written as
//     the sweep goes: RLE runs from a running boundary count, or the dense
//     nibbles and coverage bits.  Four barriers a tile.  Across the
//     cluster, each CTA knows the state of the column before its range from
//     its own event pass, stages its runs, and the run indices are offset
//     by the boundary and deviation counts of the CTAs before it.
//
// Reformulations of the plain version, each exact:
//  - Block-constant assignment.  The plain version's bsum makes agree and
//    dis per (read, site) from prefix sums over the site's block, so they
//    are constant over a block: one signed count per (read, block) is the
//    same decision (a warp a (block, word of 32 reads), a ballot).
//  - Early stop.  A MEC round maps h to a new h and depends on h alone, so
//    once a round leaves h as it was, every later round does too.  A cycle
//    of period 2 runs all mec_iters rounds.
//  - Tile sweeps in place of cumsum, scatter-add and searchsorted: a run
//    starts where the running boundary count steps, and its length is the
//    count of deviating columns between its start and the next start.
//  - Events binned by tile: integer adds commute, so the order in which a
//    bucket's events land changes nothing, and a tile's carry is the sum of
//    the events before it.
//  - Reads binned by tile (B3): likewise, neither the order in which a
//    tile's list holds its reads nor the order of its groups changes a
//    count, and a read that meets no column of a tile adds nothing there.
//  - Column words (B3): six 5-bit fields count at most 31 reads before
//    they are added to the int counts; codes past 5 add nothing.
//  - Packed counts: the sum of a + 65536 b over events is exact in int32
//    while every partial count of either half lies in (-32768, 32768).
//  - Bitplanes in place of the (R, S) int8 matrix: A == h, A == 1 - h and
//    the votes become ANDs and popcounts of 32 reads at a time.
// Byte-exactness: the balance is __fdiv_rn (no fast math); argmax takes the
// first maximum; every comparison is the plain version's integer one.
//
// What the card taught (measured on an H100, PERF.md section 6):
//  - 64-bit atomicMax from several CTAs into the leader's keys through
//    distributed shared memory gave other keys than the plain version where
//    two columns of one strip met, at 2 and 4 CTAs a region (the CPU build
//    of testing/host_kernel.py could not show it).  Each CTA keeps its own
//    keys; the leader takes the largest of each strip after a cluster
//    barrier, with plain loads.
//  - A thread's 8 columns stored side by side put a warp's scalar reads of
//    a row 32 bytes apart, 8 threads to a bank: the substitution rows cost
//    more than the rest of a tile.  slot_of lays them out for int4 reads
//    without conflicts.
//  - Most columns carry no substitution and no deletion: they skip the het
//    test and take their vote from the span count alone.

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // columns a thread holds in a tile
constexpr int kTile = kCols * kThreads;   // columns of a tile
constexpr int kTileBits = 12;             // log2(kTile)
constexpr int kRows = 7;                  // span, deletion, 5 substitution rows
constexpr int kMaxCluster = 4;            // CTAs a region, at most (B2)
constexpr int kMaxRowsCluster = 8;        // CTAs a region, at most (B3)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDelSym = 254;
constexpr unsigned kMaxCol = (1u << 26) - 1;   // columns fit 26 key bits
constexpr unsigned kNoRead = 0xffffu;          // an event's read past R
constexpr int kMaxReads = 32767;               // a 16-bit half per count

constexpr int kBlock = 128;               // a dense row starts on a block
// sections of wire.delta_flat_layout, in order
enum { IN_REF, IN_STARTS, IN_ENDS, IN_RV, IN_SUB_POS, IN_SUB_READ, IN_SUB_SYM,
       IN_DEL_READ, IN_DEL_A, IN_DEL_B, IN_LTRUE, IN_COUNT };
// sections of wire.rows_flat_layout, in order
enum { IN_ROWS, IN_QSTART, IN_ROWS_RV, IN_ROWS_LTRUE, IN_ROWS_COUNT };
// misc scalars in shared memory; the leader's also gather the cluster's
// (M_CARRY_C through M_VSUB + 4 are cleared together)
enum { M_A0_COL0, M_CD, M_LAST = M_CD + 2, M_CARRY_C = M_LAST + 2, M_CARRY_D,
       M_VSUB, M_PREV = M_VSUB + 5, M_TOTALS,
       M_COUNT = M_TOTALS + 4 * kMaxCluster };
// the state of a column in the vote: symbol or 7 (bits 0-2), deviates (bit 3)
constexpr int kStateBits = 4;

struct Params {
  const uint8_t* buf;
  uint8_t* out;
  uint32_t* planes_g;         // the planes when they are not in shared memory
  uint32_t* events_g;         // the events when they are not in shared memory
  uint16_t* list_g;           // B3's read lists when not in shared memory
  long long list_stride;      // entries of a CTA's lists in list_g
  int32_t* stage_g;           // runs of a CTA past the leader, per track
  unsigned long long* stamps;  // phase stamps (kernel_sweep's build alone)
  bool rows;                  // a dense chunk (B3): W is its row width
  int G, R, L, W, Ds, Dd, Drle, S, RW, nc, E, tiles_per_cta;
  int mec_iters, min_site_depth, min_minor_count, lo_num, lo_den, hi_num,
      hi_den, purify_window, purify_min_pairs, purify_num, purify_den;
  long long in_off[IN_COUNT];
  long long out_stride;
  // shared memory, byte offsets: the union (difference arrays or planes)
  // first
  int s_keys, s_dif, s_planes, s_events, s_list, s_q, s_meta, s_toff, s_cur;
  int s_wsum, s_wscan, s_wlast, s_misc, s_col, s_tcol, s_blk, s_bstart, s_hm,
      s_a, s_ta, s_h, s_hn, s_lnk, s_hp, s_cls;
};

// One region's inputs and the CTA's shared arrays.
struct Ctx {
  const uint8_t* ref;
  const int* starts;
  const int* ends;
  const uint8_t* rv;
  const int* sub_pos;
  const int* sub_read;
  const uint8_t* sub_sym;
  const int* del_read;
  const int* del_a;
  const int* del_b;
  const uint8_t* rows;        // (R, W / 2) split-half nibbles (B3)
  const int* qstart;          // (R,) first block of each row (B3)
  int* qs;                    // qstart staged in shared memory, or null
  const int* sq;              // qs, or qstart where it is not staged
  uint16_t* list;             // B3: this CTA's reads, listed by tile
  uint8_t* ring;              // B3: the stages of row bytes
  int2* meta;                 // B3: (kStages, kGroup) first column, class
  int ltrue;
  uint8_t* out;
  int rank, nc;               // this CTA in its region's cluster
  // B2: its columns [c_lo, c_hi) in n_tiles tiles; B3: the same range of
  // each half of the columns, [c_lo, c_hi) and [c_lo + L/2, c_hi + L/2),
  // end to end a run of 2 hl columns in n_tiles tiles
  int c_lo, c_hi, n_tiles, hl;
  unsigned long long* keys;   // (S,) best key of each strip in this CTA
  int* dif;                   // (kRows, kTile) difference arrays of a tile
  uint32_t* events;           // this CTA's events, bucketed by tile
  int* toff;                  // (n_tiles + 1,) first event (B3: read) of a tile
  int* cur;                   // (n_tiles,) scatter cursors
  int32_t* stage;             // (2, 3, Drle + 1) runs staged by a CTA > 0
  uint32_t* pcov;             // (S, RW) covered bits
  uint32_t* pmin;             // (S, RW) minor-allele bits
  uint32_t* pasm;             // (S, RW) assignment bits a block (and a temp)
  int* wsum;                  // (33,) block scan
  int2* wscan;                // (2, 32) block scan of pairs, two buffers
  int* wlast;                 // (kWarps,) state of each warp's last column
  int* misc;
  int* lmisc;                 // the leader's misc (this CTA's own on it)
  int* col;                   // (S,) site columns
  int* tcol;                  // (S,) temp
  int* blk;                   // (S,) block of a site (and a temp)
  int* bstart;                // (S + 1,) first site of each block
  uint32_t* hm;               // (2, RW) reads of haplotype 1, 2
  uint8_t* a;                 // (S,) a0 | a1 << 4 (allele indices 0..4)
  uint8_t* ta;                // (S,) temp
  uint8_t* h;                 // (S,) MEC haplotype of a site
  uint8_t* hn;                // (S,) flags and the next h
  uint8_t* lnk;               // (S,) site linked to the next one
  int8_t* hp;                 // (R,) read haplotype
  uint8_t* cls;               // (R,) read class in the vote: bit k-1 for k
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

__device__ __forceinline__ void st_i32(uint8_t* p, int v) {
  // the result sections need not be 4-byte aligned: byte stores
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

__device__ __forceinline__ int ld_i32(const uint8_t* p) {
  return (int)((unsigned)p[0] | ((unsigned)p[1] << 8) |
               ((unsigned)p[2] << 16) | ((unsigned)p[3] << 24));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ int2 warp_incl_scan2(int2 v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int nx = __shfl_up_sync(kFull, v.x, o);
    const int ny = __shfl_up_sync(kFull, v.y, o);
    if (lane >= o) { v.x += nx; v.y += ny; }
  }
  return v;
}

// Exclusive scan of v over the block; the block's total in `total`.  Every
// thread calls it.
__device__ int block_excl_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = warp_incl_scan(v);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < nw ? wsum[lane] : 0;
    const int si = warp_incl_scan(s);
    if (lane < nw) wsum[lane] = si - s;
    if (lane == 31) wsum[32] = si;
  }
  __syncthreads();
  const int res = wsum[warp] + inc - v;
  total = wsum[32];
  __syncthreads();
  return res;
}

// Exclusive scan of a pair over the block with one barrier: every warp scans
// the warp totals itself.  The two buffers alternate (`par`, the same in
// every thread): a scan writes the buffer that the scan before the last one
// read, and every thread had read it before the last scan's barrier.
__device__ int2 block_scan2(int2 v, int2* wscan, int& par, int2& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2 inc = warp_incl_scan2(v);
  int2* buf = wscan + 32 * par;
  par ^= 1;
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  int2 s = lane < kWarps ? buf[lane] : make_int2(0, 0);
  s = warp_incl_scan2(s);
  const int src = warp ? warp - 1 : 0;
  int2 before;
  before.x = __shfl_sync(kFull, s.x, src);
  before.y = __shfl_sync(kFull, s.y, src);
  total.x = __shfl_sync(kFull, s.x, kWarps - 1);
  total.y = __shfl_sync(kFull, s.y, kWarps - 1);
  if (!warp) before = make_int2(0, 0);
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// the two haplotypes' counts out of a packed int32 (low half first)
__device__ __forceinline__ int lo16(int w) { return (int)(short)(w & 0xffff); }
__device__ __forceinline__ int hi16(int w) { return (w - lo16(w)) >> 16; }

__device__ __forceinline__ int code_of(int i) { return i < 4 ? i : kDelSym; }

// 0 major, 1 minor, -1 neither, for a read symbol at a site of alleles a
__device__ __forceinline__ int allele_of(int sym, int a) {
  return sym == code_of(a & 15) ? 0 : (sym == code_of(a >> 4) ? 1 : -1);
}

__device__ __forceinline__ bool spans(const Ctx& c, int r, int col) {
  return c.rv[r] && c.starts[r] <= col && col < c.ends[r];
}

// first site slot in [0, n) whose column is >= col
__device__ __forceinline__ int lower_site(const Ctx& c, int n, int col) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.col[mid] < col) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// -- events -----------------------------------------------------------------

// Event kinds: span start and end, deletion-run start and end, then a
// substitution of symbol 0..4.  The difference-array row of a kind, and
// its sign.
enum { EV_SPAN_A, EV_SPAN_B, EV_DEL_A, EV_DEL_B, EV_SUB };
__device__ __forceinline__ int row_of(int kind) {
  return kind < EV_DEL_A ? 0 : (kind < EV_SUB ? 1 : kind - EV_SUB + 2);
}

// f(col, kind, read) for this thread's share of the region's events that a
// sweep counts: the spans of the valid reads, the deletion runs and the
// substitutions of a read (a padded one has read < 0), each at a column in
// [0, L); read is kNoRead for a read past R.  The site sweep counts every
// such event; the vote weights it by its read's class.  One loop a section
// keeps each loop's loads independent of the last.
template <class F>
__device__ __forceinline__ void for_each_event(const Params& p, const Ctx& c,
                                               F f) {
  for (int r = threadIdx.x; r < p.R; r += blockDim.x) {
    const int a = c.starts[r], b = c.ends[r];
    if (!c.rv[r]) continue;
    if (0 <= a && a < p.L) f(a, (int)EV_SPAN_A, (unsigned)r);
    if (0 <= b && b < p.L) f(b, (int)EV_SPAN_B, (unsigned)r);
  }
  for (int i = threadIdx.x; i < p.Dd; i += blockDim.x) {
    const int r = c.del_read[i], a = c.del_a[i], b = c.del_b[i];
    if (r < 0) continue;
    const unsigned read = r < p.R ? (unsigned)r : kNoRead;
    if (0 <= a && a < p.L) f(a, (int)EV_DEL_A, read);
    if (0 <= b && b < p.L) f(b, (int)EV_DEL_B, read);
  }
  for (int i = threadIdx.x; i < p.Ds; i += blockDim.x) {
    const int r = c.sub_read[i], q = c.sub_pos[i];
    const int kind = EV_SUB + imin(c.sub_sym[i], 4);
    if (r < 0 || q < 0 || q >= p.L) continue;
    f(q, kind, r < p.R ? (unsigned)r : kNoRead);
  }
}

// The vote's weight of a read's events: its class's bits as the 16-bit
// halves of the two haplotypes' counts.
__device__ __forceinline__ int class_weight(const Ctx& c, unsigned read) {
  if (read == kNoRead) return 0;
  const int k = c.cls[read];
  return (k & 1) + ((k & 2) << 15);
}

// Counts of n_tiles buckets (toff) to offsets (toff, n_tiles + 1 of them)
// and scatter cursors (cur).  Every thread calls it.
__device__ void counts_to_offsets(const Ctx& c, int nt) {
  int run = 0;
  for (int t0 = 0; t0 <= nt; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const int n = t < nt ? c.toff[t] : 0;
    int tot;
    const int off = run + block_excl_scan(n, c.wsum, tot);
    if (t <= nt) c.toff[t] = off;
    if (t < nt) c.cur[t] = off;
    run += tot;
  }
  __syncthreads();
}

// Bin this CTA's events by tile; the site sweep's span and deletion counts
// at c_lo from the events before it go to misc.
__device__ void bin_events(const Params& p, const Ctx& c) {
  const int nt = c.n_tiles;
  for (int t = threadIdx.x; t <= nt; t += blockDim.x) c.toff[t] = 0;
  if (threadIdx.x == 0) {
    c.misc[M_CARRY_C] = 0;
    c.misc[M_CARRY_D] = 0;
  }
  __syncthreads();
  int carry_c = 0, carry_d = 0;
  for_each_event(p, c, [&](int col, int kind, unsigned) {
    if (col < c.c_lo) {
      const int s = (kind & 1) ? -1 : 1;
      if (kind < EV_DEL_A) carry_c += s;
      else if (kind < EV_SUB) carry_d += s;
    } else if (col < c.c_hi) {
      atomicAdd(&c.toff[(col - c.c_lo) >> kTileBits], 1);
    }
  });
  carry_c = warp_sum(carry_c);
  carry_d = warp_sum(carry_d);
  if ((threadIdx.x & 31) == 0 && (carry_c | carry_d)) {
    atomicAdd(&c.misc[M_CARRY_C], carry_c);
    atomicAdd(&c.misc[M_CARRY_D], carry_d);
  }
  __syncthreads();
  counts_to_offsets(c, nt);
  for_each_event(p, c, [&](int col, int kind, unsigned read) {
    if (col < c.c_lo || col >= c.c_hi) return;
    const int q = col - c.c_lo;
    const int slot = atomicAdd(&c.cur[q >> kTileBits], 1);
    c.events[slot] = (read << 16) | ((unsigned)kind << kTileBits) |
                     (unsigned)(q & (kTile - 1));
  });
  __syncthreads();
}

// Where column q of a tile lies in a difference row: thread t's columns
// 8t..8t+3 at 4t of the row's first half, 8t+4..8t+7 at 4t of its second,
// so that a warp reads its threads' columns four at a time with no two
// threads on one bank.
static_assert(kCols == 8, "slot_of and quad_of take 8 columns a thread");
__device__ __forceinline__ int slot_of(int q) {
  return ((q >> 2) & 1) * (kTile / 2) + ((q >> 3) << 2) + (q & 3);
}

// One tile's events into the difference arrays (which are clear): weight 1
// in the site sweep, the read's class weight in the vote.  No barrier.
__device__ __forceinline__ void tile_events(const Ctx& c, int lt, bool vote) {
  const int e1 = c.toff[lt + 1];
  for (int e = c.toff[lt] + threadIdx.x; e < e1; e += blockDim.x) {
    const uint32_t ev = c.events[e];
    const int w = vote ? class_weight(c, ev >> 16) : 1;
    if (!w) continue;
    const int kind = (ev >> kTileBits) & 15;
    const int q = ev & (kTile - 1);
    atomicAdd(&c.dif[row_of(kind) * kTile + slot_of(q)],
              (kind == EV_SPAN_B || kind == EV_DEL_B) ? -w : w);
  }
}

// Where this thread's columns 4h..4h+3 of a tile lie in a difference row.
__device__ __forceinline__ int quad_of(int h) {
  return h * (kTile / 2) + 4 * threadIdx.x;
}

// This thread's kCols span and deletion counts in a tile (packed per
// haplotype in the vote), from the difference arrays, which it clears, and
// the carries; one barrier.  Call after the tile's events and a barrier.
__device__ __forceinline__ void tile_counts(const Ctx& c, int& par,
                                            int& carry_c, int& carry_d,
                                            int (&cov)[kCols],
                                            int (&del)[kCols]) {
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int h = 0; h < kCols / 4; ++h) {
    int4* dc = reinterpret_cast<int4*>(c.dif + quad_of(h));
    int4* dd = reinterpret_cast<int4*>(c.dif + kTile + quad_of(h));
    const int4 vc = *dc, vd = *dd;
    *dc = zero;
    *dd = zero;
    cov[4 * h] = vc.x; cov[4 * h + 1] = vc.y;
    cov[4 * h + 2] = vc.z; cov[4 * h + 3] = vc.w;
    del[4 * h] = vd.x; del[4 * h + 1] = vd.y;
    del[4 * h + 2] = vd.z; del[4 * h + 3] = vd.w;
  }
  for (int j = 1; j < kCols; ++j) {
    cov[j] += cov[j - 1];
    del[j] += del[j - 1];
  }
  int2 tot;
  const int2 ex = block_scan2(make_int2(cov[kCols - 1], del[kCols - 1]),
                              c.wscan, par, tot);
  for (int j = 0; j < kCols; ++j) {
    cov[j] += carry_c + ex.x;
    del[j] += carry_d + ex.y;
  }
  carry_c += tot.x;
  carry_d += tot.y;
}

// the substitution counts of this thread's columns 4h..4h+3 in a tile,
// read and cleared: sub[column][symbol]
__device__ __forceinline__ void take_subs(const Ctx& c, int h,
                                          int (&sub)[4][5]) {
  for (int s = 0; s < 5; ++s) {
    int4* q = reinterpret_cast<int4*>(c.dif + (2 + s) * kTile + quad_of(h));
    const int4 v = *q;
    *q = make_int4(0, 0, 0, 0);
    sub[0][s] = v.x;
    sub[1][s] = v.y;
    sub[2][s] = v.z;
    sub[3][s] = v.w;
  }
}

__device__ void clear_dif(const Ctx& c) {
  int4* d = reinterpret_cast<int4*>(c.dif);
  for (int i = threadIdx.x; i < kRows * kTile / 4; i += blockDim.x)
    d[i] = make_int4(0, 0, 0, 0);
}

// The het test of a column from its allele counts {A, C, G, T, DEL}; a het
// column updates its strip's best in this CTA's keys.  Column 0's alleles go
// to misc (the empty site slots take them).  `strip`: columns a strip.
__device__ __forceinline__ void site_key(const Params& p, const Ctx& c,
                                         int col, const int (&cnt)[5],
                                         int strip) {
  // a0: the first maximum; a1: the first maximum with a0 masked to -1
  int a0 = 0, n0 = cnt[0];
  for (int s = 1; s < 5; ++s)
    if (cnt[s] > n0) { n0 = cnt[s]; a0 = s; }
  int a1 = 0, top1 = a0 == 0 ? -1 : cnt[0];
  for (int s = 1; s < 5; ++s) {
    const int v = s == a0 ? -1 : cnt[s];
    if (v > top1) { top1 = v; a1 = s; }
  }
  if (col == 0) c.misc[M_A0_COL0] = a0 | (a1 << 4);
  const int depth = cnt[0] + cnt[1] + cnt[2] + cnt[3] + cnt[4];
  const bool het = depth >= imax(p.min_site_depth, 1) &&
                   top1 * p.lo_den >= depth * p.lo_num &&
                   top1 * p.hi_den <= depth * p.hi_num &&
                   top1 >= p.min_minor_count;
  if (!het) return;
  const float bal = __fdiv_rn((float)top1, (float)imax(n0 + top1, 1));
  if (!(bal > 0.f)) return;                // never selected
  const int stripe = imin(col / strip, p.S - 1);
  const unsigned lo = ((kMaxCol - (unsigned)col) << 6) |
                      ((unsigned)a0 << 3) | (unsigned)a1;
  atomicMax(&c.keys[stripe],
            ((unsigned long long)__float_as_uint(bal) << 32) | lo);
}

// Sweep 1 over this CTA's tiles: column counts, het columns, the best
// column of each strip among them in this CTA's keys.
__device__ void sweep_sites(const Params& p, const Ctx& c) {
  const int S = p.S, i0 = threadIdx.x * kCols;
  // strips over the region's TRUE length; the last strip takes the rest
  const int strip = imax((c.ltrue + S - 1) / S, 1);
  int carry_c = c.misc[M_CARRY_C], carry_d = c.misc[M_CARRY_D], par = 0;
  for (int lt = 0; lt < c.n_tiles; ++lt) {
    const int t0 = c.c_lo + lt * kTile;
    tile_events(c, lt, false);
    __syncthreads();
    int cov[kCols], del[kCols];
    tile_counts(c, par, carry_c, carry_d, cov, del);
    int subs[4][5];
    for (int j = 0; j < kCols; ++j) {
      const int col = t0 + i0 + j;
      if ((j & 3) == 0) take_subs(c, j >> 2, subs);
      const int* sub = subs[j & 3];
      if (col >= c.c_hi) continue;
      // no substitution and no deletion: no second allele, never a site
      if (col != 0 && del[j] == 0 &&
          (sub[0] | sub[1] | sub[2] | sub[3] | sub[4]) == 0)
        continue;
      int cnt[5];
      const int base = cov[j] - del[j] - sub[0] - sub[1] - sub[2] - sub[3] -
                       sub[4];                  // reads matching ref
      const int rf = c.ref[col];
      for (int s = 0; s < 4; ++s) cnt[s] = (rf == s ? base : 0) + sub[s];
      cnt[4] = del[j];
      site_key(p, c, col, cnt, strip);
    }
    __syncthreads();       // every column read and cleared: the next events
  }
}

// The selected strips to the front in strip order (ascending columns); the
// empty slots hold column 0 and its alleles.  Returns their count.
__device__ int compact_sites(const Params& p, const Ctx& c) {
  int run = 0;
  for (int s0 = 0; s0 < p.S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const unsigned long long key = s < p.S ? c.keys[s] : 0ull;
    int tot;
    const int dst = run + block_excl_scan(key != 0ull, c.wsum, tot);
    if (key != 0ull) {
      const unsigned lo = (unsigned)key;
      c.col[dst] = (int)(kMaxCol - (lo >> 6));
      c.a[dst] = (uint8_t)(((lo >> 3) & 7) | ((lo & 7) << 4));
    }
    run += tot;
  }
  const int a_col0 = c.misc[M_A0_COL0];
  for (int s = run + threadIdx.x; s < p.S; s += blockDim.x) {
    c.col[s] = 0;
    c.a[s] = (uint8_t)a_col0;
  }
  __syncthreads();
  return run;
}

__device__ __forceinline__ void set_allele(const Ctx& c, int idx, int lane,
                                           int v) {
  const unsigned bit = 1u << lane;
  if (v >= 0) atomicOr(&c.pcov[idx], bit); else atomicAnd(&c.pcov[idx], ~bit);
  if (v == 1) atomicOr(&c.pmin[idx], bit); else atomicAnd(&c.pmin[idx], ~bit);
}

// The allele matrix of the n_het selected sites as bitplanes.
__device__ void build_alleles(const Params& p, const Ctx& c, int n_het) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, RW = p.RW, total = p.S * RW;
  for (int idx = warp; idx < n_het * RW; idx += nw) {
    const int s = idx / RW, w = idx - s * RW;
    const int col = c.col[s], r = w * 32 + lane;
    const unsigned span = __ballot_sync(kFull, r < p.R && spans(c, r, col));
    const int v = allele_of(c.ref[col], c.a[s]);
    if (lane == 0) {
      c.pcov[idx] = v >= 0 ? span : 0u;
      c.pmin[idx] = v == 1 ? span : 0u;
    }
  }
  for (int idx = n_het * RW + threadIdx.x; idx < total; idx += blockDim.x) {
    c.pcov[idx] = 0u;
    c.pmin[idx] = 0u;
  }
  __syncthreads();
  // four substitutions a thread at a time, their loads in flight together
  for (int i0 = threadIdx.x; i0 < p.Ds; i0 += 4 * blockDim.x) {
    int rr[4], pp[4];
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      rr[k] = i < p.Ds ? c.sub_read[i] : -1;
      pp[k] = i < p.Ds ? c.sub_pos[i] : 0;
    }
    for (int k = 0; k < 4; ++k) {
      const int r = rr[k], pos = pp[k];
      if (r < 0 || r >= p.R) continue;
      const int s = lower_site(c, n_het, pos);
      if (s == n_het || c.col[s] != pos || !spans(c, r, pos)) continue;
      set_allele(c, s * RW + (r >> 5), r & 31,
                 allele_of(c.sub_sym[i0 + k * blockDim.x], c.a[s]));
    }
  }
  __syncthreads();
  // a deletion run over a site makes it DEL, whatever else the read has
  for (int i = threadIdx.x; i < p.Dd; i += blockDim.x) {
    const int r = c.del_read[i];
    if (r < 0 || r >= p.R) continue;
    const int b = c.del_b[i];
    for (int s = lower_site(c, n_het, c.del_a[i]); s < n_het && c.col[s] < b;
         ++s)
      if (spans(c, r, c.col[s]))
        set_allele(c, s * RW + (r >> 5), r & 31, allele_of(kDelSym, c.a[s]));
  }
  __syncthreads();
}

// The integer 3-sigma co-phasing test of sites x and y.
__device__ bool pair_ok(const Params& p, const Ctx& c, int x, int y) {
  const int RW = p.RW;
  int n = 0, same = 0;
  for (int w = 0; w < RW; ++w) {
    const unsigned both = c.pcov[x * RW + w] & c.pcov[y * RW + w];
    n += __popc(both);
    same += __popc(both & ~(c.pmin[x * RW + w] ^ c.pmin[y * RW + w]));
  }
  const int dv = abs(2 * same - n);
  return n >= p.purify_min_pairs && dv * p.purify_den >= n * p.purify_num &&
         dv * dv >= 9 * n;
}

__device__ void move_rows(const Params& p, const Ctx& c, uint32_t* plane,
                          int nS) {
  const int RW = p.RW, total = p.S * RW;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int s = idx / RW;
    if (c.hn[s]) c.pasm[c.blk[s] * RW + idx - s * RW] = plane[idx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
    plane[idx] = idx / RW < nS ? c.pasm[idx] : 0u;
  __syncthreads();
}

// Purification, then the second compaction: sites that passed, then the
// sites that failed, then the empty slots, each in slot order; the rows of
// the sites that failed are cleared.  Returns the count that passed.
__device__ int purify(const Params& p, const Ctx& c, int n_het) {
  const int S = p.S, dmax = imin(p.purify_window, S - 1);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    bool pass = false;
    if (s < n_het) {
      if (n_het < 2) {
        pass = true;                  // fewer than 2 sites: no purification
      } else {
        for (int d = 1; d <= dmax && !pass; ++d)
          pass = (s + d < S && pair_ok(p, c, s, s + d)) ||
                 (s - d >= 0 && pair_ok(p, c, s - d, s));
      }
    }
    c.hn[s] = pass;
  }
  __syncthreads();
  int run = 0;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int f = s < S ? c.hn[s] : 0;
    int tot;
    const int e = run + block_excl_scan(f, c.wsum, tot);
    if (s < S) c.blk[s] = e;            // passed sites before s
    run += tot;
  }
  const int nS = run;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int dst = c.hn[s] ? c.blk[s] : nS + s - c.blk[s];
    c.blk[s] = dst;
    c.tcol[dst] = c.col[s];
    c.ta[dst] = c.a[s];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    c.col[s] = c.tcol[s];
    c.a[s] = c.ta[s];
  }
  move_rows(p, c, c.pcov, nS);
  move_rows(p, c, c.pmin, nS);
  return nS;
}

// Links, blocks and the chained parity start of h.  Returns the number of
// blocks among the nS sites.
__device__ int blocks_and_init(const Params& p, const Ctx& c, int nS) {
  const int S = p.S, RW = p.RW;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    int nb = 0, same = 0;
    if (j + 1 < S) {
      for (int w = 0; w < RW; ++w) {
        const unsigned both = c.pcov[j * RW + w] & c.pcov[(j + 1) * RW + w];
        nb += __popc(both);
        same += __popc(both & ~(c.pmin[j * RW + w] ^ c.pmin[(j + 1) * RW + w]));
      }
    }
    c.lnk[j] = nb > 0;
    c.hn[j] = nb > 0 && same < nb - same;     // flip at the next site
  }
  __syncthreads();
  int runb = 0, runh = 0;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int is_start = s < S && (s == 0 || !c.lnk[s - 1]);
    const int fl = s < S ? c.hn[s] : 0;
    int tb, th;
    const int eb = runb + block_excl_scan(is_start, c.wsum, tb);
    const int eh = runh + block_excl_scan(fl, c.wsum, th);
    if (s < S) {
      c.blk[s] = eb + is_start - 1;
      c.tcol[s] = eh;                         // flips before s
      if (is_start) c.bstart[eb] = s;
    }
    runb += tb;
    runh += th;
  }
  if (threadIdx.x == 0) c.bstart[runb] = S;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    c.h[j] = (uint8_t)((c.tcol[j] - c.tcol[c.bstart[c.blk[j]]]) & 1);
  __syncthreads();
  return nS > 0 ? c.blk[nS - 1] + 1 : 0;
}

// Each read's assignment in each block: agree >= dis over the block's sites.
__device__ void assign(const Params& p, const Ctx& c, int nB) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, RW = p.RW;
  for (int q = warp; q < nB * RW; q += nw) {
    const int b = q / RW, w = q - b * RW;
    int diff = 0;
    for (int j = c.bstart[b]; j < c.bstart[b + 1]; ++j) {
      const unsigned cw = c.pcov[j * RW + w];
      if ((cw >> lane) & 1u)
        diff += (int)((c.pmin[j * RW + w] >> lane) & 1u) == c.h[j] ? 1 : -1;
    }
    const unsigned m = __ballot_sync(kFull, diff >= 0);
    if (lane == 0) c.pasm[q] = m;
  }
  __syncthreads();
}

// One MEC round's new h from the assignment.  Returns whether h changed.
__device__ bool update_h(const Params& p, const Ctx& c, int nS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, RW = p.RW;
  int changed = 0;
  for (int j = warp; j < nS; j += nw) {
    const int b = c.blk[j];
    int v1 = 0, n = 0;
    for (int w = lane; w < RW; w += 32) {
      const unsigned cw = c.pcov[j * RW + w];
      v1 += __popc(cw & ~(c.pmin[j * RW + w] ^ c.pasm[b * RW + w]));
      n += __popc(cw);
    }
    v1 = warp_sum(v1);
    n = warp_sum(n);
    const int hv = v1 > n - v1;
    if (lane == 0) {
      c.hn[j] = (uint8_t)hv;
      changed |= hv != c.h[j];
    }
  }
  const int any = __syncthreads_or(changed);
  for (int j = threadIdx.x; j < nS; j += blockDim.x) c.h[j] = c.hn[j];
  __syncthreads();
  return any != 0;
}

// Each read takes the block and hp of its FIRST covered site (hp 0 and
// block -1 without one); also the reads of haplotype 1 and 2 as bit masks.
__device__ void reads_out(const Params& p, const Ctx& c, int nS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, RW = p.RW;
  uint8_t* o_hp = c.out + 4 + 8LL * p.S;
  uint8_t* o_rb = o_hp + p.R;
  for (int w = warp; w < RW; w += nw) {
    const int r = w * 32 + lane;
    int fs = -1;
    for (int j = 0; j < nS && fs < 0; ++j)
      if ((c.pcov[j * RW + w] >> lane) & 1u) fs = j;
    const bool ok = r < p.R && c.rv[r] && fs >= 0;
    int hv = 0, rb = -1;
    if (ok) {
      rb = c.blk[fs];
      hv = ((c.pasm[rb * RW + w] >> lane) & 1u) ? 1 : 2;
    }
    const unsigned m1 = __ballot_sync(kFull, hv == 1);
    const unsigned m2 = __ballot_sync(kFull, hv == 2);
    if (lane == 0) {
      c.hm[w] = m1;
      c.hm[RW + w] = m2;
    }
    if (r < p.R) {
      c.hp[r] = (int8_t)hv;
      o_hp[r] = (uint8_t)hv;
      o_rb[2 * r] = (uint8_t)rb;              // int16, little-endian
      o_rb[2 * r + 1] = (uint8_t)(rb >> 8);
    }
  }
  __syncthreads();
}

// n_sites, site_pos, the alleles, site_h and conn.
__device__ void sites_out(const Params& p, const Ctx& c, int nS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, RW = p.RW, S = p.S;
  uint8_t* o_a0 = c.out + 4 + 4LL * S;
  uint8_t* o_a1 = o_a0 + S;
  uint8_t* o_h = o_a1 + S;
  uint8_t* o_conn = o_h + S;
  for (int j = warp; j < nS; j += nw) {
    int v1 = 0, v0 = 0;
    for (int w = lane; w < RW; w += 32) {
      const unsigned cw = c.pcov[j * RW + w], mw = c.pmin[j * RW + w];
      const unsigned h1 = c.hm[w], h2 = c.hm[RW + w];
      v1 += __popc(cw & mw & h1) + __popc(cw & ~mw & h2);
      v0 += __popc(cw & ~mw & h1) + __popc(cw & mw & h2);
    }
    v1 = warp_sum(v1);
    v0 = warp_sum(v0);
    if (lane == 0) o_h[j] = v1 > v0;
  }
  for (int j = nS + threadIdx.x; j < S; j += blockDim.x) o_h[j] = 0;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    st_i32(c.out + 4 + 4LL * j, c.col[j]);
    o_a0[j] = (uint8_t)code_of(c.a[j] & 15);
    o_a1[j] = (uint8_t)code_of(c.a[j] >> 4);
    o_conn[j] = j + 1 < S ? c.lnk[j] : 0;
  }
  if (threadIdx.x == 0) st_i32(c.out, nS);
  __syncthreads();
}

// The vote's state of a column for one haplotype's counts, as kStateBits
// bits: the voted symbol (0..5) or 7 when no read covers it, and bit 3 when
// it deviates from the reference inside the region's true length; the
// voted symbol itself in `sym`.
__device__ __forceinline__ int column_state(int cov, int del, const int (&sub)[5],
                                            int rf, bool in_true, int& sym) {
  const int base = cov - del - sub[0] - sub[1] - sub[2] - sub[3] - sub[4];
  int best = (rf == 0 ? base : 0) + sub[0], tot = best;
  sym = 0;
  for (int s = 1; s < 6; ++s) {
    const int v = s < 5 ? (rf == s ? base : 0) + sub[s] : del;
    tot += v;
    if (v > best) { best = v; sym = s; }
  }
  const bool covered = tot > 0;
  const bool dv = in_true && !(covered && sym == rf);
  return (covered ? sym : 7) | (dv ? 8 : 0);
}

// A column's two states out of packed counts (haplotype 1 in bits 0-3,
// haplotype 2 in bits 4-7) and the two voted symbols likewise.
__device__ __forceinline__ int column_states(int cov, int del,
                                             const int (&sub)[5], int rf,
                                             bool in_true, int& syms) {
  // most columns hold no substitution and no deletion: a read that covers
  // one votes its reference base (a zero packed word is zero in both halves)
  const int c1 = lo16(cov), c2 = hi16(cov);
  if ((sub[0] | sub[1] | sub[2] | sub[3] | sub[4] | del) == 0 && rf < 5 &&
      c1 >= 0 && c2 >= 0) {
    const int a = c1 > 0 ? rf : 7 | (in_true ? 8 : 0);
    const int b = c2 > 0 ? rf : 7 | (in_true ? 8 : 0);
    syms = (c1 > 0 ? rf : 0) | ((c2 > 0 ? rf : 0) << 4);
    return a | (b << kStateBits);
  }
  int s1[5], s2[5];
  for (int s = 0; s < 5; ++s) {
    s1[s] = lo16(sub[s]);
    s2[s] = hi16(sub[s]);
  }
  int y1, y2;
  const int a = column_state(c1, lo16(del), s1, rf, in_true, y1);
  const int b = column_state(c2, hi16(del), s2, rf, in_true, y2);
  syms = y1 | (y2 << 4);
  return a | (b << kStateBits);
}

// The vote's span and deletion counts (packed) at c_lo from the events
// before this CTA's range, and the state of the column before it
// (M_PREV; 0 for the leader, whose range starts at column 0).
__device__ void vote_carries(const Params& p, const Ctx& c) {
  if (threadIdx.x < 7) c.misc[M_CARRY_C + threadIdx.x] = 0;  // carries, subs
  __syncthreads();
  if (c.rank > 0) {
    int cc = 0, cd = 0;
    for_each_event(p, c, [&](int col, int kind, unsigned read) {
      if (col >= c.c_lo) return;
      const int w = class_weight(c, read);
      const int sw = (kind == EV_SPAN_B || kind == EV_DEL_B) ? -w : w;
      if (kind < EV_DEL_A) cc += sw;
      else if (kind < EV_SUB) cd += sw;
      else if (col == c.c_lo - 1 && w)
        atomicAdd(&c.misc[M_VSUB + kind - EV_SUB], w);
    });
    cc = warp_sum(cc);
    cd = warp_sum(cd);
    if ((threadIdx.x & 31) == 0 && (cc | cd)) {
      atomicAdd(&c.misc[M_CARRY_C], cc);
      atomicAdd(&c.misc[M_CARRY_D], cd);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev = 0;
    if (c.rank > 0) {
      const int col = c.c_lo - 1;
      int sub[5], syms;
      for (int s = 0; s < 5; ++s) sub[s] = c.misc[M_VSUB + s];
      prev = column_states(c.misc[M_CARRY_C], c.misc[M_CARRY_D], sub,
                           c.ref[col], col < c.ltrue, syms);
    }
    c.misc[M_PREV] = prev;
  }
  __syncthreads();
}

// A run of haplotype k (0, 1) starts at col: the leader writes it to the
// result (run eb; at eb == Drle, the deviating columns before it go to
// M_CD), a CTA after it stages it at its own index for now.
__device__ __forceinline__ void record_run(const Params& p, const Ctx& c,
                                           int k, int eb, int col, int st,
                                           int ed, uint8_t* o_start,
                                           uint8_t* o_len, uint8_t* o_val) {
  const int D = p.Drle;
  if (c.rank == 0) {
    if (eb < D) {
      st_i32(o_start + 4LL * eb, col);
      o_val[eb] = (uint8_t)st;
      st_i32(o_len + 4LL * eb, ed);
    } else if (eb == D) {
      c.misc[M_CD + k] = ed;
    }
  } else if (eb <= D) {
    int32_t* s = c.stage + 3 * (D + 1) * k;
    s[eb] = col;
    s[D + 1 + eb] = st;
    s[2 * (D + 1) + eb] = ed;
  }
}

// The dense tracks of this thread's kCols columns from col0 (a multiple of
// 8) below hi, from their states and voted symbols (cs, as sweep_votes packs
// them): split-half nibbles (column i low, i + L/2 high) and the coverage
// bits, most significant first (np.packbits).  A byte of nibbles takes the
// low one first; the high one is or-ed in after a barrier, here or in a
// later tile of the same CTA.  Every thread calls it.
__device__ __forceinline__ void write_dense(const Params& p, const Ctx& c,
                                            int col0, int hi,
                                            const int (&cs)[kCols]) {
  const int L = p.L, half = L / 2;
  uint8_t* tail = c.out + 4 + 8LL * p.S + 3LL * p.R;
  for (int k = 0; k < 2; ++k) {
    uint8_t* o_sym = tail + (long long)half * k;
    unsigned v = 0;
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + j;
      if (col < half && col < hi)
        o_sym[col] = (uint8_t)((cs[j] >> (8 + 4 * k)) & 15);
      if (((cs[j] >> (kStateBits * k)) & 7) != 7) v |= 0x80u >> j;
    }
    if (col0 < hi) tail[L + (long long)(L / 8) * k + (col0 >> 3)] = (uint8_t)v;
  }
  __syncthreads();          // the low nibbles are in
  for (int k = 0; k < 2; ++k) {
    uint8_t* o_sym = tail + (long long)half * k;
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + j;
      if (col >= half && col < hi)
        o_sym[col - half] |= (uint8_t)(((cs[j] >> (8 + 4 * k)) & 15) << 4);
    }
  }
}

// Sweep 2 over this CTA's tiles: both haplotypes' 6-symbol votes at every
// column and their tracks, as RLE runs against the reference (Drle > 0) or
// as nibbles and coverage bits (Drle == 0, one CTA a region).  Returns, in
// nb and nd, this CTA's boundary and deviating-column counts per track.
__device__ void sweep_votes(const Params& p, const Ctx& c, int (&nb)[2],
                            int (&nd)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = threadIdx.x * kCols, L = p.L, D = p.Drle;
  uint8_t* tail = c.out + 4 + 8LL * p.S + 3LL * p.R;
  uint8_t* o_start[2] = {tail + 8, tail + 8 + 4LL * D};
  uint8_t* o_len[2] = {tail + 8 + 8LL * D, tail + 8 + 12LL * D};
  uint8_t* o_val[2] = {tail + 8 + 16LL * D, tail + 8 + 17LL * D};
  int carry_c = c.misc[M_CARRY_C], carry_d = c.misc[M_CARRY_D], par = 0;
  int prev = c.misc[M_PREV];        // both states of the column before
  nb[0] = nb[1] = nd[0] = nd[1] = 0;
  for (int lt = 0; lt < c.n_tiles; ++lt) {
    const int t0 = c.c_lo + lt * kTile;
    tile_events(c, lt, true);
    __syncthreads();
    int cov[kCols], del[kCols];
    tile_counts(c, par, carry_c, carry_d, cov, del);
    // per column: both states (bits 0-7), both voted symbols (bits 8-15)
    int cs[kCols], subs[4][5];
    for (int j = 0; j < kCols; ++j) {
      const int col = t0 + i0 + j;
      if ((j & 3) == 0) take_subs(c, j >> 2, subs);
      const int (&sub)[5] = subs[j & 3];
      cs[j] = 0;
      if (col >= c.c_hi) continue;
      int syms;
      const int s = column_states(cov[j], del[j], sub, c.ref[col],
                                  col < c.ltrue, syms);
      cs[j] = s | (syms << 8);
      if (col == L - 1)
        for (int k = 0; k < 2; ++k)
          c.lmisc[M_LAST + k] = (s >> (kStateBits * k)) & 7;
    }
    if (lane == 31) c.wlast[warp] = cs[kCols - 1] & 0xff;
    if (D == 0) {
      write_dense(p, c, t0 + i0, c.c_hi, cs);
      continue;
    }
    __syncthreads();        // every warp's last column is in
    // the state of the column before this thread's first: the thread
    // before, the warp before, or the tile before
    int before = __shfl_up_sync(kFull, cs[kCols - 1] & 0xff, 1);
    if (lane == 0) before = warp ? c.wlast[warp - 1] : prev;
    prev = c.wlast[kWarps - 1];
    // a run starts at a deviating column after a column that does not
    // deviate or holds another state
    unsigned bnd = 0;           // bit j + 8k: column j starts a run of track k
    int cnt_b = 0, cnt_d = 0;   // packed: track 0 low, track 1 high
    for (int j = 0; j < kCols; ++j) {
      const int cur = cs[j] & 0xff, pre = j ? cs[j - 1] & 0xff : before;
      for (int k = 0; k < 2; ++k) {
        const int sc = (cur >> (kStateBits * k)) & 15;
        const int sp = (pre >> (kStateBits * k)) & 15;
        const bool dv = sc & 8;
        if (dv && (!(sp & 8) || (sc & 7) != (sp & 7))) {
          bnd |= 1u << (j + 8 * k);
          cnt_b += 1 << (16 * k);
        }
        if (dv) cnt_d += 1 << (16 * k);
      }
    }
    int2 tot;
    const int2 ex = block_scan2(make_int2(cnt_b, cnt_d), c.wscan, par, tot);
    for (int k = 0; k < 2; ++k) {
      const int sh = 16 * k;
      int eb = nb[k] + ((ex.x >> sh) & 0xffff);
      int ed = nd[k] + ((ex.y >> sh) & 0xffff);
      for (int j = 0; j < kCols; ++j) {
        const int sc = (cs[j] >> (kStateBits * k)) & 15;
        if ((bnd >> (j + 8 * k)) & 1) {
          record_run(p, c, k, eb, t0 + i0 + j, sc & 7, ed, o_start[k],
                     o_len[k], o_val[k]);
          ++eb;
        }
        ed += (sc >> 3) & 1;
      }
      nb[k] += (tot.x >> sh) & 0xffff;
      nd[k] += (tot.y >> sh) & 0xffff;
    }
  }
}

// The tracks' runs across the cluster: each CTA past the leader moves its
// staged runs to their indices (after the runs of the CTAs before it), then
// the leader writes the run counts, the runs past the last (start L, length
// 0, the state of column L - 1) and each run's length.
__device__ void finish_runs(const Params& p, const Ctx& c,
                            cg::cluster_group& cluster, const int (&nb)[2],
                            const int (&nd)[2]) {
  const int D = p.Drle, L = p.L;
  if (threadIdx.x == 0)
    for (int k = 0; k < 2; ++k) {
      c.lmisc[M_TOTALS + 4 * c.rank + 2 * k] = nb[k];
      c.lmisc[M_TOTALS + 4 * c.rank + 2 * k + 1] = nd[k];
    }
  cluster.sync();
  uint8_t* tail = c.out + 4 + 8LL * p.S + 3LL * p.R;
  if (c.rank > 0) {
    for (int k = 0; k < 2; ++k) {
      int off_b = 0, off_d = 0;
      for (int r = 0; r < c.rank; ++r) {
        off_b += c.lmisc[M_TOTALS + 4 * r + 2 * k];
        off_d += c.lmisc[M_TOTALS + 4 * r + 2 * k + 1];
      }
      const int32_t* s = c.stage + 3 * (D + 1) * k;
      uint8_t* o_start = tail + 8 + 4LL * D * k;
      uint8_t* o_len = tail + 8 + 8LL * D + 4LL * D * k;
      uint8_t* o_val = tail + 8 + 16LL * D + (long long)D * k;
      for (int i = threadIdx.x; i < imin(nb[k], D + 1) && off_b + i <= D;
           i += blockDim.x) {
        const int b = off_b + i;
        if (b < D) {
          st_i32(o_start + 4LL * b, s[i]);
          o_val[b] = (uint8_t)s[D + 1 + i];
          st_i32(o_len + 4LL * b, s[2 * (D + 1) + i] + off_d);
        } else {
          c.lmisc[M_CD + k] = s[2 * (D + 1) + i] + off_d;
        }
      }
    }
  }
  cluster.sync();
  if (c.rank > 0) return;
  for (int k = 0; k < 2; ++k) {
    int n_runs = 0, total = 0;
    for (int r = 0; r < c.nc; ++r) {
      n_runs += c.misc[M_TOTALS + 4 * r + 2 * k];
      total += c.misc[M_TOTALS + 4 * r + 2 * k + 1];
    }
    uint8_t* o_start = tail + 8 + 4LL * D * k;
    uint8_t* o_len = tail + 8 + 8LL * D + 4LL * D * k;
    uint8_t* o_val = tail + 8 + 16LL * D + (long long)D * k;
    __syncthreads();
    if (threadIdx.x == 0) {
      st_i32(tail + 4 * k, n_runs);
      if (n_runs <= D) c.misc[M_CD + k] = total;
    }
    for (int b = n_runs + threadIdx.x; b < D; b += blockDim.x) {
      st_i32(o_start + 4LL * b, L);
      o_val[b] = (uint8_t)c.misc[M_LAST + k];
      st_i32(o_len + 4LL * b, total);
    }
    __syncthreads();
    // a run's length: deviating columns up to the next start
    for (int b0 = 0; b0 < D; b0 += blockDim.x) {
      const int b = b0 + threadIdx.x;
      int cur = 0, nxt = 0;
      if (b < D) {
        cur = ld_i32(o_len + 4LL * b);
        nxt = b + 1 < D ? ld_i32(o_len + 4LL * (b + 1)) : c.misc[M_CD + k];
      }
      __syncthreads();
      if (b < D) st_i32(o_len + 4LL * b, nxt - cur);
      __syncthreads();
    }
  }
}

#ifdef FOCALSV_PHASES
// A build for testing/kernel_sweep.py --phases: each CTA's thread 0 stamps
// the card's clock (ns) at the phase boundaries into 8 words a CTA at
// p.stamps, past the scratch that the entry documents.  The stamp's barrier
// is this build's alone.
#define PHASE(i) phase_stamp(p, blockIdx.x, i)
__device__ void phase_stamp(const Params& p, int cta, int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[8LL * cta + i] = t;
  }
}
#else
#define PHASE(i)
#endif

// -- what both kernels share around their sources ---------------------------

// The leader's sites: the best key of each strip over the cluster (each CTA
// kept its own keys), compacted.  Returns their count.
__device__ int leader_sites(const Params& p, const Ctx& c,
                            cg::cluster_group& cluster) {
  for (int r = 1; r < p.nc; ++r) {
    const unsigned long long* keys = cluster.map_shared_rank(c.keys, r);
    for (int s = threadIdx.x; s < p.S; s += blockDim.x)
      if (keys[s] > c.keys[s]) c.keys[s] = keys[s];
  }
  __syncthreads();
  return compact_sites(p, c);
}

// From the allele bitplanes of the n_het selected sites to the results of
// the reads and the sites: purification, blocks, the MEC rounds.
__device__ void phase_reads(const Params& p, const Ctx& c, int n_het) {
  const int nS = purify(p, c, n_het);
  const int nB = blocks_and_init(p, c, nS);
  for (int it = 0; it < p.mec_iters; ++it) {
    assign(p, c, nB);
    if (!update_h(p, c, nS)) break;  // a fixed point: the rest repeat it
  }
  assign(p, c, nB);
  reads_out(p, c, nS);
  sites_out(p, c, nS);
}

// Each read's class in the vote from the leader's hp: hp 0 votes in both
// tracks.  Call after the cluster barrier that follows the leader's work.
__device__ void read_classes(const Params& p, const Ctx& c,
                             cg::cluster_group& cluster) {
  const int8_t* hp = cluster.map_shared_rank(c.hp, 0);
  for (int r = threadIdx.x; r < p.R; r += blockDim.x)
    c.cls[r] = c.rv[r] ? (hp[r] ? (uint8_t)hp[r] : (uint8_t)3) : (uint8_t)0;
}

// -- B2's source: the events of a delta chunk -------------------------------

struct DeltaSrc {
  // region g's sections, this CTA's tiles (a contiguous share of the
  // region's), its events and staged runs
  static __device__ void inputs(const Params& p, Ctx& c, int g,
                                unsigned char* sm) {
    const uint8_t* buf = p.buf;
    c.ref = buf + p.in_off[IN_REF] + (long long)g * p.L;
    c.starts = reinterpret_cast<const int*>(buf + p.in_off[IN_STARTS]) +
               (long long)g * p.R;
    c.ends = reinterpret_cast<const int*>(buf + p.in_off[IN_ENDS]) +
             (long long)g * p.R;
    c.rv = buf + p.in_off[IN_RV] + (long long)g * p.R;
    c.sub_pos = reinterpret_cast<const int*>(buf + p.in_off[IN_SUB_POS]) +
                (long long)g * p.Ds;
    c.sub_read = reinterpret_cast<const int*>(buf + p.in_off[IN_SUB_READ]) +
                 (long long)g * p.Ds;
    c.sub_sym = buf + p.in_off[IN_SUB_SYM] + (long long)g * p.Ds;
    c.del_read = reinterpret_cast<const int*>(buf + p.in_off[IN_DEL_READ]) +
                 (long long)g * p.Dd;
    c.del_a = reinterpret_cast<const int*>(buf + p.in_off[IN_DEL_A]) +
              (long long)g * p.Dd;
    c.del_b = reinterpret_cast<const int*>(buf + p.in_off[IN_DEL_B]) +
              (long long)g * p.Dd;
    c.ltrue = reinterpret_cast<const int*>(buf + p.in_off[IN_LTRUE])[g];
    const int n_all = (p.L + kTile - 1) / kTile;
    const int tlo = c.rank * n_all / p.nc, thi = (c.rank + 1) * n_all / p.nc;
    c.c_lo = tlo * kTile;
    c.c_hi = imin(thi * kTile, p.L);
    c.n_tiles = thi - tlo;
    const long long cta = (long long)g * kMaxCluster + c.rank;
    c.events = p.s_events >= 0
                   ? reinterpret_cast<uint32_t*>(sm + p.s_events)
                   : p.events_g + cta * p.E;
    c.stage = p.stage_g + cta * 6 * (p.Drle + 1);
  }

  static __device__ void sites(const Params& p, const Ctx& c) {
    clear_dif(c);
    bin_events(p, c);
    PHASE(1);
    sweep_sites(p, c);
  }

  static __device__ void alleles(const Params& p, const Ctx& c, int n_het) {
    build_alleles(p, c, n_het);
  }

  static __device__ void votes(const Params& p, const Ctx& c,
                               cg::cluster_group& cluster) {
    clear_dif(c);                    // the planes used the leader's
    vote_carries(p, c);
    PHASE(4);
    int nb[2], nd[2];
    sweep_votes(p, c, nb, nd);
    PHASE(5);
    if (p.Drle > 0) finish_runs(p, c, cluster, nb, nd);
  }
};

// -- Kernel B3's source: the rows of a dense chunk --------------------------
//
// B3 replaces focalsv_tpu/parallel/region_step.py::phase_consensus_rows_flat
// (XLA code: phase_consensus_rows_packed's row expansion, _unpack_nibbles,
// _one_region, _select_sites_strips_dynamic, _phase_core, the two votes and
// _flat_parts).  It computes the bytes of the plain version,
// focalsv_tpu_torch/parallel/region_step.py::phase_consensus_rows_flat_plain:
// the chunk's one uint8 buffer in wire.rows_flat_layout in, (G, bytes) uint8
// in wire.flat_layout out (dense tracks, never RLE).
//
// A region's R rows hold W columns each: row r covers region columns
// [128 qstart[r], 128 qstart[r] + W), column k of a row in the low nibble of
// byte k for k < W/2 and in the high nibble of byte k - W/2 otherwise (0-4
// a base or N, 5 DEL, any other code no coverage).  The (R, L) pileup never
// exists.
//
// What bounds it on an H100: operations.  The noisy ONT chunk ('dense', 64,
// 16384, 16384) at G 16 is 8.4 MB of rows, 2.5 us at 3.35 TB/s; each of the
// two sweeps decodes and counts 8.7 M (read, column) cells, a few integer
// operations each, some 0.004 ms for both at 16.75 T int32 operations a
// second (PERF.md states the count).
//
// Design: a cluster of nc CTAs of 512 threads a region (1 to 8: the most
// whose G clusters the card holds at once, see plan), CTA r taking the same
// range [c_lo, c_hi) of each half of the columns, in whole groups of 64, so
// that the byte holding column i and column i + L/2 of a track is written by
// one CTA, in equal shares.  The CTA lays its two ranges end to end as one
// run of 2 (c_hi - c_lo) columns, cut in tiles of 4096: a thread holds 8
// columns of a tile, and every thread holds columns wherever the run fills
// the tile (tiles of each half apart would leave half the threads without
// columns at L 16384 and 4 CTAs a region).  Per region:
//  0. Reads binned by tile.  Each valid read's qstart is staged in shared
//     memory; a counting sort (a histogram over the CTA's tiles, a scan, a
//     scatter) lists, for each tile, the reads whose row meets it (16-bit
//     read indices, in shared memory where they fit, else in the wrapper's
//     scratch).  A tile no read meets has an empty list; both sweeps walk
//     these lists, so a read is visited only by the tiles it meets.
//  1. Site sweep.  A tile's list is walked in groups of 8 reads.  The row
//     bytes a group needs come into a ring of 3 stages in shared memory by
//     16-byte asynchronous copies (cp.async; a 16-column piece of a row
//     never straddles its W/2 nibble boundary, its ends or a CTA's range, as
//     all of them are multiples of 16), two groups in flight while one is
//     counted, one barrier a group.  A stage holds, for each read of its
//     group, the tile's 4096 byte slots in the thread order, so that a
//     thread reads its 8 nibbles with one 8-byte load and a warp's loads
//     meet no bank conflict, and each read's first column and weight,
//     written with the copies, so that the count of a read waits on one
//     shared load and not on a chain of them.  The six symbols of a column
//     are counted in one 32-bit word of 5-bit fields (one shift and one add
//     a cell), added out to the int counts before a field can pass 31.
//     Then B2's het test and strip key; N is no allele.
//  2. The leader, as in B2, from the merge of the cluster's keys on; only
//     the allele bitplanes are found otherwise: a warp a (site, word of 32
//     reads) reads each read's nibble at the site's column.
//  3. Vote sweep: the same walk over the same lists, each read's fields
//     added to the hp-1 and hp-2 words as its class says (both for hp 0),
//     then added out as B2's packed counts (hp 1 the low 16 bits, hp 2 the
//     high); the first maximum wins, a column is covered where its sum is
//     above 0, and B2's dense writer writes the tracks.
// Columns past a row's end or past L are not covered; columns in
// [ltrue, L) are counted as any other, and only the strips use ltrue.
// What the card taught (NVIDIA H100 80GB HBM3 at 700 W, kernel_sweep.py
// --b3-only, PERF.md section 6): clusters of 8 at G 16 do not all fit at
// once (the card's GPCs hold fewer), and the second wave made a full chunk
// of L 16384 take 0.085 ms where 6 CTAs a region take 0.047.

constexpr int kNoCov = 255;
constexpr int kRangeCols = 64;   // a CTA's range of a half: groups of these
// the ring: stages of a group of reads each (a test build takes others)
#ifndef FOCALSV_RING_STAGES
#define FOCALSV_RING_STAGES 3
#endif
#ifndef FOCALSV_RING_GROUP
#define FOCALSV_RING_GROUP 8
#endif
constexpr int kGroup = FOCALSV_RING_GROUP;    // reads a stage of the ring
constexpr int kStages = FOCALSV_RING_STAGES;  // stages of the ring
static_assert(kStages >= 2 && kGroup >= 1 && kGroup < (1 << 5) - 1,
              "a ring of 2 stages or more, fields that count a group");
constexpr int kPiece = 16;       // bytes of an asynchronous copy
constexpr int kRingBytes = kStages * kGroup * kTile;
constexpr int kField = 5;        // bits of a symbol's count in a column word
constexpr int kFieldMax = (1 << kField) - 1;
static_assert(kRangeCols % kPiece == 0 && kBlock % kPiece == 0,
              "a piece never straddles a range, a block or W/2");

// Reads a CTA's lists hold at most: each read meets at most W / kTile + 2
// tiles of each half's range, and no more than the CTA's tiles.
__host__ __device__ __forceinline__ long long list_cap(int R, int W,
                                                       int tiles) {
  return (long long)R * imin(tiles, 2 * (W / kTile + 2));
}

// The region column of position v of this CTA's run.
__device__ __forceinline__ int run_col(const Params& p, const Ctx& c, int v) {
  return v < c.hl ? c.c_lo + v : c.c_lo + p.L / 2 + v - c.hl;
}

// The tiles of this CTA's run that a row from block q meets: [a0, a1] in
// the first half's range, [b0, b1] in the second's (empty where the end is
// below the start), a tile met in both counted once.
__device__ __forceinline__ void row_tiles(const Params& p, const Ctx& c,
                                          int q, int& a0, int& a1, int& b0,
                                          int& b1) {
  const long long lo = (long long)q * kBlock, hi = lo + p.W;
  const long long h1 = c.c_lo + p.L / 2;
  a0 = b0 = 0;
  a1 = b1 = -1;
  long long x = lo > c.c_lo ? lo : c.c_lo, y = hi < c.c_hi ? hi : c.c_hi;
  if (x < y) {
    a0 = (int)(x - c.c_lo) >> kTileBits;
    a1 = (int)(y - 1 - c.c_lo) >> kTileBits;
  }
  x = lo > h1 ? lo : h1;
  y = hi < h1 + c.hl ? hi : h1 + c.hl;
  if (x < y) {
    b0 = (int)(x - h1 + c.hl) >> kTileBits;
    b1 = (int)(y - 1 - h1 + c.hl) >> kTileBits;
  }
  if (a0 <= a1 && b0 <= b1 && b0 == a1) ++b0;
}

struct RowsSrc {
  static __device__ void inputs(const Params& p, Ctx& c, int g,
                                unsigned char* sm) {
    const uint8_t* buf = p.buf;
    c.rows = buf + p.in_off[IN_ROWS] + (long long)g * p.R * (p.W / 2);
    c.qstart = reinterpret_cast<const int*>(buf + p.in_off[IN_QSTART]) +
               (long long)g * p.R;
    c.rv = buf + p.in_off[IN_ROWS_RV] + (long long)g * p.R;
    c.ltrue = reinterpret_cast<const int*>(buf + p.in_off[IN_ROWS_LTRUE])[g];
    // the same share of each half of the columns, in whole groups
    const int groups = p.L / 2 / kRangeCols;
    c.c_lo = c.rank * groups / p.nc * kRangeCols;
    c.c_hi = (c.rank + 1) * groups / p.nc * kRangeCols;
    c.hl = c.c_hi - c.c_lo;
    c.n_tiles = (2 * c.hl + kTile - 1) / kTile;
    const long long cta = (long long)g * kMaxRowsCluster + c.rank;
    c.list = p.s_list >= 0 ? reinterpret_cast<uint16_t*>(sm + p.s_list)
                           : p.list_g + cta * p.list_stride;
    c.qs = p.s_q >= 0 ? reinterpret_cast<int*>(sm + p.s_q) : nullptr;
    c.sq = c.qs ? c.qs : c.qstart;
    c.ring = sm + p.s_dif;            // the union with the leader's planes
    c.meta = reinterpret_cast<int2*>(sm + p.s_meta);
  }

  // Bin the valid reads by the tiles of this CTA's run that their rows
  // meet; stage qstart.
  static __device__ void bin_reads(const Params& p, const Ctx& c) {
    const int nt = c.n_tiles;
    for (int t = threadIdx.x; t <= nt; t += blockDim.x) c.toff[t] = 0;
    __syncthreads();
    for (int r = threadIdx.x; r < p.R; r += blockDim.x) {
      const int q = c.qstart[r];
      if (c.qs) c.qs[r] = q;
      if (!c.rv[r]) continue;
      int a0, a1, b0, b1;
      row_tiles(p, c, q, a0, a1, b0, b1);
      for (int t = a0; t <= a1; ++t) atomicAdd(&c.toff[t], 1);
      for (int t = b0; t <= b1; ++t) atomicAdd(&c.toff[t], 1);
    }
    __syncthreads();
    counts_to_offsets(c, nt);
    for (int r = threadIdx.x; r < p.R; r += blockDim.x) {
      if (!c.rv[r]) continue;
      int a0, a1, b0, b1;
      row_tiles(p, c, c.sq[r], a0, a1, b0, b1);
      for (int t = a0; t <= a1; ++t)
        c.list[atomicAdd(&c.cur[t], 1)] = (uint16_t)r;
      for (int t = b0; t <= b1; ++t)
        c.list[atomicAdd(&c.cur[t], 1)] = (uint16_t)r;
    }
    __syncthreads();
  }

  // Steps of tile t: its groups of kGroup reads, one for an empty list.
  static __device__ __forceinline__ int steps_of(const Ctx& c, int t) {
    return imax(1, (c.toff[t + 1] - c.toff[t] + kGroup - 1) / kGroup);
  }

  // The asynchronous copies of the row bytes of the n reads from list entry
  // e0 on that tile t needs, into stage ps: read i's bytes for position v of
  // the tile at i * kTile + v; and each read's first column and weight bits
  // (its class in the vote, 1 in the site sweep; 0 past the n reads).
  static __device__ void stage_rows(const Params& p, const Ctx& c, int t,
                                    int e0, int n, int ps, bool vote) {
    const int hw = p.W / 2, per = kTile / kPiece;
    uint8_t* stage = c.ring + ps * (kGroup * kTile);
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
      const int r = i < n ? c.list[e0 + i] : 0;
      // a listed row meets the run: its first column lies in (-W, L)
      c.meta[ps * kGroup + i] =
          i < n ? make_int2(c.sq[r] * kBlock, vote ? c.cls[r] : 1)
                : make_int2(0, 0);
    }
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int j = i / per, v = (i - j * per) * kPiece;
      if (t * kTile + v >= 2 * c.hl) continue;
      const int r = c.list[e0 + j];
      const long long k = (long long)run_col(p, c, t * kTile + v) -
                          (long long)c.sq[r] * kBlock;
      if (k < 0 || k >= p.W) continue;
      const int kk = (int)k;
      __pipeline_memcpy_async(stage + j * kTile + v,
                              c.rows + (long long)r * hw +
                                  (kk < hw ? kk : kk - hw),
                              kPiece);
    }
  }

  // One sweep over this CTA's tiles: each thread's 8 columns counted over
  // the tile's reads, a read weighted by its class in the vote (Vote) and
  // by 1 in the site sweep.  cnt[j][s]: the count of symbol s at column j
  // (packed per haplotype in the vote).  finish(col0, hi, cnt) after each
  // tile: col0 the thread's first column, hi the end of its range (0 for
  // a thread past the run).  Every thread calls it.
  template <bool Vote, class Fin>
  static __device__ void sweep(const Params& p, const Ctx& c, Fin finish) {
    int pt = 0, pg = 0, ps = 0;       // the next step to copy, its stage
    auto issue = [&]() {
      if (pt < c.n_tiles) {
        const int e0 = c.toff[pt] + pg * kGroup;
        stage_rows(p, c, pt, e0, imin(kGroup, c.toff[pt + 1] - e0), ps,
                   Vote);
        if (++pg == steps_of(c, pt)) {
          ++pt;
          pg = 0;
        }
      }
      __pipeline_commit();
      ps = ps + 1 == kStages ? 0 : ps + 1;
    };
    for (int s = 0; s < kStages - 1; ++s) issue();
    const int hw = p.W / 2;
    int stage = 0;
    for (int t = 0; t < c.n_tiles; ++t) {
      const int v0 = t * kTile + threadIdx.x * kCols;
      const bool mine = v0 < 2 * c.hl;
      const int col0 = mine ? run_col(p, c, v0) : 0;
      int cnt[kCols][6];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int s = 0; s < 6; ++s) cnt[j][s] = 0;
      uint32_t f1[kCols], f2[kCols];  // 5-bit fields: hp 1 (or all), hp 2
#pragma unroll
      for (int j = 0; j < kCols; ++j) f1[j] = f2[j] = 0u;
      auto add_out = [&]() {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
#pragma unroll
          for (int s = 0; s < 6; ++s) {
            const int a = (int)(f1[j] >> (kField * s)) & kFieldMax;
            cnt[j][s] += Vote ? a + (((int)(f2[j] >> (kField * s)) &
                                      kFieldMax) << 16)
                              : a;
          }
          f1[j] = f2[j] = 0u;
        }
      };
      int pending = 0;                 // reads in the fields, at most
      const int nst = steps_of(c, t);
      for (int gi = 0; gi < nst; ++gi) {
        __pipeline_wait_prior(kStages - 2);   // this step's copies are in
        __syncthreads();                      // everyone's; stage free
        issue();
        const uint8_t* st = c.ring + stage * (kGroup * kTile) +
                            threadIdx.x * kCols;
        const int2* mt = c.meta + stage * kGroup;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int2 m = mt[i];
          const int k = col0 - m.x;
          if (!mine || m.y == 0 || k < 0 || k >= p.W) continue;
          const unsigned b1 = m.y & 1, b2 = (unsigned)m.y >> 1;
          unsigned long long v =
              *reinterpret_cast<const unsigned long long*>(st + i * kTile);
          if (k >= hw) v >>= 4;
          const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const uint32_t n4 = ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 15u;
            // one bit at field n4; codes past 6 (no coverage) shift it out
            const uint32_t one = __funnelshift_lc(0u, 1u, kField * n4);
            f1[j] += Vote ? one * b1 : one;
            if (Vote) f2[j] += one * b2;
          }
        }
        pending += kGroup;
        if (pending + kGroup > kFieldMax) {
          add_out();
          pending = 0;
        }
        stage = stage + 1 == kStages ? 0 : stage + 1;
      }
      add_out();
      finish(col0, mine ? (v0 < c.hl ? c.c_hi : c.c_hi + p.L / 2) : 0, cnt);
    }
    __pipeline_wait_prior(0);          // the empty groups past the last
  }

  static __device__ void sites(const Params& p, const Ctx& c) {
    bin_reads(p, c);
    PHASE(1);
    const int strip = imax((c.ltrue + p.S - 1) / p.S, 1);
    sweep<false>(p, c, [&](int col0, int hi, const int (&cnt)[kCols][6]) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (col0 + j >= hi) continue;
        const int a[5] = {cnt[j][0], cnt[j][1], cnt[j][2], cnt[j][3],
                          cnt[j][5]};
        site_key(p, c, col0 + j, a, strip);
      }
    });
  }

  // The allele bitplanes of the n_het selected sites.
  static __device__ void alleles(const Params& p, const Ctx& c, int n_het) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5, RW = p.RW, hw = p.W / 2;
    for (int idx = warp; idx < n_het * RW; idx += nw) {
      const int s = idx / RW, r = (idx - s * RW) * 32 + lane;
      int v = -1;
      if (r < p.R && c.rv[r]) {
        const long long k = (long long)c.col[s] - (long long)c.qstart[r] * kBlock;
        if (k >= 0 && k < p.W) {
          const int kk = (int)k;
          const int b = c.rows[(long long)r * hw + (kk < hw ? kk : kk - hw)];
          const int n = (kk < hw ? b : b >> 4) & 15;
          v = allele_of(n < 5 ? n : (n == 5 ? kDelSym : kNoCov), c.a[s]);
        }
      }
      const unsigned cov = __ballot_sync(kFull, v >= 0);
      const unsigned mnr = __ballot_sync(kFull, v == 1);
      if (lane == 0) {
        c.pcov[idx] = cov;
        c.pmin[idx] = mnr;
      }
    }
    for (int idx = n_het * RW + threadIdx.x; idx < p.S * RW;
         idx += blockDim.x) {
      c.pcov[idx] = 0u;
      c.pmin[idx] = 0u;
    }
    __syncthreads();
  }

  static __device__ void votes(const Params& p, const Ctx& c,
                               cg::cluster_group& cluster) {
    __syncthreads();                 // every read's class is in
    PHASE(4);
    sweep<true>(p, c, [&](int col0, int hi, const int (&cnt)[kCols][6]) {
      // both states (bits 0-7) and both voted symbols (bits 8-15)
      int cs[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        int st = 0, syms = 0;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          int best = -1, sym = 0, tot = 0;
#pragma unroll
          for (int s = 0; s < 6; ++s) {
            const int v = k ? hi16(cnt[j][s]) : lo16(cnt[j][s]);
            tot += v;
            if (v > best) { best = v; sym = s; }
          }
          st |= (tot > 0 ? sym : 7) << (kStateBits * k);
          syms |= sym << (4 * k);
        }
        cs[j] = st | (syms << 8);
      }
      write_dense(p, c, col0, hi, cs);
    });
    PHASE(5);
  }
};

template <class Src>
__global__ void __launch_bounds__(kThreads, 1) region_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / p.nc;
  unsigned char* sm = smem_raw;
  Ctx c;
  c.out = p.out + (long long)g * p.out_stride;
  c.rank = rank;
  c.nc = p.nc;
  Src::inputs(p, c, g, sm);
  c.keys = reinterpret_cast<unsigned long long*>(sm + p.s_keys);
  c.dif = reinterpret_cast<int*>(sm + p.s_dif);
  c.toff = reinterpret_cast<int*>(sm + p.s_toff);
  c.cur = reinterpret_cast<int*>(sm + p.s_cur);
  const long long plane = (long long)p.S * p.RW;
  uint32_t* planes = p.s_planes >= 0
                         ? reinterpret_cast<uint32_t*>(sm + p.s_planes)
                         : p.planes_g + (long long)g * 3 * plane;
  c.pcov = planes;
  c.pmin = planes + plane;
  c.pasm = planes + 2 * plane;
  c.wsum = reinterpret_cast<int*>(sm + p.s_wsum);
  c.wscan = reinterpret_cast<int2*>(sm + p.s_wscan);
  c.wlast = reinterpret_cast<int*>(sm + p.s_wlast);
  c.misc = reinterpret_cast<int*>(sm + p.s_misc);
  c.lmisc = cluster.map_shared_rank(c.misc, 0);
  c.col = reinterpret_cast<int*>(sm + p.s_col);
  c.tcol = reinterpret_cast<int*>(sm + p.s_tcol);
  c.blk = reinterpret_cast<int*>(sm + p.s_blk);
  c.bstart = reinterpret_cast<int*>(sm + p.s_bstart);
  c.hm = reinterpret_cast<uint32_t*>(sm + p.s_hm);
  c.a = sm + p.s_a;
  c.ta = sm + p.s_ta;
  c.h = sm + p.s_h;
  c.hn = sm + p.s_hn;
  c.lnk = sm + p.s_lnk;
  c.hp = reinterpret_cast<int8_t*>(sm + p.s_hp);
  c.cls = sm + p.s_cls;

  PHASE(0);
  for (int s = threadIdx.x; s < p.S; s += blockDim.x) c.keys[s] = 0ull;
  Src::sites(p, c);
  PHASE(2);
  cluster.sync();                  // every CTA's strip keys are in
  if (rank == 0) {
    const int n_het = leader_sites(p, c, cluster);
    Src::alleles(p, c, n_het);
    PHASE(7);
    phase_reads(p, c, n_het);
  }
  PHASE(3);
  cluster.sync();                  // every read's haplotype is in
  read_classes(p, c, cluster);
  Src::votes(p, c, cluster);
  // the leader's hp (and, for B2, its column L - 1) went through
  // distributed shared memory: it may not end before the others are done.
  // B2's finish_runs ends in a cluster barrier of its own.
  if (p.nc > 1 && (p.rows || p.Drle == 0)) cluster.sync();
  PHASE(6);
}

// Shared memory of a CTA: the strip keys, the union of B2's difference
// arrays or B3's ring and (when planes_in_smem) the three planes, B2's
// events or B3's read lists and staged qstart (when events_in_smem), B3's
// first columns and classes of the ring's reads, then the fixed arrays.  Offsets of what is not in shared
// memory are -1.  Returns bytes.
size_t carve(Params& p, bool planes_in_smem, bool events_in_smem) {
  const size_t S = p.S;
  size_t off = 0;
  auto take = [&](size_t bytes, size_t align) {
    off = (off + align - 1) / align * align;
    const size_t at = off;
    off += bytes;
    return (int)at;
  };
  p.s_keys = take(8 * S, 16);
  const size_t dif = p.rows ? (size_t)kRingBytes : 4ull * kRows * kTile;
  const size_t planes = 12 * S * (size_t)p.RW;
  p.s_dif = take(planes_in_smem && planes > dif ? planes : dif, 16);
  p.s_planes = planes_in_smem ? p.s_dif : -1;
  const bool lists = p.rows && events_in_smem;
  p.s_events = !p.rows && events_in_smem ? take(4 * (size_t)p.E, 16) : -1;
  p.s_list = lists ? take(2 * (size_t)list_cap(p.R, p.W, p.tiles_per_cta),
                          16)
                   : -1;
  p.s_q = lists ? take(4 * (size_t)p.R, 16) : -1;
  p.s_meta = p.rows ? take(8 * (size_t)(kStages * kGroup), 16) : -1;
  p.s_toff = take(4 * (size_t)(p.tiles_per_cta + 1), 4);
  p.s_cur = take(4 * (size_t)p.tiles_per_cta, 4);
  p.s_wsum = take(4 * 33, 16);
  p.s_wscan = take(8 * 64, 16);
  p.s_wlast = take(4 * kWarps, 4);
  p.s_misc = take(4 * M_COUNT, 4);
  p.s_col = take(4 * S, 4);
  p.s_tcol = take(4 * S, 4);
  p.s_blk = take(4 * S, 4);
  p.s_bstart = take(4 * (S + 1), 4);
  p.s_hm = take(8 * (size_t)p.RW, 4);
  p.s_a = take(S, 1);
  p.s_ta = take(S, 1);
  p.s_h = take(S, 1);
  p.s_hn = take(S, 1);
  p.s_lnk = take(S, 1);
  p.s_hp = take(p.R, 1);
  p.s_cls = take(p.R, 1);
  return (off + 15) / 16 * 16;
}

// The phase stamps of kernel_sweep's build: past the first n words of the
// scratch, on an 8-byte boundary.
unsigned long long* stamps_past(uint32_t* words, long long n) {
  return reinterpret_cast<unsigned long long*>(words + (n + 1) / 2 * 2);
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The sizes, the input sections and the result stride of a delta chunk; an
// error for what the kernel does not take.
int init_params(Params& p, int G, int R, int L, int Ds, int Dd, int Drle,
                int S) {
  if (R < 1 || R > kMaxReads || L < 1 || S < 1 || Ds < 0 || Dd < 0 ||
      Drle < 0 || (unsigned)L > kMaxCol || (Drle == 0 && L % 8 != 0))
    return (int)cudaErrorInvalidValue;
  p.G = G; p.R = R; p.L = L; p.Ds = Ds; p.Dd = Dd; p.Drle = Drle; p.S = S;
  p.RW = (R + 31) / 32;
  p.E = 2 * R + 2 * Dd + Ds;
  const long long g = G;
  const long long sizes[IN_COUNT] = {g * L, g * R * 4, g * R * 4, g * R,
                                     g * Ds * 4, g * Ds * 4, g * Ds,
                                     g * Dd * 4, g * Dd * 4, g * Dd * 4,
                                     g * 4};
  long long off = 0;
  for (int i = 0; i < IN_COUNT; ++i) {
    p.in_off[i] = off;
    off += sizes[i];
  }
  const long long head = 4 + 8LL * S + 3LL * R;
  p.out_stride = Drle ? head + 8 + 18LL * Drle : head + L + 2LL * (L / 8);
  return 0;
}

// The same for a dense chunk of rows W columns wide (B3): L and W
// multiples of 128, the result's tracks dense.
int init_rows_params(Params& p, int G, int R, int L, int W, int S) {
  if (R < 1 || R > kMaxReads || L < kBlock || W < kBlock || S < 1 ||
      L % kBlock != 0 || W % kBlock != 0 || (unsigned)L > kMaxCol)
    return (int)cudaErrorInvalidValue;
  p.rows = true;
  p.G = G; p.R = R; p.L = L; p.W = W; p.S = S;
  p.Ds = p.Dd = p.Drle = p.E = 0;
  p.RW = (R + 31) / 32;
  const long long g = G;
  const long long sizes[IN_ROWS_COUNT] = {g * R * (W / 2), g * R * 4, g * R,
                                          g * 4};
  long long off = 0;
  for (int i = 0; i < IN_ROWS_COUNT; ++i) {
    p.in_off[i] = off;
    off += sizes[i];
  }
  p.out_stride = 4 + 8LL * S + 3LL * R + L + 2LL * (L / 8);
  return 0;
}

void set_knobs(Params& p, int mec_iters, int min_site_depth,
               int min_minor_count, int lo_num, int lo_den, int hi_num,
               int hi_den, int purify_window, int purify_min_pairs,
               int purify_num, int purify_den) {
  p.mec_iters = mec_iters;
  p.min_site_depth = min_site_depth;
  p.min_minor_count = min_minor_count;
  p.lo_num = lo_num; p.lo_den = lo_den; p.hi_num = hi_num; p.hi_den = hi_den;
  p.purify_window = purify_window;
  p.purify_min_pairs = purify_min_pairs;
  p.purify_num = purify_num;
  p.purify_den = purify_den;
}

// How many clusters of nc CTAs with this launch's shared memory the current
// card holds at once (0: none can be placed), asked once a (card, nc, bytes)
// and kernel.
template <class Src>
int active_clusters(const cudaLaunchConfig_t& cfg, int nc) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> known;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, nc, cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> hold(lock);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, region_step_kernel<Src>,
                                     &cfg) != cudaSuccess)
    active = 0;
  cudaGetLastError();
  known[key] = active;
  return active;
}

// The launch of a chunk: CTAs a region, shared memory and what lives there,
// and the launch configuration (attr: its cluster attribute).  A cluster
// fills the SMs that one CTA a region leaves idle: the largest of 1, 2, 4
// with a tile or more a CTA and G * nc within the SMs, or past them (a
// second wave) where each CTA keeps 8 tiles or more, unless `cluster` names
// one.  On an H100 that is 2 at phase 4's delta chunks of G 64 and 4 at its
// G 51, L 131072 (PERF.md section 6).  B3 takes the most CTAs, up to 8
// (the portable cluster size), with a run of half a tile or more each, of
// which the card holds all G clusters at once (a second wave would repeat
// the leader's phasing): 8 where they fit, one fewer each time they do not
// (PERF.md section 6 names what an H100 takes at phase 6b's G 16).  B2's
// dense tracks are written by one CTA; B3's CTAs take a share of each half
// of the columns, so a cluster that `cluster` names is taken even where a
// CTA holds less than a tile.  A cluster that cannot be placed is halved.
template <class Src>
int plan(Params& p, int cluster, cudaLaunchConfig_t& cfg,
         cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int n_tiles = (p.L + kTile - 1) / kTile;
  int nc = cluster;
  const bool pick_rows = p.rows && cluster == 0;
  if (pick_rows) {
    nc = imax(1, imin(kMaxRowsCluster, p.L / (kTile / 2)));
  } else if (nc == 0) {
    const int sms = device_attr(cudaDevAttrMultiProcessorCount);
    nc = 1;
    while (nc < kMaxCluster && nc * 2 <= n_tiles &&
           ((long long)p.G * nc * 2 <= sms || n_tiles >= 8 * nc * 2))
      nc *= 2;
  }
  if (!p.rows && p.Drle == 0) nc = 1;
  if (!p.rows) nc = imax(1, imin(nc, n_tiles));
  const size_t limit =
      (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  for (;;) {
    p.nc = nc;
    // B3: the tiles of a CTA's run of its two ranges, at most
    const int groups = p.L / 2 / kRangeCols;
    p.tiles_per_cta =
        p.rows ? (2 * ((groups + nc - 1) / nc) * kRangeCols + kTile - 1) /
                     kTile
               : (n_tiles + nc - 1) / nc;
    size_t smem = 0;
    bool fits = false;
    for (int k = 0; k < 4 && !fits; ++k) {
      smem = carve(p, !(k & 2), !(k & 1));
      fits = smem <= limit;
    }
    if (!fits) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(region_step_kernel<Src>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(p.G * nc);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (nc == 1) return 0;
    const int active = active_clusters<Src>(cfg, nc);
    if (active > 0 && !(pick_rows && active < p.G)) return 0;
    nc = pick_rows ? nc - 1 : nc / 2;
  }
}

// plan_out (see the entries): CTAs a region, dynamic shared memory bytes a
// CTA, planes in shared memory (0, 1), events (B3: read lists and qstart)
// in shared memory (0, 1), the
// kernel's registers a thread and its local memory (spills) in bytes.
template <class Src>
int plan_of(Params& p, int cluster, int* plan_out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = plan<Src>(p, cluster, cfg, attr, nullptr);
  if (err) return err;
  plan_out[0] = p.nc;
  plan_out[1] = (int)cfg.dynamicSmemBytes;
  plan_out[2] = p.s_planes >= 0;
  plan_out[3] = (p.rows ? p.s_list : p.s_events) >= 0;
  cudaFuncAttributes attrs;
  err = (int)cudaFuncGetAttributes(&attrs, region_step_kernel<Src>);
  plan_out[4] = attrs.numRegs;
  plan_out[5] = (int)attrs.localSizeBytes;
  return err;
}

template <class Src>
int launch(Params& p, int cluster, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = plan<Src>(p, cluster, cfg, attr,
                            static_cast<cudaStream_t>(stream));
  if (err) return err;
  cudaLaunchKernelEx(&cfg, region_step_kernel<Src>, p);
  return (int)cudaGetLastError();
}

}  // namespace

// B2's launch of a delta chunk (see plan): plan_out = CTAs a region,
// dynamic shared memory bytes a CTA, planes in shared memory (0, 1), events
// in shared memory (0, 1), the kernel's registers a thread and its local
// memory (spills) in bytes a thread.  Returns 0 or a CUDA error.
extern "C" int focalsv_region_step_plan(int G, int R, int L, int Ds, int Dd,
                                        int Drle, int S, int cluster,
                                        int* plan_out) {
  Params p = {};
  if (G < 1 || cluster < 0 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int err = init_params(p, G, R, L, Ds, Dd, Drle, S);
  return err ? err : plan_of<DeltaSrc>(p, cluster, plan_out);
}

// B2, kernel of a delta chunk.  cluster: CTAs a region (1, 2 or 4); 0 lets
// plan choose.  The wrapper's scratch holds, per region, 3 * S * ceil(R /
// 32) words of planes, then kMaxCluster times 2R + 2Dd + Ds words of events
// and 6 * (Drle + 1) words of staged runs.
extern "C" int focalsv_region_step(
    const void* buf, void* out, void* scratch, int G, int R, int L, int Ds,
    int Dd, int Drle, int S, int mec_iters, int min_site_depth,
    int min_minor_count, int lo_num, int lo_den, int hi_num, int hi_den,
    int purify_window, int purify_min_pairs, int purify_num, int purify_den,
    int cluster, void* stream) {
  if (G <= 0) return 0;
  if (cluster < 0 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  Params p = {};
  const int err = init_params(p, G, R, L, Ds, Dd, Drle, S);
  if (err) return err;
  p.buf = static_cast<const uint8_t*>(buf);
  p.out = static_cast<uint8_t*>(out);
  set_knobs(p, mec_iters, min_site_depth, min_minor_count, lo_num, lo_den,
            hi_num, hi_den, purify_window, purify_min_pairs, purify_num,
            purify_den);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  p.planes_g = words;
  p.events_g = words + (long long)G * 3 * S * p.RW;
  p.stage_g = reinterpret_cast<int32_t*>(p.events_g + (long long)G *
                                                          kMaxCluster * p.E);
  p.stamps = stamps_past(words, (long long)G * (3LL * S * p.RW +
                                               kMaxCluster * (p.E + 6LL *
                                                              (Drle + 1))));
  return launch<DeltaSrc>(p, cluster, stream);
}

// Entries of a CTA's read lists in B3's scratch, whatever its cluster: the
// lists of one CTA a region, an even count.
static long long rows_list_stride(int R, int L, int W) {
  return (list_cap(R, W, (L + kTile - 1) / kTile) + 1) / 2 * 2;
}

// B3's launch of a dense chunk, as focalsv_region_step_plan says it (plan_out
// 3: the read lists and qstart in shared memory).
extern "C" int focalsv_region_rows_plan(int G, int R, int L, int W, int S,
                                        int cluster, int* plan_out) {
  Params p = {};
  if (G < 1 || cluster < 0 || cluster > kMaxRowsCluster)
    return (int)cudaErrorInvalidValue;
  const int err = init_rows_params(p, G, R, L, W, S);
  return err ? err : plan_of<RowsSrc>(p, cluster, plan_out);
}

// B3, kernel of a dense chunk (wire.rows_flat_layout).  cluster: CTAs a
// region (1 to 8); 0 lets plan choose.  The wrapper's scratch holds 3
// * S * ceil(R / 32) words of planes a region, then kMaxRowsCluster times
// rows_list_stride(R, L, W) / 2 words of read lists a region, each used
// where it does not fit in shared memory.
extern "C" int focalsv_region_rows(
    const void* buf, void* out, void* scratch, int G, int R, int L, int W,
    int S, int mec_iters, int min_site_depth, int min_minor_count,
    int lo_num, int lo_den, int hi_num, int hi_den, int purify_window,
    int purify_min_pairs, int purify_num, int purify_den, int cluster,
    void* stream) {
  if (G <= 0) return 0;
  if (cluster < 0 || cluster > kMaxRowsCluster)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int err = init_rows_params(p, G, R, L, W, S);
  if (err) return err;
  p.buf = static_cast<const uint8_t*>(buf);
  p.out = static_cast<uint8_t*>(out);
  set_knobs(p, mec_iters, min_site_depth, min_minor_count, lo_num, lo_den,
            hi_num, hi_den, purify_window, purify_min_pairs, purify_num,
            purify_den);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  const long long planes = (long long)G * 3 * S * p.RW;
  p.planes_g = words;
  p.list_g = reinterpret_cast<uint16_t*>(words + planes);
  p.list_stride = rows_list_stride(R, L, W);
  p.stamps = stamps_past(words, planes + (long long)G * kMaxRowsCluster *
                                             p.list_stride / 2);
  return launch<RowsSrc>(p, cluster, stream);
}
