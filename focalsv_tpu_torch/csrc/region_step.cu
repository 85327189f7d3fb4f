// Kernel B2: the region step of a delta chunk, one launch a chunk.
//
// Replaces focalsv_tpu/parallel/region_step.py::phase_consensus_delta_flat
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
// 1 us at 3.35 TB/s; its work is at most about 0.8 G int32 operations (all
// 31 MEC rounds over (R, S) and some 100 operations a column), about 0.05
// ms at the 16.75 T int32 operations a second of the card, and less where
// the MEC stops early (PERF.md counts what each chunk's data needs).  The plain version takes
// some 1,900 launches a chunk; this kernel takes one.
//
// Design: one CTA of 512 threads a region, a grid of G.  Per region:
//  1. Column sweep.  Columns are swept in tiles of 4 * 512 in shared
//     memory.  Each tile is rebuilt from the region's event lists (read
//     spans, deletion runs, substitutions: 2R + Dd * 2 + Ds events) by
//     shared atomics into difference arrays, and a block scan with a carry
//     from tile to tile gives the coverage and deletion counts.  No (G, L)
//     array goes to device memory.  Het columns update their strip's best
//     by one 64-bit atomicMax on a key (balance bits, ~column, a0, a1), so
//     the highest balance and, among equal balances, the lowest column win;
//     the key also carries the two alleles of the winning column.
//  2. Compaction of the selected strips by a prefix count (the plain
//     version's stable argsort).
//  3. The allele matrix A as two bitplanes of S rows (sites) by R bits
//     (reads): "covered" and "minor".  A row is seeded from the reference
//     base and the read spans (a ballot a word), then substitutions and
//     deletion runs rewrite their reads' bits (a binary search of the
//     site columns, which are in ascending order).  Deletion runs come
//     after substitutions: DEL wins.  The planes live in shared memory
//     when they fit (3 * S * R / 8 bytes with the block masks below: 192 KB
//     at R 1024 and S 512) and else in the wrapper's scratch, 3 * S *
//     ceil(R / 32) words a region.
//  4. Purification over popcounts of plane pairs; a second compaction
//     (passed sites, then the sites that failed, then the empty slots, each
//     in slot order) reorders the rows.
//  5. Blocks (a scan of the links), the parity initialisation (a scan of
//     the flips) and the MEC rounds.
//  6. Read assignment, site summaries, then the two votes: a second and a
//     third sweep over the column tiles with each haplotype's use-mask,
//     which write the consensus tracks as they go (RLE runs from a running
//     boundary count, or the dense nibbles and coverage bits).
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
//  - Bitplanes in place of the (R, S) int8 matrix: A == h, A == 1 - h and
//    the votes become ANDs and popcounts of 32 reads at a time.
// Byte-exactness: the balance is __fdiv_rn (no fast math); argmax takes the
// first maximum; every comparison is the plain version's integer one.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;                  // columns a thread holds in a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDelSym = 254;
constexpr unsigned kMaxCol = (1u << 26) - 1;   // columns fit 26 key bits

// sections of wire.delta_flat_layout, in order
enum { IN_REF, IN_STARTS, IN_ENDS, IN_RV, IN_SUB_POS, IN_SUB_READ, IN_SUB_SYM,
       IN_DEL_READ, IN_DEL_A, IN_DEL_B, IN_LTRUE, IN_COUNT };
// misc scalars in shared memory
enum { M_A0_COL0, M_CD, M_COUNT };

struct Params {
  const uint8_t* buf;
  uint8_t* out;
  uint32_t* scratch;          // the planes when they are not in shared memory
  int G, R, L, Ds, Dd, Drle, S, RW;
  int mec_iters, min_site_depth, min_minor_count, lo_num, lo_den, hi_num,
      hi_den, purify_window, purify_min_pairs, purify_num, purify_den;
  long long in_off[IN_COUNT];
  long long out_stride;
  // shared memory, byte offsets: the union (sweep buffers or planes) first
  int s_keys, s_dcov, s_ddel, s_dsub, s_st, s_dv, s_sym, s_cov, s_planes;
  int s_wsum, s_misc, s_col, s_tcol, s_blk, s_bstart, s_hm, s_a, s_ta, s_h,
      s_hn, s_lnk, s_hp;
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
  int ltrue;
  uint8_t* out;
  unsigned long long* keys;   // (S,) best key of each strip
  int* dcov;                  // (T,) span events of a tile
  int* ddel;                  // (T,) deletion-run events of a tile
  int* dsub;                  // (5, T) substitutions of a tile by symbol
  uint8_t* st;                // (T,) vote sweep: state, deviation, symbol,
  uint8_t* dv;                //      coverage of a tile's columns
  uint8_t* sym;
  uint8_t* cov;
  uint32_t* pcov;             // (S, RW) covered bits
  uint32_t* pmin;             // (S, RW) minor-allele bits
  uint32_t* pasm;             // (S, RW) assignment bits a block (and a temp)
  int* wsum;                  // (33,) block scan
  int* misc;
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
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

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

__device__ __forceinline__ int code_of(int i) { return i < 4 ? i : kDelSym; }

// 0 major, 1 minor, -1 neither, for a read symbol at a site of alleles a
__device__ __forceinline__ int allele_of(int sym, int a) {
  return sym == code_of(a & 15) ? 0 : (sym == code_of(a >> 4) ? 1 : -1);
}

__device__ __forceinline__ bool spans(const Ctx& c, int r, int col) {
  return c.rv[r] && c.starts[r] <= col && col < c.ends[r];
}

__device__ __forceinline__ bool uses(const Params& p, const Ctx& c, int r,
                                     int k) {
  if (r < 0 || r >= p.R || !c.rv[r]) return false;
  return k == 0 || c.hp[r] == 0 || c.hp[r] == k;
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

// One tile's events into the difference arrays.  k == 0: the counts of the
// site search (every valid read, every deletion run and substitution);
// k == 1, 2: the vote of haplotype k (reads of hp k or 0 and their events).
__device__ void tile_events(const Params& p, const Ctx& c, int t0, int T,
                            int k) {
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    c.dcov[i] = 0;
    c.ddel[i] = 0;
  }
  for (int i = threadIdx.x; i < 5 * T; i += blockDim.x) c.dsub[i] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < p.R; r += blockDim.x) {
    if (!uses(p, c, r, k)) continue;
    const unsigned a = (unsigned)(c.starts[r] - t0);
    const unsigned b = (unsigned)(c.ends[r] - t0);
    if (a < (unsigned)T) atomicAdd(&c.dcov[a], 1);
    if (b < (unsigned)T) atomicAdd(&c.dcov[b], -1);
  }
  for (int i = threadIdx.x; i < p.Dd; i += blockDim.x) {
    const int r = c.del_read[i];
    if (k == 0 ? r < 0 : !uses(p, c, r, k)) continue;
    const unsigned a = (unsigned)(c.del_a[i] - t0);
    const unsigned b = (unsigned)(c.del_b[i] - t0);
    if (a < (unsigned)T) atomicAdd(&c.ddel[a], 1);
    if (b < (unsigned)T) atomicAdd(&c.ddel[b], -1);
  }
  for (int i = threadIdx.x; i < p.Ds; i += blockDim.x) {
    const int r = c.sub_read[i];
    if (k == 0 ? r < 0 : !uses(p, c, r, k)) continue;
    const unsigned q = (unsigned)(c.sub_pos[i] - t0);
    if (q < (unsigned)T)
      atomicAdd(&c.dsub[imin(c.sub_sym[i], 4) * T + q], 1);
  }
  __syncthreads();
}

// A tile's span and deletion counts at this thread's kCols columns, from
// the tile's events and the carries of the tiles before it.
__device__ void tile_counts(const Params& p, const Ctx& c, int t0, int k,
                            int& carry_c, int& carry_d, int (&cov)[kCols],
                            int (&del)[kCols]) {
  const int T = kCols * blockDim.x, i0 = threadIdx.x * kCols;
  tile_events(p, c, t0, T, k);
  int sc = 0, sd = 0;
  for (int j = 0; j < kCols; ++j) {
    sc += c.dcov[i0 + j];
    sd += c.ddel[i0 + j];
    cov[j] = sc;
    del[j] = sd;
  }
  int tc, td;
  const int ec = block_excl_scan(sc, c.wsum, tc);
  const int ed = block_excl_scan(sd, c.wsum, td);
  for (int j = 0; j < kCols; ++j) {
    cov[j] += carry_c + ec;
    del[j] += carry_d + ed;
  }
  carry_c += tc;
  carry_d += td;
}

// Sweep 1: column counts, het columns, the best column of each strip.
__device__ void sweep_sites(const Params& p, const Ctx& c) {
  const int T = kCols * blockDim.x, i0 = threadIdx.x * kCols, S = p.S;
  // strips over the region's TRUE length; the last strip takes the rest
  const int strip = imax((c.ltrue + S - 1) / S, 1);
  for (int s = threadIdx.x; s < S; s += blockDim.x) c.keys[s] = 0ull;
  int carry_c = 0, carry_d = 0;
  for (int t0 = 0; t0 < p.L; t0 += T) {
    int cov[kCols], del[kCols];
    tile_counts(p, c, t0, 0, carry_c, carry_d, cov, del);
    for (int j = 0; j < kCols; ++j) {
      const int i = i0 + j, col = t0 + i;
      if (col >= p.L) break;
      int cnt[5], nsub = 0;
      for (int s = 0; s < 5; ++s) nsub += c.dsub[s * T + i];
      const int base = cov[j] - del[j] - nsub;   // reads matching ref
      const int rf = c.ref[col];
      for (int s = 0; s < 4; ++s)
        cnt[s] = (rf == s ? base : 0) + c.dsub[s * T + i];
      cnt[4] = del[j];
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
      if (!het) continue;
      const float bal = __fdiv_rn((float)top1, (float)imax(n0 + top1, 1));
      if (!(bal > 0.f)) continue;              // never selected
      const int stripe = imin(col / strip, S - 1);
      const unsigned lo = ((kMaxCol - (unsigned)col) << 6) |
                          ((unsigned)a0 << 3) | (unsigned)a1;
      atomicMax(&c.keys[stripe],
                ((unsigned long long)__float_as_uint(bal) << 32) | lo);
    }
  }
  __syncthreads();
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
  for (int idx = warp; idx < total; idx += nw) {
    const int s = idx / RW, w = idx - s * RW;
    unsigned cw = 0, mw = 0;
    if (s < n_het) {
      const int col = c.col[s], r = w * 32 + lane;
      const unsigned span = __ballot_sync(kFull, r < p.R && spans(c, r, col));
      const int v = allele_of(c.ref[col], c.a[s]);
      cw = v >= 0 ? span : 0u;
      mw = v == 1 ? span : 0u;
    }
    if (lane == 0) {
      c.pcov[idx] = cw;
      c.pmin[idx] = mw;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.Ds; i += blockDim.x) {
    const int r = c.sub_read[i], pos = c.sub_pos[i];
    if (r < 0 || r >= p.R) continue;
    const int s = lower_site(c, n_het, pos);
    if (s == n_het || c.col[s] != pos || !spans(c, r, pos)) continue;
    set_allele(c, s * RW + (r >> 5), r & 31, allele_of(c.sub_sym[i], c.a[s]));
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
  for (int j = warp; j < S; j += nw) {
    int v1 = 0, v0 = 0;
    if (j < nS) {
      for (int w = lane; w < RW; w += 32) {
        const unsigned cw = c.pcov[j * RW + w], mw = c.pmin[j * RW + w];
        const unsigned h1 = c.hm[w], h2 = c.hm[RW + w];
        v1 += __popc(cw & mw & h1) + __popc(cw & ~mw & h2);
        v0 += __popc(cw & ~mw & h1) + __popc(cw & mw & h2);
      }
    }
    v1 = warp_sum(v1);
    v0 = warp_sum(v0);
    if (lane == 0) o_h[j] = v1 > v0;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    st_i32(c.out + 4 + 4LL * j, c.col[j]);
    o_a0[j] = (uint8_t)code_of(c.a[j] & 15);
    o_a1[j] = (uint8_t)code_of(c.a[j] >> 4);
    o_conn[j] = j + 1 < S ? c.lnk[j] : 0;
  }
  if (threadIdx.x == 0) st_i32(c.out, nS);
  __syncthreads();
}

// Sweep 2 or 3: haplotype k's 6-symbol vote at every column and its track,
// as RLE runs against the reference (Drle > 0) or as nibbles and coverage
// bits (Drle == 0).
__device__ void vote_track(const Params& p, const Ctx& c, int k) {
  const int T = kCols * blockDim.x, i0 = threadIdx.x * kCols;
  const int L = p.L, D = p.Drle;
  uint8_t* tail = c.out + 4 + 8LL * p.S + 3LL * p.R;
  uint8_t* o_nruns = tail + 4 * (k - 1);
  uint8_t* o_start = tail + 8 + 4LL * D * (k - 1);
  uint8_t* o_len = tail + 8 + 8LL * D + 4LL * D * (k - 1);
  uint8_t* o_val = tail + 8 + 16LL * D + (long long)D * (k - 1);
  uint8_t* o_sym = tail + (long long)(L / 2) * (k - 1);
  uint8_t* o_covb = tail + L + (long long)(L / 8) * (k - 1);
  int carry_c = 0, carry_d = 0, carry_b = 0, carry_v = 0;
  int prev_st = 255, prev_dv = 0;
  for (int t0 = 0; t0 < L; t0 += T) {
    int cov[kCols], del[kCols];
    tile_counts(p, c, t0, k, carry_c, carry_d, cov, del);
    for (int j = 0; j < kCols; ++j) {
      const int i = i0 + j, col = t0 + i;
      if (col >= L) break;
      int cnt[6], nsub = 0;
      for (int s = 0; s < 5; ++s) nsub += c.dsub[s * T + i];
      const int base = cov[j] - del[j] - nsub;
      const int rf = c.ref[col];
      for (int s = 0; s < 5; ++s)
        cnt[s] = (rf == s ? base : 0) + c.dsub[s * T + i];
      cnt[5] = del[j];
      int sym = 0, best = cnt[0], tot = cnt[0];
      for (int s = 1; s < 6; ++s) {
        tot += cnt[s];
        if (cnt[s] > best) { best = cnt[s]; sym = s; }
      }
      const bool covered = tot > 0;
      c.st[i] = (uint8_t)(covered ? sym : 7);
      c.dv[i] = col < c.ltrue && !(covered && sym == rf);
      c.sym[i] = (uint8_t)sym;
      c.cov[i] = covered;
    }
    __syncthreads();
    if (D > 0) {
      // a run starts at a deviating column after a column that does not
      // deviate or holds another state
      int bnd[kCols], nb = 0, nd = 0;
      for (int j = 0; j < kCols; ++j) {
        const int i = i0 + j;
        bnd[j] = 0;
        if (t0 + i >= L) continue;
        const int ps = i ? c.st[i - 1] : prev_st;
        const int pd = i ? c.dv[i - 1] : prev_dv;
        bnd[j] = c.dv[i] && (!pd || c.st[i] != ps);
        nb += bnd[j];
        nd += c.dv[i];
      }
      int tb, td;
      int eb = carry_b + block_excl_scan(nb, c.wsum, tb);
      int ed = carry_v + block_excl_scan(nd, c.wsum, td);
      for (int j = 0; j < kCols; ++j) {
        const int i = i0 + j;
        if (t0 + i >= L) break;
        if (bnd[j]) {
          // run eb starts here; o_len holds, for now, the deviating
          // columns before each start
          if (eb < D) {
            st_i32(o_start + 4LL * eb, t0 + i);
            o_val[eb] = c.st[i];
            st_i32(o_len + 4LL * eb, ed);
          } else if (eb == D) {
            c.misc[M_CD] = ed;
          }
          ++eb;
        }
        ed += c.dv[i];
      }
      carry_b += tb;
      carry_v += td;
    } else {
      // dense: split-half nibbles (column i low, i + L/2 high) and the
      // coverage bits, most significant first (np.packbits)
      const int half = L / 2;
      for (int i = threadIdx.x; i < T && t0 + i < L; i += blockDim.x)
        if (t0 + i < half) o_sym[t0 + i] = c.sym[i];
      __syncthreads();
      for (int i = threadIdx.x; i < T && t0 + i < L; i += blockDim.x)
        if (t0 + i >= half) o_sym[t0 + i - half] |= (uint8_t)(c.sym[i] << 4);
      for (int q = threadIdx.x; q < T / 8 && t0 + 8 * q < L; q += blockDim.x) {
        unsigned v = 0;
        for (int b = 0; b < 8; ++b)
          if (c.cov[8 * q + b]) v |= 0x80u >> b;
        o_covb[(t0 >> 3) + q] = (uint8_t)v;
      }
    }
    const int last = imin(T, L - t0) - 1;
    prev_st = c.st[last];
    prev_dv = c.dv[last];
  }
  __syncthreads();
  if (D == 0) return;
  // runs past the last: start L, length 0, the last column's state
  const int n_runs = carry_b, total = carry_v;
  if (threadIdx.x == 0) {
    st_i32(o_nruns, n_runs);
    if (n_runs <= D) c.misc[M_CD] = total;
  }
  for (int b = n_runs + threadIdx.x; b < D; b += blockDim.x) {
    st_i32(o_start + 4LL * b, L);
    o_val[b] = (uint8_t)prev_st;
    st_i32(o_len + 4LL * b, total);
  }
  __syncthreads();
  // a run's length: deviating columns up to the next start
  for (int b0 = 0; b0 < D; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    int cur = 0, nxt = 0;
    if (b < D) {
      cur = ld_i32(o_len + 4LL * b);
      nxt = b + 1 < D ? ld_i32(o_len + 4LL * (b + 1)) : c.misc[M_CD];
    }
    __syncthreads();
    if (b < D) st_i32(o_len + 4LL * b, nxt - cur);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) region_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.x;
  const uint8_t* buf = p.buf;
  Ctx c;
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
  c.out = p.out + (long long)g * p.out_stride;
  unsigned char* sm = smem_raw;
  c.keys = reinterpret_cast<unsigned long long*>(sm + p.s_keys);
  c.dcov = reinterpret_cast<int*>(sm + p.s_dcov);
  c.ddel = reinterpret_cast<int*>(sm + p.s_ddel);
  c.dsub = reinterpret_cast<int*>(sm + p.s_dsub);
  c.st = sm + p.s_st;
  c.dv = sm + p.s_dv;
  c.sym = sm + p.s_sym;
  c.cov = sm + p.s_cov;
  const long long plane = (long long)p.S * p.RW;
  uint32_t* planes = p.scratch ? p.scratch + (long long)g * 3 * plane
                               : reinterpret_cast<uint32_t*>(sm + p.s_planes);
  c.pcov = planes;
  c.pmin = planes + plane;
  c.pasm = planes + 2 * plane;
  c.wsum = reinterpret_cast<int*>(sm + p.s_wsum);
  c.misc = reinterpret_cast<int*>(sm + p.s_misc);
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

  sweep_sites(p, c);
  const int n_het = compact_sites(p, c);
  build_alleles(p, c, n_het);
  const int nS = purify(p, c, n_het);
  const int nB = blocks_and_init(p, c, nS);
  for (int it = 0; it < p.mec_iters; ++it) {
    assign(p, c, nB);
    if (!update_h(p, c, nS)) break;    // a fixed point: the rest repeat it
  }
  assign(p, c, nB);
  reads_out(p, c, nS);
  sites_out(p, c, nS);
  vote_track(p, c, 1);
  vote_track(p, c, 2);
}

// Shared memory of a CTA: the union of the sweep's buffers and (when
// planes_in_smem) the three planes, then the fixed arrays.  Returns bytes.
size_t carve(Params& p, bool planes_in_smem) {
  const size_t T = (size_t)kCols * kThreads, S = p.S;
  size_t off = 0;
  auto take = [&](size_t bytes, size_t align) {
    off = (off + align - 1) / align * align;
    const size_t at = off;
    off += bytes;
    return (int)at;
  };
  p.s_keys = take(8 * S, 16);
  p.s_dcov = take(4 * T, 4);
  p.s_ddel = take(4 * T, 4);
  p.s_dsub = take(20 * T, 4);
  p.s_st = take(T, 1);
  p.s_dv = take(T, 1);
  p.s_sym = take(T, 1);
  p.s_cov = take(T, 1);
  const size_t planes = 12 * S * (size_t)p.RW;
  p.s_planes = 0;
  if (planes_in_smem && planes > off) off = planes;
  p.s_wsum = take(4 * 33, 16);
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
  return (off + 15) / 16 * 16;
}

int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

}  // namespace

extern "C" int focalsv_region_step(
    const void* buf, void* out, void* scratch, int G, int R, int L, int Ds,
    int Dd, int Drle, int S, int mec_iters, int min_site_depth,
    int min_minor_count, int lo_num, int lo_den, int hi_num, int hi_den,
    int purify_window, int purify_min_pairs, int purify_num, int purify_den,
    void* stream) {
  if (G <= 0) return 0;
  if (R < 1 || L < 1 || S < 1 || Ds < 0 || Dd < 0 || Drle < 0 ||
      (unsigned)L > kMaxCol || (Drle == 0 && L % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.buf = static_cast<const uint8_t*>(buf);
  p.out = static_cast<uint8_t*>(out);
  p.G = G; p.R = R; p.L = L; p.Ds = Ds; p.Dd = Dd; p.Drle = Drle; p.S = S;
  p.RW = (R + 31) / 32;
  p.mec_iters = mec_iters;
  p.min_site_depth = min_site_depth;
  p.min_minor_count = min_minor_count;
  p.lo_num = lo_num; p.lo_den = lo_den; p.hi_num = hi_num; p.hi_den = hi_den;
  p.purify_window = purify_window;
  p.purify_min_pairs = purify_min_pairs;
  p.purify_num = purify_num;
  p.purify_den = purify_den;
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
  const size_t limit = (size_t)smem_limit();
  size_t smem = carve(p, true);
  if (smem > limit) {
    smem = carve(p, false);
    if (smem > limit) return (int)cudaErrorInvalidValue;
    p.scratch = static_cast<uint32_t*>(scratch);
  }
  cudaFuncSetAttribute(region_step_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  void* args[] = {&p};
  cudaLaunchKernel(region_step_kernel, dim3(G), dim3(kThreads), args, smem,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
