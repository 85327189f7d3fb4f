// Kernel B6: the pair-HMM forward pass of the realignment at het sites
// (Longshot's allele evidence): a warp walks the (read row, haplotype
// column) grids of a run of (read window, haplotype window) pairs back to
// back, 32 rows at a time.
//
// Replaces focalsv_tpu/ops/pairhmm.py:44 pairhmm_forward_batch (a jitted,
// vmapped lax.scan that XLA compiles).  It computes what the plain version,
// focalsv_tpu_torch/ops/pairhmm.py::pairhmm_forward_batch_plain, computes,
// quirks included: the 3-state (M, X, Y) log-space forward recurrence over
// the cells (i, j), read row i in [0, read_len], haplotype column j in [1,
// hap_len]; free haplotype flanks (row 0's Y is 0 and its M and X are LOG0,
// except M(0, 0) = 0); a base code >= 4 never matches; the haplotype index
// clamped to [0, N - 1]; only the diagonals a = i + j <= M + N exist.  The
// term of diagonal a is fmaxf(lse2(M, X) at (read_len, a - read_len), LOG0)
// where that cell is valid and LOG0 elsewhere, so an end cell at -inf reads
// as LOG0; read_len outside [1, M] or hap_len <= 0 gives all-LOG0 terms.
// The result is
//   mt + log(sum_a exp(term_a - max(mt, LOG0 / 2))),  mt = max_a term_a.
// The log-sum-exps clamp their maximum at LOG0 / 2, so a cell whose
// predecessors are all LOG0 becomes -inf (never NaN), as in the plain
// version.  Every cell takes the plain version's float32 operations in its
// order (adds, fmaxf, libdevice expf and logf, (ea + eb) + ec); there is no
// product, so nothing contracts into an FMA, and the terms are the plain
// version's bytes on the card.  Only the last sum is taken in another order
// than torch.sum, so the result may differ from it by an ulp or so.  The
// emissions come from a (2, 256) table by the quality clamped to [0, 255]:
// the wrapper builds it with the plain version's own torch ops, so powf
// cannot differ either (the clamp is exact: the error probability saturates
// at 0.75 below quality 2 and at 1e-10 above 100).
//
// What bounds it on an H100.  At the realignment's shape (reads of 21 bases
// against windows of 25, padded to M = N = 29; a region's B reads against
// the ref and the alt window) the data needs 2 * B * 21 * 25 cells, each 7
// expf, 3 logf and some 30 adds, maxima and selects: about 150 FP32
// instructions, so the instructions bound it (the bytes, some 100 a pair,
// take far less).  But a region hands the kernel about 1,000 reads, a few
// warps a scheduler, and a cell is a chain of dependent shuffles, expf and
// logf (the logf a polynomial of 8 chained FMAs): a warp alone issues at
// well under one instruction a cycle.  So two things set the time: the
// instructions a pair takes (the idle lanes' too), and, for small calls,
// the steps a warp takes one after another.
//
// Design.  A warp takes `pairs_per_warp` consecutive (read, window) pairs,
// both windows of a read one after the other, then the next read's: the
// wrapper takes one pair a warp for small calls (fewest steps in a row),
// two or four as a call fills the card (fewer idle lanes a pair).  Its
// work is a list of groups, one per strip of 32 read rows of a read, back
// to back; a group walks the strip against each of the read's windows that
// are the warp's, one after the other, so the read's codes and emissions
// are loaded once for both.  Lane t holds row 32 s + t + 1 of strip s and
// walks its columns left to right, one a step, one step behind lane t - 1:
// lane t - 1's last cell is the cell above, lane t's own last cell the one
// to the left, and the value lane t received a step before is the
// diagonal.  So three __shfl_up_sync a step carry the wavefront, and a
// lane moves on to its row of the next pair as soon as its row of this one
// ends: one pair's ramp overlaps the next one's, and of the 32 lanes only
// the rows a strip lacks idle.  A step has no branch but the move to the
// next group (a lane outside its cells computes values it does not keep),
// and a cell's M, X and Y chains are written out side by side, so the
// compiler overlaps them.  At a pair's first column the left and diagonal
// cells are the grid's border.  Lane 0 takes the row above from row 0's
// constants on strip 0, and from the bottom row of the strip before, which
// lane 31 wrote (M, X and Y of each column); a strip that follows is held
// back until that row is 32 steps ahead (a group spans at least 32 steps).
// The lane of row read_len keeps (M, X) of each of its cells; after the
// walk the warp turns them into the terms (lse2 and fmaxf, spread over the
// lanes), takes their maximum and the sum of their exps with butterflies,
// and writes the results (and, when asked, each pair's M + N terms, LOG0
// off the end row, and its lane-steps into a counter).  A warp's workspace
// (its groups, the reads' codes and emissions, the windows, the bottom rows
// and the end rows) sits in shared memory when four warps' fit in
// kSmemBudget, else in device scratch that the wrapper allocates: any read
// or window width is taken.  The kernel is built for each of the two places
// and for reads of one strip or more.
//
// The host rehearsal (focalsv_tpu_torch/testing/host_kernel.py) builds this
// source with g++ against testing/host_cuda/.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 4;          // warps a block
constexpr float LOG0 = -1e30f;
constexpr float HALF_LOG0 = LOG0 * 0.5f;   // the plain version's LOG0 / 2
constexpr int kQual = 30;          // the quality of a read sent without quals
// a block's four workspaces go to shared memory up to this size
constexpr size_t kSmemBudget = 96 * 1024;

// One strip of one read: rows 32 s + 1 .. 32 s + rows against the windows.
struct alignas(16) Group {
  int w0, w1;     // the columns of each window's grid (0: none walked)
  int span;       // steps the group takes: w0 + w1, at least 32 before a
                  // strip
  int r;          // the read's index in the warp
  int s;          // the strip
  int rows;       // its rows, 1 to 32
  int last;       // the read's last strip
};

// Byte offsets of the parts of a warp's workspace.
struct Layout {
  size_t groups, info, em, ends[2], bottom[2], code, win[2], bytes;
};

struct Params {
  const uint8_t* reads;      // (B, M)
  const int32_t* read_lens;  // (B,)
  const uint8_t* quals;      // (B, M) clamped to [0, 255], or null
  const float* table;        // (2, 256): lm_match, lm_mis by quality
  const uint8_t* hap[2];     // (B, N_h)
  const int32_t* hap_len[2];
  float* terms[2];           // (B, M + N_h) or null
  float* out;                // (n_haps, B)
  unsigned char* scratch;    // the warps' workspaces, or null: shared memory
  unsigned long long* lane_steps;   // adds the warps' lane-steps, or null
  Layout lay;
  int B, M, N[2], n_haps, K, n_warps;
  float l_mm, l_gm, l_go, l_ge, l_ins;
};

size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// The reads that K consecutive pairs (read b, window h) can touch.
int reads_a_warp(int K, int n_haps) {
  return K % n_haps == 0 ? K / n_haps : (K + n_haps - 2) / n_haps + 1;
}

Layout layout(int M, const int N[2], int n_haps, int K) {
  Layout L = {};
  const size_t R = reads_a_warp(K, n_haps);
  const size_t strips = ((size_t)M + 31) / 32;
  size_t off = 0;
  L.groups = off;
  off += R * strips * sizeof(Group);
  L.info = off;
  off = align_up(off + R * 3 * sizeof(int), 8);
  L.em = off;
  off += R * M * 2 * sizeof(float);
  for (int h = 0; h < 2; ++h) {
    L.ends[h] = off;
    if (h < n_haps) off += R * (M + N[h]) * 2 * sizeof(float);
  }
  for (int h = 0; h < 2; ++h) {
    L.bottom[h] = off;    // only reads past 32 bases have a second strip
    if (h < n_haps && M > 32) off += (size_t)(M + N[h]) * 3 * sizeof(float);
  }
  L.code = off;
  off += R * M;
  for (int h = 0; h < 2; ++h) {
    L.win[h] = off;
    if (h < n_haps) off += R * N[h];
  }
  L.bytes = align_up(off, 16);
  return L;
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, HALF_LOG0);
  return m + logf(expf(a - ms) + expf(b - ms));
}

// One cell's three states:
//   mn = e + lse3(a, b, c), xn = l_ins + lse2(p, q), yn = lse2(r, s),
// each value by lse2's and lse3's operations in their order, written out
// side by side so that the compiler interleaves the three chains (as
// three calls, one after the other, they ran one after the other).
__device__ __forceinline__ void cell(float e, float a, float b, float c,
                                     float p, float q, float r, float s,
                                     float l_ins, float& mn, float& xn,
                                     float& yn) {
  const float ma = fmaxf(fmaxf(a, b), c);
  const float mx = fmaxf(p, q);
  const float my = fmaxf(r, s);
  const float sa = fmaxf(ma, HALF_LOG0);
  const float sx = fmaxf(mx, HALF_LOG0);
  const float sy = fmaxf(my, HALF_LOG0);
  const float ea = expf(a - sa), ep = expf(p - sx), er = expf(r - sy);
  const float eb = expf(b - sa), eq = expf(q - sx), es = expf(s - sy);
  const float ec = expf(c - sa);
  const float la = logf((ea + eb) + ec);
  const float lx = logf(ep + eq);
  const float ly = logf(er + es);
  mn = e + (ma + la);
  xn = l_ins + (mx + lx);
  yn = my + ly;
}

// kShared: the workspace is in shared memory (else in scratch); kStrips:
// a read may have more than one strip (M > 32).
template <bool kShared, bool kStrips>
__global__ void __launch_bounds__(kWarps * 32) pairhmm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= p.n_warps) return;    // the whole warp
  unsigned char* ws = kShared ? smem_raw + (size_t)warp * p.lay.bytes
                              : p.scratch + (size_t)gw * p.lay.bytes;
  const int M = p.M, H = p.n_haps;
  // the warp's pairs q0 .. q1 - 1 (pair b * H + h: read b, window h)
  const long long q0 = gw * p.K;
  const long long q1 = min(q0 + p.K, (long long)p.B * H);
  const int b0 = (int)(q0 >> (H - 1));           // H is 1 or 2
  const int nr = (int)((q1 - 1) >> (H - 1)) - b0 + 1;
  Group* groups = reinterpret_cast<Group*>(ws + p.lay.groups);
  int* info = reinterpret_cast<int*>(ws + p.lay.info);   // rlen, w0, w1
  float* em = reinterpret_cast<float*>(ws + p.lay.em);   // lm_match, lm_mis
  uint8_t* code = ws + p.lay.code;
  // the two windows' parts, selected by h (never indexed by it: an array
  // indexed at run time would live in local memory)
  uint8_t* const win0 = ws + p.lay.win[0];
  uint8_t* const win1 = ws + p.lay.win[1];
  float* const ends0 = reinterpret_cast<float*>(ws + p.lay.ends[0]);
  float* const ends1 = reinterpret_cast<float*>(ws + p.lay.ends[1]);
  float* const bot0 = reinterpret_cast<float*>(ws + p.lay.bottom[0]);
  float* const bot1 = reinterpret_cast<float*>(ws + p.lay.bottom[1]);
  const int N0 = p.N[0], N1 = p.N[1];
  const int C0 = M + N0, C1 = M + N1;

  // the warp's reads: codes and emissions by position, and the windows
  const size_t first = (size_t)b0 * M;
  for (int k = lane; k < nr * M; k += 32) {
    const int q = p.quals != nullptr ? p.quals[first + k] : kQual;
    code[k] = p.reads[first + k];
    em[2 * k] = p.table[q];
    em[2 * k + 1] = p.table[256 + q];
  }
  for (int k = lane; k < nr * N0; k += 32)
    win0[k] = p.hap[0][(size_t)b0 * N0 + k];
  if (H == 2)
    for (int k = lane; k < nr * N1; k += 32)
      win1[k] = p.hap[1][(size_t)b0 * N1 + k];
  // each read's length and the columns of its pairs that are the warp's
  // (0: none)
  for (int r = lane; r < nr; r += 32) {
    const int b = b0 + r;
    const int rlen = p.read_lens[b];
    const bool ok = rlen >= 1 && rlen <= M;
    const long long q = (long long)b * H;
    const int hl0 = q >= q0 ? p.hap_len[0][b] : 0;
    const int hl1 = H == 2 && q + 1 < q1 ? p.hap_len[1][b] : 0;
    info[3 * r] = rlen;
    info[3 * r + 1] = ok && hl0 >= 1 ? min(hl0, C0 - rlen) : 0;
    info[3 * r + 2] = ok && hl1 >= 1 ? min(hl1, C1 - rlen) : 0;
  }
  __syncwarp();

  // lane 0 lists the groups; the walk takes `steps` steps
  int n_groups = 0, steps = 0;
  if (lane == 0) {
    int start = 0;
    for (int r = 0; r < nr; ++r) {
      const int rlen = info[3 * r], w0 = info[3 * r + 1],
                w1 = info[3 * r + 2];
      if (w0 + w1 == 0) continue;
      const int S = (rlen + 31) / 32;
      for (int s = 0; s < S; ++s) {
        Group g;
        g.w0 = w0;
        g.w1 = w1;
        g.r = r;
        g.s = s;
        g.rows = min(32, rlen - 32 * s);
        g.last = s == S - 1;
        g.span = g.last ? w0 + w1 : max(w0 + w1, 32);
        groups[n_groups++] = g;
        // the step of its lowest row's last cell
        steps = max(steps, start + w0 + w1 + g.rows - 1);
        start += g.span;
      }
    }
  }
  n_groups = __shfl_sync(FULL, n_groups, 0);
  steps = __shfl_sync(FULL, steps, 0);
  __syncwarp();

  const bool top = lane == 0;
  // a valid address for the loads a lane makes but does not use
  const float* const idle = reinterpret_cast<const float*>(groups);
  int gi = 0, g_start = 0;
  Group cur = groups[0], nxt = groups[n_groups > 1 ? 1 : 0];
  int rc = 0;
  float lmat = 0.f, lmis = 0.f;
  if (n_groups > 0) {
    const int pos = cur.r * M + min(32 * cur.s + lane, M - 1);
    rc = code[pos];
    lmat = em[2 * pos];
    lmis = em[2 * pos + 1];
  }
  float m1 = LOG0, x1 = LOG0, y1 = LOG0;   // this lane's last cell
  float um = LOG0, ux = LOG0, uy = LOG0;   // the cell above it
  for (int k = 0; k < steps; ++k) {
    const float sm = __shfl_up_sync(FULL, m1, 1);
    const float sx = __shfl_up_sync(FULL, x1, 1);
    const float sy = __shfl_up_sync(FULL, y1, 1);
    const int u = k - lane;     // this lane's step in the warp's list
    if (u >= g_start + cur.span && gi + 1 < n_groups) {
      g_start += cur.span;
      cur = nxt;
      ++gi;
      nxt = groups[gi + 1 < n_groups ? gi + 1 : gi];
      const int pos = cur.r * M + min(32 * cur.s + lane, M - 1);
      rc = code[pos];
      lmat = em[2 * pos];
      lmis = em[2 * pos + 1];
    }
    // One cell, without a branch, so that the compiler can overlap the M,
    // X and Y chains: a lane before its first cell, in a group's padding
    // or past its last cell computes from values it does not keep.
    const int v = u - g_start;
    const bool live = u >= 0 && v < cur.w0 + cur.w1;
    const bool h = v >= cur.w0;
    const int j = h ? v - cur.w0 + 1 : v + 1;
    const bool first_col = j == 1;
    // the diagonal: the cell above one step ago, or the border at j = 1
    // (M and Y of (0, 0) are 0)
    const float border = top && cur.s == 0 ? 0.f : LOG0;
    const float dm = first_col ? border : um;
    const float dx = first_col ? LOG0 : ux;
    const float dy = first_col ? border : uy;
    // the cell above: lane - 1's last cell; for lane 0 row 0 (strip 0) or
    // the bottom row of the strip before
    if (kStrips) {
      const bool below = top && cur.s > 0 && live;
      const float* bt = below ? (h ? bot1 : bot0) + 3 * (j - 1) : idle;
      const float bm = bt[0], bx = bt[1], by = bt[2];
      um = !top ? sm : below ? bm : LOG0;
      ux = !top ? sx : below ? bx : LOG0;
      uy = !top ? sy : below ? by : 0.f;
    } else {
      um = top ? LOG0 : sm;
      ux = top ? LOG0 : sx;
      uy = top ? 0.f : sy;
    }
    const int Nh = h ? N1 : N0;
    const uint8_t* hp = live ? (h ? win1 : win0) + cur.r * Nh +
                                   min(j - 1, Nh - 1)
                             : win0;
    const int hc = *hp;
    const float e = rc == hc && rc < 4 ? lmat : lmis;
    const float lm = first_col ? LOG0 : m1;
    const float ly = first_col ? LOG0 : y1;
    float mn, xn, yn;
    cell(e, dm + p.l_mm, dx + p.l_gm, dy + p.l_gm, um + p.l_go, ux + p.l_ge,
         lm + p.l_go, ly + p.l_ge, p.l_ins, mn, xn, yn);
    m1 = mn;
    x1 = xn;
    y1 = yn;
    if (kStrips && live && lane == 31 && !cur.last) {
      float* wb = (h ? bot1 : bot0) + 3 * (j - 1);
      wb[0] = mn;
      wb[1] = xn;
      wb[2] = yn;
    }
    if (live && cur.last && lane == cur.rows - 1) {
      float* we = (h ? ends1 : ends0) + 2 * (cur.r * (h ? C1 : C0) + j - 1);
      we[0] = mn;
      we[1] = xn;
    }
    if (kStrips) __syncwarp();   // a bottom row written before it is read
  }
  __syncwarp();
  if (p.lane_steps != nullptr && lane == 0)
    atomicAdd(p.lane_steps, 32ull * (unsigned long long)steps);

  // the terms of each of the warp's pairs, their maximum and the sum of
  // their exps
  for (int r = 0; r < nr; ++r) {
    const int b = b0 + r;
    const int rlen = info[3 * r];
    for (int h = 0; h < H; ++h) {
      const long long q = (long long)b * H + h;
      if (q < q0 || q >= q1) continue;   // the same for the whole warp
      const int w = info[3 * r + 1 + h];
      const int C = h ? C1 : C0;
      float* en = (h ? ends1 : ends0) + 2 * (size_t)r * C;
      float mt = LOG0;     // every term is >= LOG0
      for (int k = lane; k < w; k += 32) {
        const float t = fmaxf(lse2(en[2 * k], en[2 * k + 1]), LOG0);
        en[2 * k] = t;
        mt = fmaxf(mt, t);
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, s));
      // the terms off the end row are LOG0: exp(LOG0 - ms) is 0
      const float ms = fmaxf(mt, HALF_LOG0);
      float sum = 0.f;
      for (int k = lane; k < w; k += 32) sum += expf(en[2 * k] - ms);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(FULL, sum, s);
      if (lane == 0) p.out[(size_t)h * p.B + b] = mt + logf(sum);
      float* terms = h ? p.terms[1] : p.terms[0];
      if (terms != nullptr) {
        __syncwarp();
        float* dst = terms + (size_t)b * C;
        for (int k = lane; k < C; k += 32)
          dst[k] = k >= rlen && k < rlen + w ? en[2 * (k - rlen)] : LOG0;
      }
    }
  }
}

template <bool kShared, bool kStrips>
int launch(const Params& p, size_t smem, void* stream) {
  auto* kernel = pairhmm_kernel<kShared, kStrips>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.n_warps + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)cudaGetLastError();
}

bool check_shape(int B, int M, int N0, int N1, int n_haps, int K) {
  return B >= 0 && M >= 1 && N0 >= 1 && K >= 1 &&
         (n_haps == 1 || (n_haps == 2 && N1 >= 1));
}

// Whether four warps' workspaces fit the card's shared memory as B6 takes
// it.
bool in_shared(const Layout& L) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = (size_t)kWarps * L.bytes;
  return smem <= kSmemBudget && smem <= (size_t)optin;
}

long long n_warps(int B, int n_haps, int K) {
  return ((long long)B * n_haps + K - 1) / K;
}

}  // namespace

// The bytes of device scratch that B6 needs for this shape (0: its
// workspaces fit shared memory), or -1 for a shape it does not take.
extern "C" long long focalsv_pairhmm_scratch_bytes(int B, int M, int N0,
                                                   int N1, int n_haps,
                                                   int pairs_per_warp) {
  if (!check_shape(B, M, N0, N1, n_haps, pairs_per_warp)) return -1;
  const int N[2] = {N0, n_haps == 2 ? N1 : 0};
  const Layout L = layout(M, N, n_haps, pairs_per_warp);
  if (in_shared(L)) return 0;
  return n_warps(B, n_haps, pairs_per_warp) * (long long)L.bytes;
}

// B6: log P(read | hap) of B read windows against one (n_haps 1) or two
// haplotype windows each, on the stream.  reads (B, M) uint8, read_lens (B,)
// int32, quals (B, M) uint8 (the phred quality clamped to [0, 255]) or null
// (quality 30), table (2, 256) float32 (lm_match and lm_mis by quality); for
// haplotype h: hap_h (B, N_h) uint8, hap_len_h (B,) int32 and terms_h (B, M
// + N_h) float32 or null; out (n_haps, B) float32; scratch of scratch_bytes
// as focalsv_pairhmm_scratch_bytes asks (null when it asks none);
// lane_steps one uint64 to which the launch adds 32 times each warp's steps
// (the lane-steps it took, idle lanes included), or null; each warp takes
// pairs_per_warp consecutive (read, window) pairs, both windows of a read
// after another.  The l_* are the log transition and insert-emission
// probabilities.  Returns 0 or a CUDA error; cudaErrorInvalidValue for a
// shape it does not take or too little scratch.
extern "C" int focalsv_pairhmm(
    const void* reads, const void* read_lens, const void* quals,
    const void* table, const void* hap0, const void* hap_len0,
    const void* hap1, const void* hap_len1, void* out, void* terms0,
    void* terms1, void* scratch, void* lane_steps, long long scratch_bytes,
    int B, int M, int N0, int N1, int n_haps, int pairs_per_warp, float l_mm,
    float l_gm, float l_go, float l_ge, float l_ins, void* stream) {
  const long long need = focalsv_pairhmm_scratch_bytes(B, M, N0, N1, n_haps,
                                                       pairs_per_warp);
  if (need < 0 || (need > 0 && (scratch == nullptr || scratch_bytes < need)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p = {};
  p.reads = static_cast<const uint8_t*>(reads);
  p.read_lens = static_cast<const int32_t*>(read_lens);
  p.quals = static_cast<const uint8_t*>(quals);
  p.table = static_cast<const float*>(table);
  p.hap[0] = static_cast<const uint8_t*>(hap0);
  p.hap_len[0] = static_cast<const int32_t*>(hap_len0);
  p.terms[0] = static_cast<float*>(terms0);
  p.N[0] = N0;
  if (n_haps == 2) {
    p.hap[1] = static_cast<const uint8_t*>(hap1);
    p.hap_len[1] = static_cast<const int32_t*>(hap_len1);
    p.terms[1] = static_cast<float*>(terms1);
    p.N[1] = N1;
  }
  p.out = static_cast<float*>(out);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.lane_steps = static_cast<unsigned long long*>(lane_steps);
  p.lay = layout(M, p.N, n_haps, pairs_per_warp);
  p.B = B;
  p.M = M;
  p.n_haps = n_haps;
  p.K = pairs_per_warp;
  p.n_warps = (int)n_warps(B, n_haps, pairs_per_warp);
  p.l_mm = l_mm;
  p.l_gm = l_gm;
  p.l_go = l_go;
  p.l_ge = l_ge;
  p.l_ins = l_ins;
  const bool strips = M > 32;
  if (need > 0)
    return strips ? launch<false, true>(p, 0, stream)
                  : launch<false, false>(p, 0, stream);
  const size_t smem = (size_t)kWarps * p.lay.bytes;
  return strips ? launch<true, true>(p, smem, stream)
                : launch<true, false>(p, smem, stream);
}
