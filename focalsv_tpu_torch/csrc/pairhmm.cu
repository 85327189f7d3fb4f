// Kernel B6: the pair-HMM forward pass of the realignment at het sites
// (Longshot's allele evidence), one warp a (read window, haplotype window).
//
// Replaces focalsv_tpu/ops/pairhmm.py:44 pairhmm_forward_batch (a jitted,
// vmapped lax.scan that XLA compiles).  It computes what the plain version,
// focalsv_tpu_torch/ops/pairhmm.py::pairhmm_forward_batch_plain, computes,
// quirks included: the 3-state (M, X, Y) log-space forward recurrence over
// the anti-diagonals a = i + j of the (read row i, haplotype column j) grid,
// free haplotype flanks (Y is 0 on row 0 on every diagonal, valid or not; M
// and X are LOG0 there), a base code >= 4 never matches, the haplotype index
// clamped to [0, N - 1], and for each diagonal the term
//   max over the wavefront of (i == rlen && valid ? lse2(M, X) : LOG0),
// so that an end cell at -inf reads as LOG0; the result is
//   mt + log(sum_a exp(term_a - max(mt, LOG0 / 2))),  mt = max_a term_a.
// The log-sum-exps clamp their maximum at LOG0 / 2, so a cell whose
// predecessors are all LOG0 becomes -inf (never NaN) and stays apart from
// LOG0, as in the plain version.  Every operation is the plain version's in
// its order (float32 adds, fmaxf, libdevice expf and logf, (ea + eb) + ec);
// there is no product, so nothing contracts into an FMA, and the terms are
// the plain version's bytes on the card.  Only the last sum over the M + N
// terms is taken in another order than torch.sum (a strided sum a lane, then
// a butterfly), so the result may differ from it by an ulp or so.
// lm_match and lm_mis come from the wrapper, computed with the plain
// version's own torch ops, so powf cannot differ either.
//
// What bounds it on an H100.  At the realignment shape (reads of 21 bases
// against windows of 29, M = N = 29, a region's B windows against the ref
// and the alt haplotype) the data needs 2 * B * 21 * 29 cells; each takes 7
// expf and 3 logf (libdevice: some 8 and 20 FP32 instructions) and some 30
// adds, maxima and selects, about 150 FP32 instructions, so at B = 4,000
// some 0.73 G instructions, 0.022 ms at 33.5 T instructions/s (132 SMs x 128
// lanes x 1.98 GHz).  The bytes (reads, emissions, windows, results; about
// 1.3 MB) take 0.4 us.  The latency floor of a pair is its chain of 50 (up
// to M + N = 58) dependent diagonals, each a shuffle, three adds, two
// maxima, an expf, a logf and the selects: some 300 cycles, 8 us a pair.
// So the card has to keep enough pairs in flight to hide that chain, and
// the instructions set its pace.
//
// Design.  One warp a pair, four warps a block; the ref and the alt windows
// of a region are one launch of 2B warps that share the read's emissions.
// Lane t holds read rows t, t + 32, ... (G groups of 32 rows, G = ceil((M +
// 1) / 32), a template parameter up to MAX_GROUPS): the six wavefront
// registers of each row (M, X, Y at diagonals a - 1 and a - 2), its read
// code and its two emissions.  The value at row i - 1 (`up`) is one
// __shfl_sync a state and group: lane t reads lane t - 1, and lane 0 reads
// lane 31's value of the group before (LOG0 for group 0).  The haplotype
// window and the terms sit in the warp's shared memory.  Only groups that
// hold a row <= rlen are computed, and only the diagonals up to rlen +
// hlen: every later cell is masked to LOG0, so the terms there are LOG0
// (written up front).  One lane holds row rlen and writes each diagonal's
// term (the other rows all give LOG0, so the wavefront's maximum is
// fmaxf(its term, LOG0)).  At the end the warp reduces the terms to the
// result and copies them out when the caller asks for them.
//
// Limits: 1 <= max_read <= 32 * MAX_GROUPS - 1 = 127 (four groups, the
// most that the tests hold to the plain version; the realignment takes
// 29); the terms and the window of a block's four warps must fit the
// card's shared memory.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 4;          // warps (pairs) a block
constexpr int MAX_GROUPS = 4;      // groups of 32 read rows a lane
constexpr float LOG0 = -1e30f;
constexpr float HALF_LOG0 = LOG0 * 0.5f;   // the plain version's LOG0 / 2

struct Hap {
  const uint8_t* seq;    // (B, N) codes
  const int32_t* len;    // (B,)
  float* out;            // (B,)
  float* terms;          // (B, M + N) or null
  int N;
};

struct Params {
  const uint8_t* reads;    // (B, M)
  const int32_t* read_lens;
  const float* lm_match;   // (B, M)
  const float* lm_mis;     // (B, M)
  Hap hap[2];
  int B, M, n_pairs;
  int warp_floats;         // a warp's shared memory in floats
  int T_max;               // M + the widest N
  float l_mm, l_gm, l_go, l_ge, l_ins;
};

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, HALF_LOG0);
  return m + logf(expf(a - ms) + expf(b - ms));
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, HALF_LOG0);
  return m + logf((expf(a - ms) + expf(b - ms)) + expf(c - ms));
}

// Row i - 1's value of a wavefront held as G groups of 32 rows a lane.
template <int G>
__device__ __forceinline__ float up(const float (&v)[G], int g, int lane) {
  const float src = lane == 31 ? (g == 0 ? LOG0 : v[g > 0 ? g - 1 : 0]) : v[g];
  return __shfl_sync(FULL, src, (lane + 31) & 31);
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32) pairhmm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= p.n_pairs) return;    // the whole warp
  const int h = pair >= p.B;
  const int b = (int)(pair - (long long)h * p.B);
  const Hap hp = p.hap[h];
  const int M = p.M, N = hp.N, T = M + N;
  const int rlen = p.read_lens[b];
  const int hlen = hp.len[b];

  float* terms = reinterpret_cast<float*>(smem_raw) +
                 (size_t)warp * p.warp_floats;
  uint8_t* win = reinterpret_cast<uint8_t*>(terms + p.T_max);
  const uint8_t* hsrc = hp.seq + (size_t)b * N;
  for (int k = lane; k < T; k += 32) terms[k] = LOG0;
  for (int k = lane; k < N; k += 32) win[k] = hsrc[k];
  __syncwarp();

  // rows 0..last_row take part; the groups that hold one of them
  const int last_row = min(rlen, M);
  const int active = last_row < 0 ? 0 : last_row / 32 + 1;
  const int last = last_row < 0 ? 0 : min(T, max(0, last_row + hlen));
  const int own_g = rlen >= 0 && rlen <= M ? rlen / 32 : -1;
  const int own_lane = rlen & 31;

  int rc[G];
  float lmat[G], lmis[G];
  float m1[G], x1[G], y1[G], m2[G], x2[G], y2[G];
  const size_t row0 = (size_t)b * M;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = 32 * g + lane;
    const int k = min(max(i - 1, 0), M - 1);
    rc[g] = p.reads[row0 + k];
    lmat[g] = p.lm_match[row0 + k];
    lmis[g] = p.lm_mis[row0 + k];
    m1[g] = i == 0 ? 0.f : LOG0;    // diagonal 0: cell (0, 0)
    x1[g] = LOG0;
    y1[g] = m1[g];
    m2[g] = x2[g] = y2[g] = LOG0;
  }

  for (int a = 1; a <= last; ++a) {
    float nm[G], nx[G], ny[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= active) continue;    // the same for the whole warp
      const float um2 = up(m2, g, lane), ux2 = up(x2, g, lane),
                  uy2 = up(y2, g, lane), um1 = up(m1, g, lane),
                  ux1 = up(x1, g, lane);
      const int i = 32 * g + lane;
      const int j = a - i;
      const bool valid = i <= last_row && j >= 1 && j <= hlen;
      const int hc = win[min(max(j - 1, 0), N - 1)];
      const float e = rc[g] == hc && rc[g] < 4 ? lmat[g] : lmis[g];
      const float mn = e + lse3(um2 + p.l_mm, ux2 + p.l_gm, uy2 + p.l_gm);
      const float xn = p.l_ins + lse2(um1 + p.l_go, ux1 + p.l_ge);
      float yn = lse2(m1[g] + p.l_go, y1[g] + p.l_ge);
      if (i == 0) yn = 0.f;
      nm[g] = valid && i >= 1 ? mn : LOG0;
      nx[g] = valid && i >= 1 ? xn : LOG0;
      ny[g] = valid || i == 0 ? yn : LOG0;
      if (g == own_g && lane == own_lane) {
        const float t = valid ? lse2(nm[g], nx[g]) : LOG0;
        terms[a - 1] = fmaxf(t, LOG0);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= active) continue;
      m2[g] = m1[g];
      x2[g] = x1[g];
      y2[g] = y1[g];
      m1[g] = nm[g];
      x1[g] = nx[g];
      y1[g] = ny[g];
    }
  }
  __syncwarp();

  float mt = LOG0;    // every term is >= LOG0
  for (int k = lane; k < T; k += 32) mt = fmaxf(mt, terms[k]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, s));
  const float ms = fmaxf(mt, HALF_LOG0);
  float sum = 0.f;
  for (int k = lane; k < T; k += 32) sum += expf(terms[k] - ms);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(FULL, sum, s);
  if (lane == 0) hp.out[b] = mt + logf(sum);
  if (hp.terms != nullptr) {
    float* dst = hp.terms + (size_t)b * T;
    for (int k = lane; k < T; k += 32) dst[k] = terms[k];
  }
}

template <int G>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairhmm_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.n_pairs + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaLaunchKernelEx(&cfg, pairhmm_kernel<G>, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest max_read B6 takes.
extern "C" int focalsv_pairhmm_max_read() { return 32 * MAX_GROUPS - 1; }

// B6: log P(read | hap) of B read windows against one (n_haps 1) or two
// haplotype windows each, on the stream.  reads (B, M) uint8, read_lens (B,)
// int32, lm_match and lm_mis (B, M) float32 (the emissions of each read base
// by its quality); for haplotype h: hap_h (B, N_h) uint8, hap_len_h (B,)
// int32, out_h (B,) float32 and terms_h (B, M + N_h) float32 or null.  The
// l_* are the log transition and insert-emission probabilities.  Returns 0
// or a CUDA error; cudaErrorInvalidValue for shapes it does not take.
extern "C" int focalsv_pairhmm(
    const void* reads, const void* read_lens, const void* lm_match,
    const void* lm_mis, const void* hap0, const void* hap_len0, void* out0,
    void* terms0, int N0, const void* hap1, const void* hap_len1, void* out1,
    void* terms1, int N1, int B, int M, int n_haps, float l_mm, float l_gm,
    float l_go, float l_ge, float l_ins, void* stream) {
  if (B < 0 || M < 1 || M > 32 * MAX_GROUPS - 1 || n_haps < 1 ||
      n_haps > 2 || N0 < 1 || (n_haps == 2 && N1 < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p = {};
  p.reads = static_cast<const uint8_t*>(reads);
  p.read_lens = static_cast<const int32_t*>(read_lens);
  p.lm_match = static_cast<const float*>(lm_match);
  p.lm_mis = static_cast<const float*>(lm_mis);
  p.hap[0] = Hap{static_cast<const uint8_t*>(hap0),
                 static_cast<const int32_t*>(hap_len0),
                 static_cast<float*>(out0), static_cast<float*>(terms0), N0};
  p.hap[1] = n_haps == 2
                 ? Hap{static_cast<const uint8_t*>(hap1),
                       static_cast<const int32_t*>(hap_len1),
                       static_cast<float*>(out1), static_cast<float*>(terms1),
                       N1}
                 : p.hap[0];
  p.B = B;
  p.M = M;
  p.n_pairs = n_haps * B;
  const int n_max = n_haps == 2 && N1 > N0 ? N1 : N0;
  p.T_max = M + n_max;
  // the terms, then the window's bytes, a multiple of 16 bytes a warp
  p.warp_floats = ((p.T_max + (n_max + 3) / 4) + 3) / 4 * 4;
  p.l_mm = l_mm;
  p.l_gm = l_gm;
  p.l_go = l_go;
  p.l_ge = l_ge;
  p.l_ins = l_ins;
  const size_t smem = (size_t)kWarps * p.warp_floats * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 32) / 32) {      // ceil((M + 1) / 32)
    case 1: return launch<1>(p, smem, s);
    case 2: return launch<2>(p, smem, s);
    case 3: return launch<3>(p, smem, s);
    default: return launch<4>(p, smem, s);
  }
}
