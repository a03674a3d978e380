// Strided-rounds BayesR and horseshoe block-Jacobi sweeps on 2-bit packed
// genotypes, written for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_jacobi_t_kernel
//   (wrapper bayesr_jacobi_t_pallas, pallas_call at :1032) and
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_hs_jacobi_t_kernel
//   (wrapper horseshoe_jacobi_t_pallas, pallas_call at :1151)
// in their fold-affine 2-bit mode.  Python wrappers and plain versions:
// bayesrrcpp_tpu_torch/ops/jacobi_t.py.  The two sweeps share the dot and
// apply launches and differ in the solve (solve_kernel, hs_solve_kernel).
//
// One sweep is nr rounds.  Round r sweeps slab s = rho[r], the J blocks
// {j*nr + s : j < J} of B markers each, in three launches:
//
//   dot    r = X_b . eps for the round's J*B markers, in the code domain
//          (raw codes c in {0,1,2}); one thread per packed word loads the
//          word's 16 eps values once and reuses them for the B rows of a
//          block.  Per-CTA partial sums go to an (nsplit, J*B + 1) buffer
//          (the extra column is sum(eps)); no float atomics.
//   solve  one warp per block, lane l owning marker l of the block: the
//          fold algebra r = s*(C.eps) - (m*s)*sum(eps) turns the partials
//          into standardized r, then B exact sequential Gibbs steps visit
//          the block's markers in the order inner[b, :], each one a K-way
//          component draw in the visited lane and a rank-1 update
//          r -= G[m, :] * d over the warp with the Gram block in shared
//          memory.  Writes beta, labels, d*scale, and per-block v/bacc
//          partials (reduced in a fixed order by the wrapper).  The
//          horseshoe's hs_solve_kernel has the same layout, with a
//          conjugate normal draw per step and no labels.
//   apply  eps -= sum_m d_m * x_m over the round's rows with d != 0 (most
//          BayesR markers stay in the spike, d == 0 exactly): each CTA
//          compacts the round's nonzero d*scale in index order into shared
//          memory, then four threads share a word, each owning 4 of its 16
//          eps lanes, and stream the nonzero rows branch-free.  In the
//          horseshoe every valid marker moves, so the apply streams all
//          J*B rows, as many bytes as the dot, at a few warps per SM.
//
// What bounds it on an H100: the dot reads all words once per sweep (12.6
// GB at N=100,352 x M=503,808) and decodes every code, so it is bound by
// HBM and by the decode's integer and FP32 instructions; the decode takes
// a field in place, (w & 3<<2k) | 0x4B000000 read as a float is
// 2^23 + c*4^k, and multiplies by eps pre-scaled by 4^-k (exact: powers
// of two).  The 123 x 32 dependent solve steps of the headline plan are
// latency-bound: one warp per SM.  Every reduction runs in a fixed order,
// so a chain is bitwise reproducible from run to run on the card.  The
// file is compiled with -fmad=false so the solve's arithmetic rounds like
// the plain torch version op for op; the dot and apply use explicit fmaf.
//
// Semantics kept from the TPU kernel (pallas_jacobi_t.py:534-631):
// - every block of a round sees the round-start eps;
// - position t of block j of slab s reads p/z[(s*J + j)*B + t];
// - per step: invd = 1/denom, muk = num*invd, logL = lp + (0.5/sE*num)*muk,
//   the overflow guard compares only the slab logLs against candidate k
//   (threshold 700), sums unrolled in fixed k order, first k with
//   p <= cumulative weight wins, no hit keeps beta and the label;
// - beta_out = beta_old + d with d = valid*(beta_new - beta_old); a label
//   changes only where valid and hit; v counts the labels of the hits;
//   bacc sums beta_out^2 over slab hits.
// - lanes n >= N are never written, so eps stays 0 there.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxB = 32;           // markers per block: one lane each
constexpr int kMaxK = 8;            // mixture components
constexpr int kDotThreads = 128;    // words per dot CTA
constexpr int kApplyThreads = 128;  // 4 threads per word: 32 words per CTA
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kMaxRound = 4096;     // J*B markers per round
constexpr int kPerLane = kMaxRound / kApplyThreads;
constexpr float kMagic = 8388608.0f;        // 2^23
constexpr uint32_t kMagicBits = 0x4B000000u;

// Exact float of the 2-bit field k of w, for any k.
__device__ __forceinline__ float code_f(uint32_t w, int k) {
  return __uint_as_float(kMagicBits | ((w >> (2 * k)) & 3u)) - kMagic;
}

// c * 4^k for the field k <= 10 of w, exactly (3 * 4^10 < 2^23).
__device__ __forceinline__ float code_scaled(uint32_t w, int k) {
  return __uint_as_float(kMagicBits | (w & (3u << (2 * k)))) - kMagic;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int lg = 4; lg >= 0; --lg) v += __shfl_xor_sync(kFull, v, 1 << lg);
  return v;
}

// One halving step of warp_transpose_sum: lanes with bit OFF set keep the
// upper OFF values, the others the lower, each adding its partner's copy.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[kMaxB], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// v[i] per lane -> lane l returns the warp's sum of v[l] (31 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kMaxB],
                                                    int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const uint32_t* __restrict__ words, int Nw,
           const float* __restrict__ eps, const int* __restrict__ rho,
           int round, int nr, int J, int B, float* __restrict__ partial) {
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kDotThreads + threadIdx.x;
  const long long row0 = (long long)(j * nr + rho[round]) * B;
  const int JB1 = J * B + 1;

  float acc[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) acc[i] = 0.f;
  float esum = 0.f;
  if (w < Nw) {
    // eps of the word's 16 individuals, field k pre-scaled by 4^-k for
    // k <= 10 and by 4^-(k-11) above (those fields are read from w >> 22)
    float e[16];
    const float4* e4 = reinterpret_cast<const float4*>(eps) + 4LL * w;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 t = e4[q];
      e[4 * q] = t.x; e[4 * q + 1] = t.y; e[4 * q + 2] = t.z; e[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) esum += e[k];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      e[k] *= __uint_as_float((127u - 2u * (k <= 10 ? k : k - 11)) << 23);
    // all B loads first, so a warp keeps B lines in flight
    const uint32_t* wp = words + row0 * Nw + w;
    uint32_t wds[kMaxB];
#pragma unroll
    for (int i = 0; i < kMaxB; ++i)
      wds[i] = i < B ? __ldg(wp + (long long)i * Nw) : 0u;
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      const uint32_t wd = wds[i], hi = wd >> 22;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k <= 10; ++k) s = fmaf(code_scaled(wd, k), e[k], s);
#pragma unroll
      for (int k = 0; k < 5; ++k) s = fmaf(code_scaled(hi, k), e[11 + k], s);
      acc[i] = s;
    }
  }
  __shared__ float red[kDotThreads / 32][32];
  __shared__ float red_e[kDotThreads / 32];
  red[warp][lane] = warp_transpose_sum(acc, lane);
  esum = warp_sum(esum);
  if (lane == 0) red_e[warp] = esum;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDotThreads / 32; ++q) t += red[q][lane];
    float* out = partial + (long long)blockIdx.x * JB1;
    if (lane < B) out[j * B + lane] = t;
    if (j == 0 && lane == 0) {
      float te = 0.f;
#pragma unroll
      for (int q = 0; q < kDotThreads / 32; ++q) te += red_e[q];
      out[J * B] = te;
    }
  }
}

struct SolveArgs {
  const float* partial; int nsplit;
  const int* rho; int round; int nr; int J; int B; int K; int G;
  const float* gram; const float* xsq; const float* mean; const float* scale;
  const float* beta_in; const int* labels_in;
  float* beta_out; int* labels_out;
  const int* inner; const float* p; const float* z;
  const float* pi; const float* cva; const float* sigmaE;
  const float* sigmaGG; const int* gas; const unsigned char* valid;
  float* dsc; float* dms; float* vpart; float* bpart;
};

// K, the number of mixture components, is a template argument so the
// selection below is straight-line code.
template <int K>
__global__ void __launch_bounds__(32) solve_kernel(SolveArgs a) {
  const int j = blockIdx.x;
  const int lane = threadIdx.x;
  const int B = a.B, G = a.G;
  const int JB1 = a.J * B + 1;
  const int slab = a.rho[a.round];
  const long long blk = (long long)j * a.nr + slab;
  const long long m = blk * B + lane;
  const bool act = lane < B;

  // the Gram block (B*B floats, B even: float4 copies)
  __shared__ float4 gs4[kMaxB * kMaxB / 4];
  const float* gs = reinterpret_cast<const float*>(gs4);
  const float4* g4 = reinterpret_cast<const float4*>(a.gram + blk * B * B);
#pragma unroll 8
  for (int e = lane; e < B * B / 4; e += 32) gs4[e] = g4[e];

  // partial sums in a fixed order: sum(eps) over the CTAs q = lane mod 32,
  // then the warp; r of this lane's marker over q = 0, 1, ...
  float esum = 0.f;
  for (int q = lane; q < a.nsplit; q += 32)
    esum += a.partial[(long long)q * JB1 + JB1 - 1];
  esum = warp_sum(esum);
  float rc = 0.f;
  if (act) {
    const float* pr = a.partial + j * B + lane;
#pragma unroll 8
    for (int q = 0; q < a.nsplit; ++q) rc += pr[(long long)q * JB1];
  }
  const float sE = *a.sigmaE;
  const float half_invsE = 0.5f / sE;

  float r = 0.f, sc = 0.f, ms = 0.f, xs = 0.f, bold = 0.f, okf = 0.f;
  float pl = 0.f, zl = 0.f;
  int lab = 0, g = 0, inn = 0;
  float lp[K], invd[K], sd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) { lp[k] = 0.f; invd[k] = 0.f; sd[k] = 0.f; }
  if (act) {
    sc = a.scale[m];
    ms = a.mean[m] * sc;
    r = rc * sc - ms * esum;
    xs = a.xsq[m];
    bold = a.beta_in[m];
    lab = a.labels_in[m];
    okf = a.valid[m] ? 1.f : 0.f;
    g = a.gas[m];
    inn = a.inner[blk * B + lane];
    const long long q = ((long long)slab * a.J + j) * B + lane;
    pl = a.p[q];
    zl = a.z[q];
    // per-marker constants (pallas_jacobi_t.py:_bayesr_tbl)
    const float sG = a.sigmaGG[g];
    lp[0] = logf(fmaxf(a.pi[g * K], FLT_MIN));
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float c = a.cva[g * (K - 1) + k - 1];
      const float denom = xs + (sE / sG) / c;
      invd[k] = 1.f / denom;
      sd[k] = sqrtf(sE / denom);
      lp[k] = logf(fmaxf(a.pi[g * K + k], FLT_MIN)) -
              0.5f * logf((sG / sE) * xs * c + 1.f);
    }
  }
  __syncwarp();

  float d_own = 0.f;
  int krec = -1;
  for (int t = 0; t < B; ++t) {
    const int mk = __shfl_sync(kFull, inn, t);
    const float pt = __shfl_sync(kFull, pl, t);
    const float zt = __shfl_sync(kFull, zl, t);
    float d = 0.f;
    if (lane == mk) {
      const float num = r + bold * xs;
      float muk[K], logL[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        muk[k] = num * invd[k];
        logL[k] = lp[k] + (half_invsE * num) * muk[k];
      }
      int ksel = K;
      float acum = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float lk = logL[k];
        float gmax = fabsf(logL[1] - lk);
#pragma unroll
        for (int kk = 2; kk < K; ++kk) gmax = fmaxf(gmax, fabsf(logL[kk] - lk));
        float S = expf(logL[0] - lk);
#pragma unroll
        for (int kk = 1; kk < K; ++kk) S = S + expf(logL[kk] - lk);
        const float wk = gmax > 700.f ? 0.f : 1.f / S;
        acum = acum + wk;
        ksel = (pt <= acum && ksel == K) ? k : ksel;
      }
      const bool hit = ksel < K;
      float mu_sel = 0.f, sd_sel = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mu_sel = k == ksel ? muk[k] : mu_sel;
        sd_sel = k == ksel ? sd[k] : sd_sel;
      }
      const float beta_new = hit ? mu_sel + sd_sel * zt : bold;
      d = okf * (beta_new - bold);
      d_own = d;
      krec = (okf > 0.f && hit) ? ksel : -1;
    }
    d = __shfl_sync(kFull, d, mk);
    if (act) r = r - gs[mk * B + lane] * d;
  }

  const float bnew = bold + d_own;
  if (act) {
    a.beta_out[m] = bnew;
    a.labels_out[m] = krec >= 0 ? krec : lab;
    a.dsc[j * B + lane] = d_own * sc;
  }
  const float dms = warp_sum(act ? d_own * ms : 0.f);
  if (lane == 0) a.dms[j] = dms;
  for (int gg = 0; gg < G; ++gg) {
    for (int k = 0; k < K; ++k) {
      const unsigned hits = __ballot_sync(kFull, act && g == gg && krec == k);
      if (lane == 0) a.vpart[(blk * G + gg) * K + k] = (float)__popc(hits);
    }
    const float b2 = warp_sum((act && g == gg && krec > 0) ? bnew * bnew : 0.f);
    if (lane == 0) a.bpart[blk * G + gg] = b2;
  }
}

struct HsSolveArgs {
  const float* partial; int nsplit;
  const int* rho; int round; int nr; int J; int B;
  const float* gram; const float* xsq; const float* mean; const float* scale;
  const float* beta_in; float* beta_out;
  const int* inner; const float* z;
  const float* lam; const float* tau; const float* c2; const float* sigmaE;
  const unsigned char* valid;
  float* dsc; float* dms;
};

// The horseshoe's solve (pallas_jacobi_t.py:_hs_jacobi_t_kernel, :722-774):
// solve_kernel's warp-per-block layout, fold algebra, broadcast of the
// visited marker and canonical z index, with a conjugate normal draw in
// place of the component selection.  Per-lane constants in the op order
// of the TPU kernel's operand table (build_pkgT_hs_strided, :155-173):
//   s_j = tau*c2*lam / (tau*lam + c2), denom = xsq + sE/s_j,
//   invd = 1/denom, sd = sqrt(sE/denom);
// per step beta_new = num*invd + sd*z with num = r + beta_old*xsq.
__global__ void __launch_bounds__(32) hs_solve_kernel(HsSolveArgs a) {
  const int j = blockIdx.x;
  const int lane = threadIdx.x;
  const int B = a.B;
  const int JB1 = a.J * B + 1;
  const int slab = a.rho[a.round];
  const long long blk = (long long)j * a.nr + slab;
  const long long m = blk * B + lane;
  const bool act = lane < B;

  __shared__ float4 gs4[kMaxB * kMaxB / 4];
  const float* gs = reinterpret_cast<const float*>(gs4);
  const float4* g4 = reinterpret_cast<const float4*>(a.gram + blk * B * B);
#pragma unroll 8
  for (int e = lane; e < B * B / 4; e += 32) gs4[e] = g4[e];

  float esum = 0.f;
  for (int q = lane; q < a.nsplit; q += 32)
    esum += a.partial[(long long)q * JB1 + JB1 - 1];
  esum = warp_sum(esum);
  float rc = 0.f;
  if (act) {
    const float* pr = a.partial + j * B + lane;
#pragma unroll 8
    for (int q = 0; q < a.nsplit; ++q) rc += pr[(long long)q * JB1];
  }

  float r = 0.f, sc = 0.f, ms = 0.f, xs = 0.f, bold = 0.f, okf = 0.f;
  float zl = 0.f, invd = 0.f, sd = 0.f;
  int inn = 0;
  if (act) {
    sc = a.scale[m];
    ms = a.mean[m] * sc;
    r = rc * sc - ms * esum;
    xs = a.xsq[m];
    bold = a.beta_in[m];
    okf = a.valid[m] ? 1.f : 0.f;
    inn = a.inner[blk * B + lane];
    zl = a.z[((long long)slab * a.J + j) * B + lane];
    const float sE = *a.sigmaE, tau = *a.tau, c2 = *a.c2, lam = a.lam[m];
    const float s_j = tau * c2 * lam / (tau * lam + c2);
    const float denom = xs + sE / s_j;
    invd = 1.f / denom;
    sd = sqrtf(sE / denom);
  }
  __syncwarp();

  float d_own = 0.f;
  for (int t = 0; t < B; ++t) {
    const int mk = __shfl_sync(kFull, inn, t);
    const float zt = __shfl_sync(kFull, zl, t);
    float d = 0.f;
    if (lane == mk) {
      const float num = r + bold * xs;
      const float beta_new = num * invd + sd * zt;
      d = okf * (beta_new - bold);
      d_own = d;
    }
    d = __shfl_sync(kFull, d, mk);
    if (act) r = r - gs[mk * B + lane] * d;
  }

  if (act) {
    a.beta_out[m] = bold + d_own;
    a.dsc[j * B + lane] = d_own * sc;
  }
  const float dms = warp_sum(act ? d_own * ms : 0.f);
  if (lane == 0) a.dms[j] = dms;
}

__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const uint32_t* __restrict__ words, int Nw,
             float* __restrict__ eps, const unsigned char* __restrict__ row_valid,
             const int* __restrict__ rho, int round, int nr, int J, int B,
             const float* __restrict__ dsc, const float* __restrict__ dms) {
  // the round's nonzero d*scale, compacted in index order: rows, values
  extern __shared__ float smem[];
  float* vals = smem;
  int* rows = reinterpret_cast<int*>(smem + J * B);
  __shared__ int warp_cnt[kApplyWarps + 1];
  __shared__ float dms_tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int JB = J * B;
  const int slab = rho[round];
  // warp `warp` owns entries [lo, lo + 32*kPerLane); lane holds every 32nd
  const int lo = warp * 32 * kPerLane;
  float dv[kPerLane];
  int cnt = 0;
#pragma unroll
  for (int it = 0; it < kPerLane; ++it) {
    const int e = lo + it * 32 + lane;
    dv[it] = e < JB ? dsc[e] : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kPerLane; ++it)
    cnt += __popc(__ballot_sync(kFull, dv[it] != 0.f));
  if (lane == 0) warp_cnt[warp] = cnt;
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int q = 0; q < J; ++q) t += dms[q];
    dms_tot = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int q = 0; q < kApplyWarps; ++q) {
      const int c = warp_cnt[q];
      warp_cnt[q] = run;
      run += c;
    }
    warp_cnt[kApplyWarps] = run;
  }
  __syncthreads();
  int pos = warp_cnt[warp];
#pragma unroll
  for (int it = 0; it < kPerLane; ++it) {
    const unsigned mask = __ballot_sync(kFull, dv[it] != 0.f);
    if (dv[it] != 0.f) {
      const int e = lo + it * 32 + lane;
      const int at = pos + __popc(mask & ((1u << lane) - 1u));
      vals[at] = dv[it];
      rows[at] = ((e / B) * nr + slab) * B + e % B;
    }
    pos += __popc(mask);
  }
  __syncthreads();
  const int nnz = warp_cnt[kApplyWarps];

  const int w = blockIdx.x * (kApplyThreads / 4) + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;   // eps lanes 16w + 4*sub .. +3
  if (w >= Nw) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t* wp = words + w;
#pragma unroll 16
  for (int t = 0; t < nnz; ++t) {
    const uint32_t wd = __ldg(wp + (long long)rows[t] * Nw) >> (8 * sub);
    const float dv = vals[t];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = fmaf(dv, code_f(wd, k), acc[k]);
  }
  const long long n0 = 16LL * w + 4 * sub;
  const float dt = dms_tot;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (row_valid[n0 + k]) eps[n0 + k] = eps[n0 + k] - (acc[k] - dt);
}

}  // namespace

extern "C" {

int jacobi_t_dot_splits(int Nw) { return (Nw + kDotThreads - 1) / kDotThreads; }

int jacobi_t_max_block() { return kMaxB; }

int jacobi_t_max_round() { return kMaxRound; }

int jacobi_t_max_components() { return kMaxK; }

const char* jacobi_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One sweep: 3 launches per round, nr rounds, all on `stream`.  Returns
// the first launch error (cudaGetLastError) or 0.
int jacobi_t_sweep(const void* words, int Nw, int nr, int J, int B, int K,
                   int G, const void* gram, const void* xsq, const void* mean,
                   const void* scale, void* eps, const void* row_valid,
                   const void* beta_in, const void* labels_in, void* beta_out,
                   void* labels_out, const void* rho, const void* inner,
                   const void* p, const void* z, const void* pi,
                   const void* cva, const void* sigmaE, const void* sigmaGG,
                   const void* gas, const void* valid, void* partial,
                   int nsplit, void* dsc, void* dms, void* vpart, void* bpart,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const int* rh = static_cast<const int*>(rho);
  SolveArgs sa{static_cast<const float*>(partial), nsplit, rh, 0, nr, J, B,
               K, G, static_cast<const float*>(gram),
               static_cast<const float*>(xsq), static_cast<const float*>(mean),
               static_cast<const float*>(scale),
               static_cast<const float*>(beta_in),
               static_cast<const int*>(labels_in),
               static_cast<float*>(beta_out), static_cast<int*>(labels_out),
               static_cast<const int*>(inner), static_cast<const float*>(p),
               static_cast<const float*>(z), static_cast<const float*>(pi),
               static_cast<const float*>(cva),
               static_cast<const float*>(sigmaE),
               static_cast<const float*>(sigmaGG),
               static_cast<const int*>(gas),
               static_cast<const unsigned char*>(valid),
               static_cast<float*>(dsc), static_cast<float*>(dms),
               static_cast<float*>(vpart), static_cast<float*>(bpart)};
  const dim3 dot_grid(nsplit, J);
  const int apply_ctas = (Nw + kApplyThreads / 4 - 1) / (kApplyThreads / 4);
  const size_t apply_smem = (sizeof(float) + sizeof(int)) * J * B;
  cudaError_t err;
  for (int r = 0; r < nr; ++r) {
    dot_kernel<<<dot_grid, kDotThreads, 0, s>>>(
        wd, Nw, static_cast<const float*>(eps), rh, r, nr, J, B,
        static_cast<float*>(partial));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sa.round = r;
    switch (K) {
      case 2: solve_kernel<2><<<J, 32, 0, s>>>(sa); break;
      case 3: solve_kernel<3><<<J, 32, 0, s>>>(sa); break;
      case 4: solve_kernel<4><<<J, 32, 0, s>>>(sa); break;
      case 5: solve_kernel<5><<<J, 32, 0, s>>>(sa); break;
      case 6: solve_kernel<6><<<J, 32, 0, s>>>(sa); break;
      case 7: solve_kernel<7><<<J, 32, 0, s>>>(sa); break;
      case 8: solve_kernel<8><<<J, 32, 0, s>>>(sa); break;
      default: return cudaErrorInvalidValue;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    apply_kernel<<<apply_ctas, kApplyThreads, apply_smem, s>>>(
        wd, Nw, static_cast<float*>(eps),
        static_cast<const unsigned char*>(row_valid), rh, r, nr, J, B,
        static_cast<const float*>(dsc), static_cast<const float*>(dms));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return 0;
}

// One horseshoe sweep: dot, hs_solve and apply per round, nr rounds, all
// on `stream`.  Returns the first launch error (cudaGetLastError) or 0.
int jacobi_t_hs_sweep(const void* words, int Nw, int nr, int J, int B,
                      const void* gram, const void* xsq, const void* mean,
                      const void* scale, void* eps, const void* row_valid,
                      const void* beta_in, void* beta_out, const void* rho,
                      const void* inner, const void* z, const void* lam,
                      const void* tau, const void* c2, const void* sigmaE,
                      const void* valid, void* partial, int nsplit, void* dsc,
                      void* dms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const int* rh = static_cast<const int*>(rho);
  HsSolveArgs sa{static_cast<const float*>(partial), nsplit, rh, 0, nr, J, B,
                 static_cast<const float*>(gram),
                 static_cast<const float*>(xsq),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(beta_in),
                 static_cast<float*>(beta_out),
                 static_cast<const int*>(inner), static_cast<const float*>(z),
                 static_cast<const float*>(lam), static_cast<const float*>(tau),
                 static_cast<const float*>(c2),
                 static_cast<const float*>(sigmaE),
                 static_cast<const unsigned char*>(valid),
                 static_cast<float*>(dsc), static_cast<float*>(dms)};
  const dim3 dot_grid(nsplit, J);
  const int apply_ctas = (Nw + kApplyThreads / 4 - 1) / (kApplyThreads / 4);
  const size_t apply_smem = (sizeof(float) + sizeof(int)) * J * B;
  cudaError_t err;
  for (int r = 0; r < nr; ++r) {
    dot_kernel<<<dot_grid, kDotThreads, 0, s>>>(
        wd, Nw, static_cast<const float*>(eps), rh, r, nr, J, B,
        static_cast<float*>(partial));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sa.round = r;
    hs_solve_kernel<<<J, 32, 0, s>>>(sa);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    apply_kernel<<<apply_ctas, kApplyThreads, apply_smem, s>>>(
        wd, Nw, static_cast<float*>(eps),
        static_cast<const unsigned char*>(row_valid), rh, r, nr, J, B,
        static_cast<const float*>(dsc), static_cast<const float*>(dms));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
