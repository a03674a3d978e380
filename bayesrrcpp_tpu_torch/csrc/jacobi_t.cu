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
// The decode, the dot's per-word arithmetic and the solves' bodies live in
// jacobi_t_common.cuh, shared with the fused multi-chain sweeps
// (jacobi_t_mc.cu).
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

#include "jacobi_t_common.cuh"

namespace {

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

  float acc[1][kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) acc[0][i] = 0.f;
  float esum = 0.f;
  if (w < Nw) {
    float e[1][16];
    esum = load_eps16(reinterpret_cast<const float4*>(eps) + 4LL * w, e[0]);
    // all B loads first, so a warp keeps B lines in flight
    uint32_t wds[kMaxB];
    load_words(words + row0 * Nw + w, Nw, B, wds);
    dot_rows<1>(wds, e, acc);
  }
  __shared__ float red[kDotThreads / 32][32];
  __shared__ float red_e[kDotThreads / 32];
  red[warp][lane] = warp_transpose_sum(acc[0], lane);
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

// The solves: one warp per block of the round (jacobi_t_common.cuh).
template <int K>
__global__ void __launch_bounds__(32) solve_kernel(SolveArgs a) {
  solve_block<K>(a, blockIdx.x);
}

__global__ void __launch_bounds__(32) hs_solve_kernel(HsSolveArgs a) {
  hs_solve_block(a, blockIdx.x);
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
