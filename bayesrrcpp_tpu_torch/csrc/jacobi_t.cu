// Strided-rounds BayesR and horseshoe block-Jacobi sweeps on 2-bit packed
// genotypes, written for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_jacobi_t_kernel
//   (wrapper bayesr_jacobi_t_pallas, pallas_call at :1032) and
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_hs_jacobi_t_kernel
//   (wrapper horseshoe_jacobi_t_pallas, pallas_call at :1151)
// in their dense f32 mode, their int8 mode (fold-affine codes, one byte a
// genotype) and their two 2-bit modes: fold-affine (no missing calls) and
// `miss` (code 3 marks a missing call, which standardizes to 0).  Python
// wrappers and plain versions:
// bayesrrcpp_tpu_torch/ops/jacobi_t.py.  The two sweeps share the dot and
// apply launches and differ in the solve (solve_kernel, hs_solve_kernel).
// The decode, the dot's per-word arithmetic and the solves' bodies live in
// jacobi_t_common.cuh, shared with the fused multi-chain sweeps
// (jacobi_t_mc.cu).
//
// One sweep is nr rounds.  Round r sweeps slab s = rho[r], the J blocks
// {j*nr + s : j < J} of B markers each, in three launches.  A call runs
// the first n_rounds entries of rho: a whole sweep (n_rounds == nr), or
// one chunk of a sweep's rounds, rho holding the chunk's global round
// ids, the unit of work of the marker-sharded driver, which all-reduces
// eps between chunks (parallel/sharded.py).  That chunked form replaces
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:bayesr_jacobi_t_rounds
//   (pallas_call at :2229)
// with the same launches; a chunk's solve writes only its own blocks'
// beta, labels and v/bacc partials.  The three launches:
//
//   dot    r = X_b . eps for the round's J*B markers, in the code domain
//          (raw codes c in {0,1,2}); one thread per packed word loads the
//          word's 16 eps values once and reuses them for the B rows of a
//          block.  Per-CTA partial sums go to an (nsplit, J*B + 1) buffer
//          (the extra column is sum(eps)); no float atomics.  In the
//          miss mode the same words, turned into their missing-call
//          indicator (miss_bits), go through the same arithmetic a
//          second time, into (nsplit, J*B) indicator partials.
//   solve  one warp per block, lane l owning marker l of the block: the
//          fold algebra r = s*(C.eps) - (m*s)*sum(eps) turns the partials
//          into standardized r (miss mode: C.eps + (m - 3)*(I.eps) in
//          place of C.eps, jacobi_t_common.cuh:code_dot), then B exact
//          sequential Gibbs steps visit
//          the block's markers in the order inner[b, :], each one a K-way
//          component draw in the visited lane and a rank-1 update
//          r -= G[m, :] * d over the warp with the Gram block in shared
//          memory.  Writes beta, labels, d*scale, and per-block v/bacc
//          partials (reduced in a fixed order by the wrapper).  The
//          horseshoe's hs_solve_kernel has the same layout, with a
//          conjugate normal draw per step and no labels.
//   apply  eps -= sum_m d_m * x_m over the round's rows with d != 0 (most
//          BayesR markers stay in the spike, d == 0 exactly): a CTA takes
//          48 words of every row (one CTA an SM at the headline); all its
//          threads compact the round's nonzero d*scale into one list in
//          index order, then a producer warp streams the listed rows'
//          segments into a ring of stages in shared memory (cp.async,
//          an mbarrier a stage) while consumer threads, four a word, add
//          them up (miss mode: each row also adds d*scale*(m - 3) on its
//          missing calls, the indicator term of pallas_jacobi_t.py:
//          _make_dots' dot_a).  In the horseshoe every valid marker
//          moves, so the apply streams all J*B rows, as many bytes as the
//          dot.
//
// What bounds it on an H100: the dot reads all words once per sweep (12.6
// GB at N=100,352 x M=503,808) and decodes every code, so it is bound by
// HBM and by the decode's integer and FP32 instructions (the miss mode
// doubles those: a second decode and FMA per code for the indicator, from
// the words already in registers); the decode takes
// a field in place, (w & 3<<2k) | 0x4B000000 read as a float is
// 2^23 + c*4^k, and multiplies by eps pre-scaled by 4^-k (exact: powers
// of two).  The 123 x 32 dependent solve steps of the headline plan are
// latency-bound: one warp per SM.  Every reduction runs in a fixed order,
// so a chain is bitwise reproducible from run to run on the card.  The
// file is compiled with -fmad=false so the solve's arithmetic rounds like
// the plain torch version op for op; the dot and apply use explicit fmaf.
//
// The dense mode (X (Mpad, N) f32 rows, already standardized; eps of
// length N in natural order, no lane mask) keeps the rounds, the visit
// order and the solves, and swaps the dot and the apply: dense_dot_kernel
// reads each block's B rows once (a float4 per thread where N % 4 == 0,
// else columns at a stride of 128, so any N runs) and sums as the packed
// dot does, into the same (nsplit, J*B + 1) partials; the solve takes r
// from them unfolded (scale 1, mean 0: jacobi_t_common.cuh:marker_r); the
// apply (row_apply_kernel) streams the round's moved rows: a CTA takes a
// 256-byte segment of every row, and a producer warp copies the moved
// rows' segments into a ring in shared memory (cp.async.bulk) while two
// consumer warps add them up, one thread per individual.  It is bound by
// HBM: the dot reads every row of X once per sweep (3.22 GB at N=16,384 x
// M=49,152, 0.96 ms at 3.35 TB/s) at 2 flops per 4 bytes, and the apply
// reads the moved rows again (the horseshoe's: all of them).
//
// The int8 mode (X (Mpad, N) int8 codes {0, 1, 2, 3}, pad markers code 3
// with mean = scale = 0, so they add exactly 0; eps of length N, no lane
// mask; pallas_jacobi_t.py:_decoders' int8 branch, :287-298) runs the
// dense mode's launches on the codes: the dot (int8_dot_tile) loads 16
// codes a thread a row, as the 2-bit dot loads a word, decodes each byte
// exactly (jacobi_t_common.cuh:code8_f, a PRMT under the exponent of 2^23
// and one FADD, in place of an I2F at a quarter of the FP32 rate) and
// writes sum(eps) too; the solve folds r = s*(C.eps) - (m*s)*sum(eps) as for the
// words; the apply adds d*s*c over the moved rows and takes off the
// round's d.(m*s).  Bound: one byte per genotype, 50.56 GB a sweep at
// N=100,352 x M=503,808, 15.09 ms at 3.35 TB/s; the decode (PRMT, FADD)
// and FMA per code fit under it.
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

// MISS: the miss mode, which also writes the indicator partials `pind`.
template <bool MISS>
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const uint32_t* __restrict__ words, int Nw,
           const float* __restrict__ eps, const int* __restrict__ rho,
           int round, int nr, int J, int B, float* __restrict__ partial,
           float* __restrict__ pind) {
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
  float e[1][16];
  uint32_t wds[kMaxB];
  if (w < Nw) {
    esum = load_eps16(reinterpret_cast<const float4*>(eps) + 4LL * w, e[0]);
    // all B loads first, so a warp keeps B lines in flight
    load_words(words + row0 * Nw + w, Nw, B, wds);
    dot_rows<1>(wds, e, acc);
  }
  __shared__ float red[kDotThreads / 32][32];
  __shared__ float red_e[kDotThreads / 32];
  __shared__ float red_i[MISS ? kDotThreads / 32 : 1][32];
  red[warp][lane] = warp_transpose_sum(acc[0], lane);
  esum = warp_sum(esum);
  if (lane == 0) red_e[warp] = esum;
  if constexpr (MISS) {
    // the indicator's dot: the same eps, the words turned into their
    // missing-call bits
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) acc[0][i] = 0.f;
    if (w < Nw) {
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) wds[i] = miss_bits(wds[i]);
      dot_rows<1>(wds, e, acc);
    }
    red_i[warp][lane] = warp_transpose_sum(acc[0], lane);
  }
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
    if constexpr (MISS) {
      float ti = 0.f;
#pragma unroll
      for (int q = 0; q < kDotThreads / 32; ++q) ti += red_i[q][lane];
      if (lane < B) pind[(long long)blockIdx.x * (JB1 - 1) + j * B + lane] = ti;
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

// ---- the apply of the 2-bit modes (apply_kernel), one chain.  A CTA
// covers kPkWords words of every row (131 CTAs at Nw = 6,272: one an SM),
// kPkParts consumer threads a word, each owning kPkLanes of its eps
// lanes.  First every thread loads its share of the round's d*scale (and,
// in the miss mode, each row's mean), marks the moved entries (d != 0) in
// a bitmask and, after one prefix sum over the mask's words, writes its
// moved entries' rows and values to their places in one compacted list,
// in index order: the compaction is spread over every thread, not run
// whole by each.  Then kPkIssuers issuer warps stream the listed rows'
// segments, kPkRows rows a stage, into a ring of kPkStages stages in
// shared memory (stage s by warp s mod kPkIssuers, a bulk copy a row, one
// full / empty mbarrier pair a stage), while the consumers add the staged
// rows in list order: ~48 KB in flight an SM where each lane loading its
// own rows kept ~3 KB.  The consumers are bound by their integer
// instructions (NVIDIA H100 80GB HBM3, 700 W, PERF.md §6): a code is one
// LOP3 (code_exact, its exponent bits held in a register) and one FADD,
// then the FFMA.
constexpr int kPkWords = 48;                         // words of a row a CTA
constexpr int kPkLanes = 4;                          // eps lanes a thread
constexpr int kPkParts = 16 / kPkLanes;              // threads a word
constexpr int kPkConsumers = kPkParts * kPkWords;
constexpr int kPkWarps = kPkConsumers / 32;          // consumer warps
constexpr int kPkIssuers = 4;                        // warps issuing copies
constexpr int kPkThreads = kPkConsumers + 32 * kPkIssuers;
constexpr int kPkRows = 32;                          // rows a stage
constexpr int kPkStages = 8;                         // stages of the ring
constexpr int kPkPer =                               // pre-pass entries a
    (kMaxRound + kPkThreads - 1) / kPkThreads;       // thread
static_assert(kPkConsumers % 32 == 0, "whole consumer warps");
static_assert(kPkLanes <= kMagicAt, "a lane's exponent bits in kDecodeBits");

// Dynamic shared memory of the apply: the ring, then the compacted list
// (rows, d*scale and, in the miss mode, d*scale*(mean - 3)) and the
// round's J dms.
inline size_t apply_smem_bytes(bool miss, int J, int B) {
  return sizeof(uint32_t) * kPkStages * kPkRows * kPkWords +
         (sizeof(int) + sizeof(float) * (miss ? 2 : 1)) * J * B +
         sizeof(float) * J;
}

// Per eps lane n with row_valid[n]: acc from +0 over the round's moved
// rows in index order, fmaf(d*s, c, acc) for the lane's code c (miss mode:
// then d*s*(m - 3) added where the call is missing, which is
// fmaf(d*s*(m - 3), 1, acc): where it is not, the indicator's
// fmaf(., 0, acc) leaves acc, never -0, as it is, for finite d), and
// eps <- eps - (acc - dms_tot), dms_tot = 0 + dms[0] + ... + dms[J-1]:
// the bits of the apply that looped over the compacted rows itself.  The
// bulk copies take Nw % 4 == 0 and 16-byte aligned words (the port's
// words: Nw is a multiple of 128).
template <bool MISS>
__global__ void __launch_bounds__(kPkThreads)
apply_kernel(const uint32_t* __restrict__ words, int Nw,
             float* __restrict__ eps, const unsigned char* __restrict__ row_valid,
             const int* __restrict__ rho, int round, int nr, int J, int B,
             const float* __restrict__ dsc, const float* __restrict__ dms,
             const float* __restrict__ mean) {
  extern __shared__ __align__(128) uint32_t pdyn[];
  const int JB = J * B;
  uint32_t* ring = pdyn;
  int* lrow = reinterpret_cast<int*>(ring + kPkStages * kPkRows * kPkWords);
  float* ld = reinterpret_cast<float*>(lrow + JB);   // d*scale
  float* ldm = ld + JB;                              // miss: d*s*(m - 3)
  float* dmsv = ld + (MISS ? 2 : 1) * JB;
  __shared__ uint64_t full[kPkStages], empty[kPkStages], dms_bar;
  __shared__ uint32_t moved[kMaxRound / 32];
  __shared__ int prefix[kMaxRound / 32];
  __shared__ int nnz_s;
  __shared__ float dms_tot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = rho[round];
  const int w0 = blockIdx.x * kPkWords;
  const int nw = min(kPkWords, Nw - w0);
  const auto row_of = [&](int e) { return ((e / B) * nr + slab) * B + e % B; };

  // a consumer's word, lanes and their eps, read before anything waits
  const int wi = tid / kPkParts, sub = tid % kPkParts;
  const bool live = warp < kPkWarps && wi < nw;
  const long long n0 = 16LL * (w0 + wi) + kPkLanes * sub;
  float ev[kPkLanes];
  bool rv[kPkLanes];
#pragma unroll
  for (int k = 0; k < kPkLanes; ++k) {
    rv[k] = live && row_valid[n0 + k];
    ev[k] = rv[k] ? eps[n0 + k] : 0.f;
  }

  // ---- the moved entries, by every thread: entry e = k*kPkThreads + tid
  float dv[kPkPer], mv[MISS ? kPkPer : 1];
#pragma unroll
  for (int k = 0; k < kPkPer; ++k) {
    const int e = k * kPkThreads + tid;
    dv[k] = e < JB ? __ldg(dsc + e) : 0.f;
    if constexpr (MISS) mv[k] = e < JB ? __ldg(mean + row_of(e)) : 0.f;
  }
  for (int q = tid; q < J; q += kPkThreads) dmsv[q] = __ldg(dms + q);
  if (tid == 0) {
    for (int q = 0; q < kPkStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kPkWarps);
    }
    mbar_init(&dms_bar, 1);
    mbar_fence_init();
  }
  // mask word k*(kPkThreads/32) + warp holds entries k*kPkThreads + 32*warp
  // and up, a bit a lane
#pragma unroll
  for (int k = 0; k < kPkPer; ++k) {
    const unsigned b = __ballot_sync(kFull, dv[k] != 0.f);
    if (lane == 0 && k * kPkThreads + 32 * warp < JB)
      moved[k * (kPkThreads / 32) + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    // the mask words' exclusive prefix counts, 4 words a lane
    const int nmw = (JB + 31) / 32;
    int c[4], tot = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * lane + i;
      c[i] = m < nmw ? __popc(moved[m]) : 0;
      tot += c[i];
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - tot;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * lane + i;
      if (m < nmw) prefix[m] = run;
      run += c[i];
    }
    if (lane == 31) nnz_s = incl;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPkPer; ++k) {
    if (dv[k] != 0.f) {
      const int m = k * (kPkThreads / 32) + warp;
      const int at = prefix[m] + __popc(moved[m] & ((1u << lane) - 1u));
      lrow[at] = row_of(k * kPkThreads + tid);
      ld[at] = dv[k];
      if constexpr (MISS) ldm[at] = dv[k] * (mv[k] - 3.f);
    }
  }
  __syncthreads();
  const int nnz = nnz_s;
  const int nst = (nnz + kPkRows - 1) / kPkRows;

  if (warp >= kPkWarps) {
    // ---- an issuer: stage st (list rows st*kPkRows ..) when st % kPkIssuers
    // is its number; the last issuer also sums the round's dms_tot once
    // its first stage is in flight
    const int me = warp - kPkWarps;
    bool summed = me != kPkIssuers - 1;
    const auto sum_dms = [&]() {
      if (lane == 0) {
        float t = 0.f;
        for (int q = 0; q < J; ++q) t += dmsv[q];
        dms_tot = t;
        mbar_arrive(&dms_bar);
      }
      summed = true;
    };
    const uint32_t bytes = 4u * nw;
    for (int st = me; st < nst; st += kPkIssuers) {
      const int slot = st % kPkStages;
      if (st >= kPkStages)
        mbar_wait(&empty[slot], (st / kPkStages - 1) & 1);
      const int nrow = min(kPkRows, nnz - st * kPkRows);
      uint32_t* dst = ring + slot * kPkRows * kPkWords;
      const int* rw = lrow + st * kPkRows;
      // a lane a row: one bulk copy of its nw words
      if (lane == 0) mbar_arrive_expect(&full[slot], bytes * nrow);
      __syncwarp();
      if (lane < nrow)
        bulk_load(dst + lane * kPkWords, words + (long long)rw[lane] * Nw + w0,
                  bytes, &full[slot]);
      if (!summed) sum_dms();
    }
    if (!summed) sum_dms();
    return;
  }

  // ---- the consumers: thread (wi, sub) adds its 4 lanes of each row
  float acc[kPkLanes];
  uint32_t ex[kPkLanes];
#pragma unroll
  for (int k = 0; k < kPkLanes; ++k) {
    acc[k] = 0.f;
    ex[k] = kDecodeBits[k];
  }
  for (int st = 0; st < nst; ++st) {
    const int slot = st % kPkStages;
    mbar_wait(&full[slot], (st / kPkStages) & 1);
    const uint32_t* sw = ring + slot * kPkRows * kPkWords + wi;
    const float* dl = ld + st * kPkRows;
    const float* ml = ldm + st * kPkRows;
    const int nrow = min(kPkRows, nnz - st * kPkRows);
    const auto row = [&](int q) {
      const uint32_t wd = sw[q * kPkWords] >> (2 * kPkLanes * sub);
      const float d = dl[q];
#pragma unroll
      for (int k = 0; k < kPkLanes; ++k)
        acc[k] = fmaf(d, code_exact(wd, k, ex[k]), acc[k]);
      if constexpr (MISS) {
        const float dm = ml[q];
        const uint32_t mi = miss_bits(wd);
#pragma unroll
        for (int k = 0; k < kPkLanes; ++k)
          if (mi & (1u << (2 * k))) acc[k] = acc[k] + dm;
      }
    };
    if (nrow == kPkRows) {
#pragma unroll 8
      for (int q = 0; q < kPkRows; ++q) row(q);
    } else {
#pragma unroll 4
      for (int q = 0; q < nrow; ++q) row(q);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  if (!live) return;
  mbar_wait(&dms_bar, 0);
  const float dt = dms_tot;
#pragma unroll
  for (int k = 0; k < kPkLanes; ++k)
    if (rv[k]) eps[n0 + k] = ev[k] - (acc[k] - dt);
}

// The row-major modes' rounds: dense_dot_kernel, the solve launched by
// `solve` and the row apply (jacobi_t_common.cuh), on X (Mpad, N): dense
// f32 rows, or int8 codes in the fold mode (T int8_t: the dot also writes
// sum(eps), and the apply takes off the round's d.(m*s) in dms).
template <typename T, typename Solve>
cudaError_t row_rounds(const T* X, int N, int nr, int n_rounds, int J, int B,
                       const int* rh, float* eps, float* partial, int nsplit,
                       const float* dsc, const float* dms, cudaStream_t s,
                       Solve solve) {
  const dim3 dot_grid(nsplit, J);
  RowApply ap{X, N, eps, 1, rh, 0, nr, B, J * B, dsc, dms,
              nullptr, nullptr, nullptr, nullptr};
  cudaError_t err;
  for (int r = 0; r < n_rounds; ++r) {
    launch_row_dot<1>(dot_grid, s, X, N, eps, 1, rh, r, nr, J, B, partial,
                      nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = solve(r)) != cudaSuccess) return err;
    ap.at = r;
    launch_row_apply<T>(ap, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The dot and the apply of a round, in the dense mode (mean null: wd is
// X (Mpad, N) f32 and Nw is N), the int8 mode (x_int8: wd is (Mpad, N)
// int8 codes, Nw is N), the miss mode (pind not null) or the fold mode,
// around the solve launched by `solve`, for the first n_rounds entries of
// rh.
template <typename Solve>
cudaError_t sweep_rounds(const uint32_t* wd, int Nw, int x_int8, int nr,
                         int n_rounds, int J, int B, const int* rh,
                         float* eps, const unsigned char* row_valid,
                         float* partial, int nsplit, float* pind,
                         const float* dsc, const float* dms,
                         const float* mean, cudaStream_t s, Solve solve) {
  if (mean == nullptr)
    return row_rounds(reinterpret_cast<const float*>(wd), Nw, nr, n_rounds,
                      J, B, rh, eps, partial, nsplit, dsc, dms, s, solve);
  if (x_int8)
    return row_rounds(reinterpret_cast<const int8_t*>(wd), Nw, nr, n_rounds,
                      J, B, rh, eps, partial, nsplit, dsc, dms, s, solve);
  // the copy engine's 16-byte rule (Nw is a multiple of 128 in the port)
  if (Nw % 4 != 0 || reinterpret_cast<uintptr_t>(wd) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 dot_grid(nsplit, J);
  const bool miss = pind != nullptr;
  const auto apply = miss ? apply_kernel<true> : apply_kernel<false>;
  const int apply_ctas = (Nw + kPkWords - 1) / kPkWords;
  const size_t smem = apply_smem_bytes(miss, J, B);
  cudaError_t err = cudaFuncSetAttribute(
      apply, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int r = 0; r < n_rounds; ++r) {
    if (miss)
      dot_kernel<true><<<dot_grid, kDotThreads, 0, s>>>(
          wd, Nw, eps, rh, r, nr, J, B, partial, pind);
    else
      dot_kernel<false><<<dot_grid, kDotThreads, 0, s>>>(
          wd, Nw, eps, rh, r, nr, J, B, partial, pind);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = solve(r)) != cudaSuccess) return err;
    apply<<<apply_ctas, kPkThreads, smem, s>>>(
        wd, Nw, eps, row_valid, rh, r, nr, J, B, dsc, dms, mean);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The smallest round (J*B entries) whose row apply takes the ring, and
// not the direct path (jacobi_t_common.cuh:launch_row_apply; rows < 0:
// unchanged); returns the previous value.  Both paths give the same bits.
int jacobi_t_row_apply_ring_rows(int rows) { return set_ring_rows(rows); }

int jacobi_t_dot_splits(int Nw) { return (Nw + kDotThreads - 1) / kDotThreads; }

int jacobi_t_dense_dot_splits(int N) {
  return (N + kDenseTile - 1) / kDenseTile;
}

int jacobi_t_int8_dot_splits(int N) {
  return (N + kInt8Tile - 1) / kInt8Tile;
}

int jacobi_t_max_block() { return kMaxB; }

int jacobi_t_max_round() { return kMaxRound; }

int jacobi_t_max_components() { return kMaxK; }

const char* jacobi_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One sweep: 3 launches per round, all on `stream`, for the n_rounds
// rounds rho[0..n_rounds) of a sweep of nr (n_rounds == nr: the whole
// sweep; less: one chunk, block j of round r being j*nr + rho[r]).  mean
// and scale null select the dense mode: `words` is X (Mpad, N) f32, Nw is N,
// row_valid and pind are null and nsplit is jacobi_t_dense_dot_splits(N).
// x_int8 selects the int8 mode: `words` is (Mpad, N) int8 codes, Nw is N,
// mean and scale are given, row_valid and pind null, nsplit
// jacobi_t_int8_dot_splits(N).  Otherwise `pind` ((nsplit, J*B) floats)
// selects the miss mode, null the fold mode.  Returns the first launch
// error (cudaGetLastError) or 0.
int jacobi_t_sweep(const void* words, int Nw, int x_int8, int nr,
                   int n_rounds, int J,
                   int B, int K, int G, const void* gram, const void* xsq,
                   const void* mean, const void* scale, void* eps,
                   const void* row_valid, const void* beta_in, const void* labels_in, void* beta_out,
                   void* labels_out, const void* rho, const void* inner,
                   const void* p, const void* z, const void* pi,
                   const void* cva, const void* sigmaE, const void* sigmaGG,
                   const void* gas, const void* valid, void* partial,
                   int nsplit, void* dsc, void* dms, void* vpart, void* bpart,
                   void* pind, void* stream) {
  if (K < 2 || K > kMaxK || n_rounds < 1 || n_rounds > nr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
               static_cast<float*>(vpart), static_cast<float*>(bpart),
               static_cast<const float*>(pind)};
  auto solve = [&](int r) {
    sa.round = r;
    switch (K) {
      case 2: solve_kernel<2><<<J, 32, 0, s>>>(sa); break;
      case 3: solve_kernel<3><<<J, 32, 0, s>>>(sa); break;
      case 4: solve_kernel<4><<<J, 32, 0, s>>>(sa); break;
      case 5: solve_kernel<5><<<J, 32, 0, s>>>(sa); break;
      case 6: solve_kernel<6><<<J, 32, 0, s>>>(sa); break;
      case 7: solve_kernel<7><<<J, 32, 0, s>>>(sa); break;
      default: solve_kernel<8><<<J, 32, 0, s>>>(sa); break;
    }
    return cudaGetLastError();
  };
  return sweep_rounds(static_cast<const uint32_t*>(words), Nw, x_int8, nr,
                      n_rounds, J, B, rh, static_cast<float*>(eps),
                      static_cast<const unsigned char*>(row_valid),
                      static_cast<float*>(partial), nsplit,
                      static_cast<float*>(pind),
                      static_cast<const float*>(dsc),
                      static_cast<const float*>(dms),
                      static_cast<const float*>(mean), s, solve);
}

// One horseshoe sweep: dot, hs_solve and apply per round, nr rounds, all
// on `stream`; the dense mode (mean and scale null), x_int8 and `pind` as
// jacobi_t_sweep's.  Returns the first launch error (cudaGetLastError) or
// 0.
int jacobi_t_hs_sweep(const void* words, int Nw, int x_int8, int nr, int J,
                      int B,
                      const void* gram, const void* xsq, const void* mean,
                      const void* scale, void* eps, const void* row_valid,
                      const void* beta_in, void* beta_out, const void* rho,
                      const void* inner, const void* z, const void* lam,
                      const void* tau, const void* c2, const void* sigmaE,
                      const void* valid, void* partial, int nsplit, void* dsc,
                      void* dms, void* pind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
                 static_cast<float*>(dsc), static_cast<float*>(dms),
                 static_cast<const float*>(pind)};
  auto solve = [&](int r) {
    sa.round = r;
    hs_solve_kernel<<<J, 32, 0, s>>>(sa);
    return cudaGetLastError();
  };
  return sweep_rounds(static_cast<const uint32_t*>(words), Nw, x_int8, nr, nr,
                      J, B, rh, static_cast<float*>(eps),
                      static_cast<const unsigned char*>(row_valid),
                      static_cast<float*>(partial), nsplit,
                      static_cast<float*>(pind),
                      static_cast<const float*>(dsc),
                      static_cast<const float*>(dms),
                      static_cast<const float*>(mean), s, solve);
}

}  // extern "C"
