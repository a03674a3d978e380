// Fused multi-chain strided-rounds BayesR and horseshoe sweeps on 2-bit
// packed genotypes, written for Hopper (sm_90a): C <= 16 chains that share
// the words, the Gram blocks and the visit order (rho, inner), each with
// its own eps, state, hyperparameters and p/z variates.
//
// Replaces the TPU Pallas kernels
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_jacobi_t_mc_kernel (C <= 4,
//   wrapper bayesr_jacobi_t_pallas_mc, pallas_call at :1635) and
//   _jacobi_t_mc8_kernel (4 < C <= 16, bayesr_jacobi_t_pallas_mc8, :2894),
//   _hs_jacobi_t_mc_kernel (horseshoe_jacobi_t_pallas_mc, :2054) and
//   _hs_jacobi_t_mc8_kernel (horseshoe_jacobi_t_pallas_mc8, :3263)
// in their dense f32 mode, their int8 mode and their two 2-bit modes,
// fold-affine and `miss` (jacobi_t.cu).  jacobi_t_mc_sweep also runs one chunk of a
// sweep's rounds, as jacobi_t_sweep does (n_rounds < nr), and so replaces
//   bayesrrcpp_tpu/ops/pallas_jacobi_t.py:bayesr_jacobi_t_mc_rounds
//   (pallas_call at :2403),
// the marker-sharded driver's fused unit of work.  The TPU splits C <= 4
// from 4 < C <= 16 because of VMEM (the wide kernel tiles eps through
// HBM); here one kernel serves every C <= 16 and the C eps vectors (C*Npad*4 bytes, 3.2 MB at
// N=100,352, C=8) stay in the 50 MB L2.  Python wrappers and plain
// versions: bayesrrcpp_tpu_torch/ops/jacobi_t.py (bayesr_jacobi_t_mc,
// horseshoe_jacobi_t_mc).
//
// One fused sweep is nr rounds of three launches, whatever C is:
//
//   dot_mc    r[c, m] = x_m . eps_c for the round's J*B markers and all C
//             chains.  The fold mode (fold_dot_mc_kernel): a CTA takes one
//             split of 128 words through several blocks of the round, holds
//             8 chains' eps (CP = 1, 2, 4 below 5 chains) in registers and
//             decodes each code once for them; the next block's words
//             stream into shared memory (cp.async) while each row's sums
//             are staged and added up.  The miss mode (dot_mc_kernel): a
//             thread loads its word column of the block (B words) into
//             registers once, then takes the chains CP at a time.  The
//             words are read from device memory once per round for all
//             chains.  Each chain's sums run in the single-chain dot's
//             order (the same FMA chain per row, warp_transpose_sum's tree,
//             the CTA's fixed-order sum into (C, nsplit, J*B + 1) partials).
//             In the miss mode each group of chains then takes the words'
//             missing-call indicator into (C, nsplit, J*B) indicator
//             partials, paying only for the missing calls (miss_rows: a
//             thread stages its chains' scaled eps in shared memory and
//             adds, row by row, the eps of the fields whose call is
//             missing, in field order), bit for bit the 16-FMA dense form
//             that the single-chain dot (jacobi_t.cu) runs.
//   solve_mc  one warp per (block, chain), grid (J, C): the single-chain
//             solve_block / hs_solve_block on the chain's operands.  v and
//             bacc partials per (chain, block), reduced by the wrapper in a
//             fixed order; no float atomics.
//   apply_mc  eps_c -= sum_m d[c, m] * x_m.  A CTA covers 16 words of
//             every row; its producer warp compacts the round's entries a
//             tile of 512 at a time, in index order, into one of two
//             buffers in shared memory: the rows where any chain moved (in
//             the horseshoe, every valid row), every chain's d*scale (0
//             where that chain did not move, which adds exactly nothing)
//             and, in the miss mode, each row's mean - 3.  It then streams
//             those rows' 64-byte segments into a ring of 8 stages of 32
//             rows by cp.async.bulk, one mbarrier a stage, while it
//             compacts the next tile.  Four consumer warps decode each
//             word from shared memory (a word's 16 eps lanes over 8
//             threads) and add every chain's term, in row order, with the
//             miss mode's indicator term after each row, as jacobi_t.cu's
//             apply does.  Each row is read from device memory once per
//             CTA and decoded once for all chains.
// The dense and int8 modes run jacobi_t_common.cuh's dense_dot_kernel (the
// rows of a block in registers once, decoded for int8 codes, then each
// chain's eps in turn) and row_apply_kernel (a ring of the moved rows'
// segments, or the direct path for small rounds), the single-chain
// kernel's code with a chain count.
//
// So chain c of a fused sweep equals the single-chain sweep (jacobi_t.cu)
// on chain c's operands bitwise: the same arithmetic in the same order,
// compiled with the same -fmad=false.
//
// What bounds it on an H100: the dot's operations.  It multiplies every
// code by every chain's eps, C * Mpad * Npad FMAs per sweep (4.05e11 at the
// headline and C=8: 12.1 ms at 67 TFLOP/s FP32), plus the decode (an LOP3
// and an FADD per code, shared by CP chains), against 3.8 ms for one read
// of the 12.64 GB of words; the horseshoe's apply does as many FMAs again.
// Design notes from the first runs on the card (PERF.md): with one chain per
// pass the compiler hoisted the chain-invariant decode of all B*16 codes
// out of the chain loop, ran out of registers and spilled (255 registers,
// 1.9 KB of spills); an empty asm on the words at the top of each group
// stops that, and CP=4 chains per group keeps 4*B accumulators in 255
// registers without spilling.  The apply was latency-bound with each lane
// loading its own word of each row (4 warps a CTA, 8 rows of loads in
// flight: ~1.5 KB of distinct bytes in flight per SM, where 3.35 TB/s at
// ~1 us of latency needs ~25 KB); the ring keeps 8 stages of 2 KB in
// flight per CTA, ~3 CTAs per SM, so the FMAs (C of them per lane of
// every moved row) and the decode set its pace.  Splitting a word's rows
// over CTAs would need a reduction across them, another summation order.

#include "jacobi_t_common.cuh"

namespace {

constexpr int kMaxC = 16;   // chains per fused sweep

// The CP chains' e' of one field of a thread, staged together.
template <int CP>
struct alignas(4 * CP) EsVec {
  float e[CP];
};

// The indicator of one word column's B rows for CP chains, only where a
// call is missing: acc[p][i] = the sum over the fields k of row i whose
// call is missing, in ascending k, of e'_p[k], from +0.  e'_p[k] =
// (e_p[k]*4^-k')*4^k' is the product the dense form (dot_rows on
// miss_bits) takes at that field, exactly, so each add rounds as its FMA
// does; at every other field the dense form adds a zero product, which
// leaves a sum that is never -0 unchanged.  So acc equals dot_rows on the
// indicator bit for bit (for finite eps), at a few adds a row where the
// dense form takes 16 FMAs.
// Ascending bit position is ascending k: field k is bit 2k of miss_bits
// (11-15 from w >> 22 in dot_rows).  es holds a field's CP values
// together (one 16-byte load for CP = 4), at es[k*kDotThreads].
template <int CP>
__device__ __forceinline__ void miss_rows(const uint32_t (&wds)[kMaxB],
                                          const EsVec<CP>* es,
                                          float (&acc)[CP][kMaxB]) {
  // each row's first missing call, branch-free, so that the loads of 8
  // rows are issued together (8, not 32: the registers of the loaded
  // values): a row without one loads field 0 and adds +0, which leaves
  // acc (+0) as it is
#pragma unroll
  for (int i0 = 0; i0 < kMaxB; i0 += 8) {
    asm volatile("" ::: "memory");
#pragma unroll
    for (int i = i0; i < i0 + 8; ++i) {
      const uint32_t m = miss_bits(wds[i]);
      const EsVec<CP> v =
          es[(m != 0u ? (__ffs(m) - 1) >> 1 : 0) * kDotThreads];
#pragma unroll
      for (int p = 0; p < CP; ++p)
        acc[p][i] = 0.f + (m != 0u ? v.e[p] : 0.f);
    }
  }
  // the rest, in field order (most rows of a warp have none); the word
  // is read afresh, so that the first pass's 32 masks are not kept
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    uint32_t w = wds[i];
    asm volatile("" : "+r"(w));
    uint32_t m = miss_bits(w);
    m &= m - 1u;
    while (m != 0u) {
      const EsVec<CP> v = es[((__ffs(m) - 1) >> 1) * kDotThreads];
      m &= m - 1u;
#pragma unroll
      for (int p = 0; p < CP; ++p) acc[p][i] = acc[p][i] + v.e[p];
    }
  }
}

// The miss mode's fused dot over the C chains, CP at a time, on the words
// wds: each chain's code row sums into red[c][warp][lane] and its sum(eps)
// into red_e[c][warp]; then each group of chains takes the words'
// missing-call indicator (miss_rows, on its e' staged in es) into
// red_i[c][warp][lane], through the same warp_transpose_sum.
template <int CP>
__device__ __forceinline__ void dot_mc_pass(
    uint32_t (&wds)[kMaxB], const float* __restrict__ eps, long long Npad,
    int C, int w, int Nw, int lane, int warp,
    float (*red)[kDotThreads / 32][32], float (*red_e)[kDotThreads / 32],
    float (*red_i)[kDotThreads / 32][32], EsVec<CP>* es) {
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += CP) {
    // the decode is the same for every pass: keep the compiler from
    // hoisting all B*16 decoded codes out of this loop (they spill)
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) asm volatile("" : "+r"(wds[i]));
    float acc[CP][kMaxB], esum[CP];
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      esum[p] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) acc[p][i] = 0.f;
    }
    if (w < Nw) {
      float e[CP][16];
#pragma unroll
      for (int p = 0; p < CP; ++p) {
        if (c0 + p < C) {
          esum[p] = load_eps16(
              reinterpret_cast<const float4*>(eps + (c0 + p) * Npad) + 4LL * w,
              e[p]);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) e[p][k] = 0.f;
        }
      }
      dot_rows<CP>(wds, e, acc);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float up =
            __uint_as_float((127u + 2u * (k <= 10 ? k : k - 11)) << 23);
        EsVec<CP> v;
#pragma unroll
        for (int p = 0; p < CP; ++p) v.e[p] = e[p][k] * up;
        es[k * kDotThreads] = v;
      }
    }
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const float r = warp_transpose_sum(acc[p], lane);
      const float esw = warp_sum(esum[p]);
      if (c0 + p < C) {
        red[c0 + p][warp][lane] = r;
        if (lane == 0) red_e[c0 + p][warp] = esw;
      }
    }
    if (w < Nw) {
      miss_rows<CP>(wds, es, acc);
    } else {
#pragma unroll
      for (int p = 0; p < CP; ++p)
#pragma unroll
        for (int i = 0; i < kMaxB; ++i) acc[p][i] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const float r = warp_transpose_sum(acc[p], lane);
      if (c0 + p < C) red_i[c0 + p][warp][lane] = r;
    }
  }
}

// Dynamic shared memory of dot_mc_kernel: the e' of CP chains a thread
// (miss_rows).
constexpr size_t dot_mc_smem(int CP) {
  return sizeof(float) * 16 * CP * kDotThreads;
}

// The miss mode's fused dot, CP chains per pass over the words: each code
// decoded once per pass; the indicator partials go to `pind`.
template <int CP>
__global__ void __launch_bounds__(kDotThreads)
dot_mc_kernel(const uint32_t* __restrict__ words, int Nw,
              const float* __restrict__ eps, int C,
              const int* __restrict__ rho, int round, int nr, int J, int B,
              float* __restrict__ partial, float* __restrict__ pind,
              int nsplit) {
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kDotThreads + threadIdx.x;
  const long long row0 = (long long)(j * nr + rho[round]) * B;
  const int JB1 = J * B + 1;
  const long long Npad = 16LL * Nw;
  __shared__ float red[kMaxC][kDotThreads / 32][32];
  __shared__ float red_e[kMaxC][kDotThreads / 32];
  __shared__ float red_i[kMaxC][kDotThreads / 32][32];
  extern __shared__ float es_dyn[];   // e' staged, [k][thread][p]

  uint32_t wds[kMaxB];
  if (w < Nw) {
    load_words(words + row0 * Nw + w, Nw, B, wds);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) wds[i] = 0u;
  }
  dot_mc_pass<CP>(wds, eps, Npad, C, w, Nw, lane, warp, red, red_e, red_i,
                  reinterpret_cast<EsVec<CP>*>(es_dyn) + threadIdx.x);
  __syncthreads();
  // output (c, l): the single-chain dot's fixed-order CTA sums
  for (int o = threadIdx.x; o < C * 32; o += kDotThreads) {
    const int c = o >> 5, l = o & 31;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDotThreads / 32; ++q) t += red[c][q][l];
    float* out = partial + ((long long)c * nsplit + blockIdx.x) * JB1;
    if (l < B) out[j * B + l] = t;
    if (j == 0 && l == 0) {
      float te = 0.f;
#pragma unroll
      for (int q = 0; q < kDotThreads / 32; ++q) te += red_e[c][q];
      out[J * B] = te;
    }
    float ti = 0.f;
#pragma unroll
    for (int q = 0; q < kDotThreads / 32; ++q) ti += red_i[c][q][l];
    if (l < B)
      pind[((long long)c * nsplit + blockIdx.x) * (JB1 - 1) + j * B + l] = ti;
  }
}

// ---- the fold mode's fused dot (fold_dot_mc_kernel).  A CTA takes one
// split of kDotThreads words (a thread a word, as dot_mc_kernel) and walks
// several blocks j of the round: blockIdx.y, + gridDim.y, ..., so each
// chain's eps is read once a CTA and not once a block.  A thread holds the
// eps of CP chains (CP = 8 for C > 4, two passes over the blocks at C > 8)
// and decodes each code once for all of them.  The next block's words come
// into shared memory by cp.async (a thread its own column, so no barrier)
// while the current block is summed.  Each row's CP sums are staged in
// shared memory, a warp's 32 words of a (chain, row) side by side, and lane
// l of the warp then adds pair l's 32 values in warp_transpose_sum's tree
// (lanes a and a + 16 first, then + 8, + 4, + 2, + 1): the transpose's
// 31 shuffles, 62 selects and 31 adds a chain become 32 stores, 8 loads
// and 31 adds.  A chain's sum of a (row, word) is dot_word's 16 fmaf in
// field order, from +0; then the same tree over the warp's words and the
// same sum over warps 0..3, from 0, into the same partials: the bits of
// dot_mc_kernel and of the single-chain dot_kernel<false>.  The decode's
// magic comes from kDecodeBits (one LOP3 a field, not two).  At C=8 the
// FFMAs run at ~40 % of the FP32 pipe's rate; eps read once a CTA, the
// prefetch and the magic were worth 37, 6 and 15 us of a ~250 us round
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
constexpr int kFoldSlots = 2;   // word buffers: the block summed, the next
constexpr int kFoldPad = 36;    // floats a staged (chain, row): 32 and a pad
constexpr int kFoldCtas8 = 3;   // CTAs an SM at CP = 8 (168 registers)

// Dynamic shared memory of fold_dot_mc_kernel<CP>: the word buffers (a
// column a thread), each warp's staged sums, the warps' tree sums of CP
// chains' rows, and their sums of eps.
constexpr size_t fold_dot_smem(int CP) {
  return sizeof(uint32_t) * kFoldSlots * kMaxB * kDotThreads +
         sizeof(float) * (kDotThreads / 32) *
             (32 * kFoldPad + CP * 32 + CP);
}

template <int CP>
__global__ void __launch_bounds__(kDotThreads, CP >= 8 ? kFoldCtas8 : 4)
fold_dot_mc_kernel(const uint32_t* __restrict__ words, int Nw,
                   const float* __restrict__ eps, int C,
                   const int* __restrict__ rho, int round, int nr, int J,
                   int B, float* __restrict__ partial, int nsplit) {
  constexpr int kWarps = kDotThreads / 32;
  constexpr int R = 32 / CP;   // rows a staged chunk: a lane a (chain, row)
  extern __shared__ __align__(16) uint32_t fdyn[];
  uint32_t* wbuf = fdyn;                             // [slot][row][thread]
  float* staged = reinterpret_cast<float*>(wbuf + kFoldSlots * kMaxB *
                                                      kDotThreads);
  float* wsum = staged + kWarps * 32 * kFoldPad;     // [p][warp][row]
  float* esw = wsum + CP * kWarps * 32;              // [p][warp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x * kDotThreads + tid;
  const bool live = w < Nw;
  const long long Npad = 16LL * Nw;
  const int JB1 = J * B + 1;
  const int slab = rho[round];
  const int G = gridDim.y;
  const int nj = (J - blockIdx.y + G - 1) / G;   // blocks of this CTA
  const int items = (C + CP - 1) / CP * nj;      // (chain group, block)
  float* mine = staged + warp * 32 * kFoldPad;

  // this thread's column of the B rows of item it's block
  const auto fetch = [&](int it) {
    const int j = blockIdx.y + G * (it % nj);
    const uint32_t* src = words + (long long)(j * nr + slab) * B * Nw + w;
    uint32_t* dst = wbuf + (it % kFoldSlots) * kMaxB * kDotThreads + tid;
#pragma unroll
    for (int i = 0; i < kMaxB; ++i)
      if (i < B)
        cp_async4(dst + i * kDotThreads,
                  live ? src + (long long)i * Nw : words, live);
    cp_async_commit();
  };

  float e[CP][16];
  int c0 = -CP;
  const uint32_t magic = kDecodeBits[kMagicAt];
  if (items > 0) fetch(0);
#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int j = blockIdx.y + G * (it % nj);
    if (it % nj == 0) {
      // the next group of chains: its eps, and each warp's sum(eps)
      c0 += CP;
      float es[CP];
#pragma unroll
      for (int p = 0; p < CP; ++p) {
        es[p] = 0.f;
        if (live && c0 + p < C) {
          es[p] = load_eps16(
              reinterpret_cast<const float4*>(eps + (c0 + p) * Npad) + 4LL * w,
              e[p]);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) e[p][k] = 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < CP; ++p) {
        const float t = warp_sum(es[p]);
        if (lane == 0) esw[p * kWarps + warp] = t;
      }
    }
    if (it + 1 < items) fetch(it + 1);
    else cp_async_commit();   // an empty group: the wait below stays right
    cp_async_wait<1>();
    const uint32_t* wb = wbuf + (it % kFoldSlots) * kMaxB * kDotThreads + tid;
#pragma unroll 1
    for (int r0 = 0; r0 < B; r0 += R) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = r0 + i;
        float s[CP];
        dot_word<CP>(row < B ? wb[row * kDotThreads] : 0u, e, s, magic);
#pragma unroll
        for (int p = 0; p < CP; ++p) mine[(p * R + i) * kFoldPad + lane] = s[p];
      }
      __syncwarp();
      // pair (p, i) = (lane / R, lane % R): the tree of its 32 words
      const float4* x4 =
          reinterpret_cast<const float4*>(mine + lane * kFoldPad);
      float y[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = x4[q], b = x4[q + 4];
        y[4 * q] = a.x + b.x;
        y[4 * q + 1] = a.y + b.y;
        y[4 * q + 2] = a.z + b.z;
        y[4 * q + 3] = a.w + b.w;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) y[a] = y[a] + y[a + 8];
#pragma unroll
      for (int a = 0; a < 4; ++a) y[a] = y[a] + y[a + 4];
      y[0] = y[0] + y[2];
      y[1] = y[1] + y[3];
      const int p = lane / R, i = lane % R;
      wsum[(p * kWarps + warp) * 32 + r0 + i] = y[0] + y[1];
      __syncwarp();
    }
    __syncthreads();
    // output (c, l): the single-chain dot's fixed-order CTA sums
    for (int o = tid; o < CP * 32; o += kDotThreads) {
      const int p = o >> 5, l = o & 31, c = c0 + p;
      if (c >= C || l >= B) continue;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) t += wsum[(p * kWarps + q) * 32 + l];
      float* out = partial + ((long long)c * nsplit + blockIdx.x) * JB1;
      out[j * B + l] = t;
      if (j == 0 && l == 0) {
        float te = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) te += esw[p * kWarps + q];
        out[J * B] = te;
      }
    }
    __syncthreads();
  }
}

// Launch fold_dot_mc_kernel<CP>: as many CTAs as fit on the card at once,
// nsplit x G, G <= J blocks a split.
template <int CP>
cudaError_t launch_fold_dot(int C, int Nw, int nsplit, int J, cudaStream_t s,
                            const uint32_t* words, const float* eps,
                            const int* rho, int round, int nr, int B,
                            float* partial) {
  constexpr size_t smem = fold_dot_smem(CP);
  static int ctas = 0;   // resident CTAs on the card
  if (ctas == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t err = cudaFuncSetAttribute(
        fold_dot_mc_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fold_dot_mc_kernel<CP>, kDotThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    ctas = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int G = ctas / nsplit;   // blocks of a split at once: 1 to J
  const dim3 grid(nsplit, G < 1 ? 1 : G > J ? J : G);
  fold_dot_mc_kernel<CP><<<grid, kDotThreads, smem, s>>>(
      words, Nw, eps, C, rho, round, nr, J, B, partial, nsplit);
  return cudaGetLastError();
}

// The dot of a round for C chains; mean null selects the dense mode
// (words is X (Mpad, N) f32, Nw is N), x_int8 the int8 mode (words is
// (Mpad, N) int8 codes, Nw is N), pind the miss mode.
cudaError_t launch_dot_mc(int C, int Nw, int x_int8, int nsplit, int J,
                          cudaStream_t s, const uint32_t* words,
                          const float* eps, const int* rho, int round, int nr,
                          int B, float* partial, float* pind,
                          const float* mean) {
  const dim3 grid(nsplit, J);
  if (mean == nullptr || x_int8) {
    if (mean == nullptr)
      launch_row_dot<kMaxC>(grid, s, reinterpret_cast<const float*>(words),
                            Nw, eps, C, rho, round, nr, J, B, partial,
                            nsplit);
    else
      launch_row_dot<kMaxC>(grid, s, reinterpret_cast<const int8_t*>(words),
                            Nw, eps, C, rho, round, nr, J, B, partial,
                            nsplit);
    return cudaGetLastError();
  }
  if (pind == nullptr) {
    if (C == 1) return launch_fold_dot<1>(C, Nw, nsplit, J, s, words, eps,
                                          rho, round, nr, B, partial);
    if (C == 2) return launch_fold_dot<2>(C, Nw, nsplit, J, s, words, eps,
                                          rho, round, nr, B, partial);
    if (C <= 4) return launch_fold_dot<4>(C, Nw, nsplit, J, s, words, eps,
                                          rho, round, nr, B, partial);
    return launch_fold_dot<8>(C, Nw, nsplit, J, s, words, eps, rho, round,
                              nr, B, partial);
  }
#define JT_DOT(CP)                                                        \
  do {                                                                    \
    constexpr size_t smem = dot_mc_smem(CP);                              \
    const cudaError_t attr = cudaFuncSetAttribute(                        \
        dot_mc_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        (int)smem);                                                       \
    if (attr != cudaSuccess) return attr;                                 \
    dot_mc_kernel<CP><<<grid, kDotThreads, smem, s>>>(                    \
        words, Nw, eps, C, rho, round, nr, J, B, partial, pind, nsplit);  \
  } while (0)
  if (C == 1) JT_DOT(1);
  else if (C == 2) JT_DOT(2);
  else JT_DOT(4);
#undef JT_DOT
  return cudaGetLastError();
}

// solve_block on chain blockIdx.y's slice of every per-chain operand.
template <int K>
__global__ void __launch_bounds__(32) solve_mc_kernel(SolveArgs a) {
  const long long c = blockIdx.y;
  const long long JB = (long long)a.J * a.B;
  const long long nb = (long long)a.J * a.nr;
  const long long Mpad = nb * a.B;
  SolveArgs b = a;
  b.partial += c * a.nsplit * (JB + 1);
  b.beta_in += c * Mpad;
  b.labels_in += c * Mpad;
  b.beta_out += c * Mpad;
  b.labels_out += c * Mpad;
  b.p += c * Mpad;
  b.z += c * Mpad;
  b.pi += c * a.G * K;
  b.sigmaE += c;
  b.sigmaGG += c * a.G;
  b.dsc += c * JB;
  b.dms += c * a.J;
  b.vpart += c * nb * a.G * K;
  b.bpart += c * nb * a.G;
  if (b.pind != nullptr) b.pind += c * a.nsplit * JB;
  solve_block<K>(b, blockIdx.x);
}

// hs_solve_block on chain blockIdx.y's slice of every per-chain operand.
__global__ void __launch_bounds__(32) hs_solve_mc_kernel(HsSolveArgs a) {
  const long long c = blockIdx.y;
  const long long JB = (long long)a.J * a.B;
  const long long Mpad = (long long)a.J * a.nr * a.B;
  HsSolveArgs b = a;
  b.partial += c * a.nsplit * (JB + 1);
  b.beta_in += c * Mpad;
  b.beta_out += c * Mpad;
  b.z += c * Mpad;
  b.lam += c * Mpad;
  b.tau += c;
  b.c2 += c;
  b.sigmaE += c;
  b.dsc += c * JB;
  b.dms += c * a.J;
  if (b.pind != nullptr) b.pind += c * a.nsplit * JB;
  hs_solve_block(b, blockIdx.x);
}

// The apply of the 2-bit modes.  A CTA covers kMcWords words of every row:
// warps 0..3 consume, warp 4 produces.  The producer compacts the round's
// entries a tile of kMcTile at a time, in index order, into one of two
// buffers (the rows where any chain moved, every chain's d*scale and, in
// the miss mode, each row's mean - 3), then streams those rows' segments
// of the CTA's words, kMcRows rows a stage, into a ring of kMcStages
// stages in shared memory by cp.async.bulk, one mbarrier a stage (the
// words are 16-byte aligned: Nw is a multiple of 128).  Consumer thread
// (word wi, part sub) decodes its kMcLanes eps lanes of each row from
// shared memory and adds every chain's term in row order, as the
// single-chain apply does.
constexpr int kMcWords = 16;                       // words a CTA
constexpr int kMcConsumers = 128;                  // consumer threads
constexpr int kMcWarps = kMcConsumers / 32;        // consumer warps
constexpr int kMcThreads = kMcConsumers + 32;      // and the producer warp
constexpr int kMcParts = kMcConsumers / kMcWords;  // threads a word
constexpr int kMcLanes = 16 / kMcParts;            // eps lanes a thread
constexpr int kMcTile = 512;                       // entries a tile
constexpr int kMcRows = 32;                        // rows a stage: a lane each
constexpr int kMcStages = 8;                       // stages of the ring
static_assert(kMcConsumers % kMcWords == 0 && 16 % kMcParts == 0,
              "a word's 16 lanes split evenly over its threads");

// Dynamic shared memory of apply_mc_kernel: the ring, then two tiles of
// compacted entries (values of CV chains, rows, and the miss mode's
// mean - 3).
inline size_t apply_mc_smem(int CV, bool miss) {
  const size_t ring = sizeof(uint32_t) * kMcStages * kMcRows * kMcWords;
  return ring + 2 * kMcTile * (sizeof(float) * CV + sizeof(int) +
                               (miss ? sizeof(float) : 0));
}

// CB >= C chains (a power of two, so the per-chain accumulators stay in
// registers); dsc (C, J*B) and dms (C, J) as the solves write them.
// MISS: the miss mode, whose rows also add their indicator term.
template <int CB, bool MISS>
__global__ void __launch_bounds__(kMcThreads)
apply_mc_kernel(const uint32_t* __restrict__ words, int Nw,
                float* __restrict__ eps, int C,
                const unsigned char* __restrict__ row_valid,
                const int* __restrict__ rho, int round, int nr, int J, int B,
                const float* __restrict__ dsc, const float* __restrict__ dms,
                const float* __restrict__ mean) {
  constexpr int CV = CB < 4 ? 4 : CB;   // chains per staged row (float4s)
  constexpr int L = kMcLanes;
  extern __shared__ __align__(128) uint32_t dyn[];
  uint32_t* ring = dyn;
  float4* vals4 = reinterpret_cast<float4*>(dyn + kMcStages * kMcRows *
                                                      kMcWords);
  int* rows = reinterpret_cast<int*>(vals4 + 2 * kMcTile * CV / 4);
  float* mrow = reinterpret_cast<float*>(rows + 2 * kMcTile);
  __shared__ uint64_t full[kMcStages], empty[kMcStages];
  __shared__ uint64_t ready[2], freed[2];   // a tile's buffer filled / read
  __shared__ int nnz[2];
  __shared__ float dms_tot[CB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int JB = J * B;
  const int ntiles = (JB + kMcTile - 1) / kMcTile;
  const int w0 = blockIdx.x * kMcWords;
  const int nw = min(kMcWords, Nw - w0);   // words of this CTA
  if (threadIdx.x < C) {
    float t = 0.f;
    for (int q = 0; q < J; ++q) t += dms[threadIdx.x * J + q];
    dms_tot[threadIdx.x] = t;
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < kMcStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kMcWarps);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&ready[q], 1);
      mbar_init(&freed[q], kMcWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kMcWarps) {
    // ---- the producer: compact a tile, then stream its rows
    const int slab = rho[round];
    int stage = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      if (t >= 2) mbar_wait(&freed[b], ((t >> 1) - 1) & 1);
      int* rw = rows + b * kMcTile;
      float* vl = reinterpret_cast<float*>(vals4) + b * kMcTile * CV;
      int n = 0;
      for (int it = 0; it < kMcTile / 32; ++it) {
        const int e = t * kMcTile + it * 32 + lane;
        float v[CV];
        bool f = false;
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          v[c] = c < C && e < JB ? __ldg(dsc + (long long)c * JB + e) : 0.f;
          f |= v[c] != 0.f;
        }
        const unsigned mask = __ballot_sync(kFull, f);
        if (f) {
          const int at = n + __popc(mask & ((1u << lane) - 1u));
          const int row = ((e / B) * nr + slab) * B + e % B;
          rw[at] = row;
          if constexpr (MISS) mrow[b * kMcTile + at] = __ldg(mean + row) - 3.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) vl[at * CV + c] = v[c];
        }
        n += __popc(mask);
      }
      if (lane == 0) nnz[b] = n;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[b]);
      for (int r0 = 0; r0 < n; r0 += kMcRows, ++stage) {
        const int slot = stage % kMcStages;
        if (stage >= kMcStages)
          mbar_wait(&empty[slot], (stage / kMcStages - 1) & 1);
        const int nrow = min(kMcRows, n - r0);
        uint32_t* dst = ring + slot * kMcRows * kMcWords;
        if (lane == 0) mbar_arrive_expect(&full[slot], 4u * nrow * nw);
        __syncwarp();
        if (lane < nrow)
          bulk_load(dst + lane * kMcWords,
                    words + (long long)rw[r0 + lane] * Nw + w0, 4u * nw,
                    &full[slot]);
      }
    }
    return;
  }

  // ---- the consumers: thread (wi, sub) owns eps lanes 16w + L*sub ..
  const int wi = threadIdx.x % kMcWords;
  const int sub = threadIdx.x / kMcWords;
  const int w = w0 + wi;
  float acc[CB][L];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[c][k] = 0.f;
  int stage = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    mbar_wait(&ready[b], (t >> 1) & 1);
    const int n = nnz[b];
    const float4* vt = vals4 + b * kMcTile * (CV / 4);
    const float* mt = mrow + b * kMcTile;
    for (int r0 = 0; r0 < n; r0 += kMcRows, ++stage) {
      const int slot = stage % kMcStages;
      mbar_wait(&full[slot], (stage / kMcStages) & 1);
      const uint32_t* sw = ring + slot * kMcRows * kMcWords + wi;
      const int nrow = min(kMcRows, n - r0);
#pragma unroll 4
      for (int q = 0; q < nrow; ++q) {
        const uint32_t wd = sw[q * kMcWords] >> (2 * L * sub);
        float cf[L];
#pragma unroll
        for (int k = 0; k < L; ++k) cf[k] = code_f(wd, k);
#pragma unroll
        for (int h = 0; h < CV / 4; ++h) {
          const float4 v = vt[(r0 + q) * (CV / 4) + h];
          const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * h + i < CB) {
#pragma unroll
              for (int k = 0; k < L; ++k)
                acc[4 * h + i][k] = fmaf(vq[i], cf[k], acc[4 * h + i][k]);
              if constexpr (MISS)
                apply_missing<L>(vq[i] * mt[r0 + q], wd, acc[4 * h + i]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[b]);
  }
  if (wi >= nw) return;
  const long long Npad = 16LL * Nw;
  const long long n0 = 16LL * w + L * sub;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < C) {
      float* ep = eps + c * Npad;
      const float dt = dms_tot[c];
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (row_valid[n0 + k]) ep[n0 + k] = ep[n0 + k] - (acc[c][k] - dt);
    }
  }
}

template <int CB, bool MISS>
cudaError_t launch_apply_mc_cb(int C, cudaStream_t s, const uint32_t* words,
                               int Nw, float* eps,
                               const unsigned char* row_valid, const int* rho,
                               int round, int nr, int J, int B,
                               const float* dsc, const float* dms,
                               const float* mean) {
  constexpr int CV = CB < 4 ? 4 : CB;
  // the copy engine's 16-byte rule (Nw is a multiple of 128 in the port)
  if (Nw % 4 != 0 || reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = apply_mc_smem(CV, MISS);
  const cudaError_t attr = cudaFuncSetAttribute(
      apply_mc_kernel<CB, MISS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const int ctas = (Nw + kMcWords - 1) / kMcWords;
  apply_mc_kernel<CB, MISS><<<ctas, kMcThreads, smem, s>>>(
      words, Nw, eps, C, row_valid, rho, round, nr, J, B, dsc, dms, mean);
  return cudaGetLastError();
}

template <bool MISS>
cudaError_t launch_apply_mc_mode(int C, cudaStream_t s, const uint32_t* words,
                                 int Nw, float* eps,
                                 const unsigned char* row_valid,
                                 const int* rho, int round, int nr, int J,
                                 int B, const float* dsc, const float* dms,
                                 const float* mean) {
#define JT_APPLY(CB)                                                      \
  launch_apply_mc_cb<CB, MISS>(C, s, words, Nw, eps, row_valid, rho, round, \
                               nr, J, B, dsc, dms, mean)
  if (C <= 1) return JT_APPLY(1);
  if (C <= 2) return JT_APPLY(2);
  if (C <= 4) return JT_APPLY(4);
  if (C <= 8) return JT_APPLY(8);
  return JT_APPLY(16);
#undef JT_APPLY
}

// The apply of a round for C chains; mean null selects the dense mode,
// x_int8 the int8 mode (the row apply, jacobi_t_common.cuh), `miss` the
// miss mode.
cudaError_t launch_apply_mc(int C, int Nw, int x_int8, cudaStream_t s,
                            const uint32_t* words, float* eps,
                            const unsigned char* row_valid, const int* rho,
                            int round, int nr, int J, int B, const float* dsc,
                            const float* dms, const float* mean, bool miss) {
  const RowApply ap{words, Nw, eps, C, rho, round, nr, B, J * B, dsc, dms,
                    nullptr, nullptr, nullptr, nullptr};
  if (mean == nullptr) {
    launch_row_apply<float>(ap, s);
  } else if (x_int8) {
    launch_row_apply<int8_t>(ap, s);
  } else {
    return miss ? launch_apply_mc_mode<true>(C, s, words, Nw, eps, row_valid,
                                             rho, round, nr, J, B, dsc, dms,
                                             mean)
                : launch_apply_mc_mode<false>(C, s, words, Nw, eps, row_valid,
                                              rho, round, nr, J, B, dsc, dms,
                                              mean);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The smallest round (J*B entries) whose row apply takes the ring, and
// not the direct path (jacobi_t_common.cuh:launch_row_apply; rows < 0:
// unchanged); returns the previous value.  Both paths give the same bits.
int jacobi_t_mc_row_apply_ring_rows(int rows) { return set_ring_rows(rows); }

int jacobi_t_mc_max_chains() { return kMaxC; }

const char* jacobi_t_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One fused BayesR sweep of C chains: dot_mc, solve_mc and apply_mc per
// round, all on `stream`, for the n_rounds rounds rho[0..n_rounds) of a
// sweep of nr (n_rounds < nr: one chunk, as jacobi_t_sweep's).  Per-chain
// operands are stacked along a leading chain axis: eps (C, Npad),
// beta/labels/p/z (C, Mpad), pi (C, G, K), sigmaE (C,), sigmaGG (C, G);
// scratch partial (C, nsplit, J*B + 1), dsc (C, J*B), dms (C, J), vpart (C, nb, G, K),
// bpart (C, nb, G); mean and scale null select the dense mode (`words`
// X (Mpad, N) f32, Nw = N, eps (C, N), row_valid and pind null, nsplit
// jacobi_t_dense_dot_splits(N)); x_int8 the int8 mode (`words` (Mpad, N)
// int8 codes, Nw = N, eps (C, N), mean and scale given, row_valid and pind
// null, nsplit jacobi_t_int8_dot_splits(N)); otherwise pind (C, nsplit,
// J*B) selects the miss mode, null the fold mode.  Returns the first launch error or
// 0.
int jacobi_t_mc_sweep(int C, const void* words, int Nw, int x_int8, int nr,
                      int n_rounds,
                      int J, int B, int K, int G, const void* gram,
                      const void* xsq, const void* mean, const void* scale,
                      void* eps,
                      const void* row_valid, const void* beta_in,
                      const void* labels_in, void* beta_out, void* labels_out,
                      const void* rho, const void* inner, const void* p,
                      const void* z, const void* pi, const void* cva,
                      const void* sigmaE, const void* sigmaGG,
                      const void* gas, const void* valid, void* partial,
                      int nsplit, void* dsc, void* dms, void* vpart,
                      void* bpart, void* pind, void* stream) {
  if (C < 1 || C > kMaxC || n_rounds < 1 || n_rounds > nr)
    return cudaErrorInvalidValue;
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
               static_cast<float*>(vpart), static_cast<float*>(bpart),
               static_cast<const float*>(pind)};
  const dim3 solve_grid(J, C);
  cudaError_t err;
  for (int r = 0; r < n_rounds; ++r) {
    err = launch_dot_mc(C, Nw, x_int8, nsplit, J, s, wd,
                        static_cast<const float*>(eps), rh, r, nr, B,
                        static_cast<float*>(partial),
                        static_cast<float*>(pind),
                        static_cast<const float*>(mean));
    if (err != cudaSuccess) return err;
    sa.round = r;
    switch (K) {
      case 2: solve_mc_kernel<2><<<solve_grid, 32, 0, s>>>(sa); break;
      case 3: solve_mc_kernel<3><<<solve_grid, 32, 0, s>>>(sa); break;
      case 4: solve_mc_kernel<4><<<solve_grid, 32, 0, s>>>(sa); break;
      case 5: solve_mc_kernel<5><<<solve_grid, 32, 0, s>>>(sa); break;
      case 6: solve_mc_kernel<6><<<solve_grid, 32, 0, s>>>(sa); break;
      case 7: solve_mc_kernel<7><<<solve_grid, 32, 0, s>>>(sa); break;
      case 8: solve_mc_kernel<8><<<solve_grid, 32, 0, s>>>(sa); break;
      default: return cudaErrorInvalidValue;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_apply_mc(C, Nw, x_int8, s, wd, static_cast<float*>(eps),
                          static_cast<const unsigned char*>(row_valid), rh, r,
                          nr, J, B, static_cast<const float*>(dsc),
                          static_cast<const float*>(dms),
                          static_cast<const float*>(mean), pind != nullptr);
    if (err != cudaSuccess) return err;
  }
  return 0;
}

// One fused horseshoe sweep of C chains: dot_mc, hs_solve_mc and apply_mc
// per round.  eps (C, Npad), beta/z/lam (C, Mpad), tau/c2/sigmaE (C,);
// scratch, the dense mode, x_int8 and pind as jacobi_t_mc_sweep's.  Returns the
// first launch error or 0.
int jacobi_t_hs_mc_sweep(int C, const void* words, int Nw, int x_int8,
                         int nr, int J,
                         int B, const void* gram, const void* xsq,
                         const void* mean, const void* scale, void* eps,
                         const void* row_valid, const void* beta_in,
                         void* beta_out, const void* rho, const void* inner,
                         const void* z, const void* lam, const void* tau,
                         const void* c2, const void* sigmaE,
                         const void* valid, void* partial, int nsplit,
                         void* dsc, void* dms, void* pind, void* stream) {
  if (C < 1 || C > kMaxC) return cudaErrorInvalidValue;
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
                 static_cast<float*>(dsc), static_cast<float*>(dms),
                 static_cast<const float*>(pind)};
  const dim3 solve_grid(J, C);
  cudaError_t err;
  for (int r = 0; r < nr; ++r) {
    err = launch_dot_mc(C, Nw, x_int8, nsplit, J, s, wd,
                        static_cast<const float*>(eps), rh, r, nr, B,
                        static_cast<float*>(partial),
                        static_cast<float*>(pind),
                        static_cast<const float*>(mean));
    if (err != cudaSuccess) return err;
    sa.round = r;
    hs_solve_mc_kernel<<<solve_grid, 32, 0, s>>>(sa);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_apply_mc(C, Nw, x_int8, s, wd, static_cast<float*>(eps),
                          static_cast<const unsigned char*>(row_valid), rh, r,
                          nr, J, B, static_cast<const float*>(dsc),
                          static_cast<const float*>(dms),
                          static_cast<const float*>(mean), pind != nullptr);
    if (err != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
