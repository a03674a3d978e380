// The exact sequential (J=1) BayesR and horseshoe sweeps and the row-layout
// block-Jacobi sweeps (J > 1 blocks a round), on 2-bit packed genotypes or
// dense f32 rows, for one chain or C <= 16 fused chains (J=1), written for
// Hopper (sm_90a).  One entry point serves them all: a single-chain sweep
// is the fused sweep with C=1 and p/z read by sweep position, so chain c
// of a fused sweep equals the single-chain sweep on chain c's operands
// bitwise; a row sweep is the single-chain serial sweep with J blocks of
// the flat order per round, every block of a round against the
// round-start eps, and J=1 is the serial sweep itself.
//
// Replaces the TPU Pallas kernels, in their 2-bit, int8 and dense f32
// modes,
//   bayesrrcpp_tpu/ops/pallas_sweep.py:_sweep_kernel / _sweep_kernel_qf /
//     _sweep_kernel_q (wrapper bayesr_sweep_pallas, pallas_call at :431),
//   bayesrrcpp_tpu/ops/pallas_sweep.py:_hs_kernel / _hs_kernel_qf /
//     _hs_kernel_q (horseshoe_sweep_pallas, :824),
//   bayesrrcpp_tpu/ops/pallas_multichain.py:_mc_kernel
//     (bayesr_sweep_pallas_mc, :359) and _hs_mc_kernel
//     (horseshoe_sweep_pallas_mc, :736),
//   bayesrrcpp_tpu/ops/pallas_jacobi.py:_jacobi_kernel / _jacobi_kernel_f
//     (bayesr_jacobi_pallas, :1299) and _hs_jacobi_kernel /
//     _hs_jacobi_kernel_f (horseshoe_jacobi_pallas, :1153), the row layout,
//   bayesrrcpp_tpu/ops/pallas_jacobi.py:_round_solve_kernel
//     (bayesr_round_solve_pallas, :704) and _hs_round_solve_kernel
//     (horseshoe_round_solve_pallas, :833): the row sweep's solve launch
//     alone, on r given (serial_round_solve).
// Python wrappers and plain versions: bayesrrcpp_tpu_torch/ops/serial.py,
// ops/multichain.py and ops/jacobi.py.
//
// Five storage modes (`mode`).  The fold mode (kFold; words with no
// missing call, _qf and _jacobi_kernel_f) dots the raw codes and
// standardizes afterwards, as below.  The in-kernel decode mode (kDecode;
// _q, one chain, J=1: the words hold missing calls, code 3) decodes every
// code to x = (c - mean)*scale, 0 for code 3 and for lanes >= N, before
// the dot and the apply (pallas_sweep.py:_decode_tile, :84-95), so r =
// x.eps and eps -= d.x need no sum(eps) and no d.(m*s).  The dense mode
// (kDense; X (Mpad, N) f32, eps (C, N)) has that algebra on plain f32
// rows: the row-major dot and apply of jacobi_t_common.cuh
// (dense_dot_tile, row_apply_kernel) around the same solve, which reads r
// unfolded.  It is bound by the dependency chain as the packed modes are;
// its bytes, one read of X (3.22 GB at N=16,384 x M=49,152), would take
// 0.96 ms.  int8 codes (X (Mpad, N) int8, pad markers code 3 with mean =
// scale = 0) run the same row-major launches in two modes: the int8 fold
// (kInt8; codes with no missing call, _qf and _jacobi_kernel_f's int8
// operand, pallas_sweep.py:486-493, pallas_multichain.py:412-413,
// pallas_jacobi.py:299-305), each byte decoded exactly (code8_f) and
// folded as the words are, with sum(eps) tracked; and the int8 in-kernel
// decode (kInt8Decode; _q on codes with missing calls, one chain, J=1),
// x = (c - mean)*scale and 0 for code 3, as kDecode.  Their bytes, one byte
// a genotype (50.56 GB at the headline), would take 15.09 ms.
//
// A sweep visits the blocks in `border` order, J at a time: round r holds
// the blocks at sweep positions r*J .. r*J + J-1 (J=1: one block), in
// three launches per round (no host sync inside the sweep):
//
//   dot    r[c, j, l] = code row l of block j . eps_c for the J*B markers
//          of the round and every chain, in the code domain; the words are
//          read once for all chains (jacobi_t_common.cuh:dot_rows, CP
//          chains per decode) in CTAs of 128 words x 32 rows of one block,
//          partial sums to (C, nsplit, J*B + 1), the extra column sum(eps)
//          (the int8 in-kernel decode: 4 rows a CTA, serial_q8_dot_kernel).
//          The CTAs also prefetch the round's Gram matrices into L2 for
//          the solve.
//   solve  one CTA of 256 threads per (chain, block).  All threads turn
//          the partials into r = s*(C.eps) - (m*s)*sum(eps) in shared
//          memory and stage the block's per-marker tables.  Warp 1 streams
//          the block's Gram rows in visit order into a ring of stages in
//          shared memory (cp.async.bulk, an mbarrier pair a stage; plain
//          loads where B % 4 != 0), and warp 0 runs the B dependent Gibbs
//          steps.  BayesR as windows: its lanes draw the next W steps (W <=
//          32) on the current r at once, a ballot finds the first that
//          moves (d != 0; most BayesR steps after burn-in move nothing, and
//          r - G*0 is r), every step up to it is committed, and the
//          mover's Gram row, read from the ring, updates r: warps 2-7 write
//          the update as the next of three versions of r in shared memory,
//          off warp 0's path.  The horseshoe moves on every valid step: one
//          step at a time, r in registers, the next row read from the ring
//          one step ahead.
//          Then all threads write beta, labels, d*scale and the block's
//          fixed-order sums: d.xsum, d.(m*s), and its v / bacc partials.
//          Alone, on r given, this launch is the round solve.
//   apply  eps_c -= (sum_m d*s[c, m] x_m - sum_j d.(m*s)) over the round's
//          rows where any chain moved, compacted in (block, index) order in
//          shared memory; a warp reads 32 consecutive words of a row.  CTA
//          0 also carries sum(eps) to the next round: sum(eps) - sum over
//          the blocks, in j order, of d.xsum.
//
// What bounds it on an H100: the dependency chain.  Round r+1's dot needs
// round r's apply, and a block's solve is B dependent steps, each a K-way
// categorical draw (K*K expf) and a rank-1 update: 503,808 dependent steps
// per headline serial sweep on one warp per chain; the row sweep runs J
// blocks' steps side by side on J SMs, 15,744 dependent steps per
// headline sweep at J=32, B=128.  The bytes (one read of the words, 12.6
// GB at N=100,352 x M=503,808) would take 3.8 ms.  One step at a time, a
// step cost 0.70-0.73 us (BayesR) and 0.35-0.51 us (horseshoe) on the card
// (PERF.md section 5): a single warp's latency, the draw's arithmetic
// setting the pace (loading the Gram rows further ahead did not shorten
// it).  So the design takes steps off the dependent path: a window draws
// W steps in one draw's time and commits all of them up to the first
// mover, so a BayesR block costs (moving steps) + (still steps)/W
// windows; the Gram rows wait in the ring, so no step waits on memory;
// and what a window or step needs besides its draw (the rank-1 update,
// the ring's bookkeeping, the next operands) is kept off the chain from
// one draw to the next.  The window's draws are the one-step loop's draws
// on the same r (d == 0 leaves r bitwise as it was), so the bits are the
// same.
//
// Semantics kept from the TPU kernels (pallas_sweep.py:97-301,
// pallas_jacobi.py:267-478):
// - position s of the block at sweep position i visits marker
//   inner[border[i], s]; single-chain p/z are read by sweep position
//   i*B + s, fused p/z by marker (pallas_multichain.py:38-41);
// - sum(eps) is recomputed from eps at each chunk start and tracked
//   analytically inside a chunk (:289-290, :573); the serial chunks are
//   those of the JAX wrapper, remainder first (:593-597); a row sweep is
//   one chunk: sum(eps) read at its start and tracked over all its rounds
//   (pallas_jacobi.py:1273, :428-433);
// - the per-marker tables (log-prior, 1/denom, slab sd; the horseshoe's
//   1/denom and sd) are built by the wrapper in plain torch, in the op order
//   of pallas_multichain.py:build_pkg / build_pkg_hs;
// - per step jacobi_t_common.cuh:categorical_draw, the strided solves'
//   draw (the 700 overflow guard on the slab logLs, first k with p <=
//   cumulative weight wins, no hit keeps beta and the label), d =
//   valid*(new - old); the horseshoe draws num*invd + sd*z;
// - v and bacc are kept per block position, summed by the wrapper in
//   sweep order;
// - lanes n >= N are never written, so eps stays 0 there.

#include <algorithm>

#include "jacobi_t_common.cuh"

namespace {

constexpr int kSerialMaxB = 1024;    // markers per block (shared memory)
constexpr int kRowMaxB = 512;        // the same with J > 1 blocks a round
constexpr int kSerialMaxC = 16;      // chains per fused sweep
constexpr int kSolveThreads = 256;
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kSerialTile = 512;     // apply entries per compaction tile
constexpr int kSerialApplyWords = 32;                    // one per lane
constexpr int kSerialSub = kApplyThreads / kSerialApplyWords;   // warps
constexpr int kSerialLanes = 16 / kSerialSub;            // eps lanes/thread
constexpr int kSerialTilePerLane = kSerialTile / kApplyThreads;

// `mode`: the 2-bit fold and in-kernel decode, dense f32 rows, and int8
// codes in the fold and in-kernel decode modes
enum Storage { kFold = 0, kDecode = 1, kDense = 2, kInt8 = 3,
               kInt8Decode = 4 };

// ------------------------------------------------------------------ dot

// The in-kernel decode's dot of one word column: acc[i] = x_i . e over the
// 16 individuals of the word, x = (c - m[i])*s[i] and 0 for code 3
// (pallas_sweep.py:_decode_tile); e is plain eps, 0 on lanes >= N.
__device__ __forceinline__ void decode_dot_rows(const uint32_t (&wds)[kMaxB],
                                                const float (&e)[16],
                                                const float (&m)[kMaxB],
                                                const float (&sc)[kMaxB],
                                                float (&acc)[kMaxB]) {
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float c = code_f(wds[i], k);
      const float x = c == 3.f ? 0.f : (c - m[i]) * sc[i];
      a = fmaf(x, e[k], a);
    }
    acc[i] = a;
  }
}

// The dot CTA's place in a round: grid.y runs over (block j, row group
// grp) of 32 rows; r of the round goes to the partial columns j*B + l.
struct DotTile {
  int j, grp, ngrp, nrow;
  long long blk;       // the block at sweep position q0 + j
  long long row0;      // first row of the tile in X / the words
};

__device__ __forceinline__ DotTile dot_tile(const int* border, int q0,
                                            int B) {
  DotTile t;
  t.ngrp = (B + kMaxB - 1) / kMaxB;
  t.j = blockIdx.y / t.ngrp;
  t.grp = blockIdx.y - t.j * t.ngrp;
  t.nrow = min(kMaxB, B - t.grp * kMaxB);
  t.blk = border[q0 + t.j];
  t.row0 = t.blk * B + t.grp * kMaxB;
  return t;
}

// Warm the L2 with the Gram block of the tile's block, which the solve
// reads next, spread over the threads of the dot's CTAs of that block.
__device__ __forceinline__ void prefetch_gram(const float* gram,
                                              const DotTile& t, int B) {
  const float* gb = gram + t.blk * B * B;
  const long long lines = ((long long)B * B + 31) / 32;
  const long long nthr = (long long)gridDim.x * t.ngrp * kDotThreads;
  for (long long ln = ((long long)t.grp * gridDim.x + blockIdx.x) *
                          kDotThreads + threadIdx.x;
       ln < lines; ln += nthr)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(gb + ln * 32));
}

// The row-major modes' dot: CTA (tile, (j, grp)) takes rows grp*32 .. of
// the block at sweep position q0 + j for all C chains (jacobi_t_common.cuh:
// dense_dot_tile), into (C, nsplit, J*B + 1) partials: dense f32 rows
// (no sum(eps) column) or int8 codes in the fold mode (CTAs of blockIdx.y
// 0 write sum(eps)).
template <bool V, typename T>
__global__ void __launch_bounds__(kDotThreads)
serial_dense_dot_kernel(const T* __restrict__ X, int N,
                        const float* __restrict__ eps, int C,
                        const int* __restrict__ border, int q0, int J, int B,
                        const float* __restrict__ gram,
                        float* __restrict__ partial, int nsplit) {
  __shared__ float red[kSerialMaxC][kDotThreads / 32][32];
  const DotTile tl = dot_tile(border, q0, B);
  prefetch_gram(gram, tl, B);
  const int col0 = tl.j * B + tl.grp * kMaxB;
  if constexpr (sizeof(T) == 1) {
    __shared__ float red_e[kSerialMaxC][kDotThreads / 32];
    int8_dot_tile<V>(X, N, tl.row0, tl.nrow, eps, C, red, red_e);
    dense_dot_store(red, blockIdx.y == 0 ? red_e : nullptr, C, partial,
                    nsplit, J * B + 1, col0, tl.nrow);
  } else {
    dense_dot_tile<V>(X, N, tl.row0, tl.nrow, eps, C, red);
    dense_dot_store(red, nullptr, C, partial, nsplit, J * B + 1, col0,
                    tl.nrow);
  }
}

// Launch serial_dense_dot_kernel with vector loads where rows_v4 allows.
template <typename T>
void launch_serial_row_dot(dim3 grid, cudaStream_t s, const T* X, int N,
                           const float* eps, int C, const int* border, int q0,
                           int J, int B, const float* gram, float* partial,
                           int nsplit) {
  if (rows_v4(X, eps, N))
    serial_dense_dot_kernel<true, T><<<grid, kDotThreads, 0, s>>>(
        X, N, eps, C, border, q0, J, B, gram, partial, nsplit);
  else
    serial_dense_dot_kernel<false, T><<<grid, kDotThreads, 0, s>>>(
        X, N, eps, C, border, q0, J, B, gram, partial, nsplit);
}

// ---- the int8 in-kernel decode's dot (serial_q8_dot_kernel: J=1, one chain,
// codes with missing calls).  CTA (split, g) takes the kQ8Rows rows g*kQ8Rows
// .. of the block over split blockIdx.x's kInt8Tile columns (128 threads x 16
// codes, the fold mode's mapping), so a block's rows spread over the SMs: 392
// CTAs of 128 threads at the headline (B=32, N=100,352).  A thread issues the
// loads of its 16 codes of every row of the CTA, of their rows' means and
// scales and of its eps first, all together, and only then decodes each code
// op for op as the TPU's _decode_tile does, x = code8_f, then x == 3 ? 0 : (x
// - mean)*scale, and sums a row's 16 products by fmaf in column order from
// +0.  The warp's 32 sums of a row are staged in shared memory and added in
// warp_transpose_sum's tree (staged_tree), then warps 0..3 from 0: each row's
// partial has the bits of a dot that holds all 32 rows of a split in a
// thread, since a row's sum reads no other row.  Bound: the block's codes and
// eps, 3.6 MB at the headline (1.08 us at 3.35 TB/s); the decode (7
// instructions a code) needs ~0.7 us of the card's issue.  Rows a CTA against
// us a block on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 1 row
// 4.35, 2 rows 4.00, 4 rows 4.00-4.03, 8 rows 4.51, 16 rows 6.34, 32 rows (49
// CTAs, a warp a scheduler, the rows' means and scales loaded one after
// another) 12.62.
constexpr int kQ8Rows = 4;   // rows of a block a CTA

template <bool V>
__global__ void __launch_bounds__(kDotThreads)
serial_q8_dot_kernel(const int8_t* __restrict__ X, int N,
                     const float* __restrict__ eps,
                     const int* __restrict__ border, int q0, int B,
                     const float* __restrict__ gram,
                     float* __restrict__ partial,
                     const float* __restrict__ mean,
                     const float* __restrict__ scale) {
  constexpr int R = kQ8Rows, kWarps = kDotThreads / 32;
  __shared__ __align__(16) float staged[kWarps][R][kStagePad];
  __shared__ float wsum[kWarps][R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  DotTile tl;
  tl.j = 0;
  tl.grp = blockIdx.y;
  tl.ngrp = gridDim.y;
  tl.nrow = min(R, B - tl.grp * R);
  tl.blk = border[q0];
  tl.row0 = tl.blk * B + tl.grp * R;
  prefetch_gram(gram, tl, B);
  const long long n0 = (long long)blockIdx.x * kInt8Tile;
  uint4 w[R];
  float m[R], sc[R], e[kInt8Cols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = i < tl.nrow;
    w[i] = in ? load_codes16<V>(X + (tl.row0 + i) * N, n0, N)
              : make_uint4(0u, 0u, 0u, 0u);
    m[i] = in ? __ldg(mean + tl.row0 + i) : 0.f;
    sc[i] = in ? __ldg(scale + tl.row0 + i) : 0.f;
  }
  load_eps_int8<V>(eps, n0, N, e);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t wq[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float x = code8_f(wq[q], k);
        x = x == 3.f ? 0.f : (x - m[i]) * sc[i];
        s = fmaf(x, e[4 * q + k], s);
      }
    }
    staged[warp][i][lane] = s;
  }
  __syncwarp();
  if (lane < R) wsum[warp][lane] = staged_tree(&staged[warp][lane][0]);
  __syncthreads();
  if (threadIdx.x < tl.nrow) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += wsum[q][threadIdx.x];
    partial[(long long)blockIdx.x * (B + 1) + tl.grp * R + threadIdx.x] = t;
  }
}

// CP chains per decode; Q: the in-kernel decode mode (CP == 1), which
// reads mean, scale and row_valid and writes no sum(eps) column.
template <int CP, bool Q>
__global__ void __launch_bounds__(kDotThreads)
serial_dot_kernel(const uint32_t* __restrict__ words, int Nw,
                  const float* __restrict__ eps, int C,
                  const int* __restrict__ border, int q0, int J, int B,
                  const float* __restrict__ gram,
                  float* __restrict__ partial, int nsplit,
                  const float* __restrict__ mean,
                  const float* __restrict__ scale,
                  const unsigned char* __restrict__ row_valid) {
  static_assert(!Q || CP == 1, "the in-kernel decode runs one chain");
  const DotTile tl = dot_tile(border, q0, B);
  const int nrow = tl.nrow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kDotThreads + threadIdx.x;
  const int JB = J * B, B1 = JB + 1;
  const long long Npad = 16LL * Nw;
  __shared__ float red[kSerialMaxC][kDotThreads / 32][32];
  __shared__ float red_e[kSerialMaxC][kDotThreads / 32];
  prefetch_gram(gram, tl, B);

  uint32_t wds[kMaxB];
  if (w < Nw) {
    load_words(words + tl.row0 * Nw + w, Nw, nrow, wds);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) wds[i] = 0u;
  }
  float xm[Q ? kMaxB : 1], xs[Q ? kMaxB : 1];
  if constexpr (Q) {
    const long long r0 = tl.row0;
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      xm[i] = i < nrow ? __ldg(mean + r0 + i) : 0.f;
      xs[i] = i < nrow ? __ldg(scale + r0 + i) : 0.f;
    }
  }
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += CP) {
    // the decode is the same for every pass: keep the compiler from
    // hoisting all 32*16 decoded codes out of this loop (they spill)
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
      if constexpr (Q) {
        const float4* e4 = reinterpret_cast<const float4*>(eps) + 4LL * w;
        const uchar4* v4 = reinterpret_cast<const uchar4*>(row_valid) + 4LL * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t = e4[q];
          const uchar4 v = v4[q];
          e[0][4 * q] = v.x ? t.x : 0.f;
          e[0][4 * q + 1] = v.y ? t.y : 0.f;
          e[0][4 * q + 2] = v.z ? t.z : 0.f;
          e[0][4 * q + 3] = v.w ? t.w : 0.f;
        }
        decode_dot_rows(wds, e[0], xm, xs, acc[0]);
      } else {
#pragma unroll
        for (int p = 0; p < CP; ++p) {
          if (c0 + p < C) {
            esum[p] = load_eps16(
                reinterpret_cast<const float4*>(eps + (c0 + p) * Npad) +
                    4LL * w,
                e[p]);
          } else {
#pragma unroll
            for (int k = 0; k < 16; ++k) e[p][k] = 0.f;
          }
        }
        dot_rows<CP>(wds, e, acc);
      }
    }
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const float r = warp_transpose_sum(acc[p], lane);
      const float es = warp_sum(esum[p]);
      if (c0 + p < C) {
        red[c0 + p][warp][lane] = r;
        if (lane == 0) red_e[c0 + p][warp] = es;
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < C * 32; o += kDotThreads) {
    const int c = o >> 5, l = o & 31;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDotThreads / 32; ++q) t += red[c][q][l];
    float* out = partial + ((long long)c * nsplit + blockIdx.x) * B1;
    if (l < nrow) out[tl.j * B + tl.grp * kMaxB + l] = t;
    if (blockIdx.y == 0 && l == 0) {
      float te = 0.f;
#pragma unroll
      for (int q = 0; q < kDotThreads / 32; ++q) te += red_e[c][q];
      out[JB] = te;
    }
  }
}

// ---------------------------------------------------------------- solve

struct SerialSolveArgs {
  const float* partial; int nsplit;           // (C, nsplit, J*B + 1)
  const int* border; const int* inner; int round; int J; int B; int G;
  int Mpad; int chunk_start;
  const float* tbl;                           // (C, Mpad, F)
  const float* gram;                          // (nb, B, B)
  const float* xsq; const float* mean; const float* scale;
  const float* xsum; const unsigned char* valid; const int* gas;
  float* beta; int* labels;                   // (C, Mpad), in place
  const float* p; const float* z;             // see pz_by_marker
  int pz_by_marker; long long pz_chain;       // chain stride of p/z
  const float* sigmaE;                        // (C,)
  float* esum; float* dsc;                    // (C,), (C, J*B)
  float* dms; float* espart;                  // (C, J) each
  float* vpart; float* bpart; int n_pos;      // (C, n, G, K), (C, n, G)
  int fold;     // 0 (the decodes, kDense): r = x.eps, d unscaled, no sums
  // the Gram ring (plan_ring): rows a stage, stages, the window, whether
  // the copy engine fills it, and the byte offsets in dynamic shared
  // memory of its stages' barriers and of the ring
  int ring_rows, ring_stages, window, bulk;
  int bar_off, ring_off;
};

// The block's staged operands in dynamic shared memory: B*(11 + F) words,
// then two barriers for each stage of the Gram ring, then the ring.
// r is kept in three versions (v: after the block's first v movers, in
// rv[v % 3]); rv[0] is r.
struct SolveSmem {
  float *r, *dlt, *xs, *bo, *ok, *ps, *zs, *tb;
  int *inn, *krec;
  float* rv[3];
};

__device__ __forceinline__ SolveSmem carve(float* sm, int B, int F) {
  SolveSmem s;
  s.r = sm; s.dlt = sm + B; s.xs = sm + 2 * B; s.bo = sm + 3 * B;
  s.ok = sm + 4 * B; s.ps = sm + 5 * B; s.zs = sm + 6 * B; s.tb = sm + 7 * B;
  s.inn = reinterpret_cast<int*>(sm + (7 + F) * B);
  s.krec = s.inn + B;
  s.rv[0] = s.r;
  s.rv[1] = sm + (9 + F) * B;
  s.rv[2] = sm + (10 + F) * B;
  return s;
}

// The ring's layout for blocks of B markers and F table fields: the most
// steps a window (W <= 32) that the shared memory left beside the
// operands allows, with rows a stage and stages powers of two.  The
// stages of a window, positions s0 .. s0 + W-1, must all fit in the ring
// with s0's stage and the stage before it (held while an update reads its
// row), so W <= (stages - 2)*rows + 1 (any W once the whole block fits).
struct RingPlan {
  int rows, stages, window, bar_off, ring_off;
  size_t smem;                       // dynamic shared memory of the CTA
};

constexpr int kRingStages = 8;       // most stages of the ring
constexpr int kRingRows = 8;         // most Gram rows a stage
constexpr int kWindow = 32;          // most steps a window: one a lane
constexpr int kSmemMax = 232448;     // shared memory a CTA may have
constexpr int kSmemStatic = 1024;    // kept for the static shared memory

inline RingPlan plan_ring(int B, int F) {
  RingPlan p{0, 0, 0, 0, 0, 0};
  const size_t ops = sizeof(float) * (size_t)B * (11 + F);
  const size_t row = sizeof(float) * (size_t)B;
  p.bar_off = (int)((ops + 7) / 8 * 8);
  for (int R = kRingRows; R >= 1; R /= 2) {
    const int nst = (B + R - 1) / R;
    const int off = (int)((p.bar_off + 16 * nst + 127) / 128 * 128);
    const long long fit =
        ((long long)kSmemMax - kSmemStatic - off) / (long long)row;
    int ns = (int)std::min<long long>(
        std::min<long long>(kRingStages, fit / R), nst);
    if (ns < 1) continue;
    while (ns & (ns - 1)) ns &= ns - 1;          // a power of two
    const int w = ns == nst ? kWindow : std::min(kWindow, (ns - 2) * R + 1);
    if (w < 1) continue;
    if (w > p.window) {
      p.rows = R;
      p.stages = ns;
      p.window = w;
      p.ring_off = off;
    }
  }
  p.smem = p.ring_off + (size_t)p.stages * p.rows * row;
  return p;
}

// Sum over the CTA in a fixed order (lanes, then warps 0..7); every
// thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();                    // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < kSolveWarps; ++q) t += red[q];
  return t;
}

// One step's operands: the visited marker's table row and state, and the
// position's variates.  K == 0 is the horseshoe (table: invd, sd).
template <int K>
struct StepOps {
  static constexpr int F = K == 0 ? 2 : 3 * K;
  float tb[F];
  float xs, bo, ok, p, z;
};

template <int K>
__device__ __forceinline__ void load_step(const SolveSmem& s, int t, int jl,
                                          StepOps<K>& q) {
  const float* row = s.tb + jl * StepOps<K>::F;
#pragma unroll
  for (int f = 0; f < StepOps<K>::F; ++f) q.tb[f] = row[f];
  q.xs = s.xs[jl];
  q.bo = s.bo[jl];
  q.ok = s.ok[jl];
  q.p = s.ps[t];
  q.z = s.zs[t];
}

// The Gibbs draw of one step: (d, krec).  BayesR: categorical_draw on the
// table row [lp, invd, sd]; horseshoe (K == 0): beta_new = num*invd + sd*z.
template <int K>
__device__ __forceinline__ float draw(const StepOps<K>& q, float num,
                                      float half_invsE, int& krec) {
  if constexpr (K == 0) {
    const float beta_new = num * q.tb[0] + q.tb[1] * q.z;
    krec = -1;
    return q.ok * (beta_new - q.bo);
  } else {
    return categorical_draw<K>(q.tb, q.tb + K, q.tb + 2 * K, num,
                               half_invsE, q.p, q.z, q.bo, q.ok, krec);
  }
}

// The block's Gram rows in visit order (row inner[t] at position t),
// streamed through a ring of `stages` stages of `rows` rows in shared
// memory (both powers of two): stage k holds positions k*rows .. and lives
// in slot k % stages.  Stage k has its own two barriers, full[k] (its
// copies have landed) and empty[k] (the stepping warp has let it go), each
// with one phase a block, so no wait can mistake another stage's phase for
// its own.  `bulk`: the copy engine fills a stage (B % 4 == 0 and the Gram
// 16-byte aligned); else the filling warp loads and stores the rows
// itself.
struct GramRing {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int rows, stages, bulk;
};

// Fill stages k0 .. k1-1 (one warp); a stage past the first `stages` waits
// until the stepping warp has let the slot's last stage go and that
// stage's copies have landed.  With k1 == nst it then waits until every
// copy has landed: none may land after the block is done.
__device__ __forceinline__ void ring_fill(const GramRing& g, const int* inn,
                                          const float* gb, int B, int k0,
                                          int k1, int nst) {
  const int lane = threadIdx.x & 31;
  for (int k = k0; k < k1; ++k) {
    const int slot = k & (g.stages - 1);
    if (k >= g.stages) {
      mbar_wait(&g.empty[k - g.stages], 0);
      mbar_wait(&g.full[k - g.stages], 0);
    }
    const int t0 = k * g.rows;
    const int nr = min(g.rows, B - t0);
    float* dst = g.buf + (size_t)slot * g.rows * B;
    if (g.bulk) {
      if (lane == 0) mbar_arrive_expect(&g.full[k], 4u * nr * B);
      __syncwarp();
      if (lane < nr)
        bulk_load(dst + (size_t)lane * B, gb + (long long)inn[t0 + lane] * B,
                  4u * B, &g.full[k]);
    } else {
      for (int q = 0; q < nr; ++q) {
        const float* src = gb + (long long)inn[t0 + q] * B;
        for (int i = lane; i < B; i += 32)
          dst[(size_t)q * B + i] = __ldg(src + i);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&g.full[k]);
    }
  }
  if (k1 == nst)
    for (int k = max(0, nst - g.stages); k < nst; ++k)
      mbar_wait(&g.full[k], 0);
}

// v[i] for a warp-uniform or per-lane i < NPL, with static register
// indices.
template <int NPL>
__device__ __forceinline__ float pick(const float (&v)[NPL], int i) {
  float x = v[0];
#pragma unroll
  for (int k = 1; k < NPL; ++k) x = i == k ? v[k] : x;
  return x;
}

// The horseshoe's B dependent steps (K == 0), run by warp 0.  Every valid
// step moves, so there is nothing for a window to skip: one step at a
// time, r in registers (lane l holds entries l + 32 i), each step's Gram
// row read from the ring one step ahead.  On the dependent path: d -> the
// visited entry's update (the same r - G*d, by the lane that holds it,
// from selects made before d was known) -> a shuffle -> the draw.  Off
// it: the next step's operands and row, and the update of every other
// entry.  As the plain version does, every step applies its update (a pad
// marker's d is 0: r - G*0).  The ring's bookkeeping is done once a
// stage, so a step has no branch: the next stage is waited for at the
// start of a stage, when the last row of the stage before is in
// registers and that stage can go.
template <int NPL>
__device__ __forceinline__ void block_steps_hs(const SolveSmem& s,
                                               const GramRing& g, int B) {
  const int lane = threadIdx.x & 31;
  const int lr = __ffs(g.rows) - 1;
  const int nst = (B + g.rows - 1) >> lr;
  float r[NPL], gc[NPL], gn[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int idx = lane + 32 * i;
    r[i] = idx < B ? s.r[idx] : 0.f;
  }
  mbar_wait(&g.full[0], 0);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int idx = lane + 32 * i;
    gc[i] = idx < B ? g.buf[idx] : 0.f;
  }
  int jl = s.inn[0];
  StepOps<0> q;
  load_step<0>(s, 0, jl, q);
  float rj = __shfl_sync(kFull, pick<NPL>(r, jl >> 5), jl & 31);
  for (int k = 0; k < nst; ++k) {
    for (int f = max(0, k - 1); f < k; ++f)
      if (lane == 0) mbar_arrive(&g.empty[f]);
    if (k + 1 < nst) mbar_wait(&g.full[k + 1], 0);
    const int t1 = min(B, (k + 1) << lr);
    for (int t = k << lr; t < t1; ++t) {
      int krec;
      const float d = draw<0>(q, rj + q.bo * q.xs, 0.f, krec);
      if (lane == 0) s.dlt[jl] = d;
      const int tn = min(t + 1, B - 1);   // (past the end: read, unused)
      const float* rn =
          g.buf + ((size_t)((tn >> lr) & (g.stages - 1)) * g.rows +
                   (tn & (g.rows - 1))) * B;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int idx = lane + 32 * i;
        gn[i] = idx < B ? rn[idx] : 0.f;
      }
      const int jn = s.inn[tn];
      load_step<0>(s, tn, jn, q);
      const float sr = pick<NPL>(r, jn >> 5), sg = pick<NPL>(gc, jn >> 5);
      rj = __shfl_sync(kFull, sr - sg * d, jn & 31);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        r[i] = r[i] - gc[i] * d;
        gc[i] = gn[i];
      }
      jl = jn;
    }
  }
  if (lane == 0 && nst > 0) mbar_arrive(&g.empty[nst - 1]);
}

// Named barriers between the stepping warp (warp 0) and the updating
// warps (2 .. 7): a mover handed over (A) and its update applied (D), two
// of each, taken by the parity of the mover's number so that no barrier
// is reused before its last use has completed.
constexpr int kUpdaters = kSolveThreads - 64;
constexpr int kStepAndUpdate = kUpdaters + 32;
constexpr int kBarHanded = 1, kBarApplied = 3;

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kStepAndUpdate)
               : "memory");
}

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kStepAndUpdate) : "memory");
}

__device__ __forceinline__ int next3(int v) { return v == 2 ? 0 : v + 1; }

// A mover handed to the updating warps: its Gram row's float offset in the
// ring (-1: the block is done) and its d.
struct Handover {
  int row[2];
  float d[2];
};

// The B dependent steps of one block, run by warp 0 as windows of W steps.
// A step that moves nothing (d == 0: a marker that stays in the spike, a
// draw with no hit, a pad marker) leaves r bitwise as it was (r - G*0 is
// r), so the W lanes draw the next W steps at once, lane i step s0 + i,
// all on the current r; every step up to and including the first that
// moves (a ballot) is exactly the draw the one-step-at-a-time loop would
// make, and is committed; the mover's Gram row, already in the ring,
// updates r (r[m] - G[m]*d as the loop did), and the next window starts
// after it.  The dependent path of a block is so (moving steps) + (still
// steps)/W windows; the horseshoe moves on every valid step, one step a
// window.  Off that path: the next window's operands are loaded as soon
// as the ballot has placed it; the updating warps (block_updates) write
// each mover's update as the next version of r; and the next window's
// lanes read the newest version that is surely complete, then apply to
// their own entries, in order, the one or two movers it lacks (the same
// r - G*d).  A stage of the ring is let go once the window has passed it
// and no update still reads it; the filling warp waits for a slot's last
// copy to land before it reuses the slot.
template <int K>
__device__ __forceinline__ void block_windows(const SolveSmem& s,
                                              const GramRing& g,
                                              Handover& ho, int B, int W,
                                              float half_invsE) {
  const int lane = threadIdx.x & 31;
  const int lr = __ffs(g.rows) - 1;
  const int nst = (B + g.rows - 1) >> lr;
  int s0 = 0;
  int freed = 0, landed = 0;     // stages let go / seen to have landed
  int handed = 0, applied = 0;   // movers handed over / known applied
  int vb = 0;                    // handed % 3: the newest version's buffer
  int poff = 0;                  // the last mover handed over: its row
  float pd = 0.f;                // and d
  int stage[2] = {0, 0};         // the stages of the last two movers
  bool act = lane < W && lane < B;
  int jl = s.inn[act ? lane : 0];
  StepOps<K> q;
  load_step<K>(s, act ? lane : 0, jl, q);
  float rj = s.r[jl];
  for (;;) {
    int krec;
    const float dl = draw<K>(q, rj + q.bo * q.xs, half_invsE, krec);
    const float d = act ? dl : 0.f;
    const unsigned moved = __ballot_sync(kFull, d != 0.f);
    const int last = moved ? __ffs(moved) - 1 : 31;
    if (act && lane <= last) {
      s.dlt[jl] = d;
      s.krec[jl] = krec;
    }
    const int s1 = moved ? s0 + last + 1 : s0 + W;
    if (s1 >= B) break;            // r is not needed past the block's end
    // the version of r to read: after a moving window the one before the
    // last mover (its update may still be under way), else the newest
    const bool lag = moved && applied < handed;
    for (const int need = lag ? handed - 1 : handed; applied < need;
         ++applied)
      bar_wait(kBarApplied + (applied & 1));
    // let go of the stages wholly before s1 that no update or fix-up still
    // reads before waiting on the mover's stage, which the filling warp
    // may fill only then
    int done = s1 >> lr;
    if (applied < handed) done = min(done, stage[applied & 1]);
    if (moved) done = min(done, (s1 - 1) >> lr);
    for (; freed < done; ++freed)
      if (lane == 0) mbar_arrive(&g.empty[freed]);
    float dm = 0.f;
    int off = 0, k = 0;
    if (moved) {
      dm = __shfl_sync(kFull, d, last);
      const int tm = s1 - 1;
      k = tm >> lr;
      // (a stage let go is the filling warp's to wait for)
      for (landed = max(landed, freed); landed <= k; ++landed)
        mbar_wait(&g.full[landed], 0);
      off = ((k & (g.stages - 1)) * g.rows + (tm & (g.rows - 1))) * B;
    }
    const float* rv = s.rv[lag ? (vb == 0 ? 2 : vb - 1) : vb];
    const int t = s1 + lane;
    act = lane < W && t < B;
    const int tl = act ? t : s1;
    const int jn = s.inn[tl];
    load_step<K>(s, tl, jn, q);
    rj = rv[jn];
    if (lag) rj = rj - g.buf[poff + jn] * pd;
    if (moved) {
      rj = rj - g.buf[off + jn] * dm;
      if (lane == 0) {
        ho.row[handed & 1] = off;
        ho.d[handed & 1] = dm;
      }
      __syncwarp();
      bar_arrive(kBarHanded + (handed & 1));
      stage[handed & 1] = k;
      ++handed;
      vb = next3(vb);
      poff = off;
      pd = dm;
    }
    s0 = s1;
    jl = jn;
  }
  // the updating warps finish and stop; then the rest of the ring is let
  // go, so the filling warp can fill its last stages
  for (; applied < handed; ++applied) bar_wait(kBarApplied + (applied & 1));
  if (lane == 0) ho.row[handed & 1] = -1;
  __syncwarp();
  bar_arrive(kBarHanded + (handed & 1));
  for (; freed < nst; ++freed)
    if (lane == 0) mbar_arrive(&g.empty[freed]);
}

// The updating warps (2 .. 7): mover u's rank-1 update, in the order
// handed over, from version u of r into version u + 1, r[m] - G[m]*d as
// the one-step loop computes it.
__device__ __forceinline__ void block_updates(const SolveSmem& s,
                                              const GramRing& g,
                                              const Handover& ho, int B) {
  const int h = threadIdx.x - 64;
  int v = 0;                       // u % 3
  for (int u = 0;; ++u) {
    bar_wait(kBarHanded + (u & 1));
    const int off = ho.row[u & 1];
    if (off < 0) return;
    const float dm = ho.d[u & 1];
    const float* gr = g.buf + off;
    const float* src = s.rv[v];
    v = next3(v);
    float* dst = s.rv[v];
    for (int i = h; i < B; i += kUpdaters) dst[i] = src[i] - gr[i] * dm;
    bar_arrive(kBarApplied + (u & 1));
  }
}

// Block j of the round of one chain c, blockIdx.x = c*J + j; K == 0 is
// the horseshoe.  ROW: J > 1 blocks a round; the J=1 instance has J a
// constant, so the serial sweep's solve keeps its own code.
// (a minimum of one CTA per SM: without it ptxas kept some instances to
// 40 registers and spilled across the division's slow-path call)
template <int K, int NPL, bool ROW>
__global__ void __launch_bounds__(kSolveThreads, 1)
serial_solve_kernel(SerialSolveArgs a) {
  constexpr int F = StepOps<K>::F;
  extern __shared__ __align__(128) float smem[];
  __shared__ float red[kSolveWarps];
  __shared__ float s_esum;
  __shared__ Handover ho;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int J = ROW ? a.J : 1;
  const int B = a.B, JB = J * B, B1 = JB + 1;
  const int c = ROW ? blockIdx.x / J : blockIdx.x;
  const int j = ROW ? blockIdx.x - c * J : 0;
  const int pos = a.round * J + j;              // the block's sweep position
  const long long blk = a.border[pos];
  const long long m0 = blk * B;
  const long long cm = (long long)c * a.Mpad;
  const SolveSmem s = carve(smem, B, F);
  const float* part = a.partial + (long long)c * a.nsplit * B1;
  const int cj = c * J + j;
  char* dyn = reinterpret_cast<char*>(smem);
  const int nst = (B + a.ring_rows - 1) / a.ring_rows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dyn + a.bar_off);
  const GramRing ring{reinterpret_cast<float*>(dyn + a.ring_off), bars,
                      bars + nst, a.ring_rows, a.ring_stages, a.bulk};
  const float* gb = a.gram + blk * B * B;
  for (int q = tid; q < 2 * nst; q += kSolveThreads) mbar_init(&bars[q], 1);
  mbar_fence_init();

  // sum(eps): afresh from the dot's column at a chunk start (block 0 keeps
  // it for the apply to carry on), else tracked by the previous apply (the
  // in-kernel decode and the dense mode read none)
  if (warp == 0 && a.fold) {
    float e = 0.f;
    if (a.chunk_start) {
      for (int q = lane; q < a.nsplit; q += 32)
        e += part[(long long)q * B1 + JB];
      e = warp_sum(e);
      if (lane == 0 && j == 0) a.esum[c] = e;
    } else {
      e = a.esum[c];
    }
    if (lane == 0) s_esum = e;
  }
  for (int l = tid; l < B; l += kSolveThreads) {
    const long long m = m0 + l;
    s.xs[l] = a.xsq[m];
    s.bo[l] = a.beta[cm + m];
    s.ok[l] = a.valid[m] ? 1.f : 0.f;
    s.inn[l] = a.inner[m];
    s.dlt[l] = 0.f;
    s.krec[l] = -1;
    const float* row = a.tbl + (cm + m) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) s.tb[l * F + f] = row[f];
  }
  __syncthreads();
  // warp 1 starts the Gram ring now, while r is assembled
  if (warp == 1) ring_fill(ring, s.inn, gb, B, 0, ring.stages, -1);
  const float esum0 = s_esum;
  for (int l = tid; l < B; l += kSolveThreads) {
    float rc = 0.f;
    for (int q = 0; q < a.nsplit; ++q)
      rc += part[(long long)q * B1 + j * B + l];
    if (!a.fold) {
      s.r[l] = rc;
    } else {
      const float sc = a.scale[m0 + l];
      const float ms = a.mean[m0 + l] * sc;
      s.r[l] = rc * sc - ms * esum0;
    }
    // position l's variates: by sweep position, or by its marker
    const long long at = (long long)c * a.pz_chain +
                         (a.pz_by_marker ? m0 + s.inn[l]
                                         : (long long)pos * B + l);
    s.ps[l] = K == 0 ? 0.f : a.p[at];
    s.zs[l] = a.z[at];
  }
  __syncthreads();

  if (warp == 1) {
    ring_fill(ring, s.inn, gb, B, ring.stages, nst, nst);
  } else if constexpr (K == 0) {
    if (warp == 0) block_steps_hs<NPL>(s, ring, B);
  } else if (warp == 0) {
    block_windows<K>(s, ring, ho, B, a.window, 0.5f / a.sigmaE[c]);
  } else {
    block_updates(s, ring, ho, B);
  }
  __syncthreads();

  // the block's outputs, and its sums in a fixed order
  float es = 0.f, dm = 0.f;
  for (int l = tid; l < B; l += kSolveThreads) {
    const long long m = m0 + l;
    const float d = s.dlt[l];
    a.beta[cm + m] = s.bo[l] + d;
    if constexpr (K > 0) {
      if (s.krec[l] >= 0) a.labels[cm + m] = s.krec[l];
    }
    if (a.fold) {
      const float sc = a.scale[m];
      const float ms = a.mean[m] * sc;
      a.dsc[(long long)cj * B + l] = d * sc;
      es += d * a.xsum[m];
      dm += d * ms;
    } else {
      a.dsc[(long long)cj * B + l] = d;
    }
  }
  if (a.fold) {
    const float es_t = block_sum(es, red);
    const float dm_t = block_sum(dm, red);
    if (tid == 0) {
      a.espart[cj] = es_t;
      a.dms[cj] = dm_t;
    }
  }
  if constexpr (K > 0) {
    // v (label counts of the hits) and bacc (beta_out^2 over slab hits)
    const long long cp = (long long)c * a.n_pos + pos;
    for (int g = 0; g < a.G; ++g) {
      float cnt[K], b2 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) cnt[k] = 0.f;
      for (int l = tid; l < B; l += kSolveThreads) {
        if (a.gas[m0 + l] != g) continue;
        const int kr = s.krec[l];
#pragma unroll
        for (int k = 0; k < K; ++k) cnt[k] += kr == k ? 1.f : 0.f;
        const float bn = s.bo[l] + s.dlt[l];
        if (kr > 0) b2 += bn * bn;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = block_sum(cnt[k], red);
        if (tid == 0) a.vpart[(cp * a.G + g) * K + k] = t;
      }
      const float t = block_sum(b2, red);
      if (tid == 0) a.bpart[cp * a.G + g] = t;
    }
  }
}

// ---------------------------------------------------------------- apply

// CB >= C chains (a power of two: the per-chain accumulators stay in
// registers); the round's J blocks at sweep positions q0 .., dsc (C, J*B),
// dms and espart (C, J) as the solve writes them.  Q: the in-kernel decode
// mode (CB == 1, J == 1): each row is decoded with its mean and scale, and
// d is unscaled.  esum (C,), null outside the fold mode: CTA 0 carries it
// to the next round, esum - sum_j espart in j order.
template <int CB, bool Q>
__global__ void __launch_bounds__(kApplyThreads)
serial_apply_kernel(const uint32_t* __restrict__ words, int Nw,
                    float* __restrict__ eps, int C,
                    const unsigned char* __restrict__ row_valid,
                    const int* __restrict__ border, int q0, int J, int B,
                    const float* __restrict__ dsc,
                    const float* __restrict__ dms,
                    const float* __restrict__ mean,
                    const float* __restrict__ scale,
                    float* __restrict__ esum,
                    const float* __restrict__ espart) {
  static_assert(!Q || CB == 1, "the in-kernel decode runs one chain");
  constexpr int CV = CB < 4 ? 4 : CB;   // chains per staged row (float4s)
  constexpr int L = kSerialLanes;
  __shared__ float4 vals4[kSerialTile * CV / 4];
  __shared__ int rows[kSerialTile];
  __shared__ float rmean[Q ? kSerialTile : 1], rscale[Q ? kSerialTile : 1];
  __shared__ int warp_cnt[kApplyWarps + 1];
  __shared__ float dms_tot[CB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int JB = J * B;
  const long long Npad = 16LL * Nw;
  if (!Q && threadIdx.x < C) {
    // the round's sums over its blocks, in j order
    const int c = threadIdx.x;
    float t = dms[c * J];
    for (int q = 1; q < J; ++q) t += dms[c * J + q];
    dms_tot[c] = t;
    if (esum != nullptr && blockIdx.x == 0) {
      float e = espart[c * J];
      for (int q = 1; q < J; ++q) e += espart[c * J + q];
      esum[c] = esum[c] - e;
    }
  }
  // word w of this lane; warp `sub` owns its eps lanes 16w + L*sub .. +L-1
  const int w = blockIdx.x * kSerialApplyWords + lane;
  const int sub = warp;
  const bool live = w < Nw;
  const uint32_t* wp = words + (live ? w : 0);
  float acc[CB][L];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[c][k] = 0.f;

  for (int tile0 = 0; tile0 < JB; tile0 += kSerialTile) {
    // warp `warp` owns the tile's entries [lo, lo + 32*kSerialTilePerLane)
    const int lo = tile0 + warp * 32 * kSerialTilePerLane;
    bool nz[kSerialTilePerLane];
    int cnt = 0;
#pragma unroll
    for (int it = 0; it < kSerialTilePerLane; ++it) {
      const int e = lo + it * 32 + lane;
      bool f = false;
      if (e < JB) {
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) f |= __ldg(dsc + (long long)c * JB + e) != 0.f;
      }
      nz[it] = f;
      cnt += __popc(__ballot_sync(kFull, f));
    }
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int q = 0; q < kApplyWarps; ++q) {
        const int n = warp_cnt[q];
        warp_cnt[q] = run;
        run += n;
      }
      warp_cnt[kApplyWarps] = run;
    }
    __syncthreads();
    int at0 = warp_cnt[warp];
#pragma unroll
    for (int it = 0; it < kSerialTilePerLane; ++it) {
      const unsigned mask = __ballot_sync(kFull, nz[it]);
      if (nz[it]) {
        const int at = at0 + __popc(mask & ((1u << lane) - 1u));
        const int e = lo + it * 32 + lane;
        const int row = border[q0 + e / B] * B + e % B;
        rows[at] = row;
        if constexpr (Q) {
          rmean[at] = __ldg(mean + row);
          rscale[at] = __ldg(scale + row);
        }
        float* v = reinterpret_cast<float*>(vals4) + at * CV;
#pragma unroll
        for (int c = 0; c < CV; ++c)
          v[c] = c < C ? __ldg(dsc + (long long)c * JB + e) : 0.f;
      }
      at0 += __popc(mask);
    }
    __syncthreads();
    const int nnz = warp_cnt[kApplyWarps];
    if (live) {
#pragma unroll 8
      for (int t = 0; t < nnz; ++t) {
        const uint32_t wd =
            __ldg(wp + (long long)rows[t] * Nw) >> (2 * L * sub);
        float cf[L];
#pragma unroll
        for (int k = 0; k < L; ++k) cf[k] = code_f(wd, k);
        if constexpr (Q) {
#pragma unroll
          for (int k = 0; k < L; ++k)
            cf[k] = cf[k] == 3.f ? 0.f : (cf[k] - rmean[t]) * rscale[t];
        }
#pragma unroll
        for (int q = 0; q < CV / 4; ++q) {
          const float4 v = vals4[t * (CV / 4) + q];
          const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < CB) {
#pragma unroll
              for (int k = 0; k < L; ++k)
                acc[4 * q + i][k] = fmaf(vq[i], cf[k], acc[4 * q + i][k]);
            }
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites rows and vals
  }
  if (!live) return;
  const long long n0 = 16LL * w + L * sub;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < C) {
      float* ep = eps + c * Npad;
      const float dt = Q ? 0.f : dms_tot[c];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (!row_valid[n0 + k]) continue;
        ep[n0 + k] = Q ? ep[n0 + k] - acc[c][k]
                       : ep[n0 + k] - (acc[c][k] - dt);
      }
    }
  }
}

// --------------------------------------------------------------- launch

// One sweep's operands (ops/serial.py:_sweep_cuda); K == 0 is the
// horseshoe, whose labels, gas, p, sigmaE, vpart and bpart are null.
struct SerialSweep {
  int C, pz_by_marker, Nw, n_pos, chunk, B, K, G, Mpad, nsplit, mode, J;
  const uint32_t* words; const int* border; const int* inner;
  const float* gram; const float* tbl; const float* xsq; const float* mean;
  const float* scale; const float* xsum; const unsigned char* valid;
  const int* gas; float* eps; const unsigned char* row_valid;
  float* beta; int* labels; const float* p; const float* z;
  const float* sigmaE; float* partial; float* esum; float* dsc; float* dms;
  float* espart; float* vpart; float* bpart;
};

using SolveFn = void (*)(SerialSolveArgs);

// The horseshoe's solve keeps r in registers: NPL entries a lane, the
// power of two >= B/32 (the row layout stops at kRowMaxB = 512, 16 a
// lane).
template <bool ROW>
SolveFn pick_hs(int B) {
  int npl = 1;
  while (32 * npl < B) npl *= 2;
  switch (npl) {
    case 1: return serial_solve_kernel<0, 1, ROW>;
    case 2: return serial_solve_kernel<0, 2, ROW>;
    case 4: return serial_solve_kernel<0, 4, ROW>;
    case 8: return serial_solve_kernel<0, 8, ROW>;
    case 16: return serial_solve_kernel<0, 16, ROW>;
    case 32:
      if constexpr (ROW) return nullptr;
      else return serial_solve_kernel<0, 32, ROW>;
    default: return nullptr;
  }
}

template <bool ROW>
SolveFn pick_k(int K, int B) {
  switch (K) {
    case 0: return pick_hs<ROW>(B);
    case 2: return serial_solve_kernel<2, 1, ROW>;
    case 3: return serial_solve_kernel<3, 1, ROW>;
    case 4: return serial_solve_kernel<4, 1, ROW>;
    case 5: return serial_solve_kernel<5, 1, ROW>;
    case 6: return serial_solve_kernel<6, 1, ROW>;
    case 7: return serial_solve_kernel<7, 1, ROW>;
    case 8: return serial_solve_kernel<8, 1, ROW>;
    default: return nullptr;
  }
}

// The solve for (K, B) and J blocks a round with its dynamic shared memory
// allowed, and its Gram ring planned into `a` (the copy engine fills it
// where B % 4 == 0 and the Gram is 16-byte aligned); null if the kernel
// takes no such K or B.
SolveFn ready_solve(int K, int B, int J, SerialSolveArgs& a, size_t* smem,
                    cudaError_t* err) {
  const SolveFn solve = J > 1 ? pick_k<true>(K, B) : pick_k<false>(K, B);
  *err = cudaErrorInvalidValue;
  if (solve == nullptr) return nullptr;
  const RingPlan p = plan_ring(B, K == 0 ? 2 : 3 * K);
  if (p.window < 1) return nullptr;
  a.ring_rows = p.rows;
  a.ring_stages = p.stages;
  a.window = p.window;
  a.bar_off = p.bar_off;
  a.ring_off = p.ring_off;
  a.bulk = B % 4 == 0 && reinterpret_cast<uintptr_t>(a.gram) % 16 == 0;
  *smem = p.smem;
  *err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return *err == cudaSuccess ? solve : nullptr;
}

// The dot of round r reads the words once for every CP chains (4 at most:
// more spill); C == 1 takes the single-chain instance, the in-kernel decode
// its own.  The dense mode reads the rows once for all chains.
cudaError_t launch_dot(const SerialSweep& o, int r, cudaStream_t s) {
  const dim3 grid(o.nsplit, o.J * ((o.B + kMaxB - 1) / kMaxB));
  const int q0 = r * o.J;
  if (o.mode == kDense) {
    launch_serial_row_dot<float>(
        grid, s, reinterpret_cast<const float*>(o.words), o.Nw, o.eps, o.C,
        o.border, q0, o.J, o.B, o.gram, o.partial, o.nsplit);
    return cudaGetLastError();
  }
  if (o.mode == kInt8) {
    launch_serial_row_dot<int8_t>(
        grid, s, reinterpret_cast<const int8_t*>(o.words), o.Nw, o.eps, o.C,
        o.border, q0, o.J, o.B, o.gram, o.partial, o.nsplit);
    return cudaGetLastError();
  }
  if (o.mode == kInt8Decode) {
    // J = 1: kQ8Rows rows of the block a CTA
    const dim3 qgrid(o.nsplit, (o.B + kQ8Rows - 1) / kQ8Rows);
    const int8_t* X = reinterpret_cast<const int8_t*>(o.words);
    if (rows_v4(X, o.eps, o.Nw))
      serial_q8_dot_kernel<true><<<qgrid, kDotThreads, 0, s>>>(
          X, o.Nw, o.eps, o.border, q0, o.B, o.gram, o.partial, o.mean,
          o.scale);
    else
      serial_q8_dot_kernel<false><<<qgrid, kDotThreads, 0, s>>>(
          X, o.Nw, o.eps, o.border, q0, o.B, o.gram, o.partial, o.mean,
          o.scale);
    return cudaGetLastError();
  }
#define SERIAL_DOT(CP, Q)                                                 \
  serial_dot_kernel<CP, Q><<<grid, kDotThreads, 0, s>>>(                  \
      o.words, o.Nw, o.eps, o.C, o.border, q0, o.J, o.B, o.gram,          \
      o.partial, o.nsplit, o.mean, o.scale, o.row_valid)
  if (o.mode == kDecode) SERIAL_DOT(1, true);
  else if (o.C == 1) SERIAL_DOT(1, false);
  else if (o.C == 2) SERIAL_DOT(2, false);
  else SERIAL_DOT(4, false);
#undef SERIAL_DOT
  return cudaGetLastError();
}

cudaError_t launch_apply(const SerialSweep& o, int r, cudaStream_t s) {
  const int q0 = r * o.J;
  if (o.mode == kDense || o.mode == kInt8 || o.mode == kInt8Decode) {
    // the round's J*B rows, block j at border[q0 + j] (nr = 0: a list)
    const RowApply ap{o.words, o.Nw, o.eps, o.C, o.border, q0, 0, o.B,
                      o.J * o.B, o.dsc, o.dms, o.mean, o.scale, o.esum,
                      o.espart};
    if (o.mode == kDense) launch_row_apply<float>(ap, s);
    else if (o.mode == kInt8) launch_row_apply<int8_t>(ap, s);
    else launch_row_apply<int8_t, true>(ap, s);
    return cudaGetLastError();
  }
  const int ctas = (o.Nw + kSerialApplyWords - 1) / kSerialApplyWords;
  float* esum = o.mode == kFold ? o.esum : nullptr;
#define SERIAL_APPLY(CB, Q)                                               \
  serial_apply_kernel<CB, Q><<<ctas, kApplyThreads, 0, s>>>(              \
      o.words, o.Nw, o.eps, o.C, o.row_valid, o.border, q0, o.J, o.B,     \
      o.dsc, o.dms, o.mean, o.scale, esum, o.espart)
  if (o.mode == kDecode) SERIAL_APPLY(1, true);
  else if (o.C <= 1) SERIAL_APPLY(1, false);
  else if (o.C <= 2) SERIAL_APPLY(2, false);
  else if (o.C <= 4) SERIAL_APPLY(4, false);
  else if (o.C <= 8) SERIAL_APPLY(8, false);
  else SERIAL_APPLY(16, false);
#undef SERIAL_APPLY
  return cudaGetLastError();
}

// The whole sweep: dot, solve and apply per round, all on `s`.  Returns
// the first launch error or 0.
int serial_run(const SerialSweep& o, cudaStream_t s) {
  // several blocks a round (the row layout) for one chain, in the fold or
  // dense modes only; the in-kernel decodes run one chain
  const bool decode = o.mode == kDecode || o.mode == kInt8Decode;
  if (o.C < 1 || o.C > kSerialMaxC || o.B < 1 || o.B > kSerialMaxB ||
      o.chunk < 1 || (o.K != 0 && (o.K < 2 || o.K > kMaxK)) ||
      o.mode < kFold || o.mode > kInt8Decode ||
      (decode && o.C != 1) || o.J < 1 || o.n_pos % o.J != 0 ||
      (o.J > 1 && (o.C != 1 || decode || o.B > kRowMaxB)))
    return cudaErrorInvalidValue;
  SerialSolveArgs a{o.partial, o.nsplit, o.border, o.inner, 0, o.J, o.B,
                    o.G, o.Mpad, 0, o.tbl, o.gram, o.xsq, o.mean, o.scale,
                    o.xsum, o.valid, o.gas, o.beta, o.labels, o.p, o.z,
                    o.pz_by_marker,
                    o.pz_by_marker ? (long long)o.Mpad
                                   : (long long)o.n_pos * o.B,
                    o.sigmaE, o.esum, o.dsc, o.dms, o.espart, o.vpart,
                    o.bpart, o.n_pos, o.mode == kFold || o.mode == kInt8};
  size_t smem = 0;
  cudaError_t err;
  const SolveFn solve = ready_solve(o.K, o.B, o.J, a, &smem, &err);
  if (solve == nullptr) return err;
  // the chunks of rounds: the remainder first, then `chunk` rounds
  const int nr = o.n_pos / o.J;
  const int rem = nr % o.chunk;
  for (int r = 0; r < nr; ++r) {
    if ((err = launch_dot(o, r, s)) != cudaSuccess) return err;
    a.round = r;
    a.chunk_start = r == 0 || (r >= rem && (r - rem) % o.chunk == 0);
    solve<<<o.C * o.J, kSolveThreads, smem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = launch_apply(o, r, s)) != cudaSuccess) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The smallest round (J*B entries) whose row apply takes the ring, and
// not the direct path (jacobi_t_common.cuh:launch_row_apply; rows < 0:
// unchanged); returns the previous value.  Both paths give the same bits.
int serial_row_apply_ring_rows(int rows) { return set_ring_rows(rows); }

int serial_max_block() { return kSerialMaxB; }

int serial_max_row_block() { return kRowMaxB; }

int serial_max_chains() { return kSerialMaxC; }

int serial_max_components() { return kMaxK; }

// The steps a window of the BayesR solve draws at once for blocks of B
// markers and K components, 0 where none fits; the horseshoe (K == 0)
// takes one step at a time.
int serial_window(int B, int K) {
  return B < 1 ? 0 : K == 0 ? 1 : plan_ring(B, 3 * K).window;
}

int serial_dot_splits(int Nw) { return (Nw + kDotThreads - 1) / kDotThreads; }

int serial_dense_dot_splits(int N) { return (N + kDenseTile - 1) / kDenseTile; }

int serial_int8_dot_splits(int N) { return (N + kInt8Tile - 1) / kInt8Tile; }

const char* serial_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One sweep of C chains over n_pos block positions in rounds of J (3
// launches each), on `stream`.  K == 0 is the horseshoe; `mode` the
// storage: 0 the fold mode, 1 the in-kernel decode (one chain, J=1; words
// with missing calls), 2 the dense mode (`words` X (Mpad, N) f32, Nw = N,
// eps (C, N); mean, scale, xsum and row_valid null; nsplit
// serial_dense_dot_splits(N)), 3 and 4 int8 codes (`words` (Mpad, N) int8,
// Nw = N, eps (C, N), row_valid null, nsplit serial_int8_dot_splits(N))
// in the fold mode and in the in-kernel decode (one chain, J=1; codes with
// missing calls).  J > 1 (the row layout) takes one chain,
// n_pos % J == 0 and B <= serial_max_row_block(); `chunk` counts rounds.
// Per-chain operands have a leading chain axis C: eps (C, Npad),
// beta/labels (C, Mpad), tbl (C, Mpad, F), sigmaE (C,); p/z (C, Mpad) by
// marker if pz_by_marker (fused chains), else (C, n_pos*B) by sweep
// position; scratch partial (C, nsplit, J*B + 1), esum (C,), dsc (C, J*B),
// dms and espart (C, J), vpart (C, n_pos, G, K), bpart (C, n_pos, G).
// Returns the first launch error or 0.
int serial_sweep(int C, int pz_by_marker, int Nw, int n_pos, int chunk,
                 int B, int K, int G, int Mpad, int nsplit, int mode, int J,
                 const void* words,
                 const void* border, const void* inner, const void* gram,
                 const void* tbl, const void* xsq, const void* mean,
                 const void* scale, const void* xsum, const void* valid,
                 const void* gas, void* eps, const void* row_valid,
                 void* beta, void* labels, const void* p, const void* z,
                 const void* sigmaE, void* partial, void* esum, void* dsc,
                 void* dms, void* espart, void* vpart, void* bpart,
                 void* stream) {
  return serial_run(
      SerialSweep{C, pz_by_marker, Nw, n_pos, chunk, B, K, G, Mpad, nsplit,
                  mode, J,
                  static_cast<const uint32_t*>(words),
                  static_cast<const int*>(border),
                  static_cast<const int*>(inner),
                  static_cast<const float*>(gram),
                  static_cast<const float*>(tbl),
                  static_cast<const float*>(xsq),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(xsum),
                  static_cast<const unsigned char*>(valid),
                  static_cast<const int*>(gas), static_cast<float*>(eps),
                  static_cast<const unsigned char*>(row_valid),
                  static_cast<float*>(beta), static_cast<int*>(labels),
                  static_cast<const float*>(p), static_cast<const float*>(z),
                  static_cast<const float*>(sigmaE),
                  static_cast<float*>(partial), static_cast<float*>(esum),
                  static_cast<float*>(dsc), static_cast<float*>(dms),
                  static_cast<float*>(espart), static_cast<float*>(vpart),
                  static_cast<float*>(bpart)},
      static_cast<cudaStream_t>(stream));
}

// The round solve alone (one launch, J CTAs): the solve of one round of J
// blocks of B markers on r given in the standardized domain, r1 (J*B + 1)
// floats with r of block j's marker l at j*B + l (the last unused), one
// chain.  The round's markers are numbered j*B + l: gram (J, B, B), inner
// (J, B), tbl (J*B, F), xsq, valid, gas, beta and labels (J*B,) by marker,
// updated in place; p/z (J*B,) by position j*B + s.  Writes d (J*B,) and
// the per-block vpart (J, G, K) and bpart (J, G).  K == 0 is the
// horseshoe (labels, gas, p, sigmaE, vpart, bpart null).  Returns the
// launch error or 0.
int serial_round_solve(int J, int B, int K, int G, const void* border,
                       const void* inner, const void* gram, const void* tbl,
                       const void* xsq, const void* valid, const void* gas,
                       void* beta, void* labels, const void* r1,
                       const void* p, const void* z, const void* sigmaE,
                       void* d, void* vpart, void* bpart, void* stream) {
  if (J < 1 || B < 1 || B > (J > 1 ? kRowMaxB : kSerialMaxB) ||
      (K != 0 && (K < 2 || K > kMaxK)))
    return cudaErrorInvalidValue;
  SerialSolveArgs a{static_cast<const float*>(r1), 1,
                    static_cast<const int*>(border),
                    static_cast<const int*>(inner), 0, J, B, G, J * B, 0,
                    static_cast<const float*>(tbl),
                    static_cast<const float*>(gram),
                    static_cast<const float*>(xsq), nullptr, nullptr, nullptr,
                    static_cast<const unsigned char*>(valid),
                    static_cast<const int*>(gas), static_cast<float*>(beta),
                    static_cast<int*>(labels), static_cast<const float*>(p),
                    static_cast<const float*>(z), 0, (long long)J * B,
                    static_cast<const float*>(sigmaE), nullptr,
                    static_cast<float*>(d), nullptr, nullptr,
                    static_cast<float*>(vpart), static_cast<float*>(bpart), J,
                    0};
  size_t smem = 0;
  cudaError_t err;
  const SolveFn solve = ready_solve(K, B, J, a, &smem, &err);
  if (solve == nullptr) return err;
  solve<<<J, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
