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
//          read once for all chains, each code decoded once for up to 8
//          (serial_dot_kernel), in CTAs of 128 words x 32 rows of one
//          block (16 where 32 leave the card short of CTAs), partial sums
//          to (C, nsplit, J*B + 1), the extra column sum(eps) (the int8
//          in-kernel decode: 4 rows a CTA, serial_q8_dot_kernel).  The
//          CTAs also prefetch the round's Gram matrices into L2 for the
//          solve.
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
//          rows where any chain moved, compacted by every thread into one
//          list in (block, index) order, the listed rows streamed by bulk
//          copies through a ring in shared memory (serial_apply_kernel; the
//          dense and int8 modes: jacobi_t_common.cuh:row_apply_kernel).
//          CTA 0 also carries sum(eps) to the next round: sum(eps) - sum
//          over the blocks, in j order, of d.xsum.
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
constexpr int kDotWarps = kDotThreads / 32;

// `mode`: the 2-bit fold and in-kernel decode, dense f32 rows, and int8
// codes in the fold and in-kernel decode modes
enum Storage { kFold = 0, kDecode = 1, kDense = 2, kInt8 = 3,
               kInt8Decode = 4 };

// ------------------------------------------------------------------ dot

// The dot CTA's place in a round: grid.y runs over (block j, row group grp)
// of R rows; r of the round goes to the partial columns j*B + grp*R + l.
struct DotTile {
  int j, grp, ngrp, nrow;
  long long blk;       // the block at sweep position q0 + j
  long long row0;      // first row of the tile in X / the words
};

__device__ __forceinline__ DotTile dot_tile(const int* border, int q0, int B,
                                            int R = kMaxB) {
  DotTile t;
  t.ngrp = (B + R - 1) / R;
  t.j = blockIdx.y / t.ngrp;
  t.grp = blockIdx.y - t.j * t.ngrp;
  t.nrow = min(R, B - t.grp * R);
  t.blk = border[q0 + t.j];
  t.row0 = t.blk * B + t.grp * R;
  return t;
}

// Warm the L2 with the Gram block of the tile's block, which the solve
// reads next: its 128-byte lines spread over the threads of the dot's CTAs
// of that block (a line or none a thread at the headline), counted in 32
// bits.
__device__ __forceinline__ void prefetch_gram(const float* gram,
                                              const DotTile& t, int B) {
  const float* gb = gram + t.blk * B * B;
  const int lines = (B * B + 31) / 32;
  const int nthr = gridDim.x * t.ngrp * kDotThreads;
  for (int ln = (t.grp * gridDim.x + blockIdx.x) * kDotThreads + threadIdx.x;
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

// ---- the 2-bit dots (serial_dot_kernel): the fold mode for one chain or CP
// fused chains (CP = 2, 4, 8; two passes over the chains above 8), and the
// in-kernel decode (Q: one chain, J=1).  CTA (split, (j, grp)) takes the R
// rows grp*R .. of the block at sweep position q0 + j over split
// blockIdx.x's 128 words, a thread a word.  A thread issues its loads first:
// its word's R rows (load_words: 32-bit row offsets), its eps and (Q) the
// rows' means and scales, into shared memory.  Then it sums each row: the
// fold mode with dot_word, the word's 16 fields in order from +0, each code
// decoded once (one LOP3: the magic from kDecodeBits) for the CP chains whose
// eps it holds in registers; the decode mode as the TPU's _decode_tile, x =
// c == 3 ? 0 : (c - mean)*scale, fmaf(x, eps, s) in field order from +0 on
// row_valid-masked eps (c by code_exact, its exponent bits from kDecodeBits).
// A chunk of 32 / CP rows' sums is staged in shared memory, a warp's 32
// words of a (chain, row) side by side, and lane l adds pair l's 32 values in
// warp_transpose_sum's tree (staged_tree); warps 0..3 then add from 0 into
// the (C, nsplit, J*B + 1) partials, the CTAs of blockIdx.y 0 also the
// sum(eps) column.  The bits of the dot it replaced (32 rows a CTA, at most 4
// chains a decode, warp_transpose_sum; tests/test_torch_serial_dot_order.py).
// A row's partial reads no other row, so the rows a CTA are free: R = 32, or
// 16 at 8 chains a decode (their eps take 128 registers) and where 32 would
// give fewer than two CTAs an SM (the row plans' fused chains at B = 128: 392
// CTAs where 196 ran; 8 rows, 784 CTAs, took 16.6 us a block against 13.7).
// Bound: the SMs' issue, as jacobi_t_common.cuh:dot_kernel's (a code takes
// a LOP3, a FADD and a FFMA a chain), over the bytes (a J=1 block of 512
// rows: 12.8 MB of words, 3.8 us at 3.35 TB/s); one chain at 80 registers (6
// CTAs an SM, a J=1 block's 784 CTAs in one wave) took 12.0 us a block and
// 62.1-64.1 a row round, at 128 registers 13.0-13.1 and 64.5-65.3 (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md §6).

// The in-kernel decode's sum of one word: x . e over its 16 individuals, x =
// (c - m)*sc and 0 for code 3 (pallas_sweep.py:_decode_tile), fmaf in field
// order from +0; e is plain eps, 0 on lanes >= N.
__device__ __forceinline__ float decode_dot_word(uint32_t wd,
                                                 const float (&e)[16],
                                                 float m, float sc,
                                                 const uint32_t (&ex)[11]) {
  const uint32_t hi = wd >> 22;
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float c = k <= 10 ? code_exact(wd, k, ex[k])
                            : code_exact(hi, k - 11, ex[k - 11]);
    const float x = c == 3.f ? 0.f : (c - m) * sc;
    a = fmaf(x, e[k], a);
  }
  return a;
}

template <int CP, int R, bool Q>
__global__ void __launch_bounds__(kDotThreads,
                                  Q ? 2 : CP == 1 ? 6 : CP >= 8 ? 3 : 4)
serial_dot_kernel(const uint32_t* __restrict__ words, int Nw,
                  const float* __restrict__ eps, int C,
                  const int* __restrict__ border, int q0, int J, int B,
                  const float* __restrict__ gram,
                  float* __restrict__ partial, int nsplit,
                  const float* __restrict__ mean,
                  const float* __restrict__ scale,
                  const unsigned char* __restrict__ row_valid) {
  static_assert(!Q || CP == 1, "the in-kernel decode runs one chain");
  constexpr int RC = R < 32 / CP ? R : 32 / CP;   // rows a staged chunk
  __shared__ __align__(16) float staged[kDotWarps][32][kStagePad];
  __shared__ float wsum[CP][kDotWarps][R];
  __shared__ float esw[CP][kDotWarps];
  __shared__ float qms[Q ? 2 : 1][Q ? R : 1];   // Q: the rows' mean, scale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DotTile tl = dot_tile(border, q0, B, R);
  const int w = blockIdx.x * kDotThreads + tid;
  const bool live = w < Nw;
  const long long Npad = 16LL * Nw;
  const int B1 = J * B + 1;
  float* mine = &staged[warp][0][0];

  // every load first: the words of the R rows, their means and scales
  // (staged in shared memory), the eps
  uint32_t wds[R];
  if (live) {
    load_words(words + tl.row0 * Nw + w, Nw, tl.nrow, wds);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) wds[i] = 0u;
  }
  uint32_t ex[Q ? 11 : 1];
  if constexpr (Q) {
    if (tid < R) {
      const bool in = tid < tl.nrow;
      qms[0][tid] = in ? __ldg(mean + tl.row0 + tid) : 0.f;
      qms[1][tid] = in ? __ldg(scale + tl.row0 + tid) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 11; ++k) ex[k] = kDecodeBits[k];
  }
  const uint32_t magic = kDecodeBits[kMagicAt];
  prefetch_gram(gram, tl, B);
  // one pass over the words below 8 chains (CP >= C), two above
  const int passes = CP < 8 ? 1 : (C + CP - 1) / CP;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * CP;
    if (pass > 0) {
      // the decode is the same for every pass: keep the compiler from
      // hoisting the decoded codes out of this loop (they spill); not
      // before the first pass, whose eps loads would then wait for the
      // words
#pragma unroll
      for (int i = 0; i < R; ++i) asm volatile("" : "+r"(wds[i]));
    }
    float e[CP][16], es[CP];
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      es[p] = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) e[p][k] = 0.f;
    }
    if (live) {
      if constexpr (Q) {
        const float4* e4 = reinterpret_cast<const float4*>(eps) + 4LL * w;
        const uchar4* v4 =
            reinterpret_cast<const uchar4*>(row_valid) + 4LL * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t = e4[q];
          const uchar4 v = v4[q];
          e[0][4 * q] = v.x ? t.x : 0.f;
          e[0][4 * q + 1] = v.y ? t.y : 0.f;
          e[0][4 * q + 2] = v.z ? t.z : 0.f;
          e[0][4 * q + 3] = v.w ? t.w : 0.f;
        }
      } else {
#pragma unroll
        for (int p = 0; p < CP; ++p)
          if (c0 + p < C)
            es[p] = load_eps16(
                reinterpret_cast<const float4*>(eps + (c0 + p) * Npad) +
                    4LL * w,
                e[p]);
      }
    }
    if constexpr (Q) __syncthreads();   // qms (one pass)
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const float t = warp_sum(es[p]);
      if (lane == 0) esw[p][warp] = t;
    }
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += RC) {
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        float s[CP];
        if constexpr (Q)
          s[0] = decode_dot_word(wds[r0 + i], e[0], qms[0][r0 + i],
                                 qms[1][r0 + i], ex);
        else
          dot_word<CP>(wds[r0 + i], e, s, magic);
#pragma unroll
        for (int p = 0; p < CP; ++p)
          mine[(p * RC + i) * kStagePad + lane] = s[p];
      }
      __syncwarp();
      // pair (p, i) = (lane / RC, lane % RC): the tree of its 32 words
      if (lane < CP * RC)
        wsum[lane / RC][warp][r0 + lane % RC] =
            staged_tree(mine + lane * kStagePad);
      __syncwarp();
    }
    __syncthreads();
    // output (c, l): the fixed-order CTA sums
    for (int o = tid; o < CP * R; o += kDotThreads) {
      const int p = o / R, l = o % R, c = c0 + p;
      if (c >= C || l >= tl.nrow) continue;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kDotWarps; ++q) t += wsum[p][q][l];
      float* out = partial + ((long long)c * nsplit + blockIdx.x) * B1;
      out[tl.j * B + tl.grp * R + l] = t;
      if (blockIdx.y == 0 && l == 0) {
        float te = 0.f;
#pragma unroll
        for (int q = 0; q < kDotWarps; ++q) te += esw[p][q];
        out[J * B] = te;
      }
    }
    if (pass + 1 < passes) __syncthreads();   // the next rewrites wsum, esw
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

// ---- the 2-bit apply (serial_apply_kernel): one chain or CB >= C fused
// chains (a power of two: the per-chain accumulators stay in registers), in
// the fold mode and the in-kernel decode (Q: CB == 1, J == 1); the round's J
// blocks at sweep positions q0 .., dsc (C, J*B), dms and espart (C, J) as the
// solve writes them.  The design of jacobi_t.cu:apply_kernel with the serial
// row order and a chain axis.  Each of kSaConsumers consumer threads owns L
// eps lanes of a word (their lane mask read, and their eps copied into
// shared memory by cp.async, before anything waits), 16 / L threads a word,
// so a CTA covers sa_words(L) words of every row: at L = 4 (one chain) 48
// words, 131 CTAs at Nw = 6,272, one an SM; at L = 2 (fused chains) 24, two
// an SM, so that twice the warps issue the chains' FFMAs (8 chains, every
// row moving: 38.6-39.0 us a J=1 block against 44.2 at L = 4; one chain at
// L = 2: 108.1 us a row round against 97.4-98.0; NVIDIA H100 80GB HBM3, 700
// W; PERF.md §6).  Every thread loads its share of the round's d, every chain's (a row
// moves where d != 0 in any chain), a ballot a warp marks the moved entries
// in a bitmask, one warp's prefix over the mask's words places them, and
// each moved entry is written at its place in one list in (block, index)
// order: its row, border[q0 + e / B]*B + e % B, its CB d and, in Q, the
// row's mean and scale.  Then kSaIssuers issuer warps stream the listed
// rows' segments, kSaRows rows a stage, into a ring of kSaStages stages in
// shared memory (stage s by warp s mod kSaIssuers, a cp.async.bulk a row, a
// full / empty mbarrier pair a stage), while the consumers add the staged
// rows in list order, each code decoded in one LOP3 and one FADD
// (code_exact), in runs of one block: where a block's rows end (bfirst, its
// first place in the list) its sum goes, less its mean term, into the
// lane's total in shared memory.  A round of more entries than a list holds
// (sa_tile: the row layout beyond 4,096) runs as several lists, one after
// the other, through the same ring.  Bound: the moved rows' words and each
// chain's eps, read once (the row horseshoe's 4,096 rows of 25 KB a round:
// 30.9 us at 3.35 TB/s), or at 8 chains their FFMAs.
constexpr int kSaConsumers = 192;                  // consumer threads
constexpr int kSaWarps = kSaConsumers / 32;        // consumer warps
constexpr int kSaIssuers = 4;                      // warps issuing copies
constexpr int kSaThreads = kSaConsumers + 32 * kSaIssuers;
constexpr int kSaRows = 32;                        // rows a stage
constexpr int kSaStages = 8;                       // stages of the ring
static_assert(kSaConsumers % 32 == 0, "whole consumer warps");

// Words of a row a CTA at L eps lanes a consumer thread.
__host__ __device__ constexpr int sa_words(int L) {
  return kSaConsumers * L / 16;
}

// Eps lanes a consumer thread of CB chains.
__host__ __device__ constexpr int sa_lanes(int CB) { return CB == 1 ? 4 : 2; }

// Entries a list of CB chains: a row round's (one chain), a J=1 block's.
__host__ __device__ constexpr int sa_tile(int CB) {
  return CB == 1 ? kMaxRound : kSerialMaxB;
}

// Dynamic shared memory of serial_apply_kernel<CB, Q, L> for lists of
// `tile` entries and a round of CJ = C*J blocks' sums: the ring, the
// consumers' eps and their blocks' updates summed (CB*L floats a thread
// each), the list (each entry's CB d, its row and, in Q, its mean and
// scale), the round's dms and espart and where each block's entries start
// in the list (J + 1 <= CJ + 1 ints).
inline size_t serial_apply_smem(int CB, bool Q, int L, int tile, int CJ) {
  return sizeof(uint32_t) * kSaStages * kSaRows * sa_words(L) +
         sizeof(float) * 2 * L * CB * kSaConsumers +
         (sizeof(float) * (CB + (Q ? 2 : 0)) + sizeof(int)) * tile +
         sizeof(float) * 2 * CJ + sizeof(int) * (CJ + 1);
}

// The CB chains' d of one listed entry (16-byte loads from CB = 4 on).
template <int CB>
__device__ __forceinline__ void list_d(const float* v, float (&d)[CB]) {
  if constexpr (CB >= 4) {
#pragma unroll
    for (int h = 0; h < CB / 4; ++h) {
      const float4 t = reinterpret_cast<const float4*>(v)[h];
      d[4 * h] = t.x;
      d[4 * h + 1] = t.y;
      d[4 * h + 2] = t.z;
      d[4 * h + 3] = t.w;
    }
  } else if constexpr (CB == 2) {
    const float2 t = reinterpret_cast<const float2*>(v)[0];
    d[0] = t.x;
    d[1] = t.y;
  } else {
    d[0] = v[0];
  }
}

// Per chain c and eps lane n with row_valid[n]: for each block j of the
// round in turn, acc from +0 over its moved rows in index order, fmaf(d_c,
// x, acc) with x the lane's code, and tot <- tot + (acc - dms[j]) from tot
// = +0; then eps <- eps - tot.  Q (J = 1): x = c == 3 ? 0 : (c -
// mean)*scale, op for op, and eps <- eps - acc.  CTA 0 carries esum <- esum
// - (espart[0] + ... + espart[J-1]) (esum null outside the fold mode).  A
// lane's sum is taken a block at a time, its mean term off with it, so
// that a row round's J*B updates (8,192 at J=16, B=512) do not pile up in
// one f32 sum; at J = 1 the bits are those of eps - (acc - dms[0]), the
// apply that looped over compacted tiles of 512 entries itself
// (tests/test_torch_serial_apply_order.py).  The bulk copies take Nw % 4 == 0 and 16-byte aligned words (the
// port's words: Nw is a multiple of 128).
template <int CB, bool Q, int L>
__global__ void __launch_bounds__(kSaThreads, L == 4 || CB > 8 ? 1 : 2)
serial_apply_kernel(const uint32_t* __restrict__ words, int Nw,
                    float* __restrict__ eps, int C,
                    const unsigned char* __restrict__ row_valid,
                    const int* __restrict__ border, int q0, int J, int B,
                    const float* __restrict__ dsc,
                    const float* __restrict__ dms,
                    const float* __restrict__ mean,
                    const float* __restrict__ scale,
                    float* __restrict__ esum,
                    const float* __restrict__ espart, int tile) {
  static_assert(!Q || CB == 1, "the in-kernel decode runs one chain");
  static_assert(L <= kMagicAt, "a lane's exponent bits in kDecodeBits");
  constexpr int T = kSaThreads;
  constexpr int W = sa_words(L);                    // words of a row a CTA
  constexpr int kPer = (sa_tile(CB) + T - 1) / T;   // list entries a thread
  constexpr int kMask = sa_tile(CB) / 32;           // mask words of a list
  static_assert(kMask % 32 == 0, "whole mask words a lane");
  extern __shared__ __align__(128) uint32_t sadyn[];
  uint32_t* ring = sadyn;
  float* eps_s = reinterpret_cast<float*>(ring + kSaStages * kSaRows * W);
  float* lval = eps_s + L * CB * kSaConsumers;
  int* lrow = reinterpret_cast<int*>(lval + CB * tile);
  float* lmean = reinterpret_cast<float*>(lrow + tile);
  float* lscale = lmean + (Q ? tile : 0);
  float* dmsv = lscale + (Q ? tile : 0);
  float* espv = dmsv + C * J;
  float* tot_s = espv + C * J;
  int* bfirst = reinterpret_cast<int*>(tot_s + L * CB * kSaConsumers);
  __shared__ uint64_t full[kSaStages], empty[kSaStages];
  __shared__ uint32_t moved[kMask];
  __shared__ int prefix[kMask];
  __shared__ int nnz_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int JB = J * B;
  const int w0 = blockIdx.x * W;
  const int nw = min(W, Nw - w0);
  const long long Npad = 16LL * Nw;

  // a consumer's word and lanes, their mask and eps, read before anything
  // waits
  const int wi = tid / (16 / L), sub = tid % (16 / L);
  const bool live = warp < kSaWarps && wi < nw;
  const long long n0 = 16LL * (w0 + wi) + L * sub;
  bool rv[L];
#pragma unroll
  for (int k = 0; k < L; ++k) rv[k] = live && row_valid[n0 + k];
  if (live) {
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (c < C)
          cp_async4(&eps_s[(c * L + k) * kSaConsumers + tid],
                    eps + c * Npad + n0 + k, true);
  }
  cp_async_commit();
  if (tid == 0) {
    for (int q = 0; q < kSaStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kSaWarps);
    }
    mbar_fence_init();
  }
  if constexpr (!Q) {
    for (int q = tid; q < C * J; q += T) {
      dmsv[q] = __ldg(dms + q);
      if (esum != nullptr) espv[q] = __ldg(espart + q);
    }
  }
  uint32_t ex[L];
  float acc[CB][L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    ex[k] = kDecodeBits[k];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      acc[c][k] = 0.f;
      if (!Q && warp < kSaWarps)
        tot_s[(c * L + k) * kSaConsumers + tid] = 0.f;
    }
  }
  // a consumer's block sums: the blocks before `cur` are in tot_s, acc
  // holds block cur's so far; close the blocks before block b
  int cur = 0;
  const auto close_to = [&](int b) {
    for (; cur < b; ++cur) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float dm = c < C ? dmsv[c * J + cur] : 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          float& t = tot_s[(c * L + k) * kSaConsumers + tid];
          t = t + (acc[c][k] - dm);
          acc[c][k] = 0.f;
        }
      }
    }
  };

  int base = 0;   // ring stages of the lists before this one
  for (int t0 = 0; t0 < JB; t0 += tile) {
    const int n = min(tile, JB - t0);
    // ---- the list's moved entries, by every thread: entry e = k*T + tid
    float dv[kPer][CB], mv[Q ? kPer : 1], sv[Q ? kPer : 1];
    int row[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = k * T + tid;
      const bool in = e < n;
      const int g = t0 + e;                 // the entry of the round
      row[k] = in ? __ldg(border + q0 + g / B) * B + g % B : 0;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        dv[k][c] = in && c < C ? __ldg(dsc + (long long)c * JB + g) : 0.f;
      if constexpr (Q) {
        mv[k] = in ? __ldg(mean + row[k]) : 0.f;
        sv[k] = in ? __ldg(scale + row[k]) : 0.f;
      }
    }
    // mask word k*(T/32) + warp holds entries 32 of them from k*T + 32*warp
    bool mvd[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bool f = false;
#pragma unroll
      for (int c = 0; c < CB; ++c) f |= dv[k][c] != 0.f;
      mvd[k] = f;
      const unsigned b = __ballot_sync(kFull, f);
      if (lane == 0 && k * T + 32 * warp < n) moved[k * (T / 32) + warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
      // the mask words' exclusive prefix counts, PL words a lane
      constexpr int PL = kMask / 32;
      const int nmw = (n + 31) / 32;
      int cnt[PL], tot = 0;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int m = PL * lane + i;
        cnt[i] = m < nmw ? __popc(moved[m]) : 0;
        tot += cnt[i];
      }
      int incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int run = incl - tot;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int m = PL * lane + i;
        if (m < nmw) prefix[m] = run;
        run += cnt[i];
      }
      if (lane == 31) nnz_s = incl;
    } else if (!Q && warp == 1 && t0 == 0 && lane < C && esum != nullptr &&
               blockIdx.x == 0) {
      // the round's sum(eps) update over its blocks, in j order
      const int c = lane;
      float e = espv[c * J];
      for (int q = 1; q < J; ++q) e += espv[c * J + q];
      esum[c] = esum[c] - e;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (mvd[k]) {
        const int m = k * (T / 32) + warp;
        const int at = prefix[m] + __popc(moved[m] & ((1u << lane) - 1u));
        lrow[at] = row[k];
#pragma unroll
        for (int c = 0; c < CB; ++c) lval[at * CB + c] = dv[k][c];
        if constexpr (Q) {
          lmean[at] = mv[k];
          lscale[at] = sv[k];
        }
      }
    }
    if constexpr (!Q) {
      // block j's first place in the list: its moved entries before it
      for (int j = tid; j <= J; j += T) {
        const int e = j * B - t0;
        bfirst[j] = e <= 0 ? 0 : e >= n ? nnz_s
                  : prefix[e >> 5] +
                        __popc(moved[e >> 5] & ((1u << (e & 31)) - 1u));
      }
    }
    __syncthreads();
    const int nnz = nnz_s;
    const int nst = (nnz + kSaRows - 1) / kSaRows;

    if (warp >= kSaWarps) {
      // ---- an issuer: stage st (list rows st*kSaRows ..) when st %
      // kSaIssuers is its number; ring stage base + st
      const int me = warp - kSaWarps;
      const uint32_t bytes = 4u * nw;
      for (int st = me; st < nst; st += kSaIssuers) {
        const int g = base + st, slot = g % kSaStages;
        if (g >= kSaStages)
          mbar_wait(&empty[slot], (g / kSaStages - 1) & 1);
        const int nrow = min(kSaRows, nnz - st * kSaRows);
        uint32_t* dst = ring + slot * kSaRows * W;
        // a lane a row: one bulk copy of its nw words
        if (lane == 0) mbar_arrive_expect(&full[slot], bytes * nrow);
        __syncwarp();
        if (lane < nrow)
          bulk_load(dst + lane * W,
                    words + (long long)lrow[st * kSaRows + lane] * Nw + w0,
                    bytes, &full[slot]);
      }
    } else {
      // ---- the consumers: thread (wi, sub) adds its L lanes of each row
      for (int st = 0; st < nst; ++st) {
        const int g = base + st, slot = g % kSaStages;
        mbar_wait(&full[slot], (g / kSaStages) & 1);
        const uint32_t* sw = ring + slot * kSaRows * W + wi;
        const int r0 = st * kSaRows;
        const int nrow = min(kSaRows, nnz - r0);
        const auto add = [&](int q) {
          const uint32_t wd = sw[q * W] >> (2 * L * sub);
          float x[L], d[CB];
#pragma unroll
          for (int k = 0; k < L; ++k) x[k] = code_exact(wd, k, ex[k]);
          if constexpr (Q) {
            const float m = lmean[r0 + q], s = lscale[r0 + q];
#pragma unroll
            for (int k = 0; k < L; ++k)
              x[k] = x[k] == 3.f ? 0.f : (x[k] - m) * s;
          }
          list_d<CB>(lval + (r0 + q) * CB, d);
#pragma unroll
          for (int c = 0; c < CB; ++c)
#pragma unroll
            for (int k = 0; k < L; ++k)
              acc[c][k] = fmaf(d[c], x[k], acc[c][k]);
        };
        // the stage's rows in runs of one block, each block closed before
        // the next block's first row (Q: J = 1, one run)
        for (int q = 0; q < nrow;) {
          int stop = nrow;
          if constexpr (!Q) {
            int b = cur;
            while (b + 1 < J && bfirst[b + 1] <= r0 + q) ++b;
            if (b != cur) close_to(b);
            if (b + 1 < J) stop = min(nrow, bfirst[b + 1] - r0);
          }
          if (q == 0 && stop == kSaRows) {
            if constexpr (CB >= 8) {
#pragma unroll 2
              for (int i = 0; i < kSaRows; ++i) add(i);
            } else {
#pragma unroll 8
              for (int i = 0; i < kSaRows; ++i) add(i);
            }
          } else {
#pragma unroll 2
            for (int i = q; i < stop; ++i) add(i);
          }
          q = stop;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }
    base += nst;
    if (t0 + tile < JB) __syncthreads();   // the next list overwrites this
  }
  if (!live) return;
  if constexpr (!Q) close_to(J);
  cp_async_wait<0>();   // this thread's own copies: no barrier
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < C) {
      float* ep = eps + c * Npad + n0;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int at = (c * L + k) * kSaConsumers + tid;
        if (rv[k]) ep[k] = eps_s[at] - (Q ? acc[c][k] : tot_s[at]);
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

// The 2-bit apply of a sweep: its instance, list entries and dynamic shared
// memory (ready_apply), the same for every round.
using ApplyFn = void (*)(const uint32_t*, int, float*, int,
                         const unsigned char*, const int*, int, int, int,
                         const float*, const float*, const float*,
                         const float*, float*, const float*, int);

struct ApplyPlan {
  ApplyFn fn;
  int words;   // of a row a CTA
  int tile;
  size_t smem;
};

template <int CB, bool Q>
ApplyPlan apply_plan(int C, int J, int B) {
  constexpr int L = sa_lanes(CB);
  const int tile = std::min(J * B, sa_tile(CB));
  return {serial_apply_kernel<CB, Q, L>, sa_words(L), tile,
          serial_apply_smem(CB, Q, L, tile, C * J)};
}

// The 2-bit modes' plan: the dot's rows a CTA (32, or 16 at 8 chains a
// decode and where 32 would give fewer than two CTAs an SM) and the apply's
// instance (CB >= C chains)
// with its shared memory allowed.  The bulk copies take Nw % 4 == 0 and
// 16-byte aligned words: any other shape is cudaErrorInvalidValue.
cudaError_t ready_packed(const SerialSweep& o, int* dot_rows, ApplyPlan* p) {
  if (o.Nw % 4 != 0 || reinterpret_cast<uintptr_t>(o.words) % 16 != 0)
    return cudaErrorInvalidValue;
  static int sms = 0;   // SMs of the card
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long ctas = (long long)o.nsplit * o.J * ((o.B + 31) / 32);
  *dot_rows = o.C > 4 || ctas < 2LL * sms ? 16 : 32;
  if (o.mode == kDecode) *p = apply_plan<1, true>(o.C, o.J, o.B);
  else if (o.C <= 1) *p = apply_plan<1, false>(o.C, o.J, o.B);
  else if (o.C <= 2) *p = apply_plan<2, false>(o.C, o.J, o.B);
  else if (o.C <= 4) *p = apply_plan<4, false>(o.C, o.J, o.B);
  else if (o.C <= 8) *p = apply_plan<8, false>(o.C, o.J, o.B);
  else *p = apply_plan<16, false>(o.C, o.J, o.B);
  return cudaFuncSetAttribute(
      p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
}

// The dot of round r.  The 2-bit modes read the words once for every CP
// chains (8 at most, two passes above 8), dot_rows rows of a block a CTA;
// the dense mode reads the rows once for all chains.
cudaError_t launch_dot(const SerialSweep& o, int r, int dot_rows,
                       cudaStream_t s) {
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
  const dim3 pgrid(o.nsplit, o.J * ((o.B + dot_rows - 1) / dot_rows));
#define SERIAL_DOT(CP, R, Q)                                              \
  serial_dot_kernel<CP, R, Q><<<pgrid, kDotThreads, 0, s>>>(              \
      o.words, o.Nw, o.eps, o.C, o.border, q0, o.J, o.B, o.gram,          \
      o.partial, o.nsplit, o.mean, o.scale, o.row_valid)
#define SERIAL_DOTS(R)                                                    \
  if (o.mode == kDecode) SERIAL_DOT(1, R, true);                          \
  else if (o.C == 1) SERIAL_DOT(1, R, false);                             \
  else if (o.C == 2) SERIAL_DOT(2, R, false);                             \
  else if (o.C <= 4) SERIAL_DOT(4, R, false);                             \
  else SERIAL_DOT(8, R, false)
  if (dot_rows == 16) {
    SERIAL_DOTS(16);
  } else if (o.mode == kDecode) {
    SERIAL_DOT(1, 32, true);
  } else if (o.C == 1) {
    SERIAL_DOT(1, 32, false);
  } else if (o.C == 2) {
    SERIAL_DOT(2, 32, false);
  } else {
    SERIAL_DOT(4, 32, false);
  }
#undef SERIAL_DOTS
#undef SERIAL_DOT
  return cudaGetLastError();
}

cudaError_t launch_apply(const SerialSweep& o, int r, const ApplyPlan& p,
                         cudaStream_t s) {
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
  const int ctas = (o.Nw + p.words - 1) / p.words;
  p.fn<<<ctas, kSaThreads, p.smem, s>>>(
      o.words, o.Nw, o.eps, o.C, o.row_valid, o.border, q0, o.J, o.B, o.dsc,
      o.dms, o.mean, o.scale, o.mode == kFold ? o.esum : nullptr, o.espart,
      p.tile);
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
  int dot_rows = kMaxB;
  ApplyPlan ap{nullptr, 0, 0, 0};
  if ((o.mode == kFold || o.mode == kDecode) &&
      (err = ready_packed(o, &dot_rows, &ap)) != cudaSuccess)
    return err;
  // the chunks of rounds: the remainder first, then `chunk` rounds
  const int nr = o.n_pos / o.J;
  const int rem = nr % o.chunk;
  for (int r = 0; r < nr; ++r) {
    if ((err = launch_dot(o, r, dot_rows, s)) != cudaSuccess) return err;
    a.round = r;
    a.chunk_start = r == 0 || (r >= rem && (r - rem) % o.chunk == 0);
    solve<<<o.C * o.J, kSolveThreads, smem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = launch_apply(o, r, ap, s)) != cudaSuccess) return err;
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
