// Device code shared by the single-chain sweeps (jacobi_t.cu) and the
// fused multi-chain sweeps (jacobi_t_mc.cu): the 2-bit decode and the
// missing-call indicator, the warp reductions, the dot's loads and
// per-word arithmetic (dot_rows, for one eps vector or several at once),
// the strided sweeps' one-chain 2-bit dot (dot_kernel) and the staged
// tree and sparse missing-call indicator it shares with the fused dots,
// the row-major modes' dot and apply on dense f32 rows or int8 codes
// (dense_dot_tile, row_apply_kernel) and
// the per-block solves, which each chain of a fused sweep runs on its own
// operands.  So a fused chain
// equals the single-chain kernel bitwise.  See jacobi_t.cu for the sweep's
// design and the TPU kernel semantics it keeps.  The serial and row-layout
// sweeps (serial.cu) use the decode, the dot, the row-major dot and apply
// and the BayesR categorical draw.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxB = 32;           // markers per block: one lane each
constexpr int kMaxK = 8;            // mixture components
constexpr int kDotThreads = 128;    // words per dot CTA
constexpr int kApplyThreads = 128;  // threads of a direct row or serial apply
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kMaxRound = 4096;     // J*B markers per round
constexpr float kMagic = 8388608.0f;        // 2^23
constexpr uint32_t kMagicBits = 0x4B000000u;

// Exact float of the 2-bit field k of w, for any k.
__device__ __forceinline__ float code_f(uint32_t w, int k) {
  return __uint_as_float(kMagicBits | ((w >> (2 * k)) & 3u)) - kMagic;
}

// The missing-call indicator of every field of w: bit 2k is set where
// field k holds code 3, every other bit is 0.  Decoded by code_f /
// code_scaled like a word of codes, so the indicator's dot takes the
// code dot's instructions (pallas_jacobi_t.py:_decoders, :291-302).
__device__ __forceinline__ uint32_t miss_bits(uint32_t w) {
  return w & (w >> 1) & 0x55555555u;
}

// The miss mode's term of one row in an apply (pallas_jacobi_t.py:
// _make_dots, dot_a): dm = d*scale*(mean - 3) added to the accumulator of
// each of the L fields of wd that holds a missing call, after the row's
// code term.  fmaf(dm, 0, acc) is acc, so the other fields keep theirs.
template <int L>
__device__ __forceinline__ void apply_missing(float dm, uint32_t wd,
                                              float (&acc)[L]) {
  const uint32_t wi = miss_bits(wd);
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = fmaf(dm, code_f(wi, k), acc[k]);
}

// c * 4^k for the field k <= 10 of w, exactly (3 * 4^10 < 2^23); magic
// is kMagicBits (read from kDecodeBits: one LOP3, not two).
__device__ __forceinline__ float code_scaled(uint32_t w, int k,
                                             uint32_t magic = kMagicBits) {
  return __uint_as_float(magic | (w & (3u << (2 * k)))) - kMagic;
}

// The exponent bits of 2^(23 - 2k): code_exact's ex for field k.
__host__ __device__ constexpr uint32_t exact_bits(int k) {
  return (150u - 2u * k) << 23;
}

// The decodes' constant bits, read from constant memory by the 2-bit dots
// and applies: the compiler folds a constant it knows into an immediate, and
// a LOP3 takes one 32-bit immediate, so (w & mask) | bits with both known
// takes two LOP3s, with bits read from here one (PERF.md §6).
// kDecodeBits[k] = exact_bits(k) for the fields k <= 10 that code_exact
// decodes in place, kDecodeBits[kMagicAt] = kMagicBits.
constexpr int kMagicAt = 11;
__constant__ uint32_t kDecodeBits[kMagicAt + 1] = {
    exact_bits(0), exact_bits(1), exact_bits(2), exact_bits(3),
    exact_bits(4), exact_bits(5), exact_bits(6), exact_bits(7),
    exact_bits(8), exact_bits(9), exact_bits(10), kMagicBits};

// Exact float of the field k <= 10 of w in one LOP3 and one FADD, as
// code_f in three: the field stays in place under the exponent of
// 2^(23 - 2k) (ex, kDecodeBits[k]), where its lowest bit is worth 1, so
// the float read is 2^(23 - 2k) + c and the FADD takes 2^(23 - 2k) off
// exactly.
__device__ __forceinline__ float code_exact(uint32_t w, int k, uint32_t ex) {
  return __uint_as_float(ex | (w & (3u << (2 * k)))) -
         __uint_as_float(exact_bits(k));
}

// ---- rings in shared memory, filled by the copy engine (cp.async.bulk,
// the TMA's plain bulk copy) and paced by mbarriers: a stage's `full`
// barrier completes when its bytes have landed, its `empty` barrier when
// every consumer has let it go.  Waits are on the parity of the phase.

// The address of a shared-memory object in the shared window.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// Make the barriers of the CTA's thread 0 visible to the copy engine; a
// __syncthreads() after it makes them visible to the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// ---- a thread's own asynchronous copies from global to shared memory
// (cp.async, LDGSTS: no registers held while they fly), completing in
// commit groups.

// 4 bytes, or 4 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// The eps of one word's 16 individuals (four float4 at e4), field k
// pre-scaled by 4^-k for k <= 10 and by 4^-(k-11) above (those fields are
// read from w >> 22); returns their plain sum.
__device__ __forceinline__ float load_eps16(const float4* e4, float (&e)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = e4[q];
    e[4 * q] = t.x; e[4 * q + 1] = t.y; e[4 * q + 2] = t.z; e[4 * q + 3] = t.w;
  }
  float esum = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) esum += e[k];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    e[k] *= __uint_as_float((127u - 2u * (k <= 10 ? k : k - 11)) << 23);
  return esum;
}

// The B <= R words of one packed column (stride Nw), zero above B.  Each
// row is a 32-bit byte offset from wp (one IMAD.WIDE a load), and a full
// block's loads are not predicated: 64-bit row arithmetic and a predicate
// a row took ~10 instructions a load (the SASS of dot_kernel).
template <int R>
__device__ __forceinline__ void load_words(const uint32_t* wp, int Nw, int B,
                                           uint32_t (&wds)[R]) {
  const char* base = reinterpret_cast<const char*>(wp);
  const unsigned stride = 4u * static_cast<unsigned>(Nw);
  const auto at = [&](int i) {
    return __ldg(reinterpret_cast<const uint32_t*>(base + i * stride));
  };
  if (B == R) {
#pragma unroll
    for (int i = 0; i < R; ++i) wds[i] = at(i);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) wds[i] = i < B ? at(i) : 0u;
  }
}

// s[p] = the codes of word wd . e[p] for CP eps vectors (each pre-scaled
// by load_eps16): its 16 fields in order, each decoded once (code_scaled,
// magic as there) and multiplied by every e[p], s[p] from +0 by fmaf.  The
// dot of every 2-bit mode sums a word's codes so.
template <int CP>
__device__ __forceinline__ void dot_word(uint32_t wd,
                                         const float (&e)[CP][16],
                                         float (&s)[CP],
                                         uint32_t magic = kMagicBits) {
  const uint32_t hi = wd >> 22;
#pragma unroll
  for (int p = 0; p < CP; ++p) s[p] = 0.f;
#pragma unroll
  for (int k = 0; k <= 10; ++k) {
    const float cf = code_scaled(wd, k, magic);
#pragma unroll
    for (int p = 0; p < CP; ++p) s[p] = fmaf(cf, e[p][k], s[p]);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float cf = code_scaled(hi, k, magic);
#pragma unroll
    for (int p = 0; p < CP; ++p) s[p] = fmaf(cf, e[p][11 + k], s[p]);
  }
}

// acc[p][i] = code row i of the word . e[p] (dot_word on each of the B
// words of a column).
template <int CP>
__device__ __forceinline__ void dot_rows(const uint32_t (&wds)[kMaxB],
                                         const float (&e)[CP][16],
                                         float (&acc)[CP][kMaxB]) {
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    float s[CP];
    dot_word<CP>(wds[i], e, s);
#pragma unroll
    for (int p = 0; p < CP; ++p) acc[p][i] = s[p];
  }
}

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

// Floats a staged row of a warp's 32 sums: the pad keeps staged_tree's
// 16-byte loads of 8 lanes' rows on distinct banks.
constexpr int kStagePad = 36;

// The sum of 32 staged floats x (16-byte aligned) in warp_transpose_sum's
// tree: x[a] + x[a + 16] first, then + 8, + 4, + 2, + 1.  A warp's 32
// values of a row staged side by side and summed so by one lane give the
// row's warp_transpose_sum bit for bit, in 8 loads and 31 adds where the
// transpose takes 31 shuffles, 62 selects and 31 adds a lane.
__device__ __forceinline__ float staged_tree(const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
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
  return y[0] + y[1];
}

// ---- the strided sweeps' one-chain 2-bit dot (dot_kernel; jacobi_t.cu,
// and jacobi_t_mc.cu at C = 1), fold and miss modes: a CTA a (split,
// block) of the round, grid (nsplit, J), a thread a word.  A thread issues
// the loads of its word's B rows and its 16 eps first, then sums each row
// with dot_word (16 fmaf in field order from +0), staging the warp's 32
// sums of a row side by side in shared memory; lane l adds row l's 32 in
// warp_transpose_sum's tree (staged_tree) and warps 0..3 add from 0 into
// the (nsplit, J*B + 1) partials, block 0's CTAs also the sum(eps)
// column.  MISS: then the words' missing-call indicator, only where a
// call is missing (miss_rows on the thread's e', staged in shared
// memory), through the same staged tree into (nsplit, J*B) indicator
// partials.  The bits of the dot it replaced (a thread's B rows through
// warp_transpose_sum, the indicator in the dense 16-FMA form on miss_bits;
// tests/test_torch_fold_dot_order.py).  What bounds it: issue.  At the
// headline a round is 411 M codes (25.7 M rows x words) against 103 MB of
// words (31 us at 3.35 TB/s); a code takes one LOP3 (the magic from
// kDecodeBits: ptxas folds two known constants into two LOP3s), one FADD
// and one FFMA, and the SMs issue ~2.5 instructions a cycle whatever the
// mix, so every instruction a code or row costs time: the two-LOP3 decode
// took 84.7 us a round, the one-LOP3 decode 65.4, and the loads' row
// addresses in 32 bits (load_words) 57 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).  Walking several blocks a CTA with the eps read once (the
// fused fold dot's design, 4 CTAs an SM) took 97-100 us at one chain; 8
// CTAs an SM in place of 7 changed nothing.
template <bool MISS>
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const uint32_t* __restrict__ words, int Nw,
           const float* __restrict__ eps, const int* __restrict__ rho,
           int round, int nr, int J, int B, float* __restrict__ partial,
           float* __restrict__ pind) {
  constexpr int kWarps = kDotThreads / 32;
  __shared__ __align__(16) float staged[kWarps][kMaxB][kStagePad];
  __shared__ float wsum[kWarps][32];
  __shared__ float wsum_i[MISS ? kWarps : 1][32];
  __shared__ float red_e[kWarps];
  __shared__ EsVec<1> es[MISS ? 16 * kDotThreads : 1];
  const int j = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x * kDotThreads + tid;
  const long long row0 = (long long)(j * nr + rho[round]) * B;
  const int JB1 = J * B + 1;
  uint32_t wds[kMaxB];
  float e[1][16];
  float esum = 0.f;
  if (w < Nw) {
    // all B loads first, so a warp keeps B lines in flight
    load_words(words + row0 * Nw + w, Nw, B, wds);
    esum = load_eps16(reinterpret_cast<const float4*>(eps) + 4LL * w, e[0]);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) wds[i] = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) e[0][k] = 0.f;
  }
  const uint32_t magic = kDecodeBits[kMagicAt];
  float* mine = &staged[warp][0][0];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    float s[1];
    dot_word<1>(wds[i], e, s, magic);
    mine[i * kStagePad + lane] = s[0];
  }
  __syncwarp();
  wsum[warp][lane] = staged_tree(mine + lane * kStagePad);
  esum = warp_sum(esum);
  if (lane == 0) red_e[warp] = esum;
  if constexpr (MISS) {
    // e' = (e*4^-k')*4^k', the product the dense form takes at a missing
    // call of field k; read by this thread alone
#pragma unroll
    for (int k = 0; k < 16; ++k)
      es[k * kDotThreads + tid].e[0] =
          e[0][k] *
          __uint_as_float((127u + 2u * (k <= 10 ? k : k - 11)) << 23);
    float acc[1][kMaxB];
    miss_rows<1>(wds, es + tid, acc);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) mine[i * kStagePad + lane] = acc[0][i];
    __syncwarp();
    wsum_i[warp][lane] = staged_tree(mine + lane * kStagePad);
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += wsum[q][lane];
    float* out = partial + (long long)blockIdx.x * JB1;
    if (lane < B) out[j * B + lane] = t;
    if (j == 0 && lane == 0) {
      float te = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) te += red_e[q];
      out[J * B] = te;
    }
    if constexpr (MISS) {
      float ti = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) ti += wsum_i[q][lane];
      if (lane < B)
        pind[(long long)blockIdx.x * (JB1 - 1) + j * B + lane] = ti;
    }
  }
}

// The one-chain 2-bit dot of a strided round (pind not null: the miss
// mode).
inline cudaError_t launch_one_chain_dot(int Nw, int nsplit, int J,
                                        cudaStream_t s, const uint32_t* words,
                                        const float* eps, const int* rho,
                                        int round, int nr, int B,
                                        float* partial, float* pind) {
  const dim3 grid(nsplit, J);
  if (pind != nullptr)
    dot_kernel<true><<<grid, kDotThreads, 0, s>>>(words, Nw, eps, rho, round,
                                                  nr, J, B, partial, pind);
  else
    dot_kernel<false><<<grid, kDotThreads, 0, s>>>(words, Nw, eps, rho, round,
                                                   nr, J, B, partial, pind);
  return cudaGetLastError();
}

// ---- the row-major modes: X (Mpad, N) in natural individual order, eps
// (C, N), no lane mask.  Two element types: dense f32 rows, already
// standardized (pallas_jacobi_t.py:_decoders' dense branch: no decode, no
// fold), and int8 genotype codes {0, 1, 2, 3} (the int8 branch,
// pallas_jacobi_t.py:287-298), one byte per genotype, whose dot runs in
// the code domain and is folded by the solve like the 2-bit words'
// (marker_r), or, in the serial in-kernel decode (Q), is decoded to
// x = (c - mean)*scale, 0 for code 3, before the dot and the apply
// (pallas_sweep.py:_decode_tile).  A dot CTA takes the rows of one block
// over kDenseTile columns of f32 (kDenseCols a thread) or kInt8Tile of
// codes (kInt8Cols a thread).

constexpr int kDenseCols = 4;                         // columns per thread
constexpr int kDenseTile = kDotThreads * kDenseCols;  // columns per dot CTA
constexpr int kDenseApplyTile = 512;                  // apply entries/tile
constexpr int kApplyBatch = 32;   // int8 apply: rows of loads in flight
constexpr int kDenseTilePerLane = kDenseApplyTile / kApplyThreads;

// Exact float of the int8 code in byte k of w (codes 0..3, any byte
// 0..255): PRMT puts the byte under the exponent of 2^23, one FADD takes
// 2^23 off -- in place of an I2F, which issues at a quarter of the FP32
// rate on sm_90.
__device__ __forceinline__ float code8_f(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, kMagicBits, 0x7440u | k)) - kMagic;
}

__device__ __forceinline__ float elem_f(float v) { return v; }
__device__ __forceinline__ float elem_f(int8_t v) {
  return code8_f((uint8_t)v, 0);
}

// The kDenseCols columns of this thread in the tile at column n0, 0 at
// n >= N.  V4 (N % 4 == 0 and 16-byte aligned bases, so every row is
// aligned): one float4, columns n0 + 4t .. +3.  Otherwise columns
// n0 + t + 128k: each warp load is one 128-byte line at any alignment.
template <bool V4>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          long long n0, int N,
                                          float (&v)[kDenseCols]) {
  const int t = threadIdx.x;
  if constexpr (V4) {
    const long long n = n0 + 4 * t;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) q = __ldg(reinterpret_cast<const float4*>(row + n));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kDenseCols; ++k) {
      const long long n = n0 + t + (long long)kDotThreads * k;
      v[k] = n < N ? __ldg(row + n) : 0.f;
    }
  }
}

// ---- the int8 dot: 16 codes of a row a thread (one 16-byte load), so a
// dot CTA takes kInt8Tile columns of the rows of one block, as the 2-bit
// dot takes 16 codes a word: the same loads a thread and the same decode
// and FMA a code, at four times the bytes.

constexpr int kInt8Cols = 16;                         // codes per thread
constexpr int kInt8Tile = kDotThreads * kInt8Cols;    // columns per dot CTA

// The 16 codes of this thread in a row of the tile at column n0 (0 at
// n >= N), byte k of word q the column of e[4q + k] (load_eps_int8).  V
// (N % 16 == 0 and 16-byte aligned bases): one uint4, columns n0 + 16t ..
// +15.  Otherwise columns n0 + t + 128(4q + k), a byte load each.
template <bool V>
__device__ __forceinline__ uint4 load_codes16(const int8_t* __restrict__ row,
                                              long long n0, int N) {
  const int t = threadIdx.x;
  if constexpr (V) {
    const long long n = n0 + 16 * t;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) q = __ldg(reinterpret_cast<const uint4*>(row + n));
    return q;
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long n = n0 + t + (long long)kDotThreads * (4 * q + k);
        const uint32_t b = n < N ? (uint8_t)__ldg(row + n) : 0u;
        w[q] |= b << (8 * k);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The eps of the same 16 columns, 0 at n >= N.
template <bool V>
__device__ __forceinline__ void load_eps_int8(const float* __restrict__ e,
                                              long long n0, int N,
                                              float (&v)[kInt8Cols]) {
  const int t = threadIdx.x;
  if constexpr (V) {
    const long long n = n0 + 16 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) f = __ldg(reinterpret_cast<const float4*>(e + n) + q);
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kInt8Cols; ++j) {
      const long long n = n0 + t + (long long)kDotThreads * j;
      v[j] = n < N ? __ldg(e + n) : 0.f;
    }
  }
}

// Whether the rows and eps allow vector loads: 16-byte aligned bases and
// rows (N a multiple of 4 f32 values or 16 int8 codes).
template <typename T>
inline bool rows_v4(const T* X, const void* eps, int N) {
  return N % (16 / sizeof(T)) == 0 &&
         ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(eps))
          & 15u) == 0;
}

// The dense dot of one CTA: red[c][warp][lane] = the warp's share of row
// `lane` . eps_c over tile blockIdx.x, for the nrow rows of X from row0
// (rows >= nrow read as 0) and the C chains of eps.  The rows stay in
// registers for all chains; each row's kDenseCols products sum by fmaf in
// column order, then warp_transpose_sum, so every chain of a fused sweep
// sums as a single chain does.
template <bool V4>
__device__ __forceinline__ void dense_dot_tile(
    const float* __restrict__ X, int N, long long row0, int nrow,
    const float* __restrict__ eps, int C,
    float (*red)[kDotThreads / 32][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n0 = (long long)blockIdx.x * kDenseTile;
  float x[kMaxB][kDenseCols];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    if (i < nrow) {
      load_cols<V4>(X + (row0 + i) * N, n0, N, x[i]);
    } else {
#pragma unroll
      for (int k = 0; k < kDenseCols; ++k) x[i][k] = 0.f;
    }
  }
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    float e[kDenseCols], acc[kMaxB];
    load_cols<V4>(eps + (long long)c * N, n0, N, e);
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kDenseCols; ++k) s = fmaf(x[i][k], e[k], s);
      acc[i] = s;
    }
    red[c][warp][lane] = warp_transpose_sum(acc, lane);
  }
}

// The int8 dot of one CTA: red[c][warp][lane] = the warp's share of code
// row `lane` . eps_c over tile blockIdx.x (kInt8Tile columns), for the nrow
// rows from row0 and the C chains of eps, and with red_e (the fold mode)
// red_e[c][warp] = the warp's share of sum(eps_c).  The rows stay in
// registers as codes, 16 a thread; each chain decodes them again
// (code8_f), the same instructions for every chain, and each row's 16
// products sum by fmaf in column order, then warp_transpose_sum, so every
// chain of a fused sweep sums as a single chain does.
template <bool V>
__device__ __forceinline__ void int8_dot_tile(
    const int8_t* __restrict__ X, int N, long long row0, int nrow,
    const float* __restrict__ eps, int C,
    float (*red)[kDotThreads / 32][32], float (*red_e)[kDotThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n0 = (long long)blockIdx.x * kInt8Tile;
  uint4 w[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i)
    w[i] = i < nrow ? load_codes16<V>(X + (row0 + i) * N, n0, N)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    // the decode is the same for every chain: keep the compiler from
    // hoisting all 32*16 decoded codes out of this loop (they spill)
#pragma unroll
    for (int i = 0; i < kMaxB; ++i)
      asm volatile("" : "+r"(w[i].x), "+r"(w[i].y), "+r"(w[i].z),
                   "+r"(w[i].w));
    float e[kInt8Cols], acc[kMaxB];
    load_eps_int8<V>(eps + (long long)c * N, n0, N, e);
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      const uint32_t wq[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s = fmaf(code8_f(wq[q], k), e[4 * q + k], s);
      }
      acc[i] = s;
    }
    red[c][warp][lane] = warp_transpose_sum(acc, lane);
    if (red_e != nullptr) {
      float es = e[0];
#pragma unroll
      for (int k = 1; k < kInt8Cols; ++k) es += e[k];
      es = warp_sum(es);
      if (lane == 0) red_e[c][warp] = es;
    }
  }
}

// Each chain's CTA sum in the packed dots' fixed order (warps 0, 1, ...)
// into partial[(c*nsplit + blockIdx.x)*width + col0 + l], l < nrow; with
// red_e, also its sum(eps) into the last column, width - 1.
__device__ __forceinline__ void dense_dot_store(
    float (*red)[kDotThreads / 32][32], float (*red_e)[kDotThreads / 32],
    int C, float* __restrict__ partial, int nsplit, int width, int col0,
    int nrow) {
  __syncthreads();
  for (int o = threadIdx.x; o < C * 32; o += kDotThreads) {
    const int c = o >> 5, l = o & 31;
    float* out = partial + ((long long)c * nsplit + blockIdx.x) * width;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDotThreads / 32; ++q) t += red[c][q][l];
    if (l < nrow) out[col0 + l] = t;
    if (red_e != nullptr && l == 0) {
      float te = 0.f;
#pragma unroll
      for (int q = 0; q < kDotThreads / 32; ++q) te += red_e[c][q];
      out[width - 1] = te;
    }
  }
}

// The strided sweeps' row dot: CTA (tile, j) takes block j*nr +
// rho[round] of the round for C <= CMAX chains, into (C, nsplit, J*B + 1)
// partials: dense f32 rows (dense_dot_tile) leave the sum(eps) column
// unwritten (dense r needs none); int8 codes (int8_dot_tile) are folded by
// the solve, and the CTAs of j = 0 write it.  V: vector loads (rows_v4).
template <bool V, int CMAX, typename T>
__global__ void __launch_bounds__(kDotThreads)
dense_dot_kernel(const T* __restrict__ X, int N,
                 const float* __restrict__ eps, int C,
                 const int* __restrict__ rho, int round, int nr, int J, int B,
                 float* __restrict__ partial, int nsplit) {
  __shared__ float red[CMAX][kDotThreads / 32][32];
  const int j = blockIdx.y;
  const long long row0 = (long long)(j * nr + rho[round]) * B;
  if constexpr (sizeof(T) == 1) {
    __shared__ float red_e[CMAX][kDotThreads / 32];
    int8_dot_tile<V>(X, N, row0, B, eps, C, red, red_e);
    dense_dot_store(red, j == 0 ? red_e : nullptr, C, partial, nsplit,
                    J * B + 1, j * B, B);
  } else {
    dense_dot_tile<V>(X, N, row0, B, eps, C, red);
    dense_dot_store(red, nullptr, C, partial, nsplit, J * B + 1, j * B, B);
  }
}

// Launch dense_dot_kernel with vector loads where rows_v4 allows them.
template <int CMAX, typename T>
inline void launch_row_dot(dim3 grid, cudaStream_t s, const T* X, int N,
                           const float* eps, int C, const int* rho, int round,
                           int nr, int J, int B, float* partial, int nsplit) {
  if (rows_v4(X, eps, N))
    dense_dot_kernel<true, CMAX, T><<<grid, kDotThreads, 0, s>>>(
        X, N, eps, C, rho, round, nr, J, B, partial, nsplit);
  else
    dense_dot_kernel<false, CMAX, T><<<grid, kDotThreads, 0, s>>>(
        X, N, eps, C, rho, round, nr, J, B, partial, nsplit);
}

// The operands of a row apply (row_apply_kernel).  eps_c -= sum_t d[c, t]
// * x_t over the entries e < JB of the (C, JB) deltas dsc whose row moved
// in any chain, in index order, row_t = ((e / B)*nr + slab)*B + e % B with
// slab = slab_at[at] (a strided round's rows), or with nr == 0 row_t =
// slab_at[at + e / B]*B + e % B (the blocks of a serial or row-layout
// round, listed from slab_at[at]).  The int8 fold mode also takes off each
// chain's d.(m*s) of the round, the sum of dms (C, JB / B) in block order,
// and with esum (C,) not null (the serial sweeps' tracked sum(eps)) CTA 0
// carries it to the next round: esum - the sum of espart (C, JB / B) in
// block order.  The in-kernel decode (Q) decodes each row with its mean
// and scale.
struct RowApply {
  const void* X; int N; float* eps; int C;
  const int* slab_at; int at; int nr; int B; int JB;
  const float* dsc; const float* dms;
  const float* mean; const float* scale;
  float* esum; const float* espart;
};

// One staged row's products into a row apply's accumulators: xv its L
// values (decoded with the row's mean and scale in the in-kernel decode,
// Q), vals4 the staged rows' d of every chain.
template <int CB, int CV, bool Q, int L>
__device__ __forceinline__ void apply_row(float (&acc)[CB][L],
                                          float (&xv)[L],
                                          const float4* vals4, int t,
                                          const float* rmean,
                                          const float* rscale) {
  if constexpr (Q) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      xv[k] = xv[k] == 3.f ? 0.f : (xv[k] - rmean[t]) * rscale[t];
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
          acc[4 * q + i][k] = fmaf(vq[i], xv[k], acc[4 * q + i][k]);
      }
    }
  }
}

// Row t of a row apply's entry e (RowApply's two layouts).
__device__ __forceinline__ int apply_row_index(const RowApply& a, int e,
                                               int slab) {
  return (a.nr > 0 ? (e / a.B) * a.nr + slab : a.slab_at[a.at + e / a.B]) *
             a.B + e % a.B;
}

// The sums a row apply takes before its rows: the int8 fold mode's round
// sums of dms over its blocks, in block order, into dms_tot, and CTA 0's
// carry of esum (threads c < C).
template <int CB, bool kFold>
__device__ __forceinline__ void row_apply_sums(const RowApply& a,
                                               float* dms_tot) {
  if constexpr (kFold) {
    const int C = a.C, nblk = a.JB / a.B;
    if (threadIdx.x < C) {
      const int c = threadIdx.x;
      float t = a.dms[c * nblk];
      for (int q = 1; q < nblk; ++q) t += a.dms[c * nblk + q];
      dms_tot[c] = t;
      if (a.esum != nullptr && blockIdx.x == 0) {
        float e = a.espart[c * nblk];
        for (int q = 1; q < nblk; ++q) e += a.espart[c * nblk + q];
        a.esum[c] = a.esum[c] - e;
      }
    }
  }
}

// The direct row apply: a thread takes L columns, so each warp load is one
// 128-byte line of an f32 row (L = 1) or of int8 codes (L = 4, one 32-bit
// word of codes a thread, where N % 4 == 0; else L = 1, 32 bytes a warp
// load).  The moved entries are compacted tile by tile into shared memory
// with every chain's d (0 where that chain did not move, which adds
// exactly 0); then each thread loads its columns of the tile's rows
// itself.  It serves the small rounds (JB < g_ring_rows: a serial block
// of up to 512 rows), where the ring's set-up costs more than it saves,
// the in-kernel decode (Q: the int8 `_q` apply's 32 rows) and rows that
// the copy engine cannot take (not 16-byte aligned).
template <int CB, typename T, bool Q, int L>
__device__ __forceinline__ void row_apply_direct(const RowApply& a) {
  constexpr bool kFold = sizeof(T) == 1 && !Q;
  constexpr int CV = CB < 4 ? 4 : CB;   // chains per staged row (float4s)
  __shared__ float4 vals4[kDenseApplyTile * CV / 4];
  __shared__ int rows[kDenseApplyTile];
  __shared__ float rmean[Q ? kDenseApplyTile : 1];
  __shared__ float rscale[Q ? kDenseApplyTile : 1];
  __shared__ int warp_cnt[kApplyWarps + 1];
  __shared__ float dms_tot[kFold ? CB : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int C = a.C, N = a.N, JB = a.JB;
  const T* X = static_cast<const T*>(a.X);
  row_apply_sums<CB, kFold>(a, dms_tot);
  const int slab = a.nr > 0 ? a.slab_at[a.at] : 0;
  const long long n =
      ((long long)blockIdx.x * kApplyThreads + threadIdx.x) * L;
  const bool live = n < N;
  const T* xp = X + (live ? n : 0);
  float acc[CB][L];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[c][k] = 0.f;

  for (int tile0 = 0; tile0 < JB; tile0 += kDenseApplyTile) {
    // warp `warp` owns the tile's entries [lo, lo + 32*kDenseTilePerLane)
    const int lo = tile0 + warp * 32 * kDenseTilePerLane;
    bool nz[kDenseTilePerLane];
    int cnt = 0;
#pragma unroll
    for (int it = 0; it < kDenseTilePerLane; ++it) {
      const int e = lo + it * 32 + lane;
      bool f = false;
      if (e < JB) {
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) f |= __ldg(a.dsc + (long long)c * JB + e) != 0.f;
      }
      nz[it] = f;
      cnt += __popc(__ballot_sync(kFull, f));
    }
    if (lane == 0) warp_cnt[warp] = cnt;
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
    for (int it = 0; it < kDenseTilePerLane; ++it) {
      const unsigned mask = __ballot_sync(kFull, nz[it]);
      if (nz[it]) {
        const int to = pos + __popc(mask & ((1u << lane) - 1u));
        const int e = lo + it * 32 + lane;
        const int row = apply_row_index(a, e, slab);
        rows[to] = row;
        if constexpr (Q) {
          rmean[to] = __ldg(a.mean + row);
          rscale[to] = __ldg(a.scale + row);
        }
        float* v = reinterpret_cast<float*>(vals4) + to * CV;
#pragma unroll
        for (int c = 0; c < CV; ++c)
          v[c] = c < C ? __ldg(a.dsc + (long long)c * JB + e) : 0.f;
      }
      pos += __popc(mask);
    }
    __syncthreads();
    const int nnz = warp_cnt[kApplyWarps];
    if (live) {
      if constexpr (L == 1) {
#pragma unroll 16
        for (int t = 0; t < nnz; ++t) {
          float xv[1] = {elem_f(__ldg(xp + (long long)rows[t] * N))};
          apply_row<CB, CV, Q>(acc, xv, vals4, t, rmean, rscale);
        }
      } else {
        // codes: kApplyBatch rows' words loaded before any is used, so a
        // thread keeps that many loads in flight
        for (int t0 = 0; t0 < nnz; t0 += kApplyBatch) {
          uint32_t w[kApplyBatch];
#pragma unroll
          for (int j = 0; j < kApplyBatch; ++j)
            w[j] = t0 + j < nnz
                       ? __ldg(reinterpret_cast<const unsigned int*>(
                             xp + (long long)rows[t0 + j] * N))
                       : 0u;
#pragma unroll
          for (int j = 0; j < kApplyBatch; ++j) {
            if (t0 + j < nnz) {
              float xv[L];
#pragma unroll
              for (int k = 0; k < L; ++k) xv[k] = code8_f(w[j], k);
              apply_row<CB, CV, Q>(acc, xv, vals4, t0 + j, rmean, rscale);
            }
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites rows and vals
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < C) {
      float* ep = a.eps + c * (long long)N + n;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if constexpr (kFold) ep[k] = ep[k] - (acc[c][k] - dms_tot[c]);
        else ep[k] = ep[k] - acc[c][k];
      }
    }
  }
}

// ---- the ring row apply (row_apply_ring): a CTA takes one 256-byte
// segment of every row, kRowRingWords 4-byte words (64 f32 columns, or 256
// int8 codes at L = 4), a consumer thread a word.  Every warp first marks
// the round's moved entries in a bitmask; then its compactor warp
// compacts them a tile of kRowRingTile at a time, in index order, into
// one of two buffers (the moved rows and every chain's d) while the
// consumers work through the other; kRowRingIssuers issuer warps stream
// the moved rows' segments into a ring of kRowRingStages stages of
// kRowRingRows rows by cp.async.bulk, stage s issued by warp s mod
// kRowRingIssuers, one full / empty mbarrier pair a stage.  So the loads
// never wait for a compaction, and the copies do not queue behind one
// warp: a warp's cp.async.bulk of 32 lanes issues its copies one after
// another, and one issuer warp held a CTA to one 256-byte row about
// every 75 cycles (1.6 TB/s at the dense cell on an NVIDIA H100 80GB
// HBM3, 700 W, PERF.md §6).
constexpr int kRowRingWords = 64;                   // words of a row a CTA
constexpr int kRowRingWarps = kRowRingWords / 32;   // consumer warps
constexpr int kRowRingIssuers = 4;                  // warps issuing copies
constexpr int kRowRingThreads =                     // and the compactor
    kRowRingWords + 32 * (1 + kRowRingIssuers);
constexpr int kRowRingRows = 32;                    // rows a stage: a lane each
constexpr int kRowRingStages = 6;                   // stages of the ring
constexpr int kRowRingTile = 256;                   // entries a compacted tile
constexpr int kRowRingMinRows = 1024;               // JB below it: direct
constexpr int kRowRingMaxRows = 16384;              // JB above it: direct

// The smallest round (JB entries) that takes the ring; the C interface of
// each library sets it (<lib>_row_apply_ring_rows), so that a test can
// hold the two paths against each other.
int g_ring_rows = kRowRingMinRows;

// Set g_ring_rows to `rows` (rows < 0: leave it); returns the old value.
inline int set_ring_rows(int rows) {
  const int old = g_ring_rows;
  if (rows >= 0) g_ring_rows = rows;
  return old;
}

// Dynamic shared memory of the ring apply for CV staged chains: the ring,
// then two tiles of rows and values.
inline size_t row_ring_smem(int CV) {
  return sizeof(uint32_t) * kRowRingStages * kRowRingRows * kRowRingWords +
         2 * kRowRingTile * (sizeof(float) * CV + sizeof(int));
}

template <int CB, typename T, bool Q, int L>
__device__ __forceinline__ void row_apply_ring(const RowApply& a) {
  static_assert(L * sizeof(T) == 4, "a consumer thread takes a 4-byte word");
  static_assert(!Q, "the in-kernel decode takes the direct path");
  constexpr bool kFold = sizeof(T) == 1;
  constexpr int CV = CB < 4 ? 4 : CB;   // chains per staged row (float4s)
  constexpr int kTileLane = kRowRingTile / 32;   // entries a lane a tile
  extern __shared__ __align__(128) uint32_t dyn[];
  uint32_t* ring = dyn;
  float4* vals4 =
      reinterpret_cast<float4*>(dyn + kRowRingStages * kRowRingRows *
                                          kRowRingWords);
  int* rows = reinterpret_cast<int*>(vals4 + 2 * kRowRingTile * CV / 4);
  __shared__ uint64_t full[kRowRingStages], empty[kRowRingStages];
  __shared__ uint64_t ready[2], freed[2];   // a tile's buffer filled / done
  __shared__ int nnz[2];
  __shared__ float dms_tot[kFold ? CB : 1];
  __shared__ uint32_t moved[kRowRingMaxRows / 32];   // bit: entry moved
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int C = a.C, N = a.N, JB = a.JB;
  const int ntiles = (JB + kRowRingTile - 1) / kRowRingTile;
  const long long n0 = (long long)blockIdx.x * kRowRingWords * L;
  row_apply_sums<CB, kFold>(a, dms_tot);
  // which entries moved in some chain, by every warp at once (8 loads a
  // chain in flight a thread), so that the compactor's tiles load only
  // the d of the rows that moved: one warp alone paid a load latency a
  // tile, which a round with few moved rows (BayesR) could not hide
  for (int base = 0; base < JB; base += 8 * kRowRingThreads) {
    bool f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = base + k * kRowRingThreads + threadIdx.x;
      f[k] = false;
      if (e < JB) {
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) f[k] |= __ldg(a.dsc + (long long)c * JB + e) != 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned b = __ballot_sync(kFull, f[k]);
      const int e0 = base + k * kRowRingThreads + warp * 32;
      if (lane == 0 && e0 < JB) moved[e0 / 32] = b;
    }
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < kRowRingStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kRowRingWarps);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&ready[q], 1);
      mbar_init(&freed[q], kRowRingWarps + kRowRingIssuers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp > kRowRingWarps) {
    // ---- an issuer: the copies of its stages, tile by tile
    const int me = warp - kRowRingWarps - 1;
    const T* X = static_cast<const T*>(a.X);
    const uint32_t bytes = static_cast<uint32_t>(
        min((long long)kRowRingWords * L, N - n0) * sizeof(T));
    int stage = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      mbar_wait(&ready[b], (t >> 1) & 1);
      const int n = nnz[b];
      const int* rw = rows + b * kRowRingTile;
      for (int r0 = 0; r0 < n; r0 += kRowRingRows, ++stage) {
        if (stage % kRowRingIssuers != me) continue;
        const int slot = stage % kRowRingStages;
        if (stage >= kRowRingStages)
          mbar_wait(&empty[slot], (stage / kRowRingStages - 1) & 1);
        const int nrow = min(kRowRingRows, n - r0);
        if (lane == 0) mbar_arrive_expect(&full[slot], bytes * nrow);
        __syncwarp();
        if (lane < nrow)
          bulk_load(ring + (slot * kRowRingRows + lane) * kRowRingWords,
                    X + (long long)rw[r0 + lane] * N + n0, bytes,
                    &full[slot]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&freed[b]);
    }
    return;
  }
  if (warp == kRowRingWarps) {
    // ---- the compactor
    const int slab = a.nr > 0 ? a.slab_at[a.at] : 0;
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      if (t >= 2) mbar_wait(&freed[b], ((t >> 1) - 1) & 1);
      int* rw = rows + b * kRowRingTile;
      float* vl = reinterpret_cast<float*>(vals4) + b * kRowRingTile * CV;
      int n = 0;
#pragma unroll
      for (int it = 0; it < kTileLane; ++it) {
        const int w = t * kTileLane + it;
        const unsigned mask = w * 32 < JB ? moved[w] : 0u;
        if ((mask >> lane) & 1u) {
          const int to = n + __popc(mask & ((1u << lane) - 1u));
          const int e = t * kRowRingTile + it * 32 + lane;
          const int row = apply_row_index(a, e, slab);
          rw[to] = row;
#pragma unroll
          for (int c = 0; c < CV; ++c)
            vl[to * CV + c] =
                c < C ? __ldg(a.dsc + (long long)c * JB + e) : 0.f;
        }
        n += __popc(mask);
      }
      if (lane == 0) nnz[b] = n;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[b]);
    }
    return;
  }

  // ---- the consumers: thread i owns word i of the segment, columns
  // n .. n + L - 1; its eps are read before the first row lands
  const long long n = n0 + (long long)threadIdx.x * L;
  const bool live = n < N;
  constexpr bool kPre = CB * L <= 8;
  float acc[CB][L], ev[kPre ? CB : 1][L];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[c][k] = 0.f;
  if constexpr (kPre) {
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int k = 0; k < L; ++k)
        ev[c][k] = live && c < C ? a.eps[c * (long long)N + n + k] : 0.f;
  }
  int stage = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    mbar_wait(&ready[b], (t >> 1) & 1);
    const int cnt = nnz[b];
    const float4* vt = vals4 + b * kRowRingTile * (CV / 4);
    for (int r0 = 0; r0 < cnt; r0 += kRowRingRows, ++stage) {
      const int slot = stage % kRowRingStages;
      mbar_wait(&full[slot], (stage / kRowRingStages) & 1);
      const uint32_t* sw =
          ring + slot * kRowRingRows * kRowRingWords + threadIdx.x;
      const int nrow = min(kRowRingRows, cnt - r0);
      const auto row = [&](int q) {
        const uint32_t w = sw[q * kRowRingWords];
        float xv[L];
        if constexpr (sizeof(T) == 1) {
#pragma unroll
          for (int k = 0; k < L; ++k) xv[k] = code8_f(w, k);
        } else {
          xv[0] = __uint_as_float(w);
        }
        apply_row<CB, CV, false>(acc, xv, vt, r0 + q, nullptr, nullptr);
      };
      if (sizeof(T) == 4 && CB <= 2 && nrow == kRowRingRows) {
        // a full stage of f32 rows for one or two chains: unrolled, the
        // rows' loads are issued ahead of the FMA chains (int8 codes and
        // more chains have the work a row to hide them)
#pragma unroll
        for (int q = 0; q < kRowRingRows; ++q) row(q);
      } else {
#pragma unroll 4
        for (int q = 0; q < nrow; ++q) row(q);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[b]);
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < C) {
      float* ep = a.eps + c * (long long)N + n;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        float e0;
        if constexpr (kPre) e0 = ev[c][k];
        else e0 = ep[k];
        if constexpr (kFold) ep[k] = e0 - (acc[c][k] - dms_tot[c]);
        else ep[k] = e0 - acc[c][k];
      }
    }
  }
}

// The row apply, one launch a round: the ring (RING) or the direct path.
// Every column sums its rows in the same order on either path, whatever
// L, CB and C, so the two give the same bits.  CB >= C, a power of two:
// the per-chain accumulators stay in registers.
template <int CB, typename T, bool Q, int L, bool RING>
__global__ void __launch_bounds__(RING ? kRowRingThreads : kApplyThreads)
row_apply_kernel(RowApply a) {
  static_assert(!Q || CB == 1, "the in-kernel decode runs one chain");
  static_assert(L == 1 || sizeof(T) == 1, "several columns: int8 codes");
  if constexpr (RING) row_apply_ring<CB, T, Q, L>(a);
  else row_apply_direct<CB, T, Q, L>(a);
}

// Launch the row apply of columns L a thread (the ring's words: L f32
// columns or codes) for a.C chains with the smallest CB >= C.
template <typename T, bool Q, int L, bool RING>
inline void launch_row_apply_cols(const RowApply& a, cudaStream_t s) {
  const int per = (RING ? kRowRingWords : kApplyThreads) * L;
  const int ctas = (a.N + per - 1) / per;
#define JT_ROW_APPLY(CB)                                                  \
  do {                                                                    \
    if constexpr (RING) {                                                 \
      const size_t smem = row_ring_smem(CB < 4 ? 4 : CB);                \
      cudaFuncSetAttribute(row_apply_kernel<CB, T, Q, L, true>,           \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                           (int)smem);                                    \
      row_apply_kernel<CB, T, Q, L, true><<<ctas, kRowRingThreads, smem, s>>>( \
          a);                                                             \
    } else {                                                              \
      row_apply_kernel<CB, T, Q, L, false><<<ctas, kApplyThreads, 0, s>>>( \
          a);                                                             \
    }                                                                     \
  } while (0)
  if constexpr (Q) {
    JT_ROW_APPLY(1);
  } else {
    if (a.C <= 1) JT_ROW_APPLY(1);
    else if (a.C <= 2) JT_ROW_APPLY(2);
    else if (a.C <= 4) JT_ROW_APPLY(4);
    else if (a.C <= 8) JT_ROW_APPLY(8);
    else JT_ROW_APPLY(16);
  }
#undef JT_ROW_APPLY
}

// Launch the row apply for a.C chains: dense f32 rows (T float), int8
// codes in the fold mode, or with Q the in-kernel decode (one chain).  The
// ring takes the fold and dense rounds of g_ring_rows to kRowRingMaxRows
// entries whose rows the copy engine can take (16-byte aligned: N a
// multiple of 4 f32 values or 16 codes); the direct path the others (the
// in-kernel decode's rounds: its blocks are small, B = 32 at the auto
// plan), int8 codes 4 columns a thread where N % 4 == 0 and the codes are
// 4-byte aligned, else 1.
template <typename T, bool Q = false>
inline void launch_row_apply(const RowApply& a, cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.X);
  const bool ring = !Q && a.JB >= g_ring_rows && a.JB <= kRowRingMaxRows &&
                    a.N % (16 / sizeof(T)) == 0 && base % 16 == 0;
  if constexpr (sizeof(T) == 1) {
    if constexpr (!Q) {
      if (ring) {
        launch_row_apply_cols<T, Q, 4, true>(a, s);
        return;
      }
    }
    if (a.N % 4 == 0 && base % 4 == 0)
      launch_row_apply_cols<T, Q, 4, false>(a, s);
    else launch_row_apply_cols<T, Q, 1, false>(a, s);
  } else {
    if (ring) launch_row_apply_cols<T, Q, 1, true>(a, s);
    else launch_row_apply_cols<T, Q, 1, false>(a, s);
  }
}

// The BayesR categorical draw of one marker (pallas_sweep.py:246-264):
// the K components' tables lp, invd and sd (spike first, lp the log-prior
// term), num = r + beta_old*xsq.  The reference's overflow guard zeroes a
// component's weight when any slab logL is more than 700 from its own;
// the first k with p <= the cumulative weight wins, and no hit keeps
// beta_old.  Returns d = ok*(beta_new - beta_old); krec is the hit's
// component, or -1 (no hit, or an invalid marker).  Every solve calls
// this one function, so they round alike.
template <int K>
__device__ __forceinline__ float categorical_draw(
    const float* lp, const float* invd, const float* sd, float num,
    float half_invsE, float p, float z, float bold, float okf, int& krec) {
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
    ksel = (p <= acum && ksel == K) ? k : ksel;
  }
  const bool hit = ksel < K;
  float mu_sel = 0.f, sd_sel = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mu_sel = k == ksel ? muk[k] : mu_sel;
    sd_sel = k == ksel ? sd[k] : sd_sel;
  }
  const float beta_new = hit ? mu_sel + sd_sel * z : bold;
  krec = (okf > 0.f && hit) ? ksel : -1;
  return okf * (beta_new - bold);
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
  const float* pind;   // the miss mode's indicator partials, else null
};

// r of marker `lane` of block j in the code domain: the per-CTA partials
// of C.eps summed in a fixed order (q = 0, 1, ...) and, in the miss mode
// (pind not null), the (mean - 3)-scaled dot of the missing indicator
// added to it, dot_c + dot_ind*(m - 3) (pallas_jacobi_t.py:_make_dots,
// :381-393): every missing call counts as the marker's mean, so the fold
// algebra that follows standardizes it to 0.
__device__ __forceinline__ float code_dot(const float* partial,
                                          const float* pind, int nsplit,
                                          int JB, int j, int B, int lane,
                                          float mean) {
  float rc = 0.f;
  const float* pr = partial + j * B + lane;
#pragma unroll 8
  for (int q = 0; q < nsplit; ++q) rc += pr[(long long)q * (JB + 1)];
  if (pind != nullptr) {
    float ri = 0.f;
    const float* pi = pind + j * B + lane;
#pragma unroll 8
    for (int q = 0; q < nsplit; ++q) ri += pi[(long long)q * JB];
    rc = rc + ri * (mean - 3.f);
  }
  return rc;
}

// sum(eps) of a fold-mode round from the dot's last partial column, over
// the CTAs q = lane mod 32, then the warp; 0 in the dense mode (scale
// null), which reads no sum.
__device__ __forceinline__ float fold_esum(const float* partial, int nsplit,
                                           int JB1, const float* scale,
                                           int lane) {
  if (scale == nullptr) return 0.f;
  float esum = 0.f;
  for (int q = lane; q < nsplit; q += 32)
    esum += partial[(long long)q * JB1 + JB1 - 1];
  return warp_sum(esum);
}

// r of marker m (lane `lane` of block j) from the dot's partials, with
// its scale sc and mean*scale ms (the apply's d*scale and d.(m*s) terms).
// Fold modes: r = s*(code_dot) - (m*s)*sum(eps).  The dense mode (mean and
// scale null): r is the dot itself, sc = 1 and ms = 0; the fold algebra
// with scale 1 and mean 0 would give the same bits (rc*1 is rc, and
// rc - 0*sum(eps) is rc), so it is skipped.
__device__ __forceinline__ float marker_r(const float* partial,
                                          const float* pind, int nsplit,
                                          int JB, int j, int B, int lane,
                                          const float* mean,
                                          const float* scale, long long m,
                                          float esum, float& sc, float& ms) {
  if (scale == nullptr) {
    sc = 1.f;
    ms = 0.f;
    return code_dot(partial, nullptr, nsplit, JB, j, B, lane, 0.f);
  }
  const float rc = code_dot(partial, pind, nsplit, JB, j, B, lane, mean[m]);
  sc = scale[m];
  ms = mean[m] * sc;
  return rc * sc - ms * esum;
}

// The BayesR solve of block j of the round, run by one warp (lane l owns
// marker l).  K, the number of mixture components, is a template argument
// so the selection below is straight-line code.
template <int K>
__device__ __forceinline__ void solve_block(const SolveArgs& a, int j) {
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
  const float esum = fold_esum(a.partial, a.nsplit, JB1, a.scale, lane);
  const float sE = *a.sigmaE;
  const float half_invsE = 0.5f / sE;

  float r = 0.f, sc = 0.f, ms = 0.f, xs = 0.f, bold = 0.f, okf = 0.f;
  float pl = 0.f, zl = 0.f;
  int lab = 0, g = 0, inn = 0;
  float lp[K], invd[K], sd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) { lp[k] = 0.f; invd[k] = 0.f; sd[k] = 0.f; }
  if (act) {
    r = marker_r(a.partial, a.pind, a.nsplit, a.J * B, j, B, lane, a.mean,
                 a.scale, m, esum, sc, ms);
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
      d = categorical_draw<K>(lp, invd, sd, r + bold * xs, half_invsE, pt,
                              zt, bold, okf, krec);
      d_own = d;
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
  const float* pind;   // the miss mode's indicator partials, else null
};

// The horseshoe's solve of block j (pallas_jacobi_t.py:_hs_jacobi_t_kernel,
// :722-774): solve_block's warp-per-block layout, fold algebra, broadcast of
// the visited marker and canonical z index, with a conjugate normal draw in
// place of the component selection.  Per-lane constants in the op order of
// the TPU kernel's operand table (build_pkgT_hs_strided, :155-173):
//   s_j = tau*c2*lam / (tau*lam + c2), denom = xsq + sE/s_j,
//   invd = 1/denom, sd = sqrt(sE/denom);
// per step beta_new = num*invd + sd*z with num = r + beta_old*xsq.
__device__ __forceinline__ void hs_solve_block(const HsSolveArgs& a, int j) {
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

  const float esum = fold_esum(a.partial, a.nsplit, JB1, a.scale, lane);

  float r = 0.f, sc = 0.f, ms = 0.f, xs = 0.f, bold = 0.f, okf = 0.f;
  float zl = 0.f, invd = 0.f, sd = 0.f;
  int inn = 0;
  if (act) {
    r = marker_r(a.partial, a.pind, a.nsplit, a.J * B, j, B, lane, a.mean,
                 a.scale, m, esum, sc, ms);
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

}  // namespace
