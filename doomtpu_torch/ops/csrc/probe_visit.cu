// Hopper probes P1-P3: the price of one construct of K1-K3's loops on
// this card, and whether a one-hot product on the tensor cores copies
// f32 data exactly.
//
// Replaces scripts/probe_visit_cost.py: `run` (:31) and its 17 construct
// kernels (P1), `main6.kern` (:301, P2) and `main7.kern` (:350, P3).
// The plain PyTorch versions are in doomtpu_torch/ops/probe_visit.py.
//
// P1 (visit_kernel<C>): construct C repeated n times into an (8, 128)
// accumulator.  A TPU construct works on one (8, 128) vector register; a
// thread here owns one element of it, (s, l) = ((g >> 7) & 7, g & 127)
// for global thread g, so one block of 1024 threads computes the TPU
// kernel's output element for element, and every further 1024 threads a
// copy of it (K1's occupancy, 132 x 4 blocks of 256 threads: the price
// while every SM holds 32 warps, as under K1).  The tensor-core
// constructs (mma_kernel<C, STAGED, V>) give a warp a 32-lane group of
// all 8 rows instead, a copy per 128 threads; their two launch shapes
// hold 2 copies an SM, the yardstick of their bound: one block of 256
// threads, and one such block on every SM.  Each construct is the one
// that plays the TPU construct's part on Hopper:
//
//   math          32 chained (a*3)^(a>>1) in registers
//   branch(_f)    a warp-uniform `if` (a __any_sync vote) that fires every
//                 other iteration / never; body a shared-memory
//                 read-modify-write
//   branch_div    the same `if` taken by half the lanes of each warp
//   relayout      a read of the thread's element of an 8-value row of a
//                 shared-memory table, at row i & 63
//   dynload       a load at the dynamic row ((i*37) & 63) * 8 + s of a
//                 (512, 128) table: 256 KB, above the 227 KB of shared
//                 memory a block may use, so it is read through L1
//   gather_l2     a dependent load from a 4 MB table (resident in L2, as
//                 K1's texel, flat and sky tables are) at an index hashed
//                 from the accumulator; each copy starts its own chains
//   smem          8 uniform reads of an (8, 64) global table and a select
//                 chain
//   fori0         a rolled loop whose runtime bounds give 0 trips
//   colbcast13    one row load into shared memory, then 13 field reads of
//                 it (K1's row[R_*])
//   lanegather13  a warp loads 32 words of its row; 13 __shfl_sync
//                 broadcasts
//   mxu*          one-hot products through mma.sync m16n8k8 TF32
//   branchy_*     a branch that consumes 13 fields, from mma.sync / from
//                 plain loads
//   fdiv/fmulrcp  8 chained __fdiv_rn / __fmul_rn by the reciprocal a
//                 step (K1 divides per row, paint.cu:56-60)
//
// Why mma.sync m16n8k8 and not wgmma: the TPU probe asks what one field
// broadcast through the matrix unit costs inside a per-column loop, and
// whether its result is exact.  That is one warp's product at a time, in
// registers, inside a thread's loop; wgmma is a 64-row warpgroup tile fed
// from shared memory, for large products.  Each (8, K) x (K, 128) field
// product runs transposed, out^T = S^T w^T (exact_kernel's form): the
// selector is A, its 16-lane m-tiles fill M, w's 8 rows fill N = 8, so
// no row is padding, and a warp's two m-tiles share w's fragments.  A
// thread's (b0, b1) of two k-steps are 4 adjacent words of w (`kidx`).
// Each window is loaded and split into its TF32 pieces once an
// iteration, into registers, and serves all 13 products.  The identity
// of mxubcast / mxubcast13 (64 KB; a warp's 32 lanes of it, 128
// registers a thread) stays in registers for the block's life.  The 13
// distinct selectors (832 KB at K = 128, 312 KB at K = 48) fit no SM's
// registers or shared memory, so the occupancy shape gives each block
// one 32-lane group of 8 copies and stages that group's fragments of
// all 13 selectors in shared memory once, 16 bytes a lane a fragment
// (a warp's read of one fragment is 512 contiguous bytes, no bank
// conflict).  8 warps an SM at up to 255 registers a thread; the field
// loop runs two fields side by side (4 or 12 independent mma.sync a
// k-step), and the k-steps are unrolled.  `HIGHEST` splits w into three
// TF32 pieces (hi, mid, lo) with one accumulator each, added with IEEE
// f32 adds at the end: each piece's one-hot product is exact, and so is
// (lo + mid) + hi, so the result is the f32 product on any input.
// Whether one shared accumulator keeps the sum exact is P3's question,
// not P1's.
//
// What bounds it on the card: the operations each construct needs
// (ops/probe_visit.py::NEEDS: its own loads, arithmetic, shuffles and
// branches, and for the mma constructs their useful TF32 FMAs at 1024 a
// clock an SM) over issue and each pipe's rate, except where latency
// rules: gather_l2 (L2), the divide chain.  A staged selector fragment is
// 512 bytes of shared memory, 4 clocks at 128 bytes a clock, for one
// mma.sync (P = 1: mxu13diff) or three (P = 3), so mxu13diff is paced by
// its selector's reads at ~4x its bound and the three-piece constructs
// at ~1.3x; the identity constructs read no operand from memory in the
// loop.  The loop's SASS counted by class is a diagnostic beside it
// (ops/probe_visit.py::construct_sass).
//
// P2 / P3 (exact_kernel<P>): the 8 (8, 128) x (128, 128) one-hot
// products of main6 / main7, out[f] = w S[f], TF32 operands from
// cvt.rna.tf32.f32 (round to nearest, ties away).  P = 1: one pass.
// P = 3: w split into hi, mid and lo pieces, three mma.sync passes
// summed in ONE f32 accumulator (lo, mid, hi each k-step), so the tensor
// core's own accumulate decides the sum.  Output: `copies` (64, 128)
// slices of bit patterns, rows 8f..8f+7 the product with selector f.
//
// What bounds it: bytes.  One copy reads w (4 KB) and S (512 KB) and
// writes 32 KB: 0.17 us at 3.35 TB/s, against 0.004 us of the card's
// TF32 FMAs (P3: 0.013).  What sets its time at one copy: the launch,
// then one product's latency (a 20 KB stage and a chain of 16, P3 48,
// dependent mma.sync).
// The design: each product is transposed, out[f]^T = S[f]^T w^T, so the
// 128 output lanes fill m16n8k8's 16 rows and w's 8 rows its N = 8 (no
// zero padding).  A block of 2 warps takes one selector and 32 lanes (a
// warp one 16-lane m-tile, all of K in one accumulator), so one copy is
// 32 blocks on 32 SMs, each reading 1/32 of S.  A block stages its
// (128, 32) slab of S[f] with 16-byte cp.async into padded shared
// memory; while that is in flight it reads w with 16-byte loads and
// splits it into its TF32 pieces once, into shared memory, permuted so a
// thread's (b0, b1) of a k-step are one conflict-free 8-byte read; one
// barrier, then each warp holds its selector fragments in registers for
// the block's life.  Copies (full-card occupancy: as many layers of 32
// blocks as the card holds at once, each block walking copies z, z +
// layers, ...) run two a warp side by side while two are left, each
// product reading w's fragments from shared memory (volatile loads, so
// the price of a field with its data in shared memory is what a copy
// measures); the output goes out as 16-byte stores through a padded
// tile per warp.  Only copies c < `stored` are written: stored = copies
// is the function, stored = 1 runs every copy's products but writes one
// slice, so the occupancy price can be read with and without the
// output's HBM write (the mma results stay live: whether a copy is
// stored is known only at run time).
//
// Numerics: -fmad=false; every f32 add, multiply and divide is an
// IEEE-rounded intrinsic, as in the plain versions.

#include <algorithm>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#define ROLLED _Pragma("unroll 1")

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 8, LANES = 128, WINDOWS = 64;
constexpr int FIELDS = 13;          // fields a seg visit reads (the probes' 13)
constexpr int CHAIN = 8;            // fdiv / fmulrcp: operations a step
constexpr int GATHER_SHIFT = 12;    // gather_l2: a 2^20-word table
constexpr int MAX_THREADS = 1024;

// the order of ops/probe_visit.py::CONSTRUCTS
enum Construct {
  MATH, BRANCH, BRANCH_F, BRANCH_DIV, RELAYOUT, DYNLOAD, GATHER_L2, SMEM,
  FORI0, COLBCAST13, LANEGATHER13, MXUBCAST, MXUBCAST13, MXU13DIFF,
  MXU13HI, MXU48HI, MXU13CVT, BRANCHY_MXU, BRANCHY_LD, FDIV, FMULRCP,
  N_CONSTRUCTS
};
const char* const NAMES =
    "math,branch,branch_f,branch_div,relayout,dynload,gather_l2,smem,fori0,"
    "colbcast13,lanegather13,mxubcast,mxubcast13,mxu13diff,mxu13hi,mxu48hi,"
    "mxu13cvt,branchy_mxu,branchy_ld,fdiv,fmulrcp";

__host__ __device__ constexpr bool is_mma(int c) {
  return c >= MXUBCAST && c <= BRANCHY_MXU;
}

struct Args {
  const void* x;   // the construct's input
  const void* t;   // its table, selectors or divisors (or null)
  int n;           // iterations
  int arg;         // fori0: the inner loop's trip count (the TPU's 0)
  int* out;        // [copies, 8, 128]
};

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// d += A B, one m16n8k8 TF32 tile: A's fragment a0..a3 is (gr, tq),
// (gr + 8, tq), (gr, tq + 4), (gr + 8, tq + 4); B's b0, b1 (tq, gr),
// (tq + 4, gr); d (gr, 2tq), (gr, 2tq + 1), (gr + 8, 2tq), (gr + 8,
// 2tq + 1), for lane 4gr + tq
__device__ __forceinline__ void mma16(float (&d)[4], uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// an 8-byte shared-memory read that neither compiler may hoist out of a
// loop or merge with another
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// x = hi + mid + lo, each a TF32 value (exact: each difference is)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = tf32(x);
  const float r1 = __fsub_rn(x, __uint_as_float(hi));
  mid = tf32(r1);
  lo = tf32(__fsub_rn(r1, __uint_as_float(mid)));
}

// ---- P1's tensor-core constructs ------------------------------------------
// A warp owns one copy's 32-lane group g (lanes 32g..32g+31: two 16-lane
// m-tiles) of all 8 rows, each field product transposed, out_f^T =
// S_f^T w^T: the lanes fill m16n8k8's M, w's 8 rows its N, no padding.
constexpr int MMA_THREADS = 256;         // a block at most: 8 warps
constexpr int GROUP = 32;                // output lanes a warp
constexpr int GROUPS = LANES / GROUP;    // warps a copy
constexpr int MT = GROUP / 16;           // m-tiles a warp

template <int C>
struct Mma {
  static constexpr int K =
      (C == MXU48HI || C == MXU13CVT || C == BRANCHY_MXU) ? 48 : LANES;
  static constexpr int KK = K / 8;       // k-steps a product
  static constexpr int P =
      (C == MXUBCAST || C == MXUBCAST13 || C == MXU13DIFF) ? 1 : 3;
  static constexpr bool EYE = C == MXUBCAST || C == MXUBCAST13;
  static constexpr bool ADD = C == MXUBCAST13;   // A is w + f, rounded once
  // a lane group's A fragments of every field, 16 bytes a lane each
  static constexpr int SLAB = EYE ? 0 : FIELDS * KK * MT * 32;
};
static_assert(FIELDS % 2 == 1, "fields run in pairs, then the last alone");

__host__ __device__ constexpr bool has_variant(int c) {
  return c == MXU13DIFF || c == MXU13HI;
}

// The k of fragment column q (0-3; column q + 4 is k + 1) in k-step kk:
// a thread's (b0, b1) of k-steps 2h and 2h + 1 are the 4 adjacent words
// w[gr][16h + 4tq ..].  Any bijection onto the k-step pair's 16 k serves
// the product; this one makes w's loads 16 bytes a thread.
__device__ __forceinline__ int kidx(int kk, int q) {
  return 16 * (kk >> 1) + 4 * q + 2 * (kk & 1);
}

// A's fragment (a0, a1, a2, a3) of the m-tile at lanes L..L+15 in k-step
// kk, A[m][k] = sel[k][L + m] for the (K, 128) selector `sel`, cvt.rna
__device__ __forceinline__ uint4 a_frag(const float* sel, int L, int kk,
                                        int lane) {
  const float* p = sel + kidx(kk, lane & 3) * LANES + L + (lane >> 2);
  return make_uint4(tf32(__ldg(p)), tf32(__ldg(p + 8)), tf32(__ldg(p + LANES)),
                    tf32(__ldg(p + LANES + 8)));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// What a warp keeps across its loop: the identity's fragments (mxubcast,
// mxubcast13; in registers for the block's life), the window's fragments
// (V = 0: split once an iteration, in registers across the 13 products),
// the accumulators, and where the staged operands sit in shared memory.
template <int C, int V>
struct MmaWarp {
  using M = Mma<C>;
  static constexpr bool BREG = V == 0 && !M::ADD;
  uint4 eye[M::EYE ? MT : 1][M::EYE ? M::KK : 1];
  uint32_t b[BREG ? M::P : 1][BREG ? M::KK : 1][2];   // lo, mid, hi
  float raw[M::ADD ? M::KK : 1][2];
  float facc[MT][4];
  int iacc[MT][4], v0[MT][4], t[MT][4];
  const float* S;
  int L0, lane;
  uint32_t slab_at, piece_at;
};

// Fields f0 .. f0 + NF - 1 of one iteration i, both m-tiles, each from a
// zero accumulator (P = 3: lo, mid, hi, summed (lo + mid) + hi), added
// into the element's accumulator in field order.  mxubcast's second
// field of a pair walks its k-steps in reverse: its two products are the
// same (one identity, one w), and ptxas merges two identical mma.sync
// chains into one; in another order they are two chains with the same
// one-hot sum.  (The other constructs' products differ, and the reverse
// order costs the L2-streamed mxu13hi a spill at 255 registers.)
template <int NF, int C, bool STAGED, int V>
__device__ __forceinline__ void mma_fields(MmaWarp<C, V>& c, int f0) {
  using M = Mma<C>;
  constexpr int KK = M::KK, P = M::P;
  float d[NF][MT][P][4] = {};
#pragma unroll
  for (int step = 0; step < KK; ++step) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int kk = C == MXUBCAST && j == 1 ? KK - 1 - step : step;
      uint32_t bk[P][2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if constexpr (V == 1) {
          const uint2 v = lds64(c.piece_at + 8 * ((p * KK + kk) * 32));
          bk[p][0] = v.x;
          bk[p][1] = v.y;
        } else if constexpr (M::ADD) {
          bk[p][0] = tf32(__fadd_rn(c.raw[kk][0], (float)(f0 + j)));
          bk[p][1] = tf32(__fadd_rn(c.raw[kk][1], (float)(f0 + j)));
        } else {
          bk[p][0] = c.b[p][kk][0];
          bk[p][1] = c.b[p][kk][1];
        }
      }
#pragma unroll
      for (int h = 0; h < MT; ++h) {
        uint4 a;
        if constexpr (M::EYE)
          a = c.eye[h][kk];
        else if constexpr (STAGED)
          a = lds128(c.slab_at + 512 * (((f0 + j) * KK + kk) * MT + h));
        else
          a = a_frag(c.S + (f0 + j) * M::K * LANES, c.L0 + 16 * h, kk,
                     c.lane);
#pragma unroll
        for (int p = 0; p < P; ++p)
          mma16(d[j][h][p], a.x, a.y, a.z, a.w, bk[p][0], bk[p][1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = f0 + j;
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = P == 1 ? d[j][h][0][e]
                               : __fadd_rn(__fadd_rn(d[j][h][0][e],
                                                     d[j][h][1][e]),
                                           d[j][h][2][e]);
        if constexpr (C == BRANCHY_MXU) {
          // field 0 decides the branch, which consumes the sum of the rest
          c.v0[h][e] = f == 0 ? (int)s : c.v0[h][e];
          c.t[h][e] += f == 0 ? 0 : (int)s;
        } else if constexpr (C == MXU13CVT) {
          c.iacc[h][e] += (int)s;
        } else {
          c.facc[h][e] = __fadd_rn(c.facc[h][e], s);
        }
      }
  }
}

// Construct C n times.  STAGED (the grid a multiple of GROUPS blocks):
// block b takes lane group b % GROUPS of copies (b / GROUPS) x warps +
// warp, and stages that group's A fragments of all 13 selectors in
// shared memory once (FIELDS x K x 32 lanes x 4 bytes: 208 KB at K = 128,
// 78 KB at K = 48).  Otherwise warp gw of the grid takes lane group
// gw % GROUPS of copy gw / GROUPS and reads the selectors through L1 /
// L2 (one block on one SM: all 128 lanes' selectors, 832 / 312 KB, fit
// no SM's shared memory).  V = 1 (mxu13diff, mxu13hi, staged only): the
// block stages each window's TF32 pieces in shared memory and every
// product reads its w fragments there, as exact_kernel does.
template <int C, bool STAGED, int V>
__global__ void __launch_bounds__(MMA_THREADS, 1) mma_kernel(const Args a) {
  using M = Mma<C>;
  constexpr int KK = M::KK, P = M::P;
  extern __shared__ __align__(16) uint4 msm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3, wpb = blockDim.x >> 5;
  int g, copy;
  if constexpr (STAGED) {
    g = blockIdx.x % GROUPS;
    copy = blockIdx.x / GROUPS * wpb + warp;
  } else {
    const int gw = blockIdx.x * wpb + warp;
    g = gw % GROUPS;
    copy = gw / GROUPS;
  }
  const float* x = static_cast<const float*>(a.x);
  MmaWarp<C, V> c;
  c.S = static_cast<const float*>(a.t);
  c.L0 = GROUP * g;
  c.lane = lane;
  c.slab_at = smem_addr(msm) + 16 * lane;
  uint2* piece = reinterpret_cast<uint2*>(msm + M::SLAB);
  c.piece_at = smem_addr(piece) + 8 * lane;
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c.facc[h][e] = 0.f;
      c.iacc[h][e] = 0;
    }
  if constexpr (M::EYE) {
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        c.eye[h][kk] = a_frag(c.S, c.L0 + 16 * h, kk, lane);
  } else if constexpr (STAGED) {
    for (int u = threadIdx.x; u < M::SLAB; u += blockDim.x) {
      const int l = u % 32, h = u / 32 % MT, kk = u / (32 * MT) % KK;
      const int f = u / (32 * MT * KK);
      msm[u] = a_frag(c.S + f * M::K * LANES, c.L0 + 16 * h, kk, l);
    }
    __syncthreads();
  }
  ROLLED for (int i = 0; i < a.n; ++i) {
    const float* w = x + (i & (WINDOWS - 1)) * ROWS * LANES;
    if constexpr (V == 0) {
#pragma unroll
      for (int h = 0; h < KK / 2; ++h) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(
            w + gr * LANES + 16 * h + 4 * tq));
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 2 * h + e / 2, j = e & 1;
          if constexpr (M::ADD)
            c.raw[kk][j] = v[e];
          else if constexpr (P == 1)
            c.b[0][kk][j] = tf32(v[e]);
          else
            split3(v[e], c.b[2][kk][j], c.b[1][kk][j], c.b[0][kk][j]);
        }
      }
    } else {
      // this window's pieces, [P][KK][32 lanes] (b0, b1)
      for (int u = threadIdx.x; u < KK * 32; u += blockDim.x) {
        const int l = u & 31, kk = u >> 5;
        const float2 q = __ldg(reinterpret_cast<const float2*>(
            w + (l >> 2) * LANES + kidx(kk, l & 3)));
        if constexpr (P == 1) {
          piece[u] = make_uint2(tf32(q.x), tf32(q.y));
        } else {
          uint32_t h0, m0, l0, h1, m1, l1;
          split3(q.x, h0, m0, l0);
          split3(q.y, h1, m1, l1);
          piece[u] = make_uint2(l0, l1);
          piece[KK * 32 + u] = make_uint2(m0, m1);
          piece[2 * KK * 32 + u] = make_uint2(h0, h1);
        }
      }
      __syncthreads();
    }
    if constexpr (C == BRANCHY_MXU) {
#pragma unroll
      for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) c.t[h][e] = c.v0[h][e] = 0;
    }
    ROLLED for (int f = 0; f < FIELDS - 1; f += 2)
      mma_fields<2, C, STAGED, V>(c, f);
    mma_fields<1, C, STAGED, V>(c, FIELDS - 1);
    if constexpr (C == BRANCHY_MXU) {
      // the warp's vote over its (8, 32) tile
      bool live = false;
#pragma unroll
      for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) live = live || c.v0[h][e] + i > -1;
      if (__any_sync(FULL, live)) {
#pragma unroll
        for (int h = 0; h < MT; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) c.iacc[h][e] += c.t[h][e];
      }
    }
    if constexpr (V == 1) __syncthreads();
  }
  // the accumulator's (lane, row) of m-tile h: (gr, 2tq), (gr, 2tq + 1),
  // (gr + 8, 2tq), (gr + 8, 2tq + 1)
  int* o = a.out + (size_t)copy * ROWS * LANES + c.L0 + gr;
  constexpr bool INT = C == MXU13CVT || C == BRANCHY_MXU;
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[(2 * tq + (e & 1)) * LANES + 16 * h + 8 * (e >> 1)] =
          INT ? c.iacc[h][e] : (int)c.facc[h][e];
}

// dynamic shared memory of mma_kernel<C, STAGED, V>
template <int C, bool STAGED, int V>
constexpr size_t mma_smem() {
  return (STAGED ? (size_t)Mma<C>::SLAB * 16 : 0)
         + (V == 1 ? (size_t)Mma<C>::P * Mma<C>::KK * 32 * 8 : 0);
}

template <int C, bool STAGED, int V>
cudaError_t launch_mma(int blocks, int threads, const Args& a,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem<C, STAGED, V>();
  static_assert(smem <= 232448, "a block's shared memory");
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        mma_kernel<C, STAGED, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  mma_kernel<C, STAGED, V><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
__device__ void elem_construct(const Args& a, int* sm) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (g >> 7) & (ROWS - 1), l = g & (LANES - 1);
  const int* xi = static_cast<const int*>(a.x);
  const float* xf = static_cast<const float*>(a.x);
  int acc = 0;
  if constexpr (C == MATH) {
    unsigned u = (unsigned)xi[s * LANES + l];
    ROLLED for (int i = 0; i < a.n; ++i) {
#pragma unroll
      for (int k = 0; k < 32; ++k) u = (u * 3u) ^ (unsigned)((int)u >> 1);
    }
    acc = (int)u;
  } else if constexpr (C == BRANCH || C == BRANCH_F || C == BRANCH_DIV) {
    volatile int* o = sm + threadIdx.x;
    const int xv = xi[s * LANES + l];
    *o = xv;
    ROLLED for (int i = 0; i < a.n; ++i) {
      bool take;
      if constexpr (C == BRANCH) take = __any_sync(FULL, (xv + i) & 1);
      else if constexpr (C == BRANCH_F) take = __any_sync(FULL, xv + i < -5);
      else take = (xv + i + l) & 1;
      if (take) *o = *o + 1;
    }
    acc = *o;
  } else if constexpr (C == RELAYOUT) {
    for (int k = threadIdx.x; k < WINDOWS * ROWS; k += blockDim.x)
      sm[k] = xi[k];
    __syncthreads();
    ROLLED for (int i = 0; i < a.n; ++i)
      acc += sm[(i & (WINDOWS - 1)) * ROWS + s];
  } else if constexpr (C == DYNLOAD) {
    ROLLED for (int i = 0; i < a.n; ++i)
      acc += __ldg(xi + (((i * 37) & (WINDOWS - 1)) * ROWS + s) * LANES + l);
  } else if constexpr (C == GATHER_L2) {
    // each copy its own chains (start + 1024 x copy): copies on one SM
    // must not hit each other's lines in L1
    const int* tab = static_cast<const int*>(a.t);
    unsigned u = (unsigned)xi[s * LANES + l] + (unsigned)(g & ~1023);
    ROLLED for (int i = 0; i < a.n; ++i) {
      const unsigned h = u * 0x61C88647u + (unsigned)i;
      u += (unsigned)__ldg(tab + (h >> GATHER_SHIFT));
    }
    acc = (int)u;
  } else if constexpr (C == SMEM) {
    ROLLED for (int i = 0; i < a.n; ++i) {
      const int c = i & (WINDOWS - 1);
      int v = __ldg(xi + c);
#pragma unroll
      for (int b = 1; b < ROWS; ++b) {
        const int tb = __ldg(xi + b * WINDOWS + c);
        v = s == b ? tb : v;
      }
      acc += v;
    }
  } else if constexpr (C == FORI0) {
    ROLLED for (int i = 0; i < a.n; ++i) {
      ROLLED for (int k = i; k < i + a.arg; ++k) {
        acc += 1;
        asm volatile("" : "+r"(acc));
      }
    }
  } else if constexpr (C == COLBCAST13) {
    ROLLED for (int i = 0; i < a.n; ++i) {
      // one buffer a parity: one barrier an iteration
      int* w = sm + (i & 1) * blockDim.x;
      w[threadIdx.x] =
          __ldg(xi + ((i & (WINDOWS - 1)) * ROWS + s) * LANES + l);
      __syncthreads();
      const int* row = w + (threadIdx.x & ~(LANES - 1));
#pragma unroll
      for (int r = 0; r < FIELDS; ++r) acc += row[r];
    }
  } else if constexpr (C == LANEGATHER13) {
    const int lane = threadIdx.x & 31;
    ROLLED for (int i = 0; i < a.n; ++i) {
      const int v =
          __ldg(xi + ((i & (WINDOWS - 1)) * ROWS + s) * LANES + lane);
#pragma unroll
      for (int f = 0; f < FIELDS; ++f) acc += __shfl_sync(FULL, v, f);
    }
  } else if constexpr (C == BRANCHY_LD) {
    ROLLED for (int i = 0; i < a.n; ++i) {
      const float* w = xf + ((i & (WINDOWS - 1)) * ROWS + s) * LANES;
      int v[FIELDS];
#pragma unroll
      for (int f = 0; f < FIELDS; ++f) v[f] = (int)__ldg(w + f);
      if (__any_sync(FULL, v[0] + i > -1)) {
        int t = v[1] + v[2];
#pragma unroll
        for (int f = 3; f < FIELDS; ++f) t += v[f];
        acc += t;
      }
    }
  } else if constexpr (C == FDIV || C == FMULRCP) {
    const float dv = static_cast<const float*>(a.t)[s * LANES + l];
    float v = xf[s * LANES + l];
    ROLLED for (int i = 0; i < a.n; ++i) {
#pragma unroll
      for (int k = 0; k < CHAIN; ++k)
        v = C == FDIV ? __fdiv_rn(v, dv) : __fmul_rn(v, dv);
    }
    acc = __float_as_int(v);
  }
  a.out[g] = acc;
}

template <int C>
__global__ void __launch_bounds__(MAX_THREADS, 1) visit_kernel(const Args a) {
  extern __shared__ int sm[];
  elem_construct<C>(a, sm);
}

// P2 / P3's block: EXACT_TILES warps, each one 16-lane m-tile of one
// selector's product
constexpr int EXACT_TILES = 2;
constexpr int EXACT_LANES = 16 * EXACT_TILES;      // output lanes a block
constexpr int EXACT_GROUPS = LANES / EXACT_LANES;  // blocks a selector
constexpr int EXACT_THREADS = 32 * EXACT_TILES;
constexpr int KSTEPS = LANES / 8;
static_assert(ROWS * KSTEPS % EXACT_THREADS == 0, "w's k-steps a thread");
// padded row strides (words): the slab's a0..a3 reads, the pieces'
// 8-byte (b0, b1) reads and the output tile's writes each hit 32 banks
constexpr int SLAB_STRIDE = EXACT_LANES + 8;
constexpr int PIECE_STRIDE = LANES + 8;
constexpr int TILE_STRIDE = 16 + 4;

// NC copies' products side by side, one accumulator each (P = 3: lo,
// mid, hi into it every k-step); the selector's fragments `a` in
// registers, w's read from shared memory at `b_at` for every product,
// k-step kk + 1's while kk's products run
template <int P, int NC>
__device__ __forceinline__ void products(float (&d)[NC][4],
                                         const uint32_t (&a)[KSTEPS][4],
                                         uint32_t b_at) {
  uint2 b[2][P][NC];
  auto load = [&](uint2(&bk)[P][NC], int kk) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        bk[p][j] = lds64(b_at + 4 * (p * ROWS * PIECE_STRIDE + 8 * kk));
  };
  load(b[0], 0);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    if (kk + 1 < KSTEPS) load(b[(kk + 1) & 1], kk + 1);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        mma16(d[j], a[kk][0], a[kk][1], a[kk][2], a[kk][3],
              b[kk & 1][p][j].x, b[kk & 1][p][j].y);
  }
}

// grid (EXACT_GROUPS, 8 selectors, layers): block (g, f, z) computes
// lanes 32g..32g+31 of out[c][8f..8f+7] for copies c = z, z + layers, ...
// (written for c < stored)
template <int P>
__global__ void __launch_bounds__(EXACT_THREADS) exact_kernel(
    const float* __restrict__ w, const float* __restrict__ S,
    int* __restrict__ out, int copies, int stored) {
  __shared__ __align__(16) float slab[LANES][SLAB_STRIDE];  // S[f][:, l0..]
  // TF32 pieces of w (P = 3: lo, mid, hi), a row's k-step kk at 8kk..8kk+7
  // in the order k0, k0 + 4, k0 + 1, k0 + 5, ... (k0 = 8kk)
  __shared__ __align__(16) uint32_t piece[P][ROWS][PIECE_STRIDE];
  __shared__ __align__(16) float tile[EXACT_TILES][ROWS][TILE_STRIDE];
  const int f = blockIdx.y, l0 = blockIdx.x * EXACT_LANES;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gr = lane >> 2, tq = lane & 3;

  constexpr int SLAB_CHUNKS = EXACT_LANES / 4;
  const float* sel = S + (size_t)f * LANES * LANES + l0;
  for (int i = t; i < LANES * SLAB_CHUNKS; i += EXACT_THREADS) {
    const int k = i / SLAB_CHUNKS, c = i % SLAB_CHUNKS;
    cp_async16(&slab[k][4 * c], sel + k * LANES + 4 * c);
  }
  // while the slab is in flight: w's k-steps g = t, t + 64 (row g / 16,
  // k0 = 8 (g % 16)), two 16-byte loads each, split once a block
#pragma unroll
  for (int n = 0; n < ROWS * KSTEPS / EXACT_THREADS; ++n) {
    const int g = t + n * EXACT_THREADS, s = g / KSTEPS;
    const int k0 = 8 * (g % KSTEPS);
    const float4 u = __ldg(reinterpret_cast<const float4*>(w + s * LANES
                                                           + k0));
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + s * LANES
                                                           + k0 + 4));
    const float x[8] = {u.x, v.x, u.y, v.y, u.z, v.z, u.w, v.w};
    uint32_t pc[P][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (P == 1) pc[0][e] = tf32(x[e]);
      else split3(x[e], pc[2][e], pc[1][e], pc[0][e]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      *reinterpret_cast<uint4*>(&piece[p][s][k0]) =
          make_uint4(pc[p][0], pc[p][1], pc[p][2], pc[p][3]);
      *reinterpret_cast<uint4*>(&piece[p][s][k0 + 4]) =
          make_uint4(pc[p][4], pc[p][5], pc[p][6], pc[p][7]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // A = S[f]^T: this warp's m-tile, lanes l0 + 16 warp .. + 15
  const int m = 16 * warp + gr;
  uint32_t a[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int k = 8 * kk + tq;
    a[kk][0] = tf32(slab[k][m]);
    a[kk][1] = tf32(slab[k][m + 8]);
    a[kk][2] = tf32(slab[k + 4][m]);
    a[kk][3] = tf32(slab[k + 4][m + 8]);
  }
  // B = w^T: (b0, b1) = (w[gr][k0 + tq], w[gr][k0 + tq + 4])
  const uint32_t b_at = smem_addr(&piece[0][gr][2 * tq]);
  float(*tl)[TILE_STRIDE] = tile[warp];
  // out[c][8f + s][l0 + 16 warp + l] from the accumulator's (l, s) =
  // (gr, 2tq), (gr, 2tq + 1), (gr + 8, 2tq), (gr + 8, 2tq + 1): through
  // the tile, one 16-byte store a lane
  auto store = [&](const float(&d)[4], int c) {
    if (c >= stored) return;
    __syncwarp();
    tl[2 * tq][gr] = d[0];
    tl[2 * tq + 1][gr] = d[1];
    tl[2 * tq][gr + 8] = d[2];
    tl[2 * tq + 1][gr + 8] = d[3];
    __syncwarp();
    const int r = lane >> 2, q = 4 * (lane & 3);
    *reinterpret_cast<float4*>(
        out + ((size_t)c * ROWS * ROWS + f * ROWS + r) * LANES + l0
        + 16 * warp + q) = *reinterpret_cast<const float4*>(&tl[r][q]);
  };
  // copies two at a time while two are left (so one copy runs one chain;
  // two chains a warp made P3 3-10% faster than one at full-card
  // occupancy, PERF.md)
  const int layers = gridDim.z;
  ROLLED for (int c = blockIdx.z; c < copies; c += 2 * layers) {
    if (c + layers < copies) {
      float d[2][4] = {};
      products<P, 2>(d, a, b_at);
      store(d[0], c);
      store(d[1], c + layers);
    } else {
      float d[1][4] = {};
      products<P, 1>(d, a, b_at);
      store(d[0], c);
    }
  }
}

// layers of 32 exact_kernel<P> blocks the card holds at once
template <int P>
cudaError_t exact_layers(int& layers) {
  static int cached = 0;
  if (cached == 0) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, exact_kernel<P>, EXACT_THREADS, 0);
    if (e != cudaSuccess) return e;
    cached = std::max(1, sms * per / (EXACT_GROUPS * ROWS));
  }
  layers = cached;
  return cudaSuccess;
}

template <int P>
cudaError_t launch_exact(const float* w, const float* S, int* out,
                         int copies, int stored, cudaStream_t stream) {
  int layers;
  const cudaError_t e = exact_layers<P>(layers);
  if (e != cudaSuccess) return e;
  layers = std::min(layers, (copies + 1) / 2);
  exact_kernel<P><<<dim3(EXACT_GROUPS, ROWS, layers), EXACT_THREADS, 0,
                    stream>>>(w, S, out, copies, stored);
  return cudaGetLastError();
}

// dynamic shared memory of construct C's block of `threads`
size_t smem_bytes(int c, int threads) {
  switch (c) {
    case BRANCH: case BRANCH_F: case BRANCH_DIV:
      return (size_t)threads * sizeof(int);
    case RELAYOUT: return (size_t)WINDOWS * ROWS * sizeof(int);
    case COLBCAST13: return 2 * (size_t)threads * sizeof(int);
    default: return 0;
  }
}

template <int C>
cudaError_t launch(int blocks, int threads, const Args& a, int variant,
                   cudaStream_t stream) {
  if constexpr (is_mma(C)) {
    const bool staged = blocks % GROUPS == 0;
    if (variant == 0)
      return staged ? launch_mma<C, true, 0>(blocks, threads, a, stream)
                    : launch_mma<C, false, 0>(blocks, threads, a, stream);
    if constexpr (has_variant(C))
      if (variant == 1 && staged)
        return launch_mma<C, true, 1>(blocks, threads, a, stream);
    return cudaErrorInvalidValue;
  } else {
    if (variant != 0) return cudaErrorInvalidValue;
    visit_kernel<C><<<blocks, threads, smem_bytes(C, threads), stream>>>(a);
    return cudaGetLastError();
  }
}

template <int... Cs>
cudaError_t dispatch(int c, int blocks, int threads, const Args& a,
                     int variant, cudaStream_t stream,
                     std::integer_sequence<int, Cs...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((c == Cs ? (e = launch<Cs>(blocks, threads, a, variant, stream), 0) : 0),
   ...);
  return e;
}

}  // namespace

extern "C" {

// Construct `construct` (the index of its name in probe_visit_names)
// n times on blocks x threads threads; out holds one (8, 128) copy per
// 1024 threads (per 128 for the mma constructs, whose blocks hold at
// most 256 threads; x 16-byte aligned).  variant 1 (mxu13diff, mxu13hi
// on a grid of a multiple of 4 blocks): w's fragments read from shared
// memory for every product, not held in registers.
int probe_visit(int construct, int blocks, int threads, const void* x,
                const void* t, int n, int arg, int variant, int* out,
                void* stream) {
  const bool mma = construct >= 0 && is_mma(construct);
  if (construct < 0 || construct >= N_CONSTRUCTS || blocks < 1
      || threads < 32 || threads % 32 != 0
      || threads > (mma ? MMA_THREADS : MAX_THREADS)
      || (long long)blocks * threads % (mma ? 32 * GROUPS : 1024)
      || (mma && (uintptr_t)x % 16))
    return (int)cudaErrorInvalidValue;
  const Args a{x, t, n, arg, out};
  return (int)dispatch(construct, blocks, threads, a, variant,
                       (cudaStream_t)stream,
                       std::make_integer_sequence<int, N_CONSTRUCTS>{});
}

// P2 (passes 1) or P3 (passes 3): w [8, 128] f32, S [8 * 128, 128] f32,
// out [stored, 64, 128] i32 (copies' products run, the first `stored`
// written), every pointer 16-byte aligned
int probe_exact(int passes, const float* w, const float* S, int* out,
                int copies, int stored, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (copies < 1 || stored < 1 || stored > copies
      || ((uintptr_t)w | (uintptr_t)S | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (passes == 1) return (int)launch_exact<1>(w, S, out, copies, stored, st);
  if (passes == 3) return (int)launch_exact<3>(w, S, out, copies, stored, st);
  return (int)cudaErrorInvalidValue;
}

const char* probe_visit_names() { return NAMES; }

const char* probe_visit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
