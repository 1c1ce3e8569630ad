// Emission kernel: the deferred pass's item pool, per camera and screen
// column, from the item pack and the mid pool.
//
// Replaces the item pool's presence, emission, per-slot sprite column
// math and mid fill: the JAX package's doomtpu/render/things.py::
// item_pool (XLA code, no pl.pallas_call; its one-hot contractions and
// the [B, N, W] presence and reversed cumsum), whose PyTorch transcript
// is the plain version, doomtpu_torch/ops/emit.py::emit_reference.
// Computes the same outputs bit for bit: the pool [8, B, KI, W] (zeros
// in every slot past a column's count), icnt [B, W], item_overflow and
// item_peak [B].
//
// Design: a block takes one camera and its columns, a thread a column
// (a screen wider than the block in passes of blockDim columns).
// (1) The block fills a seg -> item table in shared memory from the
//     pack's valid selected mids (their seg ids ride in IPI_SOFF).  A
//     level whose table does not fit (ops/emit.py::emit_block) looks
//     each seg up by a walk of the pack instead.
// (2) Each thread reads its column's mid records k < cnt through the
//     pool's strides (slot-major [B, KM, W] views, or the JAX layout's
//     [B, W, KM] store seen slot-major; no copy) and, for each record of
//     kind KIND_MID whose seg is a selected mid, sets that item's bit in
//     the column's mask (shared memory, a bit an item).
// (3) Each warp walks the camera's items nearest first (pack slot N-1 is
//     the nearest), 32 at a time: lane j tests item base + j against the
//     warp's 32 columns (a sprite's [x0, x1e); a mid's bit in any of the
//     warp's masks, one OR reduction), a ballot keeps the items that
//     meet them, and the kept items are taken from the highest lane down,
//     their flags and x range broadcast by shuffles.  Each column counts
//     its present items and notes the first KI in its slot list (shared
//     memory); the rest are the farthest-first drop.
// (4) Each thread writes its column's KI slots in slot order, so a warp
//     stores slot s of 32 neighbouring columns in one 128-byte store a
//     plane: a sprite slot's billboard column (layout.cuh, the item-pass
//     kernel's arithmetic) and its eight words; a mid slot's word and
//     draw words d1..d5 from the last (largest k) record of its seg;
//     zeros past the count.
// (5) icnt a column; item_overflow (the present items past KI) and
//     item_peak (the largest count) reduced over the block: warp
//     reductions, then shared memory.  No atomics, no second pass.
//
// What bounds it on the card: bytes.  It writes the pool whole, 8 planes
// x B x KI x W words (1.0 GB at 4096 cameras, KI 24, W 320: 0.30 ms at
// 3.35 TB/s), and reads far less: the pack's words of the items the
// columns hold and the first three of every item, the mid records of
// each column.  Stores of whole 128-byte lines keep it at the write
// rate; the walk, the shuffles and three IEEE divides a sprite slot are
// cheap next to them.
//
// Numerics: compiled with -fmad=false; billboard_column's products, sums
// and quotients are __fmul_rn / __fadd_rn / __fdiv_rn.

#include "layout.cuh"

#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPR_MARK = 1 << 29;   // ops/items.py SPR_MARK

struct Params {
  const int* ipk; const int* fpk; int N;   // [B, N, 8] i32, [B, N, 12] f32
  // mid pool planes, each [B, KM, W] with strides sb, sk, sw (in words)
  const int* mspan; const int* md1; const int* md2; const int* md3;
  const int* md4; const int* md5; const int* md6;
  const int* mcnt;                         // [B, W]
  long long sb, sk, sw;
  int KM, B, W, H, KI, G, table;
  int T, spr0, PW;                         // sprite picture -> atlas column
  int* pool;                               // [8, B, KI, W]
  int* icnt;                               // [B, W]
  int* overflow; int* peak;                // [B]
};

// the selected valid mid whose seg id is `seg`, or -1
__device__ int mid_item(const Params& p, const int* ip, const int* tab,
                        int seg) {
  if (seg < 0 || seg >= p.G) return -1;
  if (p.table) return tab[seg];
  ROLLED for (int n = 0; n < p.N; ++n) {
    const int* ir = ip + (long long)n * IPI_ROWS;
    if ((ir[IPI_FL] & 3) == 1 && ir[IPI_SOFF] == seg) return n;
  }
  return -1;
}

__global__ void __launch_bounds__(MAX_THREADS) emit_kernel(Params p) {
  extern __shared__ int smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const int NW = (p.N + 31) >> 5;
  int* slot_item = smem;                                  // [KI][nt]
  unsigned* mask = (unsigned*)(slot_item + p.KI * nt);    // [NW][nt]
  int* red = (int*)(mask + NW * nt);                      // [2][warps]
  int* tab = red + 2 * warps;                             // [G] (table)
  const int b = blockIdx.x;
  const int* ip = p.ipk + (long long)b * p.N * IPI_ROWS;
  const int* fp = p.fpk + (long long)b * p.N * IPF_ROWS;

  // (1) seg -> item
  if (p.table) {
    ROLLED for (int g = tid; g < p.G; g += nt) tab[g] = -1;
    __syncthreads();
    ROLLED for (int n = tid; n < p.N; n += nt) {
      const int* ir = ip + (long long)n * IPI_ROWS;
      const int seg = ir[IPI_SOFF];
      if ((ir[IPI_FL] & 3) == 1 && seg >= 0 && seg < p.G) tab[seg] = n;
    }
    __syncthreads();
  }
  const long long plane = (long long)p.B * p.KI * p.W;
  int overflow = 0, peak = 0;
  ROLLED for (int xs = 0; xs < p.W; xs += nt) {
    const int x = xs + tid;
    const bool live = x < p.W;
    const long long m0 = (long long)b * p.sb + (long long)x * p.sw;
    // (2) the column's mids, a bit an item
    ROLLED for (int w = 0; w < NW; ++w) mask[w * nt + tid] = 0u;
    int mcnt = 0;
    if (live) {
      mcnt = min(p.mcnt[(long long)b * p.W + x], p.KM);
      ROLLED for (int k = 0; k < mcnt; ++k) {
        const long long o = m0 + k * p.sk;
        if (((p.mspan[o] >> 29) & 3) != KIND_MID) continue;
        const int n = mid_item(p, ip, tab, p.md6[o]);
        if (n >= 0) mask[(n >> 5) * nt + tid] |= 1u << (n & 31);
      }
    }
    // (3) the items nearest first, 32 a step; the first KI present ones
    // take the column's slots
    int count = 0;
    const int wx0 = xs + warp * 32, wx1 = min(wx0 + 31, p.W - 1);
    if (wx0 < p.W) {                           // the same for the warp
      ROLLED for (int base = (p.N - 1) & ~31; base >= 0; base -= 32) {
        const int n = base + lane;
        int fl = 0, x0 = 0, x1e = 0;
        if (n < p.N) {
          const int* ir = ip + (long long)n * IPI_ROWS;
          fl = ir[IPI_FL];
          x0 = ir[IPI_X0];
          x1e = ir[IPI_X1E];
        }
        const unsigned mids = mask[(base >> 5) * nt + tid];
        const unsigned any = __reduce_or_sync(FULL, mids);
        const bool keep = (fl & 1) && ((fl & 2) ? (x1e > wx0 && x0 <= wx1)
                                                : ((any >> lane) & 1u));
        unsigned ball = __ballot_sync(FULL, keep);
        while (ball) {
          const int j = 31 - __clz(ball);
          ball ^= 1u << j;
          const int jfl = __shfl_sync(FULL, fl, j);
          const int jx0 = __shfl_sync(FULL, x0, j);
          const int jx1 = __shfl_sync(FULL, x1e, j);
          const bool present =
              live && ((jfl & 2) ? (x >= jx0 && x < jx1) : ((mids >> j) & 1u));
          if (present) {
            if (count < p.KI) slot_item[count * nt + tid] = base + j;
            ++count;
          }
        }
      }
    }
    // (4) the column's slots in slot order, zeros past its count
    if (live) {
      const int used = min(count, p.KI);
      int* out = p.pool + (long long)b * p.KI * p.W + x;   // + s * W
      ROLLED for (int s = 0; s < p.KI; ++s) {
        int w0 = 0, w1 = 0, w2 = 0, w3 = 0, w4 = 0, w5 = 0, w6 = 0, w7 = 0;
        if (s < used) {
          const int n = slot_item[s * nt + tid];
          const int* ir = ip + (long long)n * IPI_ROWS;
          if (ir[IPI_FL] & 2) {
            const int* fw = fp + (long long)n * IPF_ROWS;
            const BillboardColumn c =
                billboard_column(x, ir, (const float*)fw);
            // the screen clamp only (K2 applies the seg clip); ct <= H
            // keeps ct + 1 in the word's 9-bit field
            const int ct = min(max(c.ty, 0), p.H);
            const int cb = min(c.by, p.H - 1);
            w0 = pack16(ct + 1, cb + 1) | SPR_MARK;
            w1 = wadd(wadd(p.spr0, wmul(wsub(ir[IPI_PIC], p.T), p.PW)), c.tx);
            w2 = pack16(c.by, c.ty);
            w3 = pack16(0, ir[IPI_TH]);
            w4 = pack16(ir[IPI_LW], c.zd);
            w5 = fw[IPF_UY1];
            w6 = fw[IPF_VPX];
            w7 = fw[IPF_VPY];
          } else {
            // the last record of the mid's seg (one exists: it is
            // present)
            const int seg = ir[IPI_SOFF];
            long long o = -1;
            ROLLED for (int k = mcnt - 1; k >= 0; --k) {
              const long long ok = m0 + k * p.sk;
              if (((p.mspan[ok] >> 29) & 3) == KIND_MID && p.md6[ok] == seg) {
                o = ok;
                break;
              }
            }
            if (o >= 0) {
              const int mw = p.mspan[o];
              w0 = pack16((mw >> 8) & 255, mw & 255);
              w1 = p.md1[o];
              w2 = p.md2[o];
              w3 = p.md3[o];
              w4 = p.md4[o];
              w5 = p.md5[o];
            }
          }
        }
        int* o = out + (long long)s * p.W;
        o[0] = w0;
        o[plane] = w1;
        o[2 * plane] = w2;
        o[3 * plane] = w3;
        o[4 * plane] = w4;
        o[5 * plane] = w5;
        o[6 * plane] = w6;
        o[7 * plane] = w7;
      }
      p.icnt[(long long)b * p.W + x] = used;
      overflow += max(count - p.KI, 0);
      peak = max(peak, count);
    }
  }
  // (5) the camera's overflow and peak
  overflow = __reduce_add_sync(FULL, overflow);
  peak = __reduce_max_sync(FULL, peak);
  if (lane == 0) {
    red[warp] = overflow;
    red[warps + warp] = peak;
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0, pk = 0;
    for (int w = 0; w < warps; ++w) {
      o += red[w];
      pk = max(pk, red[warps + w]);
    }
    p.overflow[b] = o;
    p.peak[b] = pk;
  }
}

// a block's shared memory (ops/emit.py::emit_smem_bytes)
size_t smem_bytes(int threads, int N, int KI, int G, int table) {
  return ((size_t)threads * (KI + (N + 31) / 32) + 2 * (threads / 32)
          + (table ? (size_t)G : 0)) * sizeof(int);
}

// raise the kernel's dynamic shared memory limit to `smem` (never lower)
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace

extern "C" {

// threads a block (a multiple of 32, at most 512); table: the seg -> item
// table in shared memory
int doom_emit(
    const int* ipk, const float* fpk, int N,
    const int* mspan, const int* md1, const int* md2, const int* md3,
    const int* md4, const int* md5, const int* md6, const int* mcnt,
    long long sb, long long sk, long long sw, int KM,
    int B, int W, int H, int KI, int G, int T, int spr0, int PW,
    int threads, int table, int* pool, int* icnt, int* overflow, int* peak,
    void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 || N <= 0
      || W <= 0 || KI < 0 || KM < 0)
    return (int)cudaErrorInvalidConfiguration;
  Params p{ipk, (const int*)fpk, N, mspan, md1, md2, md3, md4, md5, md6,
           mcnt, sb, sk, sw, KM, B, W, H, KI, G, table, T, spr0, PW,
           pool, icnt, overflow, peak};
  const size_t smem = smem_bytes(threads, N, KI, G, table);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  emit_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// blocks of `threads` threads the card keeps on one SM
int doom_emit_blocks_per_sm(int threads, int N, int KI, int G, int table) {
  const size_t smem = smem_bytes(threads, N, KI, G, table);
  if (allow_smem(smem) != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, emit_kernel,
                                                threads, smem);
  return blocks;
}

const char* doom_emit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
