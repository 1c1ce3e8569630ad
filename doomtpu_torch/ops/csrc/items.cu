// Item composite kernel: the deferred pass's per-column item pool folded
// farthest -> nearest over the paint frame, with the sprite-vs-seg clip
// and the shade of the pixels the items wrote.
//
// Replaces doomtpu/ops/pallas_items.py::_kernel_kouter and ::_kernel
// (the TPU kernels launched by composite_items; _kernel's in-kernel clip
// runs here for any item capacity).  Computes the same outputs bit for
// bit; the plain PyTorch version is
// doomtpu_torch/ops/items.py::composite_items_reference, and the item
// pool's planes are described in doomtpu_torch/render/things.py.
//
// Design: a block takes one camera and a tile of TC screen columns,
// TC x R threads; thread (c, g) serves column c and band g of its rows,
// [g * BH, (g + 1) * BH).  Shared memory holds, for the tile:
// - the clip records of each column up to its count, staged once, 5
//   words each: the seg's two endpoints and the record's (top, bottom)
//   bounds on a sprite in front of it (renderer/map_objects.rs:127-166);
// - per pool slot, its rows [y0, y1] after the clip, and its ld word
//   (light | zdist | written);
// - the marks: one word per pixel, (slot + 1) << 8 | texel, 0 where no
//   item drew.
// Four steps, two barriers.  (1) Stage the clip records and zero the
// band's marks.  (2) The slots of a column are split over its R
// threads: each folds a sprite slot's clip over the staged records (a
// max / min, so the order does not matter) and stores the slot's rows.
// (3) Each thread folds its column's slots far to near over its band's
// rows: per row v by interpolation, texel | opaque << 8 from the column
// atlas, and where opaque the slot's mark overwrites (nearer slots win).
// (4) Each thread shades the marked pixels of its band (palette, light
// diminish) and stores idx, ld and rgb there, and only there: with
// TC = 32 a warp stores consecutive columns of one row.  The kernel
// never reads idx or ld; pixels no item drew keep the paint frame.
//
// TC and R come from ops/items.py::items_tile (32 columns while the
// tile's shared memory fits 227 KB; bands of ~BAND_ROWS rows).  Measured
// on an H100 (e1m1-scale, 4096 cameras, 320x200, item capacity 24, clip
// 64; PERF.md): 16 bands beat 1-8 (2.4 ms against 10.8, 7.2, 4.8, 3.2);
// 40 registers, no spills, 71 KB of shared memory a block, 3 blocks
// (48 warps) an SM.  The fold's row loop takes two rows a step, so two
// atlas loads are in flight.
//
// What bounds it on the card: 2.4 ms against a 0.31 ms byte bound
// (idx / ld / rgb written once where items draw, each occupied slot and
// clip record read once).  The per-row atlas loads (a few MB, resident
// in L2) and IEEE divides of the fold, and the warps' divergence over
// columns with different slot counts and heights, set its time.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn / __fdiv_rn.  The shade multiplies by the
// f32 reciprocal of 255 (inv_255), as XLA computes light / 255.  A
// sprite slot's clipped top goes through the 9-bit field of the item
// word as in the plain version (items.py::clipped_words).

#include "layout.cuh"

// Every row loop stays rolled (see paint.cu: nvcc 12.8 for sm_90a drew
// one row past a span's end with these loops unrolled).
#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int SPR_MARK = 1 << 29;
constexpr int MAX_THREADS = 512;

struct Params {
  // item pool planes, each [B, KI, W]
  const int* iword; const int* icol; const int* ibyty; const int* ioffth;
  const int* ilz; const int* iuy1; const int* ivpx; const int* ivpy;
  const int* icnt;                       // [B, W]
  const int* atlas; int n_atlas, rows;   // [C * rows] texel | opaque << 8
  const int* pal;                        // [256] 0xRRGGBB
  // clip pool planes, each [B, KC, W]; KC = 0: no clip
  const int* cspan; const int* cd2; const int* clsx; const int* clsy;
  const int* clex; const int* cley; const int* ccnt;   // [B, W]
  int B, W, H, KI, KC;
  float inv_255;
  int TC, R, BH, ntiles;
  int* idx; int* ld; int* rgb;           // [B, H, W], updated in place
};

__global__ void __launch_bounds__(MAX_THREADS) items_kernel(const Params p) {
  extern __shared__ int smem[];
  const int TC = p.TC, H = p.H, W = p.W;
  int* marks = smem;                          // [H][TC]
  int* srows = marks + H * TC;                // [KI][TC] y0 << 16 | y1
  int* slz = srows + p.KI * TC;               // [KI][TC] ld word
  int* recs = slz + p.KI * TC;                // [KC][CLIP_RECORD_WORDS][TC]

  const int b = blockIdx.x / p.ntiles;
  const int c = threadIdx.x, g = threadIdx.y;
  const int x = (blockIdx.x % p.ntiles) * TC + c;
  const bool live = x < W;
  const long bw = (long)b * W + x;
  int cnt = live ? min(p.icnt[bw], p.KI) : 0;
  const int ccnt = (cnt > 0 && p.KC > 0) ? min(p.ccnt[bw], p.KC) : 0;
  const int ylo = g * p.BH, yhi = min(ylo + p.BH, H) - 1;

  // (1) the column's clip records, its band's marks
  const long clip0 = (long)b * p.KC * W + x;   // record k at + k * W
  ROLLED for (int k = g; k < ccnt; k += p.R) {
    const long o = clip0 + (long)k * W;
    int* r = recs + k * CLIP_RECORD_WORDS * TC + c;
    r[0] = p.clsx[o];
    r[TC] = p.clsy[o];
    r[2 * TC] = p.clex[o];
    r[3 * TC] = p.cley[o];
    r[4 * TC] = record_bounds(p.cspan[o], p.cd2[o], H);
  }
  if (cnt > 0) {
    ROLLED for (int y = ylo; y <= yhi; ++y) marks[y * TC + c] = 0;
  }
  __syncthreads();

  // (2) each slot's rows after the clip, and its ld word
  const long slot0 = (long)b * p.KI * W + x;   // slot k at + k * W
  ROLLED for (int k = g; k < cnt; k += p.R) {
    const long o = slot0 + (long)k * W;
    const int word = p.iword[o];
    int ct = ((word >> 16) & 0x1FF) - 1;
    int cb = lo16(word) - 1;
    if (p.KC > 0 && (word & SPR_MARK)) {
      const float vx = fbits(p.ivpx[o]), vy = fbits(p.ivpy[o]);
      int tsc = -1, bsc = H;
      const int* r = recs + c;
      ROLLED for (int kc = 0; kc < ccnt; ++kc, r += CLIP_RECORD_WORDS * TC) {
        if (is_behind_vertex(fbits(r[0]), fbits(r[TC]), fbits(r[2 * TC]),
                             fbits(r[3 * TC]), vx, vy))
          continue;
        const int tb = r[4 * TC];
        tsc = max(tsc, tb >> 16);
        bsc = min(bsc, lo16(tb));
      }
      // the clipped word's 9-bit top field, as clipped_words packs it
      ct = ((min(max(ct, tsc), H) + 1) & 0x1FF) - 1;
      cb = min(cb, bsc);
    }
    // rows [y0, y1] as two i16 (y1 < 0: none)
    srows[k * TC + c] = pack16(max(ct, 0), max(min(cb, H - 1), -1));
    slz[k * TC + c] = p.ilz[o] | LD_WRITTEN;
  }
  __syncthreads();

  // (3) far to near over the band's rows
  ROLLED for (int k = cnt - 1; k >= 0; --k) {
    const int yy = srows[k * TC + c];
    const int y0 = max(yy >> 16, ylo), y1 = min(lo16(yy), yhi);
    if (y0 > y1) continue;
    const long o = slot0 + (long)k * W;
    const int byty = p.ibyty[o], offth = p.ioffth[o];
    const int by = byty >> 16, ty = lo16(byty);
    const int off_y = offth >> 16, th = lo16(offth);
    const float uy1 = fbits(p.iuy1[o]);
    const float thf = (float)th, dby = (float)(by - ty);
    const int thb = max(th, 1);
    // colbase * rows in wrapping i32, as the reference computes it
    const int col_ix = (int)((unsigned)p.icol[o] * (unsigned)p.rows);
    const int mark = (k + 1) << 8;
    auto texel_at = [&](int y) {
      const float ay = __fdiv_rn((float)(y - ty), dby);
      int tyv = as_i16(__fadd_rn(thf, __fmul_rn(ay, uy1))) + off_y;
      tyv = wrap_tex(tyv, thb, 0);
      const int t_ix = (int)((unsigned)col_ix + (unsigned)tyv);
      return p.atlas + min(max(t_ix, 0), p.n_atlas - 1);
    };
    // two rows a step, both atlas loads in flight before either mark
    ROLLED for (int y = y0; y <= y1; y += 2) {
      const bool two = y < y1;
      const int* a0 = texel_at(y);
      const int* a1 = two ? texel_at(y + 1) : a0;
      const int t0 = *a0, t1 = *a1;
      if (t0 & 0x100) marks[y * TC + c] = mark | (t0 & 0xFF);
      if (two && (t1 & 0x100)) marks[(y + 1) * TC + c] = mark | (t1 & 0xFF);
    }
  }

  // (4) shade the marked pixels (layout.cuh, shade_rgb)
  if (cnt == 0) return;
  const long pix0 = (long)b * H * W + x;       // row y at + y * W
  ROLLED for (int y = ylo; y <= yhi; ++y) {
    const int m = marks[y * TC + c];
    if (m == 0) continue;
    const int texel = m & 0xFF;
    const int l = slz[((m >> 8) - 1) * TC + c];
    const long q = pix0 + (long)y * W;
    p.idx[q] = texel;
    p.ld[q] = l;
    p.rgb[q] = shade_rgb(p.pal[texel], l, p.inv_255);
  }
}

// raise the kernel's dynamic shared memory limit to `smem` (never lower)
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace

extern "C" {

// tc columns per block, bands threads per column (tc * bands <= 512)
int doom_items(
    const int* iword, const int* icol, const int* ibyty, const int* ioffth,
    const int* ilz, const int* iuy1, const int* ivpx, const int* ivpy,
    const int* icnt, const int* atlas, int n_atlas, int rows, const int* pal,
    const int* cspan, const int* cd2, const int* clsx, const int* clsy,
    const int* clex, const int* cley, const int* ccnt,
    int B, int W, int H, int KI, int KC, float inv_255, int tc, int bands,
    int* idx, int* ld, int* rgb, void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return 0;
  if (tc < 1 || bands < 1 || tc * bands > MAX_THREADS)
    return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (W + tc - 1) / tc;
  Params p{iword, icol, ibyty, ioffth, ilz, iuy1, ivpx, ivpy, icnt,
           atlas, n_atlas, rows, pal,
           cspan, cd2, clsx, clsy, clex, cley, ccnt,
           B, W, H, KI, KC, inv_255, tc, bands, (H + bands - 1) / bands,
           ntiles, idx, ld, rgb};
  const size_t smem =
      (size_t)tc * (H + 2 * KI + CLIP_RECORD_WORDS * KC) * sizeof(int);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  items_kernel<<<(unsigned)B * ntiles, dim3(tc, bands), smem,
                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// blocks of tc x bands threads the card keeps on one SM
int doom_items_blocks_per_sm(int tc, int bands, int H, int KI, int KC) {
  const size_t smem =
      (size_t)tc * (H + 2 * KI + CLIP_RECORD_WORDS * KC) * sizeof(int);
  if (allow_smem(smem) != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, items_kernel,
                                                tc * bands, smem);
  return blocks;
}

const char* doom_items_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
