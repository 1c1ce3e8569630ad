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
// Design: one thread per (camera, screen column), 128 columns per block.
// A thread walks its column's pool slots from the farthest (cnt - 1) to
// the nearest (0).  For a sprite slot it first clips [ct, cb] against
// every clip-pool record of the column that lies in front of the sprite
// (renderer/map_objects.rs:127-166).  Then, per row of [ct, cb], it
// interpolates v, reads texel | opaque << 8 from the unpacked column
// atlas and, where opaque, overwrites idx with -2 - texel (a mark: the
// paint frame's idx is -1 or a texel) and ld with the slot's
// light | zdist | written.  Nearer slots overwrite farther ones, so the
// frame holds the painter's winner.  A last pass over the rows the
// thread wrote shades each marked pixel (palette, light diminish) and
// restores its idx.  Every element has one writer: its column's thread.
//
// What bounds it on the card: memory latency, not FLOPs.  Per drawn
// pixel it does one IEEE divide, a few integer ops, one atlas load (the
// atlas is a few MB, resident in L2) and two stores; the frame planes
// are read and written only where items draw.  Each row's stores from
// one warp hit 32 columns of different rows, so they do not coalesce;
// per-camera tiles in shared memory are later work.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn / __fdiv_rn.  The shade multiplies by the
// f32 reciprocal of 255 (inv_255), as XLA computes light / 255.  Sector
// light levels are in [0, 255], so the light read back from ld is the
// slot's.

#include "layout.cuh"

// Every row loop stays rolled (see paint.cu: nvcc 12.8 for sm_90a drew
// one row past a span's end with these loops unrolled).
#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int SPR_MARK = 1 << 29;
constexpr int THREADS = 128;

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
  int* idx; int* ld; int* rgb;           // [B, H, W], updated in place
};

__global__ void __launch_bounds__(THREADS) items_kernel(Params p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const long bw = (long)b * p.W + w;
  int cnt = p.icnt[bw];
  if (cnt > p.KI) cnt = p.KI;
  if (cnt <= 0) return;
  const int H = p.H, W = p.W;
  const long slot0 = (long)b * p.KI * W + w;     // slot k at + k * W
  const long pix0 = (long)b * H * W + w;         // row y at + y * W
  const int ccnt = p.KC > 0 ? min(p.ccnt[bw], p.KC) : 0;
  const long clip0 = (long)b * p.KC * W + w;
  int ylo = H, yhi = -1;

  ROLLED
  for (int k = cnt - 1; k >= 0; --k) {
    const long o = slot0 + (long)k * W;
    const int word = p.iword[o];
    int ct = ((word >> 16) & 0x1FF) - 1;
    int cb = lo16(word) - 1;
    if (ccnt > 0 && (word & SPR_MARK)) {
      const float vx = fbits(p.ivpx[o]), vy = fbits(p.ivpy[o]);
      int tsc, bsc;
      clip_fold(p.cspan, p.cd2, p.clsx, p.clsy, p.clex, p.cley, clip0, W,
                ccnt, vx, vy, H, tsc, bsc);
      ct = max(ct, tsc);
      cb = min(cb, bsc);
    }
    const int y0 = max(ct, 0), y1 = min(cb, H - 1);
    if (y0 > y1) continue;
    const int byty = p.ibyty[o], offth = p.ioffth[o];
    const int by = byty >> 16, ty = lo16(byty);
    const int off_y = offth >> 16, th = lo16(offth);
    const int ldw = p.ilz[o] | LD_WRITTEN;
    const float uy1 = fbits(p.iuy1[o]);
    const int colbase = p.icol[o];
    const float thf = (float)th, dby = (float)(by - ty);
    const int thb = max(th, 1);
    // colbase * rows in wrapping i32, as the reference computes it
    const int col_ix = (int)((unsigned)colbase * (unsigned)p.rows);
    ROLLED
    for (int y = y0; y <= y1; ++y) {
      const float ay = __fdiv_rn((float)(y - ty), dby);
      int tyv = as_i16(__fadd_rn(thf, __fmul_rn(ay, uy1))) + off_y;
      tyv = wrap_tex(tyv, thb, 0);
      int t_ix = (int)((unsigned)col_ix + (unsigned)tyv);
      t_ix = min(max(t_ix, 0), p.n_atlas - 1);
      const int packed = p.atlas[t_ix];
      if (packed & 0x100) {
        const long q = pix0 + (long)y * W;
        p.idx[q] = -2 - (packed & 0xFF);
        p.ld[q] = ldw;
        ylo = min(ylo, y);
        yhi = max(yhi, y);
      }
    }
  }

  shade_marked_rows(p.idx, p.ld, p.rgb, p.pal, p.inv_255, pix0, W, ylo, yhi);
}

}  // namespace

extern "C" {

int doom_items(
    const int* iword, const int* icol, const int* ibyty, const int* ioffth,
    const int* ilz, const int* iuy1, const int* ivpx, const int* ivpy,
    const int* icnt, const int* atlas, int n_atlas, int rows, const int* pal,
    const int* cspan, const int* cd2, const int* clsx, const int* clsy,
    const int* clex, const int* cley, const int* ccnt,
    int B, int W, int H, int KI, int KC, float inv_255,
    int* idx, int* ld, int* rgb, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  Params p{iword, icol, ibyty, ioffth, ilz, iuy1, ivpx, ivpy, icnt,
           atlas, n_atlas, rows, pal,
           cspan, cd2, clsx, clsy, clex, cley, ccnt,
           B, W, H, KI, KC, inv_255, idx, ld, rgb};
  dim3 grid((W + THREADS - 1) / THREADS, B);
  items_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* doom_items_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
