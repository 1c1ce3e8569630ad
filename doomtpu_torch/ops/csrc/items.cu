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

__device__ __forceinline__ int lo16(int v) { return (int)(short)(v & 0xFFFF); }

// jnp.minimum / maximum: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// bitmap_render.rs:137-165: is the seg (ls -> le) NOT in front of v
__device__ __forceinline__ bool is_behind_vertex(
    float lsx, float lsy, float lex, float ley, float vx, float vy) {
  float min_x = min_nan(lsx, lex), max_x = max_nan(lsx, lex);
  // is_left_of(v, ls, le): cross(v - ls, le - ls) <= 0
  float ax = __fsub_rn(vx, lsx), ay = __fsub_rn(vy, lsy);
  float bx = __fsub_rn(lex, lsx), by = __fsub_rn(ley, lsy);
  float cross = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
  bool left = cross <= 0.0f;
  return (min_x > vx) || ((max_x > vx) && !left);
}

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
      int tsc = -1, bsc = H;
      ROLLED
      for (int kc = 0; kc < ccnt; ++kc) {
        const long c = clip0 + (long)kc * W;
        if (is_behind_vertex(fbits(p.clsx[c]), fbits(p.clsy[c]),
                             fbits(p.clex[c]), fbits(p.cley[c]), vx, vy))
          continue;
        const int cw = p.cspan[c];
        const bool is_mid = ((cw >> 29) & 3) == KIND_MID;
        const int cd2 = p.cd2[c];
        if (cw & SPAN_E2T) tsc = max(tsc, (cw & 255) - 1);
        if ((cw & SPAN_DC) && is_mid) tsc = max(tsc, lo16(cd2));
        if (cw & SPAN_E2B) bsc = min(bsc, ((cw >> 8) & 255) - 1);
        if (is_mid) bsc = min(bsc, cd2 >> 16);
      }
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

  // shade the item pixels (bitmap_render.rs:190-208) and unmark idx
  ROLLED
  for (int y = ylo; y <= yhi; ++y) {
    const long q = pix0 + (long)y * W;
    const int v = p.idx[q];
    if (v > -2) continue;
    const int texel = -2 - v;
    const int l = p.ld[q];
    const float light = (float)((l >> 16) & 0xFF);
    const float zd = (float)lo16(l);
    float factor = __fsub_rn(__fmul_rn(light, p.inv_255),
                             __fmul_rn(zd, 1.0f / 4096.0f));
    factor = fmaxf(factor, 0.0f);
    const int c = p.pal[texel];
    int packed = 0;
    for (int shift = 16; shift >= 0; shift -= 8) {
      const float chan = (float)((c >> shift) & 0xFF);
      const float byte = fminf(fmaxf(truncf(__fmul_rn(chan, factor)), 0.0f),
                               255.0f);
      packed |= ((int)byte) << shift;
    }
    p.idx[q] = texel;
    p.rgb[q] = packed;
  }
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
