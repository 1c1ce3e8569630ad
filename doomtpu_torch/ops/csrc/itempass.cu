// Item-pass kernel: every selected sprite and masked mid of a camera
// painted over its paint frame, with no per-column item cap, then the
// shade of the pixels the items wrote.
//
// Replaces doomtpu/ops/pallas_itempass.py::_kernel (the TPU kernel
// launched by item_pass).  Computes the same outputs bit for bit; the
// plain PyTorch version is doomtpu_torch/ops/itempass.py::
// item_pass_reference, and the item pack's rows are described there.
//
// Design: one thread per (camera, screen column), 128 columns per block,
// a 2-D grid of column blocks x cameras.  A thread walks its camera's N
// items in pack order (farthest first), skipping invalid items and items
// whose [x0, x1e) misses its column.  For a sprite it computes the
// billboard column math (u, zdist, bottom and top rows) and folds the
// column's clip records (renderer/map_objects.rs:127-166); for a masked
// mid it takes the last matching record of the column's mid pool.  Then,
// per row of [ct, cb], it interpolates v, reads texel | opaque << 8 from
// the unpacked column atlas at the picture's column, and where opaque
// overwrites idx with -2 - texel (a mark: the paint frame's idx is -1 or
// a texel) and ld with light | zdist | written.  Nearer items overwrite
// farther ones, so the frame holds the painter's winner; a last pass
// over the rows the thread wrote shades each marked pixel and restores
// its idx.  Every element has one writer: its column's thread.  The TPU
// kernel's per-(tile, 128-column block) live-item lists, 4-item scalar
// packs, tile-uniform picture windows and 8-row blocks are TPU devices
// and have no counterpart.
//
// What bounds it on the card: bytes and latency, not FLOPs.  The bytes
// it must move are the item packs (80 B per item and camera; 12 B of an
// item that covers none of its camera's columns), the occupied clip and
// mid records of the columns items cover, and 12 B per pixel it writes;
// the atlas (a few MB) stays in L2.  Each thread reads its camera's
// pack rows (the same words for all 128 threads of a block: one
// broadcast load each), so the pack costs latency per item, not
// bandwidth: every thread walks all N items, although at e1m1-scale
// only about a fifth of (camera, item) pairs cover any column.  The
// clip records are re-read once per sprite that covers the column (L1
// / L2 hits after the first).  Row stores of one warp hit 32 columns of
// a row: adjacent words, coalesced.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn / __fdiv_rn; x / y is an IEEE divide.  The
// shade multiplies by inv_255 (layout.cuh, shade_marked_rows).

#include "layout.cuh"

// Every row loop stays rolled (see paint.cu: nvcc 12.8 for sm_90a drew
// one row past a span's end with such loops unrolled).
#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int THREADS = 128;
constexpr int PIC = 128;   // the JAX kernel's 128 x 128 picture tables

// item pack rows (ops/itempass.py IPI_* / IPF_*)
constexpr int IPI_FL = 0, IPI_X0 = 1, IPI_X1E = 2, IPI_LW = 3, IPI_PIC = 4;
constexpr int IPI_TH = 5, IPI_SOFF = 6, IPI_BSX = 7, IPI_ROWS = 8;
constexpr int IPF_DX = 0, IPF_INV0 = 1, IPF_INV1 = 2, IPF_Z0 = 3;
constexpr int IPF_Z1 = 4, IPF_YBS = 5, IPF_YBD = 6, IPF_YTS = 7;
constexpr int IPF_YTD = 8, IPF_UY1 = 9, IPF_VPX = 10, IPF_VPY = 11;
constexpr int IPF_ROWS = 12;

struct Params {
  const int* ipk; const float* fpk; int N;   // [B, N, 8] i32, [B, N, 12] f32
  // clip pool planes, each [B, KC, W]
  const int* cspan; const int* cd2; const int* clsx; const int* clsy;
  const int* clex; const int* cley; const int* ccnt;   // [B, W]
  // mid pool planes, each [B, KM, W]
  const int* mspan; const int* md1; const int* md2; const int* md3;
  const int* md4; const int* md5; const int* md6; const int* mcnt;
  const int* atlas; int n_atlas, rows;   // [C * rows] texel | opaque << 8
  int T, TW, spr0, PW;                   // picture -> atlas columns
  const int* pal;                        // [256] 0xRRGGBB
  int B, W, H, KC, KM;
  float inv_255;
  int* idx; int* ld; int* rgb;           // [B, H, W], updated in place
};

__global__ void __launch_bounds__(THREADS) itempass_kernel(Params p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const int H = p.H, W = p.W;
  const long bw = (long)b * W + w;
  const long pix0 = (long)b * H * W + w;         // row y at + y * W
  const long clip0 = (long)b * p.KC * W + w;     // record k at + k * W
  const long mid0 = (long)b * p.KM * W + w;
  const int ccnt = min(p.ccnt[bw], p.KC);
  const int mcnt = min(p.mcnt[bw], p.KM);
  const int* ip = p.ipk + (long)b * p.N * IPI_ROWS;
  const float* fp = p.fpk + (long)b * p.N * IPF_ROWS;
  const int n_rows = min(p.rows, PIC);
  int ylo = H, yhi = -1;

  ROLLED
  for (int n = 0; n < p.N; ++n) {
    const int* ir = ip + (long)n * IPI_ROWS;
    const int fl = __ldg(ir + IPI_FL);
    if (!(fl & 1) || w < __ldg(ir + IPI_X0) || w >= __ldg(ir + IPI_X1E))
      continue;
    const int soff = __ldg(ir + IPI_SOFF);
    const int pic = __ldg(ir + IPI_PIC);
    int ct, cb, by, ty, tx, offy, th, light, zd;
    float uy1;
    if (fl & 2) {
      // the sprite's billboard column math
      const float* fr = fp + (long)n * IPF_ROWS;
      const float xb = (float)wsub(w, __ldg(ir + IPI_BSX));
      const float ax = __fdiv_rn(xb, __ldg(fr + IPF_DX));
      const float oma = __fsub_rn(1.0f, ax);
      const float denom = __fadd_rn(__fmul_rn(oma, __ldg(fr + IPF_INV0)),
                                    __fmul_rn(ax, __ldg(fr + IPF_INV1)));
      const float u = __fdiv_rn(
          __fadd_rn(__fmul_rn(oma, __ldg(fr + IPF_Z0)),
                    __fmul_rn(ax, __ldg(fr + IPF_Z1))),
          denom);
      const int lw = __ldg(ir + IPI_LW);
      tx = wrap_tex(as_i16(u) + soff, max(lw >> 16, 1), 0);
      zd = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));
      by = as_i16(__fadd_rn(__ldg(fr + IPF_YBS),
                            __fmul_rn(xb, __ldg(fr + IPF_YBD))));
      ty = as_i16(__fadd_rn(__ldg(fr + IPF_YTS),
                            __fmul_rn(xb, __ldg(fr + IPF_YTD))));
      int tsc, bsc;
      clip_fold(p.cspan, p.cd2, p.clsx, p.clsy, p.clex, p.cley, clip0, W,
                ccnt, __ldg(fr + IPF_VPX), __ldg(fr + IPF_VPY), H, tsc, bsc);
      ct = max(max(0, ty), tsc);
      cb = min(min(H - 1, by), bsc);
      offy = 0;
      th = __ldg(ir + IPI_TH);
      light = lw & 0xFFFF;
      uy1 = __ldg(fr + IPF_UY1);
    } else {
      // the mid's draw data: the last record of its seg in the mid pool
      int k_hit = -1;
      ROLLED
      for (int k = 0; k < mcnt; ++k) {
        const long o = mid0 + (long)k * W;
        if (((p.mspan[o] >> 29) & 3) == KIND_MID && p.md6[o] == soff)
          k_hit = k;
      }
      if (k_hit < 0) continue;
      const long o = mid0 + (long)k_hit * W;
      const int mw = p.mspan[o], d2 = p.md2[o], d3 = p.md3[o],
                d4 = p.md4[o];
      ct = ((mw >> 8) & 255) - 1;
      cb = (mw & 255) - 1;
      by = d2 >> 16;
      ty = lo16(d2);
      tx = wsub(p.md1[o], wmul(pic, p.TW));
      offy = d3 >> 16;
      th = lo16(d3);
      light = d4 >> 16;
      zd = lo16(d4);
      uy1 = fbits(p.md5[o]);
    }
    const int y0 = max(ct, 0), y1 = min(cb, H - 1);
    if (y0 > y1) continue;

    // the picture's column in the atlas (JAX item_q / item_mq: 128 x 128)
    const int c = min(max(tx, 0), PIC - 1);
    const bool is_tex = pic < p.T;
    if (c >= (is_tex ? p.TW : p.PW)) continue;      // transparent column
    const int col = wadd(is_tex ? wmul(pic, p.TW)
                                : wadd(p.spr0, wmul(wsub(pic, p.T), p.PW)),
                         c);
    const int col_ix = wmul(col, p.rows);
    const int ldw = shl(light, 16) | (zd & 0xFFFF) | LD_WRITTEN;
    const float thf = (float)th, dby = (float)(by - ty);
    const int thb = max(th, 1);
    ROLLED
    for (int y = y0; y <= y1; ++y) {
      const float ay = __fdiv_rn((float)(y - ty), dby);
      int tyv = as_i16(__fadd_rn(thf, __fmul_rn(ay, uy1))) + offy;
      tyv = wrap_tex(tyv, thb, 0);
      if (tyv >= n_rows) continue;                  // past the 128 rows
      int t_ix = wadd(col_ix, tyv);
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

int doom_itempass(
    const int* ipk, const float* fpk, int N,
    const int* cspan, const int* cd2, const int* clsx, const int* clsy,
    const int* clex, const int* cley, const int* ccnt,
    const int* mspan, const int* md1, const int* md2, const int* md3,
    const int* md4, const int* md5, const int* md6, const int* mcnt,
    const int* atlas, int n_atlas, int rows, int T, int TW, int spr0, int PW,
    const int* pal, int B, int W, int H, int KC, int KM, float inv_255,
    int* idx, int* ld, int* rgb, void* stream) {
  if (B <= 0 || W <= 0 || N <= 0) return 0;
  Params p{ipk, fpk, N, cspan, cd2, clsx, clsy, clex, cley, ccnt,
           mspan, md1, md2, md3, md4, md5, md6, mcnt,
           atlas, n_atlas, rows, T, TW, spr0, PW, pal,
           B, W, H, KC, KM, inv_255, idx, ld, rgb};
  dim3 grid((W + THREADS - 1) / THREADS, B);
  itempass_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* doom_itempass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
