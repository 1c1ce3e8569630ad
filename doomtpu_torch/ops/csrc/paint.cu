// Paint kernel: walls, visplanes and sky drawn at emit time, then the
// composite (planes over walls) and the shade, for B cameras.
//
// Replaces doomtpu/ops/pallas_paint.py::_kernel (the TPU kernel launched
// by render_paint).  Computes the same outputs bit for bit; the plain
// PyTorch version is doomtpu_torch/ops/paint.py::paint_reference; the
// seg row layout and the span word are in layout.cuh (with
// doomtpu_torch/ops/layout.py).
//
// Design: a block takes one camera and a tile of TC screen columns, and
// keeps the tile's frame in shared memory: per pixel a 16-bit texel |
// PLANE and the 32-bit ld word.  The wall and plane buffers of the
// reference merge there, since its composite takes a plane-written
// pixel from the planes and any other from the walls: a plane write
// always lands, a wall write only where no plane has written.  The
// block is TC x R threads; thread (c, g) serves column c and band g of
// its rows, [g * BH, (g + 1) * BH).
//
// Warp 0 lists, in traversal order, the camera's active segs whose x
// range meets the tile and that the live-seg cap keeps at the tile's
// 128-column block (`drop`, ops/paint.py::live_drop; a tile never
// straddles two blocks), up to LIST a round, one ballot per 32 rows.
// The list is taken R segs a step, in three phases split by barriers:
// (1) thread g does seg g's divides at its column (texture column, 1/z
// distance, each piece's bottom and top row: the terms that do not
// depend on the occlusion state) into shared memory; (2) band 0 alone
// walks the R segs front to back with the occlusion state (hor / fo /
// co) in registers, emits the mid and clip records, and records the
// column's paint jobs (rows, kind, seg) in the order they land;
// (3) every band paints its rows of the column's jobs, in that order,
// two rows a loop step so that two texel loads are in flight.  The
// block stops once every column is closed.  Last, each thread
// composites and shades its band's rows and stores idx / ld / rgb
// once: with TC = 32 a warp stores 32 consecutive columns of one row.
// The per-camera overflow sums of a camera's tiles meet in `ovf`
// through integer atomics (the wrapper zeroes it).  Pool slots past a
// column's count are not written (every consumer reads a column's
// slots below its count only).
//
// TC and R come from ops/paint.py::paint_tile: TC = 32 columns while the
// block's shared memory fits the 227 KB a block may use, fewer above;
// R bands of ~BAND_ROWS rows, at most 256 threads.  Measured on an H100
// (e1m1-scale, 4096 cameras, 320x200; PERF.md): 8 bands beat 1, 2 and
// 4 (5.2 ms against 10.9, 7.9 and 6.6); 64 registers, no spills, 53 KB
// of shared memory a block, 4 blocks (32 warps) an SM.
//
// What bounds it on the card: not bytes (5.2 ms against a 1.08 ms byte
// bound: idx / ld / rgb written once, the pools only in their occupied
// slots) but the walk and the painting, each thread's dependent chain
// of row loads, IEEE divides and texel gathers into tex / flat / sky
// tables resident in L2, with warps of one tile diverging over jobs of
// different kinds and lengths.  The cost probe (PAINT_PROBE below)
// splits it: ~1.1 ms init and outputs, ~0.3 ms the seg lists and
// x-range checks, ~1.5 ms the terms and the walk, ~2.2 ms painting.
//
// Numerics: compiled with -fmad=false; the parity-critical products also
// use __fmul_rn and every division __fdiv_rn, so no product is ever
// contracted into an FMA.  Where the JAX kernel divides by a constant,
// XLA multiplies by the constant's f32 reciprocal, and so does this
// kernel (inv_* parameters).  Trig arrives per camera from the host.

#include "layout.cuh"

// Every row loop stays rolled.  Measured with nvcc 12.8 for sm_90a: the
// unrolled form of the variable-bound paint loops ran one row past its
// bound (a one-row wall overdraw at span boundaries: 608 idx/ld/rgb
// elements off on the demo fixture at B=8); `#pragma unroll 1` and
// `-Xptxas -O0` both give exact results.
#define ROLLED _Pragma("unroll 1")

// PAINT_PROBE, set only by the cost probe's libraries (ops/build.py
// VARIANTS): 1 init and outputs only; 2 + the seg lists and the x-range
// checks; 3 + the terms, the occlusion walk and the records, without
// painting.  Unset: the full kernel.
#ifndef PAINT_PROBE
#define PAINT_PROBE 4
#endif

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int LD_SKY = 1 << 25;
constexpr int SKY_W = 256;
constexpr int SKY_H = 128;
constexpr int FLAT = 64;
constexpr int PLANE = 1 << 8;   // texel word: a plane wrote the pixel
// a block: at most 256 threads, 4 blocks an SM (64 registers a thread)
constexpr int MAX_THREADS = 256, MIN_BLOCKS = 4;
constexpr int LIST = 256;       // rows of the tile's seg list per round
constexpr int TERMS = 6;        // per (seg, column): tx_base, zdist, by|ty x4
constexpr int JOBS = 4;         // paint jobs a seg gives a column, at most
constexpr int JOB_FLOOR = 4, JOB_CEIL = 5;   // job kinds; 0-3: wall piece

constexpr int MID_PLANES = 7, CLIP_PLANES = 7;

struct Params {
  const int* rows; const int* scnt;
  const int* drop;   // [B, G] bit w: the row is dropped at block w; or null
  const float* camf; const int* cami;
  int B, G;
  const int* tex; int TH, TW;
  const int* flats; const int* sky; const int* pal;
  int W, H, KM, KC, pow2, twq;
  float half_w, half_h, inv_aspect, wx_c, eye, inv_w, inv_h, inv_255;
  int TC, R, BH, ntiles;
  int* idx; int* ld; int* rgb;
  int* mpool; int* cpool; int* cnt_mid; int* cnt_clip; int* ovf;
};

// One thread's view of its column: the tile frame's column in shared
// memory and the band of rows it paints.
struct Column {
  const Params& P;
  int x;
  uint16_t* stex;    // texel | PLANE, row y at stex[y * TC]
  int* sld;          // ld word, row y at sld[y * TC]
  int ylo, yhi;      // the band's rows

  // wall column rows [ct, cb] (this band's part): v by linear
  // interpolation over the full (unclipped) bottom..top edges + offset,
  // wrapped (bitmap_render.rs:253-263).  Lands where no plane wrote.
  __device__ void paint_wall(int ct, int cb, int by, int ty, int tx,
                             int zdist, int light, const int* pw) {
    const int y0 = max(ct, ylo), y1 = min(cb, yhi);
    if (y0 > y1) return;
    const int thb = max(pw[P_TH], 1);
    const float uy1 = fbits(pw[P_UY1RAW]);
    const int offy = pw[P_OFFY];
    const int* texp = P.tex + (size_t)pw[P_TEX] * P.TH * P.TW;
    const int txc = min(max(tx, 0), P.twq - 1);
    const int ldw = (shl(light, 16) | LD_WRITTEN) | (zdist & 0xFFFF);
    const float denom = (float)(by - ty);
    auto texel_at = [&](int y) {
      float ay = __fdiv_rn((float)(y - ty), denom);
      int tyv = as_i16(__fadd_rn((float)thb, __fmul_rn(ay, uy1))) + offy;
      tyv = wrap_tex(tyv, thb, P.pow2);
      tyv = min(max(tyv, 0), P.TH - 1);
      return texp + (size_t)tyv * P.TW + txc;
    };
    // two rows a step, both texel loads in flight before either store
    ROLLED for (int y = y0; y <= y1; y += 2) {
      const bool two = y < y1;
      const int o = y * P.TC;
      const bool w0 = !(stex[o] & PLANE);
      const bool w1 = two && !(stex[o + P.TC] & PLANE);
      const int* a0 = texel_at(y);
      const int* a1 = two ? texel_at(y + 1) : a0;
      const int t0 = w0 ? *a0 : 0, t1 = w1 ? *a1 : 0;
      if (w0) {
        stex[o] = t0 & 0xFF;
        sld[o] = ldw;
      }
      if (w1) {
        stex[o + P.TC] = t1 & 0xFF;
        sld[o + P.TC] = ldw;
      }
    }
  }

  // floor/ceiling/sky span rows [y0, y1] (this band's part): per-pixel
  // inverse projection + flat sample (visplanes.rs:82-152) or sky
  // columns (visplanes.rs:42-80)
  __device__ void paint_plane(int y0, int y1, int fl, bool is_sky, int h,
                              int light, float cosv, float sinv, float fh,
                              int pxi, int pyi, int stx) {
    y0 = max(y0, ylo);
    y1 = min(y1, yhi);
    if (y0 > y1) return;
    const float wz = __fsub_rn(__fsub_rn((float)h, fh), P.eye);
    const float vx = __fmul_rn(__fsub_rn(P.half_w, (float)x), P.inv_aspect);
    const int ldc = shl(light, 16) | LD_WRITTEN | (is_sky ? LD_SKY : 0);
    const int* flatp = P.flats + (size_t)fl * FLAT * FLAT;
    // the texel's address and the ld word of row y
    auto texel_at = [&](int y, int& ldv) {
      const float vy = __fsub_rn(P.half_h, (float)y);
      const float wx = __fdiv_rn(__fmul_rn(P.wx_c, wz), vy);
      ldv = ldc | (as_i16(wx) & 0xFFFF);
      if (is_sky) {
        int sty = as_i16(__fmul_rn(
            __fmul_rn(__fmul_rn((float)y, (float)SKY_H), 2.f), P.inv_h));
        if (sty < 0) sty += SKY_H;
        sty %= SKY_H;
        sty = min(max(sty, 0), SKY_H - 1);
        return P.sky + sty * SKY_W + stx;
      }
      const float wy = __fdiv_rn(__fmul_rn(wz, vx), vy);
      const float rx = __fsub_rn(__fmul_rn(wx, cosv), __fmul_rn(wy, sinv));
      const float ry = __fadd_rn(__fmul_rn(wy, cosv), __fmul_rn(wx, sinv));
      const int ftx = (as_i16(rx) + pxi) & (FLAT - 1);
      const int fty = (as_i16(ry) + pyi) & (FLAT - 1);
      return flatp + fty * FLAT + ftx;
    };
    // two rows a step, both texel loads in flight before either store
    ROLLED for (int y = y0; y <= y1; y += 2) {
      const bool two = y < y1;
      int l0, l1 = 0;
      const int* a0 = texel_at(y, l0);
      const int* a1 = two ? texel_at(y + 1, l1) : a0;
      const int t0 = *a0, t1 = *a1;
      const int o = y * P.TC;
      stex[o] = (t0 & 0xFF) | PLANE;
      sld[o] = l0;
      if (two) {
        stex[o + P.TC] = (t1 & 0xFF) | PLANE;
        sld[o + P.TC] = l1;
      }
    }
  }
};

// The walker's records: mid and clip pool slots and their overflow.
struct Emitter {
  const Params& P;
  int b, x;
  int cnt_m, cnt_c, ovf_m, ovf_c;

  __device__ void emit_clip(int rec, int d2, int g, const int* row) {
    if (cnt_c < P.KC) {
      const int vals[CLIP_PLANES] = {rec, d2, g, row[R_LSX], row[R_LSY],
                                     row[R_LEX], row[R_LEY]};
      const size_t plane = (size_t)P.B * P.KC * P.W;
      size_t o = ((size_t)b * P.KC + cnt_c) * P.W + x;
#pragma unroll
      for (int i = 0; i < CLIP_PLANES; ++i) P.cpool[i * plane + o] = vals[i];
      ++cnt_c;
    } else {
      ++ovf_c;
    }
  }

  __device__ void emit_mid(const int (&vals)[MID_PLANES]) {
    if (cnt_m < P.KM) {
      const size_t plane = (size_t)P.B * P.KM * P.W;
      size_t o = ((size_t)b * P.KM + cnt_m) * P.W + x;
#pragma unroll
      for (int i = 0; i < MID_PLANES; ++i) P.mpool[i * plane + o] = vals[i];
      ++cnt_m;
    } else {
      ++ovf_m;
    }
  }
};

// The terms of a seg at one column that do not depend on the occlusion
// state: the texture column before the piece's wrap, the column's 1/z
// distance (the divides) and each active piece's bottom | top row.
__device__ __forceinline__ void seg_terms(const int* row, int x, int* t,
                                          int TC) {
  const int x0 = row[R_X0], x1 = row[R_X1], flags = row[R_FLAGS];
  const float dx = (float)wsub(x, x0);
  const float ax = __fdiv_rn(dx, (float)wsub(x1, x0));
  const float uz0 = fbits(row[R_LSX]);
  const float uz1 = fbits(row[R_LEX]);
  const float inv0 = __fdiv_rn(1.f, uz0);
  const float inv1 = __fdiv_rn(1.f, uz1);
  const float oma = __fsub_rn(1.f, ax);
  const float denom = __fadd_rn(__fmul_rn(oma, inv0), __fmul_rn(ax, inv1));
  const float u = __fdiv_rn(
      __fadd_rn(__fmul_rn(oma, __fdiv_rn(0.f, uz0)),
                __fmul_rn(ax, __fdiv_rn(fbits(row[R_LENGTH]), uz1))),
      denom);
  t[0] = as_i16(u) + as_i16(fbits(row[R_SOFF])) + row[R_OFFX];
  t[TC] = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));
  for (int p = 0; p < 4; ++p) {
    if (!(flags & (1 << p))) continue;
    const int* pw = row + R_PIECE0 + P_WORDS * p;
    const int by = as_i16(__fadd_rn(fbits(pw[P_YBS]),
                                    __fmul_rn(dx, fbits(pw[P_YBD]))));
    const int ty = as_i16(__fadd_rn(fbits(pw[P_YTS]),
                                    __fmul_rn(dx, fbits(pw[P_YTD]))));
    t[(2 + p) * TC] = pack16(by, ty);
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
paint_kernel(const Params P) {
  extern __shared__ int smem[];
  const int TC = P.TC, R = P.R, H = P.H;
  int* sld = smem;                             // [H][TC] ld words
  uint16_t* stex = (uint16_t*)(sld + H * TC);  // [H][TC] texel | PLANE
  int* list = sld + H * TC + (H * TC + 1) / 2; // [LIST] rows of the tile
  int* terms = list + LIST;                    // [R][TERMS][TC]
  int* jobs = terms + R * TERMS * TC;          // [JOBS * R][2][TC]
  int* njobs = jobs + 2 * JOBS * R * TC;       // [TC]
  int* col_open = njobs + TC;                    // [TC] column not closed
  int* meta = col_open + TC;                     // list length, next row
  const int b = blockIdx.x / P.ntiles;
  const int tx0 = (blockIdx.x % P.ntiles) * TC;   // the tile's columns
  const int tx1 = min(tx0 + TC, P.W) - 1;
  const int c = threadIdx.x, g = threadIdx.y, tid = g * TC + c;
  const int x = tx0 + c;
  const bool live = x <= tx1;
  Column col{P, x, stex + c, sld + c, g * P.BH, min((g + 1) * P.BH, H) - 1};
  if (live) {
    ROLLED for (int y = col.ylo; y <= col.yhi; ++y) {
      col.stex[y * TC] = 0;
      col.sld[y * TC] = 0;
    }
  }

  const float cosv = P.camf[b * 3 + 0];
  const float sinv = P.camf[b * 3 + 1];
  const float fh = P.camf[b * 3 + 2];
  const int pxi = P.cami[b * 3 + 0];
  const int pyi = P.cami[b * 3 + 1];
  const int txoff = P.cami[b * 3 + 2];
  // sky column of this screen column (row-invariant)
  const int stx = min(max(
      (as_i16(__fmul_rn(__fmul_rn((float)x, (float)SKY_W), P.inv_w))
       + txoff) % SKY_W, 0), SKY_W - 1);

  // the walker (band 0) of each column: occlusion state and records
  Emitter em{P, b, x, 0, 0, 0, 0};
  bool hor = !live;      // a column past the screen's edge walks nothing
  int fo = H, co = -1;
  if (g == 0) col_open[c] = !hor;
  const int n = P.scnt[b];
  const int* rows_b = P.rows + (size_t)b * P.G * NR;
#if PAINT_PROBE >= 2
  int next = 0;          // warp 0: the next row to cull
  for (;;) {
    if (!__syncthreads_or(g == 0 && !hor)) break;
    // warp 0 lists, in traversal order, the next rows whose x range
    // meets the tile, up to LIST of them
    if (tid < 32) {
      const int lanes = min(32, TC * R);
      const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
      int m = 0;
      while (next < n) {
        const int k = next + tid;
        bool keep = false;
        if (k < n) {
          const int* row = rows_b + (size_t)k * NR;
          keep = (row[R_FLAGS] & 15) != 0 && clamp_i16(row[R_X1]) >= tx0
                 && clamp_i16(row[R_X0]) <= tx1
                 && !(P.drop && ((P.drop[(size_t)b * P.G + k] >> (tx0 >> 7))
                                 & 1));
        }
        const unsigned ball = __ballot_sync(mask, keep);
        if (m + __popc(ball) > LIST) break;
        if (keep) list[m + __popc(ball & ((1u << tid) - 1u))] = k;
        m += __popc(ball);
        next += lanes;
      }
      if (tid == 0) {
        meta[0] = m;
        meta[1] = next;
      }
    }
    __syncthreads();
    const int m = meta[0];
    const bool more = meta[1] < n;
    for (int j0 = 0; j0 < m; j0 += R) {
      if (j0 > 0 && !__syncthreads_or(g == 0 && !hor)) break;
      const int S = min(R, m - j0);      // segs of this step
#if PAINT_PROBE >= 3
      // (1) thread g: the state-free terms of seg j0 + g at its column
      if (g < S && col_open[c]) {
        const int* row = rows_b + (size_t)list[j0 + g] * NR;
        if (x >= clamp_i16(row[R_X0]) && x <= clamp_i16(row[R_X1]))
          seg_terms(row, x, terms + g * TERMS * TC + c, TC);
      }
      __syncthreads();
#endif
      // (2) band 0 walks the S segs front to back: the occlusion state,
      // the records, and the paint jobs in the order they land
      if (g == 0) {
        int nj = 0;
        for (int i = 0; i < S && !hor; ++i) {
          const int* row = rows_b + (size_t)list[j0 + i] * NR;
          const int flags = row[R_FLAGS];
          // outside [x0, x1] every piece of this seg is a no-op here
          if (x < clamp_i16(row[R_X0]) || x > clamp_i16(row[R_X1])) continue;
#if PAINT_PROBE == 2
          ++em.cnt_c;   // keeps the checks live
          continue;
#endif
          const bool two_sided = flags & 16;
          const bool draw_c = flags & 32;
          const bool f_sky = flags & 1024;
          const bool c_sky = flags & 2048;
          const bool has_mid = flags & (1 << 12);
          const int light = row[R_LIGHT];
          const int g_id = row[R_G];
          const int* t = terms + i * TERMS * TC + c;
          const int zdist = t[TC];
          int* job = jobs + c;
          // a job: rows y0 | y1 and kind | seg << 4
          auto push = [&](int y0, int y1, int kind) {
            if (y0 > y1) return;
            job[2 * nj * TC] = pack16(y0, y1);
            job[(2 * nj + 1) * TC] = kind | (i << 4);
            ++nj;
          };

          for (int p = 0; p < 4 && !hor; ++p) {
            if (!(flags & (1 << p))) continue;
            const int* pw = row + R_PIECE0 + P_WORDS * p;
            const bool draws_p = flags & (64 << p);
            const int cd2 = t[(2 + p) * TC];
            const int by = cd2 >> 16, ty = lo16(cd2);
            const int cb = min(H - 1, min(fo, by));
            const int ct = max(0, max(co, ty));
            const bool in_ver = cb >= ct;       // the column is open here

            if (p == 0) {
              const bool solid = !two_sided;
              const bool gap = !in_ver && fo > co;
              const bool keep_g = min(H - 1, fo) - max(0, co) > 1;
              const bool gap_b = gap && by <= co;
              const bool gap_t = gap && draw_c && ty >= fo;
              int rec = pack_span(KIND_WALL, ct, cb) | SPAN_E2B | SPAN_E2T;
              if (!draws_p) rec |= SPAN_NODRAW;
              const bool m_e = in_ver && solid;
              const bool fl_keep = f_sky || (min(H - 1, fo) - cb > 1);
              const bool fl_emit =
                  in_ver && cb < fo && cb != H - 1 && fl_keep;
              const bool m_f = fl_emit || (gap_b && (f_sky || keep_g));
              const bool ce_keep =
                  c_sky || (min(H - 1, ct) - max(0, co) > 1);
              const bool ce_emit = in_ver && draw_c && ct > co && ce_keep;
              const bool m_c = ce_emit || (gap_t && (c_sky || keep_g));
              if (m_e) em.emit_clip(rec, cd2, g_id, row);
              if (m_e && draws_p) push(ct, cb, 0);
              if (m_f)
                push(max(min(max(fl_emit ? cb : co, -1), 254), 0),
                     min(min(max(fo, -1), 254), H - 1), JOB_FLOOR);
              if (m_c)
                push(max(min(max(co, -1), 254), 0),
                     min(min(max(ce_emit ? ct : fo, -1), 254), H - 1),
                     JOB_CEIL);
              if (in_ver && two_sided) {
                fo = cb;
                if (draw_c) co = ct;
              }
              if (solid || gap_b || gap_t) {
                hor = true;
                fo = H / 2;
                co = H / 2;
              }
            } else if (p == 1) {
              if (!in_ver) continue;
              const int rec =
                  pack_span(KIND_MID, ct, cb) | (draw_c ? SPAN_DC : 0);
              em.emit_clip(rec, cd2, g_id, row);
              if (has_mid) {
                const int tx = wrap_tex(t[0], max(pw[P_TW], 1), P.pow2);
                const int vals[MID_PLANES] = {
                    rec, pw[P_TEX] * P.TW + tx, cd2,
                    pack16(pw[P_OFFY], pw[P_TH]), pack16(light, zdist),
                    pw[P_UY1], g_id};
                em.emit_mid(vals);
              }
            } else {
              if (!in_ver) continue;
              int rec = pack_span(KIND_WALL, ct, cb)
                        | (p == 2 ? SPAN_E2B : SPAN_E2T);
              if (!draws_p) rec |= SPAN_NODRAW;
              em.emit_clip(rec, cd2, g_id, row);
              if (draws_p) push(ct, cb, p);
              if (p == 2) fo = ct; else co = cb;
            }
          }
        }
        njobs[c] = nj;
        col_open[c] = !hor;
      }
#if PAINT_PROBE >= 4
      __syncthreads();
      // (3) every band paints its rows of the column's jobs, in order
      if (live) {
        const int nj = njobs[c];
        const int* job = jobs + c;
        for (int q = 0; q < nj; ++q) {
          const int yy = job[2 * q * TC];
          const int y0 = yy >> 16, y1 = lo16(yy);
          if (max(y0, col.ylo) > min(y1, col.yhi)) continue;
          const int kind = job[(2 * q + 1) * TC];
          const int i = kind >> 4;
          const int* row = rows_b + (size_t)list[j0 + i] * NR;
          const int light = row[R_LIGHT];
          const int* t = terms + i * TERMS * TC + c;
          if ((kind & 15) < JOB_FLOOR) {
            const int p = kind & 15;
            const int* pw = row + R_PIECE0 + P_WORDS * p;
            const int cd2 = t[(2 + p) * TC];
            const int tx = wrap_tex(t[0], max(pw[P_TW], 1), P.pow2);
            col.paint_wall(y0, y1, cd2 >> 16, lo16(cd2), tx, t[TC], light,
                           pw);
          } else {
            const int f = (kind & 15) - JOB_FLOOR;   // 0 floor, 1 ceiling
            col.paint_plane(y0, y1, row[R_FLAT + f],
                            row[R_FLAGS] & (1024 << f), row[R_PLANEH + f],
                            light, cosv, sinv, fh, pxi, pyi, stx);
          }
        }
      }
#endif
    }
    if (!more) break;
  }
#endif
  if (!live) return;

  // composite (plane over wall, merged in shared memory) + shade
  // (bitmap_render.rs:190-208)
  const size_t fb = (size_t)b * H * P.W + x;
  ROLLED for (int y = col.ylo; y <= col.yhi; ++y) {
    const int texel = col.stex[y * TC] & 0xFF;
    const int ldw = col.sld[y * TC];
    const bool written = ldw & LD_WRITTEN;
    const bool is_sky = ldw & LD_SKY;
    const int light = (ldw >> 16) & 0xFF;
    const int dist = (int)(int16_t)(ldw & 0xFFFF);
    const int rgbw = P.pal[texel];
    float factor = __fsub_rn(__fmul_rn((float)light, P.inv_255),
                             __fmul_rn((float)dist, 1.f / 4096.f));
    factor = fmaxf(factor, 0.f);
    if (is_sky) factor = 1.f;
    int packed = 0;
#pragma unroll
    for (int shift = 16; shift >= 0; shift -= 8) {
      const float chan = (float)((rgbw >> shift) & 0xFF);
      float v = truncf(__fmul_rn(chan, factor));
      v = fminf(fmaxf(v, 0.f), 255.f);
      packed |= (int)v << shift;
    }
    const size_t o = fb + (size_t)y * P.W;
    P.idx[o] = written ? texel : -1;
    P.ld[o] = ldw;
    P.rgb[o] = written ? packed : 0;
  }
  if (g == 0) {
    P.cnt_mid[(size_t)b * P.W + x] = em.cnt_m;
    P.cnt_clip[(size_t)b * P.W + x] = em.cnt_c;
    if (em.ovf_m) atomicAdd(&P.ovf[b * 2 + 0], em.ovf_m);
    if (em.ovf_c) atomicAdd(&P.ovf[b * 2 + 1], em.ovf_c);
  }
}

// a block's shared memory (ops/paint.py::paint_smem_bytes)
size_t smem_bytes(int tc, int bands, int H) {
  const size_t pixels = (size_t)tc * H;
  return (pixels + (pixels + 1) / 2 + LIST + (TERMS + 2 * JOBS) * bands * tc
          + 2 * tc + 2) * sizeof(int);
}

// raise the kernel's dynamic shared memory limit to `smem` (never lower)
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      paint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace

extern "C" {

// tc columns per block, bands threads per column (tc * bands <= 256);
// ovf must hold zeros.
int doom_paint(const int* rows, const int* scnt, const int* drop,
               const float* camf, const int* cami, int B, int G,
               const int* tex, int TH, int TW, const int* flats,
               const int* sky, const int* pal,
               int W, int H, int KM, int KC, int pow2, int twq,
               float half_w, float half_h, float inv_aspect, float wx_c,
               float eye, float inv_w, float inv_h, float inv_255,
               int tc, int bands,
               int* idx, int* ld, int* rgb,
               int* mpool, int* cpool, int* cnt_mid, int* cnt_clip, int* ovf,
               void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return (int)cudaSuccess;
  if (tc < 1 || bands < 1 || tc * bands > MAX_THREADS)
    return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (W + tc - 1) / tc;
  const int bh = (H + bands - 1) / bands;
  Params P{rows, scnt, drop, camf, cami, B, G, tex, TH, TW, flats, sky, pal,
           W, H, KM, KC, pow2, twq, half_w, half_h, inv_aspect, wx_c, eye,
           inv_w, inv_h, inv_255, tc, bands, bh, ntiles,
           idx, ld, rgb, mpool, cpool, cnt_mid, cnt_clip, ovf};
  const size_t smem = smem_bytes(tc, bands, H);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  paint_kernel<<<(unsigned)B * ntiles, dim3(tc, bands), smem,
                 (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// blocks of tc x bands threads at height H the card keeps on one SM
int doom_paint_blocks_per_sm(int tc, int bands, int H) {
  const size_t smem = smem_bytes(tc, bands, H);
  if (allow_smem(smem) != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, paint_kernel,
                                                tc * bands, smem);
  return blocks;
}

int doom_row_words() { return NR; }

const char* doom_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
