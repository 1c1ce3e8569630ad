// Paint kernel: walls, visplanes and sky drawn at emit time, then the
// composite (planes over walls) and the shade, for B cameras.
//
// Replaces doomtpu/ops/pallas_paint.py::_kernel (the TPU kernel launched
// by render_paint).  Computes the same outputs bit for bit; the plain
// PyTorch version is doomtpu_torch/ops/paint.py::paint_reference; the
// seg row layout and the span word are in layout.cuh (with
// doomtpu_torch/ops/layout.py).
//
// Design: one block per camera, one thread per screen column.  A thread
// walks its camera's active segs front to back, keeps the occlusion
// state (hor / fo / co), the pool slot counts and the overflow counts in
// registers, paints its own column of the wall and plane buffers and
// finally composites and shades that column.  Every output element has
// exactly one writer: the per-camera overflow sums go through shared
// memory and are written by thread 0.
//
// What bounds it on the card: not FLOPs but memory latency -- the
// per-seg row loads (every thread of a block reads the same row, so one
// broadcast line per seg, served from L1/L2) and the texel gathers into
// tex/flat/sky tables of a few hundred KB that stay resident in the
// 50 MB L2.  The simple design answers that with broadcast row reads,
// an early exit once the column is closed, a cheap x-range reject that
// touches three words of a row, and column stores that coalesce across
// a warp's neighbouring columns.  Tiling cameras, shared-memory column
// buffers and warp-level seg culling are later work.
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

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int LD_SKY = 1 << 25;
constexpr int SKY_W = 256;
constexpr int SKY_H = 128;
constexpr int FLAT = 64;

constexpr int MID_PLANES = 7, CLIP_PLANES = 7;

struct Params {
  const int* rows; const int* scnt; const float* camf; const int* cami;
  int B, G;
  const int* tex; int TH, TW;
  const int* flats; const int* sky; const int* pal;
  int W, H, KM, KC, pow2, twq;
  float half_w, half_h, inv_aspect, wx_c, eye, inv_w, inv_h, inv_255;
  int* idx; int* ld; int* rgb; int* pidx; int* pld;
  int* mpool; int* cpool; int* cnt_mid; int* cnt_clip; int* ovf;
};

struct Column {
  const Params& P;
  int b, x;
  size_t fb;         // offset of (b, 0, x) in [B, H, W] buffers
  int cnt_m, cnt_c, ovf_m, ovf_c;

  __device__ Column(const Params& p, int b_, int x_)
      : P(p), b(b_), x(x_), cnt_m(0), cnt_c(0), ovf_m(0), ovf_c(0) {
    fb = (size_t)b * P.H * P.W + x;
  }

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

  // wall column rows [ct, cb]: v by linear interpolation over the full
  // (unclipped) bottom..top edges + offset, wrapped (bitmap_render.rs:253-263)
  __device__ void paint_wall(int ct, int cb, int by, int ty, int tx,
                             int zdist, int light, const int* pw) {
    const int thb = max(pw[P_TH], 1);
    const float uy1 = fbits(pw[P_UY1RAW]);
    const int offy = pw[P_OFFY];
    const int* texp = P.tex + (size_t)pw[P_TEX] * P.TH * P.TW;
    const int txc = min(max(tx, 0), P.twq - 1);
    const int ldw = (shl(light, 16) | LD_WRITTEN) | (zdist & 0xFFFF);
    const float denom = (float)(by - ty);
    ROLLED for (int y = ct; y <= cb; ++y) {
      float ay = __fdiv_rn((float)(y - ty), denom);
      int tyv = as_i16(__fadd_rn((float)thb, __fmul_rn(ay, uy1))) + offy;
      tyv = wrap_tex(tyv, thb, P.pow2);
      tyv = min(max(tyv, 0), P.TH - 1);
      size_t o = fb + (size_t)y * P.W;
      P.idx[o] = texp[(size_t)tyv * P.TW + txc] & 0xFF;
      P.ld[o] = ldw;
    }
  }

  // floor/ceiling/sky span rows [y0, y1]: per-pixel inverse projection +
  // flat sample (visplanes.rs:82-152) or sky columns (visplanes.rs:42-80)
  __device__ void paint_plane(int y0, int y1, int fl, bool is_sky, int h,
                              int light, float cosv, float sinv, float fh,
                              int pxi, int pyi, int stx) {
    const float wz = __fsub_rn(__fsub_rn((float)h, fh), P.eye);
    const float vx = __fmul_rn(__fsub_rn(P.half_w, (float)x), P.inv_aspect);
    const int ldc = shl(light, 16) | LD_WRITTEN | (is_sky ? LD_SKY : 0);
    const int* flatp = P.flats + (size_t)fl * FLAT * FLAT;
    ROLLED for (int y = y0; y <= y1; ++y) {
      const float vy = __fsub_rn(P.half_h, (float)y);
      const float wx = __fdiv_rn(__fmul_rn(P.wx_c, wz), vy);
      int texel;
      if (is_sky) {
        int sty = as_i16(__fmul_rn(
            __fmul_rn(__fmul_rn((float)y, (float)SKY_H), 2.f), P.inv_h));
        if (sty < 0) sty += SKY_H;
        sty %= SKY_H;
        sty = min(max(sty, 0), SKY_H - 1);
        texel = P.sky[sty * SKY_W + stx] & 0xFF;
      } else {
        const float wy = __fdiv_rn(__fmul_rn(wz, vx), vy);
        const float rx = __fsub_rn(__fmul_rn(wx, cosv), __fmul_rn(wy, sinv));
        const float ry = __fadd_rn(__fmul_rn(wy, cosv), __fmul_rn(wx, sinv));
        const int ftx = (as_i16(rx) + pxi) & (FLAT - 1);
        const int fty = (as_i16(ry) + pyi) & (FLAT - 1);
        texel = flatp[fty * FLAT + ftx] & 0xFF;
      }
      size_t o = fb + (size_t)y * P.W;
      P.pidx[o] = texel;
      P.pld[o] = ldc | (as_i16(wx) & 0xFFFF);
    }
  }
};

__global__ void paint_kernel(const Params P) {
  __shared__ int ovf_s[2];
  const int b = blockIdx.x;
  const int x = threadIdx.x;
  if (x < 2) ovf_s[x] = 0;
  __syncthreads();

  if (x < P.W) {
    Column c(P, b, x);
    const int H = P.H;
    ROLLED for (int y = 0; y < H; ++y) {
      size_t o = c.fb + (size_t)y * P.W;
      P.idx[o] = 0; P.ld[o] = 0; P.pidx[o] = 0; P.pld[o] = 0;
    }
    {
      const size_t mplane = (size_t)P.B * P.KM * P.W;
      const size_t cplane = (size_t)P.B * P.KC * P.W;
      for (int k = 0; k < P.KM; ++k)
        for (int i = 0; i < MID_PLANES; ++i)
          P.mpool[i * mplane + ((size_t)b * P.KM + k) * P.W + x] = 0;
      for (int k = 0; k < P.KC; ++k)
        for (int i = 0; i < CLIP_PLANES; ++i)
          P.cpool[i * cplane + ((size_t)b * P.KC + k) * P.W + x] = 0;
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

    bool hor = false;
    int fo = H, co = -1;
    const int n = P.scnt[b];
    const int* rows_b = P.rows + (size_t)b * P.G * NR;
    for (int k = 0; k < n && !hor; ++k) {
      const int* row = rows_b + (size_t)k * NR;
      const int flags = row[R_FLAGS];
      const int x0 = row[R_X0];
      const int x1 = row[R_X1];
      // outside [x0, x1] every piece of this seg is a no-op here
      if (x < clamp_i16(x0) || x > clamp_i16(x1) || (flags & 15) == 0)
        continue;

      const bool two_sided = flags & 16;
      const bool draw_c = flags & 32;
      const bool f_sky = flags & 1024;
      const bool c_sky = flags & 2048;
      const bool has_mid = flags & (1 << 12);
      const int light = row[R_LIGHT];
      const int g = row[R_G];
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
      const int tx_base = as_i16(u) + as_i16(fbits(row[R_SOFF])) + row[R_OFFX];
      const int zdist = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));

      for (int p = 0; p < 4 && !hor; ++p) {
        if (!(flags & (1 << p))) continue;
        const int* pw = row + R_PIECE0 + P_WORDS * p;
        const bool draws_p = flags & (64 << p);
        const int by = as_i16(__fadd_rn(fbits(pw[P_YBS]),
                                        __fmul_rn(dx, fbits(pw[P_YBD]))));
        const int ty = as_i16(__fadd_rn(fbits(pw[P_YTS]),
                                        __fmul_rn(dx, fbits(pw[P_YTD]))));
        const int cb = min(H - 1, min(fo, by));
        const int ct = max(0, max(co, ty));
        const bool in_ver = cb >= ct;       // the column is open here
        const int tx = wrap_tex(tx_base, max(pw[P_TW], 1), P.pow2);
        const int cd2 = pack16(by, ty);

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
          const bool fl_emit = in_ver && cb < fo && cb != H - 1 && fl_keep;
          const bool m_f = fl_emit || (gap_b && (f_sky || keep_g));
          const bool ce_keep =
              c_sky || (min(H - 1, ct) - max(0, co) > 1);
          const bool ce_emit = in_ver && draw_c && ct > co && ce_keep;
          const bool m_c = ce_emit || (gap_t && (c_sky || keep_g));
          if (m_e) c.emit_clip(rec, cd2, g, row);
          if (m_e && draws_p)
            c.paint_wall(ct, cb, by, ty, tx, zdist, light, pw);
          if (m_f) {
            int y0 = max(min(max(fl_emit ? cb : co, -1), 254), 0);
            int y1 = min(min(max(fo, -1), 254), H - 1);
            c.paint_plane(y0, y1, row[R_FLAT], f_sky, row[R_PLANEH], light,
                          cosv, sinv, fh, pxi, pyi, stx);
          }
          if (m_c) {
            int y0 = max(min(max(co, -1), 254), 0);
            int y1 = min(min(max(ce_emit ? ct : fo, -1), 254), H - 1);
            c.paint_plane(y0, y1, row[R_FLAT + 1], c_sky, row[R_PLANEH + 1],
                          light, cosv, sinv, fh, pxi, pyi, stx);
          }
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
          const int rec = pack_span(KIND_MID, ct, cb) | (draw_c ? SPAN_DC : 0);
          c.emit_clip(rec, cd2, g, row);
          if (has_mid) {
            const int vals[MID_PLANES] = {
                rec, pw[P_TEX] * P.TW + tx, cd2, pack16(pw[P_OFFY], pw[P_TH]),
                pack16(light, zdist), pw[P_UY1], g};
            c.emit_mid(vals);
          }
        } else {
          if (!in_ver) continue;
          int rec = pack_span(KIND_WALL, ct, cb) | (p == 2 ? SPAN_E2B : SPAN_E2T);
          if (!draws_p) rec |= SPAN_NODRAW;
          c.emit_clip(rec, cd2, g, row);
          if (draws_p) c.paint_wall(ct, cb, by, ty, tx, zdist, light, pw);
          if (p == 2) fo = ct; else co = cb;
        }
      }
    }

    // composite (plane over wall) + shade (bitmap_render.rs:190-208)
    ROLLED for (int y = 0; y < H; ++y) {
      size_t o = c.fb + (size_t)y * P.W;
      const int pw_ = P.pld[o];
      const bool use_p = pw_ & LD_WRITTEN;
      const int ldw = use_p ? pw_ : P.ld[o];
      const int texel = use_p ? P.pidx[o] : P.idx[o];
      const bool written = ldw & LD_WRITTEN;
      const bool is_sky = ldw & LD_SKY;
      const int light = (ldw >> 16) & 0xFF;
      const int dist = (int)(int16_t)(ldw & 0xFFFF);
      const int rgbw = P.pal[texel & 0xFF];
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
      P.idx[o] = written ? texel : -1;
      P.ld[o] = ldw;
      P.rgb[o] = written ? packed : 0;
    }
    P.cnt_mid[(size_t)b * P.W + x] = c.cnt_m;
    P.cnt_clip[(size_t)b * P.W + x] = c.cnt_c;
    if (c.ovf_m) atomicAdd(&ovf_s[0], c.ovf_m);
    if (c.ovf_c) atomicAdd(&ovf_s[1], c.ovf_c);
  }
  __syncthreads();
  if (x < 2) P.ovf[b * 2 + x] = ovf_s[x];
}

}  // namespace

extern "C" {

int doom_paint(const int* rows, const int* scnt, const float* camf,
               const int* cami, int B, int G,
               const int* tex, int TH, int TW, const int* flats,
               const int* sky, const int* pal,
               int W, int H, int KM, int KC, int pow2, int twq,
               float half_w, float half_h, float inv_aspect, float wx_c,
               float eye, float inv_w, float inv_h, float inv_255,
               int* idx, int* ld, int* rgb, int* pidx, int* pld,
               int* mpool, int* cpool, int* cnt_mid, int* cnt_clip, int* ovf,
               void* stream) {
  Params P{rows, scnt, camf, cami, B, G, tex, TH, TW, flats, sky, pal,
           W, H, KM, KC, pow2, twq, half_w, half_h, inv_aspect, wx_c, eye,
           inv_w, inv_h, inv_255,
           idx, ld, rgb, pidx, pld, mpool, cpool, cnt_mid, cnt_clip, ovf};
  if (B <= 0) return (int)cudaSuccess;
  const int threads = ((W + 31) / 32) * 32;
  paint_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

int doom_row_words() { return NR; }

const char* doom_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
