// Resolve kernel: the scan + resolve pipeline's winner fold, texel fetch
// and shade, for B cameras.  Per camera and screen column it turns the
// wall scan's unified span pool (csrc/scan.cu) into the frames the
// deferred pass reads: idx (palette index, -1 unwritten), ld (light << 16
// | z-dist | LD_WRITTEN | LD_SKY, the paint kernel's word) and rgb (the
// shade, 0xRRGGBB).
//
// Replaces no TPU kernel: the JAX package computes the resolve and the
// shade in XLA (doomtpu/render/resolve.py::resolve_frame, shade), and the
// port's plain PyTorch version of both, with the ld packing, is
// doomtpu_torch/render/resolve.py::resolve_reference.  This kernel gives
// the same bits in every pixel.
//
// Design: a block takes one camera and a tile of 32 screen columns, one
// lane a column, and 8 warps, warp g the band of rows [g * BH, (g + 1) *
// BH).  The pool is read in place, slot-major ([B][K][W] a plane): slot k
// of the tile's 32 columns is 128 contiguous bytes.
// (1) The winner fold: each thread walks its column's slots 0 .. cnt-1 in
// draw order, reading the span word only, and writes the slot id into two
// arrays in shared memory, the wall winner (kind wall, texture drawn) and
// the plane winner (floor or ceiling), over the rows of its band the slot
// covers.  A later slot overwrites an earlier one: each pixel keeps its
// last covering slot, as the plain version's scatter-max of slot ids.  A
// thread writes and reads only its own column's band, so the fold needs
// no barrier.  Only rows 0-254 can be covered (the span word's 8-bit y
// fields), so the arrays hold min(H, 255) rows: 25.6 KB at H = 200.
// (2) The sweep: each warp walks its band row by row, lane = column, so
// the stores of idx, ld and rgb are 128-byte rows.  At each pixel the
// thread reads its winners' data words (kept in registers while the
// winner stays the same from row to row), computes only the texel index
// the pixel can take (wall v, the plane's inverse projection, or the sky
// column), fetches one packed texel from the column atlas (two under a
// sky with transparent texels: the sky's and the wall's below it), and
// shades it with the palette, staged in shared memory.
//
// What bounds it on the card: bytes (idx, ld and rgb written once, 12 B a
// pixel, with the occupied slots' span words and records read once): 0.53
// ms at B = 2048, 320x200.  The work a pixel is a few dozen instructions
// and at most two IEEE divides; the texels, the palette and the records
// come from L2 and L1.  Measured on an H100 (PERF.md; e1m1-scale-masked
// spread poses): 1.28 ms at B = 2048 and 2.54 at B = 4096, 42% of the byte
// bound, against 140 and 191 ms for the plain version; 46 registers, 26.6
// KB of shared memory at H = 200, 5 blocks an SM.
//
// Numerics: compiled with -fmad=false; every product, sum and difference
// is __fmul_rn / __fadd_rn / __fsub_rn and every division __fdiv_rn, in
// the plain version's order.  A division by a constant is the multiply by
// its f32 reciprocal (the inv_* parameters) that XLA makes of it.

#include "layout.cuh"

// every row loop stays rolled (see csrc/paint.cu)
#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int LD_SKY = 1 << 25;
constexpr int SKY_W = 256;
constexpr int SKY_H = 128;
constexpr int FLAT = 64;
constexpr int TC = 32;           // columns a block: one warp's lanes
constexpr int BANDS = 8;         // warps a block, a band of rows each
constexpr int COVER_ROWS = 255;  // rows a span word can cover: 0 .. 254
constexpr unsigned short NONE = 0xFFFF;   // no winner slot

struct Params {
  // the pool planes span, d1 .. d5, each [B][K][W]
  const int* span; const int* d1; const int* d2; const int* d3;
  const int* d4; const int* d5;
  const int* cnt;                       // [B][W]
  const float* camf; const int* cami;   // [B][3]: cos sin fh; px py txoff
  const int* atlas; int n_atlas, rows, TW, sky_tex, flat_off;
  const int* pal;
  int B, W, H, K, pow2, sky_opaque, ntiles, bh, crows;
  float focus_x, focus_y, inv_aspect, wx_c, eye, inv_w, inv_h, inv_255;
  int* idx; int* ld; int* rgb;
};

__device__ __forceinline__ int fetch(const Params& P, int index) {
  return __ldg(P.atlas + min(max(index, 0), P.n_atlas - 1));
}

__global__ void __launch_bounds__(TC * BANDS) resolve_kernel(const Params P) {
  extern __shared__ int smem[];
  int* spal = smem;                                       // [256]
  unsigned short* win = (unsigned short*)(smem + 256);    // [crows][2][TC]
  const int c = threadIdx.x, g = threadIdx.y;
  const int b = blockIdx.x / P.ntiles;
  const int x = (blockIdx.x % P.ntiles) * TC + c;
  for (int i = g * TC + c; i < 256; i += TC * BANDS) spal[i] = P.pal[i];
  __syncthreads();
  if (x >= P.W) return;
  const int ylo = g * P.bh, yhi = min(ylo + P.bh, P.H) - 1;
  const int chi = min(yhi, P.crows - 1);   // the band's coverable rows
  unsigned short* wcol = win + c;          // row y: wcol[2 * TC * y]
  unsigned short* pcol = win + TC + c;

  // ---- (1) the winner fold: the last covering wall and plane slot ----
  ROLLED for (int y = ylo; y <= chi; ++y) {
    wcol[2 * TC * y] = NONE;
    pcol[2 * TC * y] = NONE;
  }
  const size_t col = (size_t)b * P.K * P.W + x;   // (b, slot 0, x)
  const int n = min(P.cnt[(size_t)b * P.W + x], P.K);
  ROLLED for (int k = 0; k < n; ++k) {
    const int s = __ldg(P.span + col + (size_t)k * P.W);
    const int kind = (s >> 29) & 3;
    const bool wall = kind == KIND_WALL && s >= 0;   // bit 31: no texture
    const bool plane = kind == KIND_FLOOR || kind == KIND_CEIL;
    if (!wall && !plane) continue;
    const int y0 = max(((s >> 8) & 255) - 1, ylo);
    const int y1 = min((s & 255) - 1, chi);
    unsigned short* w = plane ? pcol : wcol;
    ROLLED for (int y = y0; y <= y1; ++y) w[2 * TC * y] = (unsigned short)k;
  }

  // ---- (2) the sweep: texel, light, distance and shade a pixel -------
  const float cosv = P.camf[b * 3 + 0];
  const float sinv = P.camf[b * 3 + 1];
  const float fh = P.camf[b * 3 + 2];
  const int pxi = P.cami[b * 3 + 0];
  const int pyi = P.cami[b * 3 + 1];
  const int txoff = P.cami[b * 3 + 2];
  const float vx = __fmul_rn(__fsub_rn(P.focus_x, (float)x), P.inv_aspect);
  // the sky's texture column of this screen column (row-invariant)
  const int stx =
      wadd(as_i16(__fmul_rn(__fmul_rn((float)x, (float)SKY_W), P.inv_w)),
           txoff) % SKY_W;
  const int sky_col = wmul(wadd(wmul(P.sky_tex, P.TW), stx), P.rows);

  // the winners' words, loaded when the winner changes; the empty
  // values where no slot covers the pixel
  int wk = NONE, a1 = -1, a2 = 0, a3 = 0, a4 = 0, a5 = 0;
  int pk = NONE, p1 = -1, p2 = 0;
  const size_t fb = (size_t)b * P.H * P.W + x;
  ROLLED for (int y = ylo; y <= yhi; ++y) {
    const int ws = y <= chi ? wcol[2 * TC * y] : NONE;
    const int ps = y <= chi ? pcol[2 * TC * y] : NONE;
    if (ws != wk) {
      wk = ws;
      if (ws == NONE) {
        a1 = -1;
        a2 = a3 = a4 = a5 = 0;
      } else {
        const size_t o = col + (size_t)ws * P.W;
        a1 = __ldg(P.d1 + o);
        a2 = __ldg(P.d2 + o);
        a3 = __ldg(P.d3 + o);
        a4 = __ldg(P.d4 + o);
        a5 = __ldg(P.d5 + o);
      }
    }
    if (ps != pk) {
      pk = ps;
      if (ps == NONE) {
        p1 = -1;
        p2 = 0;
      } else {
        const size_t o = col + (size_t)ps * P.W;
        p1 = __ldg(P.d1 + o);
        p2 = __ldg(P.d2 + o);
      }
    }
    const bool has_wall = a1 >= 0;
    const bool has_plane = p1 >= 0;
    const bool is_sky = has_plane && ((p1 >> 21) & 1);
    const bool use_plane = has_plane && !is_sky;
    const float vy = __fsub_rn(P.focus_y, (float)y);

    // plane distance (floors, ceilings and sky): visplanes.rs:103-129
    float wz = 0.f, wx = 0.f;
    if (has_plane) {
      wz = __fsub_rn(__fsub_rn((float)(p2 >> 16), fh), P.eye);
      wx = __fdiv_rn(__fmul_rn(wz, P.wx_c), vy);
    }
    auto wall_index = [&]() {    // bitmap_render.rs:253-263
      const int by = a2 >> 16, tyl = lo16(a2);
      const int offy = a3 >> 16, th = lo16(a3);
      const float ay = __fdiv_rn((float)wsub(y, tyl), (float)wsub(by, tyl));
      int tyv = wadd(as_i16(__fadd_rn((float)th,
                                      __fmul_rn(ay, __int_as_float(a5)))),
                     offy);
      tyv = wrap_tex(tyv, max(th, 1), P.pow2);
      return wadd(wmul(max(a1, 0), P.rows), tyv);
    };
    auto flat_index = [&]() {    // visplanes.rs:103-129
      const float wy = __fdiv_rn(__fmul_rn(wz, vx), vy);
      const float rx = __fsub_rn(__fmul_rn(wx, cosv), __fmul_rn(wy, sinv));
      const float ry = __fadd_rn(__fmul_rn(wy, cosv), __fmul_rn(wx, sinv));
      const int ftx = wadd(as_i16(rx), pxi) & (FLAT - 1);
      const int fty = wadd(as_i16(ry), pyi) & (FLAT - 1);
      const int flat = (p1 >> 8) & 0x1FFF;
      return wadd(wmul(wadd(wadd(P.flat_off, wmul(flat, FLAT)), ftx), P.rows),
                  fty);
    };
    auto sky_index = [&]() {     // visplanes.rs:42-80
      int sty = as_i16(__fmul_rn(
          __fmul_rn(__fmul_rn((float)y, (float)SKY_H), 2.f), P.inv_h));
      if (sty < 0) sty += SKY_H;
      return wadd(sky_col, sty % SKY_H);
    };

    // the texel fetch: plane, sky and wall are exclusive sources under
    // an opaque sky; under a masked one a transparent sky texel shows
    // the wall drawn earlier.  A texel nothing can take is not fetched.
    const bool sky_first = P.sky_opaque && is_sky;
    int packed = 0;
    if (use_plane || sky_first || has_wall)
      packed = fetch(P, use_plane ? flat_index()
                                  : sky_first ? sky_index() : wall_index());
    const int texel = packed & 0xFF;
    const bool opaque = packed & 0x100;
    const int light_w = a4 >> 16, dist_w = lo16(a4);
    const int light_p = p1 >> 22, dist_p = as_i16(wx);
    const bool use_plane_px = use_plane && opaque;
    int idx = -1, light = light_w, dist = dist_w;
    bool sky = is_sky;
    if (P.sky_opaque) {
      if ((has_wall && opaque && !has_plane) || use_plane_px || is_sky)
        idx = texel;
      if (use_plane_px || is_sky) {
        light = light_p;
        dist = dist_p;
      }
    } else {
      const int sp = is_sky ? fetch(P, sky_index()) : 0;
      const bool sky_opaque = sp & 0x100;
      const bool use_sky = is_sky && sky_opaque;
      const bool under_sky_wall = is_sky && !sky_opaque && has_wall && opaque;
      if ((has_wall && opaque && !has_plane && !use_sky) || under_sky_wall
          || use_plane_px)
        idx = texel;
      if (use_sky) idx = sp & 0xFF;
      if ((use_plane_px || use_sky) && !under_sky_wall) {
        light = light_p;
        dist = dist_p;
      }
      sky = use_sky;
    }

    // the shade (bitmap_render.rs:190-208): palette colour diminished by
    // light and distance, 1 on the sky; Rust `as u8` per channel
    float factor = __fsub_rn(__fmul_rn((float)light, P.inv_255),
                             __fmul_rn((float)dist, 1.f / 4096.f));
    factor = sky ? 1.f : fmaxf(factor, 0.f);
    const int rgbw = spal[max(idx, 0)];
    int shaded = 0;
#pragma unroll
    for (int shift = 16; shift >= 0; shift -= 8) {
      const float chan = (float)((rgbw >> shift) & 0xFF);
      const float v = fminf(fmaxf(truncf(__fmul_rn(chan, factor)), 0.f),
                            255.f);
      shaded |= (int)v << shift;
    }
    const size_t o = fb + (size_t)y * P.W;
    P.idx[o] = idx;
    P.ld[o] = shl(light, 16) | (dist & 0xFFFF) | (idx >= 0 ? LD_WRITTEN : 0)
              | (sky ? LD_SKY : 0);
    P.rgb[o] = idx >= 0 ? shaded : 0;
  }
}

// shared memory of a block: the palette and the two winner arrays
size_t smem_bytes(int crows) {
  return 256 * sizeof(int) + (size_t)crows * 2 * TC * sizeof(unsigned short);
}

}  // namespace

extern "C" {

int doom_resolve(const int* span, const int* d1, const int* d2,
                 const int* d3, const int* d4, const int* d5, const int* cnt,
                 const float* camf, const int* cami, const int* atlas,
                 int n_atlas, int rows, int TW, int sky_tex, int flat_off,
                 const int* pal, int B, int W, int H, int K, int pow2,
                 int sky_opaque, float focus_x, float focus_y,
                 float inv_aspect, float wx_c, float eye, float inv_w,
                 float inv_h, float inv_255, int* idx, int* ld, int* rgb,
                 void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return (int)cudaSuccess;
  if (K < 1 || K >= NONE || n_atlas < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (W + TC - 1) / TC;
  const int bh = (H + BANDS - 1) / BANDS;
  const int crows = min(H, COVER_ROWS);
  Params P{span, d1, d2, d3, d4, d5, cnt, camf, cami,
           atlas, n_atlas, rows, TW, sky_tex, flat_off, pal,
           B, W, H, K, pow2, sky_opaque, ntiles, bh, crows,
           focus_x, focus_y, inv_aspect, wx_c, eye, inv_w, inv_h, inv_255,
           idx, ld, rgb};
  resolve_kernel<<<(unsigned)B * ntiles, dim3(TC, BANDS), smem_bytes(crows),
                   (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// blocks the card keeps on one SM at height H
int doom_resolve_blocks_per_sm(int H) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, resolve_kernel, TC * BANDS, smem_bytes(min(H, COVER_ROWS)));
  return blocks;
}

const char* doom_resolve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
