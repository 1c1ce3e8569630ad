// Word layouts and device helpers shared by the kernels: paint.cu,
// scan.cu, rows.cu, items.cu, itempass.cu, emit.cu and resolve.cu.
// Mirrors doomtpu_torch/ops/layout.py: the span record of the pools and
// the seg row that rows.cu writes and the paint and wall-scan kernels
// read (those three libraries export doom_row_words() = NR, which
// ops/build.py checks against the Python NR when it loads them); the
// item kernels' staged clip record and shade; the item pack
// (ops/itempass.py IPI_* / IPF_*) and a sprite's billboard column math,
// which the item-pass and emission kernels share.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// span record: nodraw(1, sign bit) | kind(2) | dc(1) | e2b(1) | e2t(1)
// | y0+1 (8) | y1+1 (8)
constexpr int KIND_WALL = 0, KIND_FLOOR = 1, KIND_CEIL = 2, KIND_MID = 3;
constexpr int SPAN_E2T = 1 << 26;
constexpr int SPAN_E2B = 1 << 27;
constexpr int SPAN_DC = 1 << 28;
constexpr int SPAN_NODRAW = INT32_MIN;

// seg row (i32 words; f32 fields as their bits)
constexpr int R_G = 0, R_X0 = 1, R_X1 = 2, R_FLAGS = 3;
constexpr int R_LSX = 4, R_LSY = 5, R_LEX = 6, R_LEY = 7;
constexpr int R_LENGTH = 8, R_SOFF = 9, R_OFFX = 10, R_LIGHT = 11;
constexpr int R_FLAT = 12, R_PLANEH = 14, R_PIECE0 = 16;
constexpr int P_YBS = 0, P_YBD = 1, P_YTS = 2, P_YTD = 3, P_TH = 4;
constexpr int P_TW = 5, P_OFFY = 6, P_TEX = 7, P_UY1 = 8, P_UY1RAW = 9;
constexpr int P_WORDS = 10;
constexpr int NR = R_PIECE0 + 4 * P_WORDS;

__device__ __forceinline__ float fbits(int v) { return __int_as_float(v); }

// Rust `as i16` on f32: trunc toward zero, saturate, NaN -> 0
__device__ __forceinline__ int as_i16(float v) {
  if (isnan(v)) return 0;
  v = fminf(fmaxf(truncf(v), -32768.f), 32767.f);
  return (int)v;
}
__device__ __forceinline__ int clamp_i16(int v) {
  return min(max(v, -32768), 32767);
}
// i32 arithmetic that wraps like the JAX/torch versions (no C UB)
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int shl(int a, int s) {
  return (int)((unsigned)a << s);
}
__device__ __forceinline__ int pack16(int hi, int lo) {
  return shl(hi & 0xFFFF, 16) | (lo & 0xFFFF);
}
__device__ __forceinline__ int pack_span(int kind, int y0, int y1) {
  int y0c = min(max(y0, -1), 254) + 1;
  int y1c = min(max(y1, -1), 254) + 1;
  return shl(kind, 29) | shl(y0c, 8) | y1c;
}
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

// if t < 0 { t += size * (1 - t / size) }; t %= size   (trunc div/rem)
__device__ __forceinline__ int wrap_tex(int t, int size, int pow2) {
  if (pow2) return t & (size - 1);
  if (t < 0) t = t + size * (1 - t / size);
  return t % size;
}

// A clip record staged for the sprite-vs-seg clip
// (renderer/map_objects.rs:127-166) by the item kernels: the seg's two
// endpoints (lsx, lsy, lex, ley) and `record_bounds`.
constexpr int CLIP_RECORD_WORDS = 5;

// a clip record's bounds on a sprite whose seg lies in front of it: the
// top (from -1) and bottom (from H) it sets, as two i16 top | bottom
__device__ __forceinline__ int record_bounds(int cw, int d2, int H) {
  const bool is_mid = ((cw >> 29) & 3) == KIND_MID;
  int top = -1, bot = H;
  if (cw & SPAN_E2T) top = max(top, (cw & 255) - 1);
  if ((cw & SPAN_DC) && is_mid) top = max(top, lo16(d2));
  if (cw & SPAN_E2B) bot = min(bot, ((cw >> 8) & 255) - 1);
  if (is_mid) bot = min(bot, d2 >> 16);
  return pack16(top, bot);
}

// The shade of an item pixel (bitmap_render.rs:190-208): palette colour
// `rgbw` diminished by the ld word's light and zdist; light / 255 is the
// multiply by inv_255 = f32(1 / 255) that XLA makes of it.
__device__ __forceinline__ int shade_rgb(int rgbw, int ld, float inv_255) {
  const float light = (float)((ld >> 16) & 0xFF);
  const float zd = (float)lo16(ld);
  float factor = __fsub_rn(__fmul_rn(light, inv_255),
                           __fmul_rn(zd, 1.0f / 4096.0f));
  factor = fmaxf(factor, 0.0f);
  int packed = 0;
#pragma unroll
  for (int shift = 16; shift >= 0; shift -= 8) {
    const float chan = (float)((rgbw >> shift) & 0xFF);
    const float byte = fminf(fmaxf(truncf(__fmul_rn(chan, factor)), 0.0f),
                             255.0f);
    packed |= ((int)byte) << shift;
  }
  return packed;
}

// The item pack (ops/itempass.py IPI_* / IPF_*, render/things.py
// item_pack): per selected item of a camera, IPI_ROWS i32 words and
// IPF_ROWS f32 words.
constexpr int IPI_FL = 0, IPI_X0 = 1, IPI_X1E = 2, IPI_LW = 3, IPI_PIC = 4;
constexpr int IPI_TH = 5, IPI_SOFF = 6, IPI_BSX = 7, IPI_ROWS = 8;
constexpr int IPF_DX = 0, IPF_INV0 = 1, IPF_INV1 = 2, IPF_Z0 = 3;
constexpr int IPF_Z1 = 4, IPF_YBS = 5, IPF_YBD = 6, IPF_YTS = 7;
constexpr int IPF_YTD = 8, IPF_UY1 = 9, IPF_VPX = 10, IPF_VPY = 11;
constexpr int IPF_ROWS = 12;

// A sprite's billboard at screen column x (map_objects.rs:37-121, the
// JAX package's per-slot sprite math): texel column tx, zdist zd, and
// the unclipped bottom and top rows by, ty.  ir / fr are the sprite's
// pack words.  Compiled with -fmad=false; every parity-critical product,
// sum and quotient is an explicitly rounded __f*_rn.
struct BillboardColumn {
  int tx, zd, by, ty;
};

__device__ __forceinline__ BillboardColumn billboard_column(
    int x, const int* ir, const float* fr) {
  BillboardColumn c;
  const float xb = (float)wsub(x, ir[IPI_BSX]);
  const float ax = __fdiv_rn(xb, fr[IPF_DX]);
  const float oma = __fsub_rn(1.0f, ax);
  const float denom = __fadd_rn(__fmul_rn(oma, fr[IPF_INV0]),
                                __fmul_rn(ax, fr[IPF_INV1]));
  const float u = __fdiv_rn(__fadd_rn(__fmul_rn(oma, fr[IPF_Z0]),
                                      __fmul_rn(ax, fr[IPF_Z1])),
                            denom);
  c.tx = wrap_tex(as_i16(u) + ir[IPI_SOFF], max(ir[IPI_LW] >> 16, 1), 0);
  c.zd = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));
  c.by = as_i16(__fadd_rn(fr[IPF_YBS], __fmul_rn(xb, fr[IPF_YBD])));
  c.ty = as_i16(__fadd_rn(fr[IPF_YTS], __fmul_rn(xb, fr[IPF_YTD])));
  return c;
}

}  // namespace
