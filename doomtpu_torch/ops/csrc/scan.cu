// Wall-scan kernel: the occlusion scan of the scan + resolve pipeline,
// emitting the unified span pool (span word + d1..d6 per record), the
// per-column counts and the per-camera overflow, for B cameras.
//
// Replaces doomtpu/ops/pallas_scan.py::_kernel / _one_seg (the TPU kernel
// launched by wall_scan_pallas), which reproduces the seg walk of
// doomtpu/render/walls.py::wall_scan.  Computes the same outputs bit for
// bit below each column's count; the plain PyTorch version is
// doomtpu_torch/ops/scan.py::scan_reference; the record format and the
// seg row layout (the paint kernel's rows) are in layout.cuh (with
// doomtpu_torch/ops/layout.py).
//
// Design: one thread per (camera, screen column), in a grid of column
// blocks x cameras, so any screen width fits.  A thread walks its
// camera's active segs front to back and keeps the occlusion state
// (hor / fo / co), its slot cursor and its overflow count in registers;
// it stops once its column is closed (hor), after which no record can be
// emitted.  Each record goes to the column's cursor while cursor < K
// (else it counts as overflow), in JAX's emission order.  The pool is
// slot-major ([plane][B][K][W]), so a warp's neighbouring columns store
// neighbouring words.  Slots at or past a column's count are not written
// (nothing reads them).  The per-camera overflow is summed with integer
// atomics: exact and order-free.
//
// What bounds it on the card: bytes.  It must read each camera's active
// seg rows (14 words of a row and 9 of each active piece; every thread
// of a block reads the same row, one broadcast line per seg from L1/L2)
// and write the counts and the 7 words of each occupied slot; it does a
// few tens of f32 operations per (column, visited seg), far below the
// card's rate.  The design keeps the state in registers, skips a seg
// with three words (x range and flags) where the column is outside it,
// stops at the seg that closes the column, and writes only occupied
// slots, coalesced across the warp.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn and every division __fdiv_rn, as the paint
// kernel does.

#include "layout.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int POOL_PLANES = 7;

struct Params {
  const int* rows; const int* scnt;
  int B, G, W, H, K, TW, pow2;
  int* pool; int* cnt; int* ovf;
};

struct Column {
  const Params& P;
  size_t o;          // offset of (b, slot 0, x) in one pool plane
  size_t plane;      // words per pool plane
  int cnt, ovf;

  __device__ Column(const Params& p, int b, int x) : P(p), cnt(0), ovf(0) {
    o = (size_t)b * P.K * P.W + x;
    plane = (size_t)P.B * P.K * P.W;
  }

  __device__ void emit(int rec, int d1, int d2, int d3, int d4, int d5,
                       int d6) {
    if (cnt >= P.K) {
      ++ovf;
      return;
    }
    const int vals[POOL_PLANES] = {rec, d1, d2, d3, d4, d5, d6};
    const size_t at = o + (size_t)cnt * P.W;
#pragma unroll
    for (int i = 0; i < POOL_PLANES; ++i) P.pool[i * plane + at] = vals[i];
    ++cnt;
  }
};

__global__ void __launch_bounds__(THREADS) scan_kernel(const Params P) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (x >= P.W) return;
  const int H = P.H;
  Column c(P, b, x);
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
    const int light = row[R_LIGHT];
    const int g = row[R_G];
    // plane records' d1 / d2 (floor, ceiling)
    const int fl_d1 =
        shl(light, 22) | shl(row[R_FLAT], 8) | (f_sky ? 1 << 21 : 0);
    const int fl_d2 = pack16(row[R_PLANEH], 0);
    const int ce_d1 =
        shl(light, 22) | shl(row[R_FLAT + 1], 8) | (c_sky ? 1 << 21 : 0);
    const int ce_d2 = pack16(row[R_PLANEH + 1], 0);

    // perspective-correct texture u + column depth (bitmap_render.rs:241-251)
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
    const int tx_base =
        wadd(wadd(as_i16(u), as_i16(fbits(row[R_SOFF]))), row[R_OFFX]);
    const int zdist = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));
    const int d4 = pack16(light, zdist);

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
      const int d1 = wadd(wmul(pw[P_TEX], P.TW), tx);
      const int d2 = pack16(by, ty);
      const int d3 = pack16(pw[P_OFFY], pw[P_TH]);
      const int d5 = pw[P_UY1RAW];
      int rec = pack_span(KIND_WALL, ct, cb);
      if (!draws_p) rec |= SPAN_NODRAW;

      if (p == 0) {
        const bool solid = !two_sided;
        if (in_ver && solid)
          c.emit(rec | SPAN_E2B | SPAN_E2T, d1, d2, d3, d4, d5, g);
        // visplanes (segs.rs:263-291), 1-pixel skip at emission
        const bool fl_keep = f_sky || (min(H - 1, fo) - cb > 1);
        if (in_ver && cb < fo && cb != H - 1 && fl_keep)
          c.emit(pack_span(KIND_FLOOR, cb, fo), fl_d1, fl_d2, 0, 0, 0, g);
        const bool ce_keep = c_sky || (min(H - 1, ct) - max(0, co) > 1);
        if (in_ver && draw_c && ct > co && ce_keep)
          c.emit(pack_span(KIND_CEIL, co, ct), ce_d1, ce_d2, 0, 0, 0, g);
        // occluded-gap fill (segs.rs:293-318)
        const bool gap = !in_ver && fo > co;
        const bool keep_g = min(H - 1, fo) - max(0, co) > 1;
        const bool gap_b = gap && by <= co;
        if (gap_b && (f_sky || keep_g))
          c.emit(pack_span(KIND_FLOOR, co, fo), fl_d1, fl_d2, 0, 0, 0, g);
        const bool gap_t = gap && draw_c && ty >= fo;
        if (gap_t && (c_sky || keep_g))
          c.emit(pack_span(KIND_CEIL, co, fo), ce_d1, ce_d2, 0, 0, 0, g);
        if (in_ver && two_sided) {
          fo = cb;
          if (draw_c) co = ct;
        }
        if (solid || gap_b || gap_t) {
          hor = true;
          fo = H / 2;
          co = H / 2;
        }
      } else {
        if (!in_ver) continue;
        if (p == 1) {
          const int mid = pack_span(KIND_MID, ct, cb) | (draw_c ? SPAN_DC : 0);
          c.emit(mid, d1, d2, d3, d4, d5, g);
        } else if (p == 2) {
          c.emit(rec | SPAN_E2B, d1, d2, d3, d4, d5, g);
          fo = ct;                           // segs.rs:329-331
        } else {
          c.emit(rec | SPAN_E2T, d1, d2, d3, d4, d5, g);
          co = cb;                           // segs.rs:333-335
        }
      }
    }
  }
  P.cnt[(size_t)b * P.W + x] = c.cnt;
  if (c.ovf) atomicAdd(&P.ovf[b], c.ovf);
}

}  // namespace

extern "C" {

int doom_scan(const int* rows, const int* scnt, int B, int G, int W, int H,
              int K, int TW, int pow2, int* pool, int* cnt, int* ovf,
              void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  Params P{rows, scnt, B, G, W, H, K, TW, pow2, pool, cnt, ovf};
  dim3 grid((W + THREADS - 1) / THREADS, B);
  scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

int doom_row_words() { return NR; }

const char* doom_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
