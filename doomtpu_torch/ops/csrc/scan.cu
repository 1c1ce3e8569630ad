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
// Design: a block takes one camera and a tile of TC screen columns, one
// thread a column (TC a multiple of 32: ops/scan.py SCAN_COLUMNS).  The
// camera's active seg rows are taken in rounds: warp 0 lists, in
// traversal order, the next LIST rows whose x range meets the tile (a
// stable ballot and prefix-popcount compaction), and the block stages
// their 14 words (seg id, x range, flags, lsx / lex, length, offsets,
// light, flats, plane heights) and the 9 words of each active piece in
// shared memory, each row read once from device memory.  Then every
// thread walks the staged rows front to back with its column's
// occlusion state (hor / fo / co), slot cursor and overflow count in
// registers, and stops at the seg that closes its column; the block
// stops taking rounds once every column of the tile is closed
// (__syncthreads_and), not when the camera's rows run out.  Each record
// goes to the column's cursor while cursor < K (else it counts as
// overflow), in JAX's emission order.  The pool is slot-major
// ([plane][B][K][W]): neighbouring columns' records of one slot are
// neighbouring words.  Slots at or past a column's count are not written
// (nothing reads them).  The per-camera overflow is summed with integer
// atomics: exact and order-free.
//
// What bounds it on the card: not bytes (1.2 ms against a 0.17 ms byte
// bound: the active rows read once, the counts and the occupied slots'
// 7 words written once).  A cost probe of the kernel cut after each
// stage (PERF.md, H100, e1m1-scale-masked, 4096 cameras) gave ~0.1 ms to
// the lists and the staging, ~0.65 to the walk and ~0.5 to the pool
// stores: the lanes of a warp store at their own columns' cursors,
// which differ, so a record's 7 stores touch up to 32 lines each.
// Buffering a warp's
// records in shared memory and storing them slot by slot made the
// stores coalesce but cut the blocks an SM holds, and the walk lost as
// much as the stores gained.  32 columns a block beat 64-128.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn and every division __fdiv_rn, as the paint
// kernel does.

#include "layout.cuh"

namespace {

constexpr int MAX_THREADS = 128;
constexpr int POOL_PLANES = 7;
// rows a round: a ballot's worth at least, or a round could list none
constexpr int LIST = 32;
// a staged row: the 14 row words the scan reads, then 9 words a piece
// (R_LSY, R_LEY and each P_UY1 are not staged)
constexpr int BASE_WORDS = 14, PIECE_WORDS = 9;
constexpr int ROW_WORDS = BASE_WORDS + 4 * PIECE_WORDS;
constexpr int S_G = 0, S_X0 = 1, S_X1 = 2, S_FLAGS = 3, S_LSX = 4;
constexpr int S_LEX = 5, S_LENGTH = 6, S_SOFF = 7, S_OFFX = 8;
constexpr int S_LIGHT = 9, S_FLAT = 10, S_PLANEH = 12;
constexpr int Q_YBS = 0, Q_YBD = 1, Q_YTS = 2, Q_YTD = 3, Q_TH = 4;
constexpr int Q_TW = 5, Q_OFFY = 6, Q_TEX = 7, Q_UY1RAW = 8;

// the row word staged at offset w
__device__ __forceinline__ int row_word(int w) {
  if (w < BASE_WORDS) return w < 5 ? w : (w == 5 ? R_LEX : w + 2);
  const int p = (w - BASE_WORDS) / PIECE_WORDS;
  const int q = (w - BASE_WORDS) % PIECE_WORDS;
  return R_PIECE0 + P_WORDS * p + (q < Q_UY1RAW ? q : P_UY1RAW);
}

struct Params {
  const int* rows; const int* scnt;
  int B, G, W, H, K, TW, pow2, ntiles;
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

// One staged seg row at column x: its records in emission order and the
// occlusion update (walls.py::wall_scan's _one_seg).
__device__ void scan_seg(const Params& P, const int* row, int x, bool& hor,
                         int& fo, int& co, Column& c) {
  const int H = P.H;
  const int flags = row[S_FLAGS];
  const int x0 = row[S_X0];
  const int x1 = row[S_X1];
  // outside [x0, x1] every piece of this seg is a no-op here
  if (x < clamp_i16(x0) || x > clamp_i16(x1)) return;

  const bool two_sided = flags & 16;
  const bool draw_c = flags & 32;
  const bool f_sky = flags & 1024;
  const bool c_sky = flags & 2048;
  const int light = row[S_LIGHT];
  const int g = row[S_G];
  // plane records' d1 / d2 (floor, ceiling)
  const int fl_d1 =
      shl(light, 22) | shl(row[S_FLAT], 8) | (f_sky ? 1 << 21 : 0);
  const int fl_d2 = pack16(row[S_PLANEH], 0);
  const int ce_d1 =
      shl(light, 22) | shl(row[S_FLAT + 1], 8) | (c_sky ? 1 << 21 : 0);
  const int ce_d2 = pack16(row[S_PLANEH + 1], 0);

  // perspective-correct texture u + column depth (bitmap_render.rs:241-251)
  const float dx = (float)wsub(x, x0);
  const float ax = __fdiv_rn(dx, (float)wsub(x1, x0));
  const float uz0 = fbits(row[S_LSX]);
  const float uz1 = fbits(row[S_LEX]);
  const float inv0 = __fdiv_rn(1.f, uz0);
  const float inv1 = __fdiv_rn(1.f, uz1);
  const float oma = __fsub_rn(1.f, ax);
  const float denom = __fadd_rn(__fmul_rn(oma, inv0), __fmul_rn(ax, inv1));
  const float u = __fdiv_rn(
      __fadd_rn(__fmul_rn(oma, __fdiv_rn(0.f, uz0)),
                __fmul_rn(ax, __fdiv_rn(fbits(row[S_LENGTH]), uz1))),
      denom);
  const int tx_base =
      wadd(wadd(as_i16(u), as_i16(fbits(row[S_SOFF]))), row[S_OFFX]);
  const int zdist = as_i16(__fdiv_rn(__fadd_rn(oma, ax), denom));
  const int d4 = pack16(light, zdist);

  for (int p = 0; p < 4 && !hor; ++p) {
    if (!(flags & (1 << p))) continue;
    const int* pw = row + BASE_WORDS + PIECE_WORDS * p;
    const bool draws_p = flags & (64 << p);
    const int by = as_i16(__fadd_rn(fbits(pw[Q_YBS]),
                                    __fmul_rn(dx, fbits(pw[Q_YBD]))));
    const int ty = as_i16(__fadd_rn(fbits(pw[Q_YTS]),
                                    __fmul_rn(dx, fbits(pw[Q_YTD]))));
    const int cb = min(H - 1, min(fo, by));
    const int ct = max(0, max(co, ty));
    const bool in_ver = cb >= ct;       // the column is open here
    const int tx = wrap_tex(tx_base, max(pw[Q_TW], 1), P.pow2);
    const int d1 = wadd(wmul(pw[Q_TEX], P.TW), tx);
    const int d2 = pack16(by, ty);
    const int d3 = pack16(pw[Q_OFFY], pw[Q_TH]);
    const int d5 = pw[Q_UY1RAW];
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

__global__ void __launch_bounds__(MAX_THREADS) scan_kernel(const Params P) {
  __shared__ int staged[LIST * ROW_WORDS];   // the round's rows
  __shared__ int list[LIST], flags_of[LIST], meta[2];
  const int TC = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x / P.ntiles;
  const int tx0 = (blockIdx.x % P.ntiles) * TC;   // the tile's columns
  const int tx1 = min(tx0 + TC, P.W) - 1;
  const int x = tx0 + tid;
  const bool live = x <= tx1;
  Column c(P, b, x);
  bool hor = !live;      // a column past the screen's edge walks nothing
  int fo = P.H, co = -1;
  const int n = P.scnt[b];
  const int* rows_b = P.rows + (size_t)b * P.G * NR;

  int next = 0;          // warp 0: the next row to cull
  while (!__syncthreads_and(hor)) {
    // warp 0 lists, in traversal order, the next rows that meet the tile
    if (tid < 32) {
      int m = 0;
      while (next < n) {
        const int k = next + tid;
        int flags = 0;
        bool keep = false;
        if (k < n) {
          const int* row = rows_b + (size_t)k * NR;
          flags = row[R_FLAGS];
          keep = (flags & 15) != 0 && clamp_i16(row[R_X1]) >= tx0
                 && clamp_i16(row[R_X0]) <= tx1;
        }
        const unsigned ball = __ballot_sync(0xffffffffu, keep);
        if (m + __popc(ball) > LIST) break;
        if (keep) {
          const int at = m + __popc(ball & ((1u << tid) - 1u));
          list[at] = k;
          flags_of[at] = flags;
        }
        m += __popc(ball);
        next += 32;
      }
      if (tid == 0) {
        meta[0] = m;
        meta[1] = next;
      }
    }
    __syncthreads();
    const int m = meta[0];
    const bool more = meta[1] < n;
    // the listed rows' words, each active piece's only
    for (int i = tid; i < m * ROW_WORDS; i += TC) {
      const int j = i / ROW_WORDS, w = i % ROW_WORDS;
      const int p = (w - BASE_WORDS) / PIECE_WORDS;
      if (w < BASE_WORDS || (flags_of[j] & (1 << p)))
        staged[i] = rows_b[(size_t)list[j] * NR + row_word(w)];
    }
    __syncthreads();
    for (int j = 0; j < m && !hor; ++j)
      scan_seg(P, staged + j * ROW_WORDS, x, hor, fo, co, c);
    if (!more) break;
  }
  if (!live) return;
  P.cnt[(size_t)b * P.W + x] = c.cnt;
  if (c.ovf) atomicAdd(&P.ovf[b], c.ovf);
}

}  // namespace

extern "C" {

// tc columns a block: a multiple of 32, at most 128
int doom_scan(const int* rows, const int* scnt, int B, int G, int W, int H,
              int K, int TW, int pow2, int tc, int* pool, int* cnt, int* ovf,
              void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (tc < 32 || tc > MAX_THREADS || tc % 32)
    return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (W + tc - 1) / tc;
  Params P{rows, scnt, B, G, W, H, K, TW, pow2, ntiles, pool, cnt, ovf};
  scan_kernel<<<(unsigned)B * ntiles, tc, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// blocks of tc threads the card keeps on one SM
int doom_scan_blocks_per_sm(int tc) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan_kernel, tc, 0);
  return blocks;
}

int doom_row_words() { return NR; }

const char* doom_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
