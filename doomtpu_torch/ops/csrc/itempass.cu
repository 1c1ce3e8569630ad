// Item-pass kernel: every selected sprite and masked mid of a camera
// painted over its paint frame, with no per-column item cap, then the
// shade of the pixels the items wrote.
//
// Replaces doomtpu/ops/pallas_itempass.py::_kernel (the TPU kernel
// launched by item_pass).  Computes the same outputs bit for bit; the
// plain PyTorch version is doomtpu_torch/ops/itempass.py::
// item_pass_reference, and the item pack's rows are described there.
//
// Design: a block takes one camera and a tile of TC screen columns,
// TC x R threads; thread (c, g) serves column c and band g of its rows,
// [g * BH, (g + 1) * BH).  The block lists the camera's N packed items
// whose [x0, x1e) meets the tile, in pack order (farthest first): each
// thread tests one item of a pass of TC x R, a ballot a warp and the
// warps' counts summed in order give each kept item its place (a stable
// compaction).  The list is taken in rounds of up to S items:
// (1) the block stages the round's 8 int and 12 float pack words in
//     shared memory; the first round also stages the tile's clip
//     records (5 words each: the seg's endpoints and the record's
//     top | bottom bounds on a sprite in front, layout.cuh) and its mid
//     records' keys (the seg id of a KIND_MID record, else -1);
// (2) the (item, column) pairs are split over the R threads of a
//     column: each does a sprite's billboard math and folds its clip
//     over the staged records (renderer/map_objects.rs:127-166), or
//     finds a mid's last matching record and reads its draw words; it
//     stores the pair's rows, edges, texture terms, atlas column and ld
//     word (light | zdist | written) in shared memory;
// (3) each band folds the round's items in list order over its rows:
//     per row v by interpolation, texel | opaque << 8 from the column
//     atlas, and where opaque the 16-bit mark (slot + 1) << 8 | texel
//     overwrites (nearer items come later and win);
// (4) each band shades its marked pixels (palette, light diminish) and
//     stores idx, ld and rgb there, and only there; with TC = 32 a warp
//     stores consecutive columns of one row.  A round that leaves items
//     for a next one clears its marks.
// The kernel never reads idx or ld: pixels no item drew keep the paint
// frame.  The TPU kernel's per-(tile, 128-column block) live-item lists,
// 4-item scalar packs, tile-uniform picture windows and 8-row blocks are
// TPU devices and have no counterpart.
//
// TC and R come from ops/itempass.py::itempass_tile (32 columns while
// the block's shared memory fits 227 KB; bands of ~BAND_ROWS rows).
// Measured on an H100 (e1m1-scale, 4096 cameras, 320x200, clip 64, mid
// 40; PERF.md): 16 bands beat 1-8; rounds of 16 items and 16-bit marks
// keep a block at 75 KB, 3 blocks (48 warps) an SM at 40 registers,
// where rounds of 32 held 2 and lost; reading the clip records from L1
// instead of staging them cost registers and blocks, and lost.
//
// What bounds it on the card: not bytes (2.75 ms against a 0.32 ms byte
// bound: each (camera, item) pair's first words, the covering items'
// packs, the records of the columns items cover, 12 B per written
// pixel) but latency: a cost probe of the kernel cut after each stage
// (PERF.md) gave ~0.6 ms to the list and staging (dependent loads
// between barriers), ~0.35 to the terms, ~1.4 to the fold (an IEEE
// divide, an atlas load from L2 and a shared store a row) and ~0.45 to
// the write.
//
// Numerics: compiled with -fmad=false, and the parity-critical products
// use __fmul_rn / __fadd_rn / __fdiv_rn.  The shade multiplies by
// inv_255 = f32(1 / 255), as XLA computes light / 255 (layout.cuh,
// shade_rgb).

#include "layout.cuh"

// Every row loop stays rolled (see paint.cu: nvcc 12.8 for sm_90a drew
// one row past a span's end with such loops unrolled).
#define ROLLED _Pragma("unroll 1")

namespace {

constexpr int LD_WRITTEN = 1 << 24;
constexpr int MAX_THREADS = 512;
constexpr int PIC = 128;   // the JAX kernel's 128 x 128 picture tables
constexpr int S = 16;      // items a round (ops/itempass.py ROUND_ITEMS)

// the item pack's rows: layout.cuh (ops/itempass.py IPI_* / IPF_*)
constexpr int PACK = IPI_ROWS + IPF_ROWS;   // staged words an item

// terms of an (item, column) pair, each [S][TC]
constexpr int T_ROWS = 0;    // y0 << 16 | y1 (y0 > y1: nothing to draw)
constexpr int T_BYTY = 1;    // by | ty
constexpr int T_OFFTH = 2;   // off_y | th
constexpr int T_UY1 = 3;     // uy1 bits
constexpr int T_COL = 4;     // atlas column * rows (wrapping i32)
constexpr int T_LD = 5;      // light << 16 | zdist | written
constexpr int TERMS = 6;

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
  int TC, R, BH, ntiles;
  int* idx; int* ld; int* rgb;           // [B, H, W], updated in place
};

// The terms of list slot j at column x (phase 2): the sprite's billboard
// column (layout.cuh billboard_column, shared with the emission kernel)
// and its clip over the staged records, or the mid's draw words; then
// the rows, the picture's atlas column and the ld word.
__device__ void item_terms(const Params& p, int b, int x, const int* ir,
                           const float* fr, const int* recs,
                           const int* mkey, int ccnt, int mcnt, int* t) {
  const int TC = p.TC, H = p.H;
  t[T_ROWS * S * TC] = pack16(0, -1);
  if (x >= p.W || x < ir[IPI_X0] || x >= ir[IPI_X1E]) return;
  const int fl = ir[IPI_FL], soff = ir[IPI_SOFF], pic = ir[IPI_PIC];
  int ct, cb, by, ty, tx, offy, th, light, zd;
  float uy1;
  if (fl & 2) {
    const BillboardColumn bc = billboard_column(x, ir, fr);
    tx = bc.tx;
    zd = bc.zd;
    by = bc.by;
    ty = bc.ty;
    const float vx = fr[IPF_VPX], vy = fr[IPF_VPY];
    int tsc = -1, bsc = H;
    const int* r = recs;
    ROLLED for (int kc = 0; kc < ccnt; ++kc, r += CLIP_RECORD_WORDS * TC) {
      if (is_behind_vertex(fbits(r[0]), fbits(r[TC]), fbits(r[2 * TC]),
                           fbits(r[3 * TC]), vx, vy))
        continue;
      const int tb = r[4 * TC];
      tsc = max(tsc, tb >> 16);
      bsc = min(bsc, lo16(tb));
    }
    ct = max(max(0, ty), tsc);
    cb = min(min(H - 1, by), bsc);
    offy = 0;
    th = ir[IPI_TH];
    light = ir[IPI_LW] & 0xFFFF;
    uy1 = fr[IPF_UY1];
  } else {
    // the mid's draw data: the last record of its seg in the mid pool
    int k_hit = -1;
    ROLLED for (int k = 0; k < mcnt; ++k)
      if (mkey[k * TC] == soff) k_hit = k;
    if (k_hit < 0) return;
    const long o = ((long)b * p.KM + k_hit) * p.W + x;
    const int mw = p.mspan[o], d2 = p.md2[o], d3 = p.md3[o], d4 = p.md4[o];
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
  if (y0 > y1) return;
  // the picture's column in the atlas (JAX item_q / item_mq: 128 x 128)
  const int c = min(max(tx, 0), PIC - 1);
  const bool is_tex = pic < p.T;
  if (c >= (is_tex ? p.TW : p.PW)) return;      // transparent column
  const int col = wadd(is_tex ? wmul(pic, p.TW)
                              : wadd(p.spr0, wmul(wsub(pic, p.T), p.PW)),
                       c);
  t[T_ROWS * S * TC] = pack16(y0, y1);
  t[T_BYTY * S * TC] = pack16(by, ty);
  t[T_OFFTH * S * TC] = pack16(offy, th);
  t[T_UY1 * S * TC] = __float_as_int(uy1);
  t[T_COL * S * TC] = wmul(col, p.rows);
  t[T_LD * S * TC] = shl(light, 16) | (zd & 0xFFFF) | LD_WRITTEN;
}

__global__ void __launch_bounds__(MAX_THREADS) itempass_kernel(Params p) {
  extern __shared__ int smem[];
  const int TC = p.TC, R = p.R, H = p.H;
  int* terms = smem;                           // [TERMS][S][TC]
  int* recs = terms + TERMS * S * TC;          // [KC][CLIP_RECORD_WORDS][TC]
  int* mkey = recs + p.KC * CLIP_RECORD_WORDS * TC;   // [KM][TC]
  int* pack = mkey + p.KM * TC;                // [S][PACK] a round's packs
  int* list = pack + S * PACK;                 // [TC * R] a pass's items
  int* wcount = list + TC * R;                 // [TC * R / 32] per warp
  uint16_t* marks = (uint16_t*)(wcount + (TC * R + 31) / 32);   // [H][TC]

  const int b = blockIdx.x / p.ntiles;
  const int tx0 = (blockIdx.x % p.ntiles) * TC;   // the tile's columns
  const int tx1 = min(tx0 + TC, p.W) - 1;
  const int c = threadIdx.x, g = threadIdx.y, tid = g * TC + c;
  const int x = tx0 + c;
  const bool live = x <= tx1;
  const long bw = (long)b * p.W + x;
  const int ylo = g * p.BH, yhi = min(ylo + p.BH, H) - 1;
  const int* ip = p.ipk + (long)b * p.N * IPI_ROWS;
  const int* fp = (const int*)p.fpk + (long)b * p.N * IPF_ROWS;
  const int n_rows = min(p.rows, PIC);
  int ccnt = 0, mcnt = 0;
  bool staged = false;

  ROLLED for (int y = ylo; y <= yhi; ++y) marks[y * TC + c] = 0;
  const int nthreads = TC * R, warp = tid / 32, lane = tid % 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const unsigned wmask = warp == (nthreads - 1) / 32 && nthreads % 32
                             ? (1u << (nthreads % 32)) - 1u : 0xffffffffu;
  // the camera's items, nthreads a pass
  for (int base = 0; base < p.N; base += nthreads) {
    // (1) the pass's items that meet the tile, listed in pack order: a
    // ballot a warp, the warps' counts summed in order
    const int n = base + tid;
    bool keep = false;
    if (n < p.N) {
      const int* ir = ip + (long)n * IPI_ROWS;
      keep = (ir[IPI_FL] & 1) && ir[IPI_X1E] > tx0 && ir[IPI_X0] <= tx1;
    }
    const unsigned ball = __ballot_sync(wmask, keep);
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    int at = 0, listed = 0;
    for (int w = 0; w * 32 < nthreads; ++w) {
      at += w < warp ? wcount[w] : 0;
      listed += wcount[w];
    }
    if (keep) list[at + __popc(ball & lanes_below)] = n;
    __syncthreads();
    const bool last_pass = base + nthreads >= p.N;
    // the listed items in rounds of S
    for (int j0 = 0; j0 < listed; j0 += S) {
      const int m = min(S, listed - j0);
      const bool more = j0 + S < listed || !last_pass;
      // their pack words; the tile's records, once
      ROLLED for (int i = tid; i < m * PACK; i += nthreads) {
        const int j = i / PACK, w = i % PACK;
        const long it = list[j0 + j];
        pack[i] = w < IPI_ROWS ? ip[it * IPI_ROWS + w]
                               : fp[it * IPF_ROWS + w - IPI_ROWS];
      }
      if (!staged) {
        staged = true;
        if (live) {
          ccnt = min(p.ccnt[bw], p.KC);
          mcnt = min(p.mcnt[bw], p.KM);
        }
        const long clip0 = (long)b * p.KC * p.W + x;   // record k: + k * W
        ROLLED for (int k = g; k < ccnt; k += R) {
          const long o = clip0 + (long)k * p.W;
          int* r = recs + k * CLIP_RECORD_WORDS * TC + c;
          r[0] = p.clsx[o];
          r[TC] = p.clsy[o];
          r[2 * TC] = p.clex[o];
          r[3 * TC] = p.cley[o];
          r[4 * TC] = record_bounds(p.cspan[o], p.cd2[o], H);
        }
        const long mid0 = (long)b * p.KM * p.W + x;
        ROLLED for (int k = g; k < mcnt; k += R) {
          const long o = mid0 + (long)k * p.W;
          mkey[k * TC + c] =
              ((p.mspan[o] >> 29) & 3) == KIND_MID ? p.md6[o] : -1;
        }
      }
      __syncthreads();
      // (2) the terms of each (item, column) pair, the items of a column
      // split over its R threads
      ROLLED for (int j = g; j < m; j += R) {
        const int* ir = pack + j * PACK;
        item_terms(p, b, x, ir, (const float*)(ir + IPI_ROWS), recs + c,
                   mkey + c, ccnt, mcnt, terms + j * TC + c);
      }
      __syncthreads();
      // (3) the round's items in list order over the band's rows
      ROLLED for (int j = 0; j < m; ++j) {
        const int* t = terms + j * TC + c;
        const int yy = t[T_ROWS * S * TC];
        const int y0 = max(yy >> 16, ylo), y1 = min(lo16(yy), yhi);
        if (y0 > y1) continue;
        const int byty = t[T_BYTY * S * TC], offth = t[T_OFFTH * S * TC];
        const int by = byty >> 16, ty = lo16(byty);
        const int offy = offth >> 16, th = lo16(offth);
        const float uy1 = fbits(t[T_UY1 * S * TC]);
        const int col_ix = t[T_COL * S * TC];
        const float thf = (float)th, dby = (float)(by - ty);
        const int thb = max(th, 1);
        const int mark = (j + 1) << 8;
        // the atlas word of row y, or a transparent one past the 128 rows
        auto texel_at = [&](int y) {
          const float ay = __fdiv_rn((float)(y - ty), dby);
          int tyv = as_i16(__fadd_rn(thf, __fmul_rn(ay, uy1))) + offy;
          tyv = wrap_tex(tyv, thb, 0);
          const int t_ix = min(max(wadd(col_ix, tyv), 0), p.n_atlas - 1);
          return tyv < n_rows ? p.atlas[t_ix] : 0;
        };
        // two rows a step, both atlas loads in flight before either mark
        ROLLED for (int y = y0; y <= y1; y += 2) {
          const bool two = y < y1;
          const int t0 = texel_at(y);
          const int t1 = two ? texel_at(y + 1) : 0;
          if (t0 & 0x100) marks[y * TC + c] = mark | (t0 & 0xFF);
          if (t1 & 0x100) marks[(y + 1) * TC + c] = mark | (t1 & 0xFF);
        }
      }
      // (4) shade and store the band's marked pixels
      if (live) {
        const long pix0 = (long)b * H * p.W + x;   // row y at + y * W
        ROLLED for (int y = ylo; y <= yhi; ++y) {
          const int mk = marks[y * TC + c];
          if (mk == 0) continue;
          const int texel = mk & 0xFF;
          const int l = terms[(T_LD * S + (mk >> 8) - 1) * TC + c];
          const long q = pix0 + (long)y * p.W;
          p.idx[q] = texel;
          p.ld[q] = l;
          p.rgb[q] = shade_rgb(p.pal[texel], l, p.inv_255);
          if (more) marks[y * TC + c] = 0;
        }
      }
      __syncthreads();    // the next round restages pack and terms
    }
  }
}

// a block's shared memory (ops/itempass.py::itempass_smem_bytes)
size_t smem_bytes(int tc, int bands, int H, int KC, int KM) {
  const int threads = tc * bands;
  return ((size_t)tc * (TERMS * S + CLIP_RECORD_WORDS * KC + KM)
          + S * PACK + threads + (threads + 31) / 32) * sizeof(int)
         + (size_t)tc * H * sizeof(uint16_t);
}

// raise the kernel's dynamic shared memory limit to `smem` (never lower)
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      itempass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace

extern "C" {

// tc columns per block, bands threads per column (tc * bands <= 512)
int doom_itempass(
    const int* ipk, const float* fpk, int N,
    const int* cspan, const int* cd2, const int* clsx, const int* clsy,
    const int* clex, const int* cley, const int* ccnt,
    const int* mspan, const int* md1, const int* md2, const int* md3,
    const int* md4, const int* md5, const int* md6, const int* mcnt,
    const int* atlas, int n_atlas, int rows, int T, int TW, int spr0, int PW,
    const int* pal, int B, int W, int H, int KC, int KM, float inv_255,
    int tc, int bands, int* idx, int* ld, int* rgb, void* stream) {
  if (B <= 0 || W <= 0 || H <= 0 || N <= 0) return 0;
  if (tc < 1 || bands < 1 || tc * bands > MAX_THREADS)
    return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (W + tc - 1) / tc;
  Params p{ipk, fpk, N, cspan, cd2, clsx, clsy, clex, cley, ccnt,
           mspan, md1, md2, md3, md4, md5, md6, mcnt,
           atlas, n_atlas, rows, T, TW, spr0, PW, pal,
           B, W, H, KC, KM, inv_255, tc, bands, (H + bands - 1) / bands,
           ntiles, idx, ld, rgb};
  const size_t smem = smem_bytes(tc, bands, H, KC, KM);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  itempass_kernel<<<(unsigned)B * ntiles, dim3(tc, bands), smem,
                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// blocks of tc x bands threads the card keeps on one SM
int doom_itempass_blocks_per_sm(int tc, int bands, int H, int KC, int KM) {
  const size_t smem = smem_bytes(tc, bands, H, KC, KM);
  if (allow_smem(smem) != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, itempass_kernel,
                                                tc * bands, smem);
  return blocks;
}

const char* doom_itempass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
