// Seg-row kernels: the seg rows the paint and wall-scan kernels read, and
// the paint kernel's live-seg drop bits (per camera or per tile).
//
// Replaces no Pallas kernel: the JAX package builds these inputs in XLA
// inside doomtpu/ops/pallas_paint.py::render_paint (its field matrix and
// live lists).  The plain PyTorch versions are
// doomtpu_torch/ops/paint.py::build_rows_reference and
// live_drop_reference; the kernels compute the same outputs bit for bit:
// rows [B, G, NR] (every row, the inactive ones after scnt too), scnt
// [B], drop [B, G] and live_dropped.
//
// rows_kernel, a block a camera:
// (1) Each seg's active bit (any of its four pieces), by seg id, into
//     shared memory, and the camera's count, scnt.
// (2) The stable partition of the traversal order, active segs first:
//     the order is read in tiles of THREADS positions, a block-wide
//     exclusive scan of the active bits (ballot, popcount, warp sums)
//     gives an active seg its row, carry + prefix, and an inactive one
//     scnt + its inactive carry + prefix: argsort(~act, stable) exactly.
//     Each seg's row index goes to shared memory by seg id (the order is
//     a permutation of the segs, seg_order's argsort).
// (3) The rows, in tiles of THREADS segs by seg id: a thread reads its
//     seg's camera-stage fields (neighbouring threads on neighbouring
//     words; the fields' own dtypes and strides, so the [1, G] fields
//     expanded to B are read in place) and writes its row's 56 words to
//     a staging tile in shared memory as 16-byte words; then each half
//     warp stores one staged row whole, 14 16-byte words on 14
//     neighbouring lanes, at its row index.  Every store fills its
//     32-byte sectors; no row is written twice.
//
// drop_kernel, a warp a camera (per-camera live lists): the rows
// k < scnt in row order, 32 at a time; for each 128-column block w a
// ballot of the rows whose [x0, x1] meets it, and each live row's rank
// in its block's list is block w's carry (lane w holds it) plus a
// prefix popcount.  Bit w of drop[b, k] is set where rank > gc (the
// list's capacity); drop is written for every k, 0 past scnt.  The
// camera's sum over blocks of max(count - gc, 0) is added into
// live_dropped with an integer atomic, exact in any order (the launcher
// zeroes it first).
//
// tile_drop_kernel, a block a tile of tb cameras (tile-shared live
// lists, tb 8, or 4 where B is no multiple of 8): a tile's list of
// block w holds the traversal positions live in w for any of its
// cameras, in position order.
// (1) For each camera, the inverse of its order in shared memory (a
//     seg's position), then each row k < scnt ORs its live blocks into
//     the tile's word at its seg's position (a shared-memory atomicOr).
// (2) A warp a block w walks the positions 32 at a time: a ballot of
//     the live ones, the rank carry + prefix popcount, and bit w of the
//     position's dropped word where rank > gc; the tile's sum over
//     blocks of max(count - gc, 0) goes into live_dropped.
// (3) For each camera, the inverse again; drop[b, k] is the row's live
//     blocks and its position's dropped word, 0 past scnt.
//
// What bounds it on the card: bytes.  At 4096 cameras and 736 segs the
// rows are 0.675 GB written once, the fields about 0.48 GB read once
// (chip_smoke.py counts them from the call): about 0.35 ms at 3.35 TB/s.
// The drop reads two words of each active row and writes 4 bytes a
// (camera, seg); the tile drop reads the order twice and R_G besides.
// The staging tile costs shared memory, not bytes, and keeps the stores
// whole where a thread a row would store at a 224-byte stride.
//
// Integers as the plain version takes them: x0, x1 and offset_x_total
// through f32 and back (__int2float_rn, __float2int_rz: exact for the
// f32-born integers the camera stage gives); the edge starts' bits of
// their f32; non-finite f32 fields 0 where the plain version applies
// fin(); a negative flat id indexes from the table's end, as torch's
// indexing does.  Indices into the rows and the drop mask are 64-bit.

#include "layout.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int QUADS = NR / 4;              // 16-byte words of a row
// a staged row's stride in 16-byte words: 15, so the 8 lanes of a
// quarter warp store 16-byte words to 8 distinct 4-bank groups
constexpr int STAGE_QUADS = QUADS + 1;
constexpr int LIVE_BLOCK = 128;

static_assert(NR % 4 == 0, "a seg row is whole 16-byte words");

// the camera-stage fields: [B, G] fields, then [B, G, 4] (one a
// piece).  FIELDS spells them, name:dtype (b bool, i int32, f float32),
// as ops/layout.py's ROW_FIELDS + PIECE_FIELDS do; ops/build.py checks
// the two against each other when it loads the library
enum {
  F_X0, F_X1, F_LSX, F_LSY, F_LEX, F_LEY, F_LENGTH, F_SOFF, F_OFFX,
  F_LIGHT, F_FFL, F_CFL, F_FH, F_CH, F_TWO, F_DC,
  F_ACT, F_DRAWS, F_YBS, F_YBD, F_YTS, F_YTD, F_UY1, F_OFFY, F_TEX,
  N_FIELDS
};
constexpr const char* FIELDS =
    "x0:i x1:i lsx:f lsy:f lex:f ley:f length:f start_offset:f "
    "offset_x_total:i light:i floor_flat:i ceil_flat:i floor_h_i:i "
    "ceil_h_i:i two_sided:b draw_ceiling:b "
    "active:b draws:b yb_s:i yb_d:f yt_s:i yt_d:f uy1:f off_y:i tex:i";

// a field: its data and its strides in elements (batch, seg, piece)
struct Field {
  const void* p;
  long long sb, sg, sp;
};

struct Params {
  Field f[N_FIELDS];
  const int* order;                        // [B, G]
  const unsigned char* flat_is_sky;        // [NF] bool
  const int* tex_h; const int* tex_w;      // [T]
  int NF, B, G;
  int* rows;                               // [B, G, NR]
  int* scnt;                               // [B]
};

struct DropParams {
  const int* rows; const int* scnt;
  const int* order;                        // [B, G] (the tile drop)
  int B, G, nbw, gc, tb;
  int* drop;                               // [B, G]
  int* dropped;                            // scalar
};

template <typename T>
__device__ __forceinline__ T at(const Field& f, int b, int s, int q = 0) {
  return static_cast<const T*>(f.p)[b * f.sb + s * f.sg + q * f.sp];
}
__device__ __forceinline__ int word(const Field& f, int b, int s, int q = 0) {
  return at<int>(f, b, s, q);
}
__device__ __forceinline__ int flag(const Field& f, int b, int s, int q = 0) {
  return at<unsigned char>(f, b, s, q) != 0;
}
// an f32 field's bits, 0 where it is not finite (fin)
__device__ __forceinline__ int fin_bits(int v) {
  return (v & 0x7f800000) == 0x7f800000 ? 0 : v;
}
// an i32 through f32 and back (via_f32)
__device__ __forceinline__ int via_f32(int v) {
  return __float2int_rz(__int2float_rn(v));
}
// the bits of an i32's f32
__device__ __forceinline__ int f32_bits(int v) {
  return __float_as_int(__int2float_rn(v));
}

__device__ __forceinline__ int any_active(const Params& p, int b, int s) {
  const Field& f = p.f[F_ACT];
  return flag(f, b, s, 0) | flag(f, b, s, 1) | flag(f, b, s, 2)
         | flag(f, b, s, 3);
}

__device__ __forceinline__ int sky(const Params& p, int flat) {
  return p.flat_is_sky[flat < 0 ? flat + p.NF : flat] != 0;
}

// the row of seg s of camera b, in registers
__device__ __forceinline__ void seg_row(const Params& p, int b, int s,
                                        int (&w)[NR]) {
  const Field* f = p.f;
  int flags = flag(f[F_TWO], b, s) << 4 | flag(f[F_DC], b, s) << 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    flags |= flag(f[F_ACT], b, s, q) << q
             | flag(f[F_DRAWS], b, s, q) << (6 + q);
    const int tex = word(f[F_TEX], b, s, q);
    const int ts = max(tex, 0);
    if (q == 1) flags |= (tex >= 0) << 12;
    int* pw = w + R_PIECE0 + P_WORDS * q;
    pw[P_YBS] = f32_bits(word(f[F_YBS], b, s, q));
    pw[P_YBD] = fin_bits(word(f[F_YBD], b, s, q));
    pw[P_YTS] = f32_bits(word(f[F_YTS], b, s, q));
    pw[P_YTD] = fin_bits(word(f[F_YTD], b, s, q));
    pw[P_TH] = p.tex_h[ts];
    pw[P_TW] = p.tex_w[ts];
    pw[P_OFFY] = word(f[F_OFFY], b, s, q);
    pw[P_TEX] = ts;
    const int uy1 = word(f[F_UY1], b, s, q);
    pw[P_UY1] = fin_bits(uy1);
    pw[P_UY1RAW] = uy1;
  }
  const int ffl = word(f[F_FFL], b, s), cfl = word(f[F_CFL], b, s);
  flags |= sky(p, ffl) << 10 | sky(p, cfl) << 11;
  w[R_G] = s;
  w[R_X0] = via_f32(word(f[F_X0], b, s));
  w[R_X1] = via_f32(word(f[F_X1], b, s));
  w[R_FLAGS] = flags;
  w[R_LSX] = fin_bits(word(f[F_LSX], b, s));
  w[R_LSY] = fin_bits(word(f[F_LSY], b, s));
  w[R_LEX] = fin_bits(word(f[F_LEX], b, s));
  w[R_LEY] = fin_bits(word(f[F_LEY], b, s));
  w[R_LENGTH] = fin_bits(word(f[F_LENGTH], b, s));
  w[R_SOFF] = fin_bits(word(f[F_SOFF], b, s));
  w[R_OFFX] = via_f32(word(f[F_OFFX], b, s));
  w[R_LIGHT] = word(f[F_LIGHT], b, s);
  w[R_FLAT] = ffl;
  w[R_FLAT + 1] = cfl;
  w[R_PLANEH] = word(f[F_FH], b, s);
  w[R_PLANEH + 1] = word(f[F_CH], b, s);
}

// the block's sum of v; every thread calls it
__device__ __forceinline__ int block_sum(int v, int* wsum) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += wsum[i];
  __syncthreads();
  return total;
}

// the block's exclusive prefix of the bits a (0 or 1) in thread order,
// and their total; every thread calls it
__device__ __forceinline__ int block_scan(int a, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(FULL, a);
  if (lane == 0) wsum[warp] = __popc(m);
  __syncthreads();
  int before = __popc(m & ((1u << lane) - 1u));
  total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const int c = wsum[i];
    if (i < warp) before += c;
    total += c;
  }
  __syncthreads();
  return before;
}

__global__ void __launch_bounds__(THREADS)
rows_kernel(const __grid_constant__ Params p) {
  extern __shared__ int4 smem4[];
  int4* stage = smem4;                                 // [THREADS][15]
  int* wsum = reinterpret_cast<int*>(stage + THREADS * STAGE_QUADS);
  int* dest = wsum + WARPS;                            // [G]: a seg's row
  const int b = blockIdx.x, t = threadIdx.x;
  const int G = p.G;

  // (1) active bits by seg id, and scnt
  int n = 0;
  for (int s = t; s < G; s += THREADS) {
    const int a = any_active(p, b, s);
    dest[s] = a;
    n += a;
  }
  const int scnt = block_sum(n, wsum);
  if (t == 0) p.scnt[b] = scnt;

  // (2) the stable partition: each seg's row.  A seg's entry is read and
  // written by the one thread that holds its order position
  const int* order = p.order + (long long)b * G;
  int carry_a = 0, carry_i = scnt;
  for (int j0 = 0; j0 < G; j0 += THREADS) {
    const int j = j0 + t;
    int s = 0, a = 0;
    if (j < G) {
      s = order[j];
      a = dest[s];
    }
    int total;
    const int before = block_scan(a, wsum, total);
    if (j < G) dest[s] = a ? carry_a + before : carry_i + (t - before);
    carry_a += total;
    carry_i += min(THREADS, G - j0) - total;
  }
  __syncthreads();

  // (3) the rows, staged by seg id, stored whole at their rows
  int4* rows = reinterpret_cast<int4*>(p.rows) + (long long)b * G * QUADS;
  const int lane = t & 31, half = lane >> 4, q = lane & 15;
  for (int s0 = 0; s0 < G; s0 += THREADS) {
    const int s = s0 + t;
    if (s < G) {
      int w[NR];
      seg_row(p, b, s, w);
#pragma unroll
      for (int i = 0; i < QUADS; ++i)
        stage[t * STAGE_QUADS + i] =
            make_int4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
    __syncthreads();
    const int nt = min(THREADS, G - s0);
    if (q < QUADS)
      for (int r = 2 * (t >> 5) + half; r < nt; r += 2 * WARPS)
        rows[(long long)dest[s0 + r] * QUADS + q] =
            stage[r * STAGE_QUADS + q];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
drop_kernel(const __grid_constant__ DropParams p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= p.B) return;                               // the whole warp
  const int n = p.scnt[b];
  const int* rows = p.rows + (long long)b * p.G * NR;
  int* drop = p.drop + (long long)b * p.G;
  const unsigned upto = (2u << lane) - 1u;      // lanes <= lane (31: all)
  int carry = 0;                  // lane w: block w's live rows so far
  for (int k0 = 0; k0 < p.G; k0 += 32) {
    const int k = k0 + lane;
    int bits = 0;
    if (k0 < n) {                                     // the whole warp
      const bool act = k < n;
      int x0 = 0, x1 = 0;
      if (act) {
        x0 = clamp_i16(rows[k * NR + R_X0]);
        x1 = clamp_i16(rows[k * NR + R_X1]);
      }
      for (int w = 0; w < p.nbw; ++w) {
        const int wlo = w * LIVE_BLOCK;
        const bool live = act && x0 < wlo + LIVE_BLOCK && x1 >= wlo;
        const unsigned m = __ballot_sync(FULL, live);
        const int rank = __shfl_sync(FULL, carry, w) + __popc(m & upto);
        if (live && rank > p.gc) bits |= (int)(1u << w);
        if (lane == w) carry += __popc(m);
      }
    }
    if (k < p.G) drop[k] = bits;
  }
  const int over = __reduce_add_sync(FULL, lane < p.nbw ? max(carry - p.gc, 0)
                                                        : 0);
  if (lane == 0 && over) atomicAdd(p.dropped, over);
}

// the 128-column blocks (bits, nbw of them) a row's [x0, x1] meets
__device__ __forceinline__ unsigned live_blocks(const int* row, int nbw) {
  const int x0 = clamp_i16(row[R_X0]), x1 = clamp_i16(row[R_X1]);
  unsigned m = 0;
  for (int w = 0; w < nbw; ++w)
    if (x0 < (w + 1) * LIVE_BLOCK && x1 >= w * LIVE_BLOCK) m |= 1u << w;
  return m;
}

// the inverse of camera b's order in inv (a seg's position); the
// caller syncs before and after
__device__ __forceinline__ void invert_order(const DropParams& p, int b,
                                             int* inv) {
  const int* order = p.order + (long long)b * p.G;
  for (int j = threadIdx.x; j < p.G; j += THREADS) inv[order[j]] = j;
}

__global__ void __launch_bounds__(THREADS)
tile_drop_kernel(const __grid_constant__ DropParams p) {
  extern __shared__ int smem[];
  const int G = p.G, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* inv = smem;                                     // [G]
  unsigned* tlive = reinterpret_cast<unsigned*>(inv + G);  // [G] by pos
  unsigned* tdrop = tlive + G;                         // [G] by pos
  const int b0 = blockIdx.x * p.tb;
  for (int j = t; j < G; j += THREADS) tlive[j] = tdrop[j] = 0;

  // (1) the tile's live blocks by position
  for (int c = 0; c < p.tb; ++c) {
    const int b = b0 + c;
    __syncthreads();
    invert_order(p, b, inv);
    __syncthreads();
    const int* rows = p.rows + (long long)b * G * NR;
    for (int k = t; k < p.scnt[b]; k += THREADS) {
      const unsigned m = live_blocks(rows + (long long)k * NR, p.nbw);
      if (m) atomicOr(&tlive[inv[rows[(long long)k * NR + R_G]]], m);
    }
  }
  __syncthreads();

  // (2) each block's list over positions: the dropped ones
  const unsigned upto = (2u << lane) - 1u;      // lanes <= lane (31: all)
  int over = 0;
  for (int w = warp; w < p.nbw; w += WARPS) {
    int carry = 0;
    for (int j0 = 0; j0 < G; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < G && (tlive[j] >> w & 1u);
      const unsigned m = __ballot_sync(FULL, live);
      if (live && carry + __popc(m & upto) > p.gc)
        atomicOr(&tdrop[j], 1u << w);
      carry += __popc(m);
    }
    over += max(carry - p.gc, 0);
  }
  if (lane == 0 && over) atomicAdd(p.dropped, over);

  // (3) each camera's drop bits
  for (int c = 0; c < p.tb; ++c) {
    const int b = b0 + c;
    __syncthreads();
    invert_order(p, b, inv);
    __syncthreads();
    const int n = p.scnt[b];
    const int* rows = p.rows + (long long)b * G * NR;
    int* drop = p.drop + (long long)b * G;
    for (int k = t; k < G; k += THREADS) {
      int bits = 0;
      if (k < n) {
        const int* row = rows + (long long)k * NR;
        bits = (int)(live_blocks(row, p.nbw) & tdrop[inv[row[R_G]]]);
      }
      drop[k] = bits;
    }
  }
}

size_t rows_smem(int G) {
  return sizeof(int4) * THREADS * STAGE_QUADS + sizeof(int) * (WARPS + G);
}

size_t tile_drop_smem(int G) { return sizeof(int) * 3 * (size_t)G; }

// raise a kernel's dynamic shared memory limit to smem, once per size
// (allowed: the kernel's limit so far)
cudaError_t allow_smem(const void* kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

size_t rows_allowed = 48 * 1024, tile_drop_allowed = 48 * 1024;

}  // namespace

extern "C" {

// fields: N_FIELDS x (data pointer, batch, seg and piece strides in
// elements), in FIELDS order
int doom_rows(const long long* fields, int nfields, const int* order,
              const unsigned char* flat_is_sky, int NF, const int* tex_h,
              const int* tex_w, int B, int G, int* rows, int* scnt,
              void* stream) {
  if (nfields != N_FIELDS || G < 0 || NF <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Params p;
  for (int i = 0; i < N_FIELDS; ++i)
    p.f[i] = Field{(const void*)fields[4 * i], fields[4 * i + 1],
                   fields[4 * i + 2], fields[4 * i + 3]};
  p.order = order;
  p.flat_is_sky = flat_is_sky;
  p.tex_h = tex_h;
  p.tex_w = tex_w;
  p.NF = NF;
  p.B = B;
  p.G = G;
  p.rows = rows;
  p.scnt = scnt;
  const size_t smem = rows_smem(G);
  const cudaError_t e = allow_smem((const void*)rows_kernel, smem,
                                   rows_allowed);
  if (e != cudaSuccess) return (int)e;
  rows_kernel<<<(unsigned)B, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// nbw 128-column blocks (at most 32), capacity gc, lists a camera (tb
// 1) or a tile of tb cameras (4 or 8; B a multiple of it, order read);
// zeroes *dropped first
int doom_live_drop(const int* rows, const int* scnt, const int* order,
                   int B, int G, int nbw, int gc, int tb, int* drop,
                   int* dropped, void* stream) {
  if (nbw < 1 || nbw > 32 || G < 0 || !(tb == 1 || tb == 4 || tb == 8)
      || B % tb)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(dropped, 0, sizeof(int),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess || B <= 0) return (int)e;
  const DropParams p{rows, scnt, order, B, G, nbw, gc, tb, drop, dropped};
  if (tb == 1) {
    drop_kernel<<<(unsigned)((B + WARPS - 1) / WARPS), THREADS, 0,
                  (cudaStream_t)stream>>>(p);
  } else {
    const size_t smem = tile_drop_smem(G);
    e = allow_smem((const void*)tile_drop_kernel, smem, tile_drop_allowed);
    if (e != cudaSuccess) return (int)e;
    tile_drop_kernel<<<(unsigned)(B / tb), THREADS, smem,
                       (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// shared memory of a rows block at G segs, and the blocks an SM holds
int doom_rows_smem_bytes(int G) { return (int)rows_smem(G); }

int doom_rows_blocks_per_sm(int G) {
  const size_t smem = rows_smem(G);
  if (allow_smem((const void*)rows_kernel, smem, rows_allowed)
      != cudaSuccess)
    return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rows_kernel,
                                                THREADS, smem);
  return blocks;
}

// shared memory of a drop block at G segs (tb 1: none, a tile: three
// words a seg), and the blocks an SM holds
int doom_live_drop_smem_bytes(int G, int tb) {
  return tb == 1 ? 0 : (int)tile_drop_smem(G);
}

int doom_live_drop_blocks_per_sm(int G, int tb) {
  int blocks = 0;
  if (tb == 1) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, drop_kernel,
                                                  THREADS, 0);
    return blocks;
  }
  const size_t smem = tile_drop_smem(G);
  if (allow_smem((const void*)tile_drop_kernel, smem, tile_drop_allowed)
      != cudaSuccess)
    return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tile_drop_kernel,
                                                THREADS, smem);
  return blocks;
}

const char* doom_rows_fields() { return FIELDS; }

int doom_row_words() { return NR; }

const char* doom_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
