// Hopper probe P4: the price of per-camera row bounds against looping
// over a tile's union row range.
//
// Replaces scripts/probe_percam_ybounds.py:141, the kernel of
// `make_kernel(mode)` (:56).  The plain PyTorch version is
// doomtpu_torch/ops/probe_ybounds.py::ybounds_reference.
//
// The TPU kernel runs S grid steps in order, one emission a step: each
// adds 1 to 8-row blocks of TB = 8 cameras' [H = 200, 128] counts, within
// row bounds taken from the emission's [TB, 128] lo / hi rows.  Here a
// block takes one (camera, 32-column tile), as K1's blocks do, and one
// chunk of the emissions: a grid of 8 x 4 x chunks blocks of 256
// threads.  A loop over the chunk's emissions inside the block takes the
// place of the sequential grid; the tile's [200, 32] partial counts stay
// in shared memory (25.6 KB), and the chunks' partials are summed by
// integer atomicAdd into the zeroed output (integer sums do not depend
// on their order, so the output is the same bit for bit for any chunk
// count).  chunks = 1 is the serial walk (32 blocks: the latency of a
// mechanism inside a serial loop like K1's walk); the full-card chunking
// (`full_chunks`) keeps every SM as many blocks deep as fit, which is
// the probe's price at the card's throughput.  Thread t owns row
// 8 * yb + t / 32 of every 8-row block yb at column t % 32, so an 8-row
// block's 256 words are one a thread and a thread touches only its own
// words (the band mode: rows [25 g, 25 g + 25) of its column, g = t / 32).
// Modes, each with the TPU mode's output:
//
//   empty    loop machinery only: camera 0's blocks add the emission's
//            lo rows to their rows 0-7
//   union    the union of the 8 cameras' 8-row blocks, +1 on all of them
//   percam   the union loop, skipping 8-row blocks outside the block's own
//            camera's bounds; the bounds are reduced once an emission,
//            warp w taking camera w's 128 lanes (__reduce_min_sync /
//            __reduce_max_sync), then across warps through shared memory
//   percamS  the same bounds used directly as the loop's trip counts
//   percamR  the TPU's "full reductions" route: the block stages its
//            camera's 128 lo and hi in shared memory and every thread
//            reduces them itself, no warp reduction; own-bounds loop
//   band     K1's own mechanism (paint.cu:468-478): each lane's rows
//            [lo, hi] painted by R = 8 bands of 25 rows, each band
//            intersecting them with its own rows (no TPU body)
//
// What bounds it on the card: bytes (each emission's 8 KB of bounds,
// 33.5 MB at S = 4096, and the 800 KB output: ~10 us at 3.35 TB/s); what
// sets its time is the per-emission chain of loads, reductions, one
// barrier (double-buffered slots) and the row loop's trips, over S /
// chunks emissions a block.  The design splits that chain over chunks
// and leaves each mode's per-emission body, the probe's answer, as it
// was.  Row blocks use floor division (an arithmetic shift), as the TPU
// kernel's `//`.

#include <algorithm>
#include <climits>
#include <utility>

#include <cuda_runtime.h>

#define ROLLED _Pragma("unroll 1")

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TB = 8, H = 200, LANES = 128, TILE = 32, THREADS = 256;
constexpr int TILES = LANES / TILE;
constexpr int BANDS = THREADS / TILE, BAND = H / BANDS;

// the order of ops/probe_ybounds.py::MODES
enum Mode { EMPTY, UNION, PERCAM, PERCAM_S, PERCAM_R, BAND_M, N_MODES };
const char* const NAMES = "empty,union,percam,percamS,percamR,band";

// +1 on 8-row blocks [b0, b1) of the thread's rows
__device__ __forceinline__ void add_blocks(int* cnt, int b0, int b1, int t) {
  ROLLED for (int yb = b0; yb < b1; ++yb) cnt[yb * THREADS + t] += 1;
}

// block (cam x TILES + tile, chunk): emissions [chunk x S / chunks,
// (chunk + 1) x S / chunks), its partial counts added into `out`
template <int M>
__global__ void __launch_bounds__(THREADS) ybounds_kernel(const int* lo,
                                                          const int* hi,
                                                          int S, int* out) {
  __shared__ int cnt[H * TILE];
  __shared__ int red[2][2 * TB];         // a parity: lo mins, hi maxes
  __shared__ int stage[2][2 * LANES];    // percamR, a parity: lo, hi
  const int cam = blockIdx.x / TILES, tile = blockIdx.x % TILES;
  const int t = threadIdx.x, c = t & (TILE - 1), w = t / TILE;
  const int s0 = (int)((long long)blockIdx.y * S / gridDim.y);
  const int s1 = (int)((long long)(blockIdx.y + 1) * S / gridDim.y);
  if (s0 == s1) return;
  for (int k = t; k < H * TILE; k += THREADS) cnt[k] = 0;
  __syncthreads();
  ROLLED for (int s = s0; s < s1; ++s) {
    const int* los = lo + (size_t)s * TB * LANES;
    const int* his = hi + (size_t)s * TB * LANES;
    if constexpr (M == EMPTY) {
      if (cam == 0) cnt[w * TILE + c] += los[w * LANES + tile * TILE + c];
    } else if constexpr (M == BAND_M) {
      const int x = cam * LANES + tile * TILE + c;
      const int y0 = max(los[x], w * BAND);
      const int y1 = min(his[x], w * BAND + BAND - 1);
      ROLLED for (int y = y0; y <= y1; ++y) cnt[y * TILE + c] += 1;
    } else if constexpr (M == PERCAM_R) {
      int* st = stage[s & 1];
      st[t] = t < LANES ? los[cam * LANES + t] : his[cam * LANES + t - LANES];
      __syncthreads();
      int mn = st[0], mx = st[LANES];
      for (int k = 1; k < LANES; ++k) {
        mn = min(mn, st[k]);
        mx = max(mx, st[LANES + k]);
      }
      add_blocks(cnt, max(mn, 0) >> 3, (min(mx, H - 1) >> 3) + 1, t);
    } else {
      // warp w reduces camera w's 128 lanes
      int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
      for (int k = 0; k < LANES / 32; ++k) {
        mn = min(mn, los[w * LANES + c + 32 * k]);
        mx = max(mx, his[w * LANES + c + 32 * k]);
      }
      mn = __reduce_min_sync(FULL, mn);
      mx = __reduce_max_sync(FULL, mx);
      int* rd = red[s & 1];
      if (c == 0) {
        rd[w] = mn;
        rd[TB + w] = mx;
      }
      __syncthreads();
      int ulo = rd[0], uhi = rd[TB];
#pragma unroll
      for (int b = 1; b < TB; ++b) {
        ulo = min(ulo, rd[b]);
        uhi = max(uhi, rd[TB + b]);
      }
      const int u0 = max(ulo, 0) >> 3, u1 = (min(uhi, H - 1) >> 3) + 1;
      const int o0 = max(rd[cam], 0) >> 3;
      const int o1 = (min(rd[TB + cam], H - 1) >> 3) + 1;
      if constexpr (M == UNION) {
        add_blocks(cnt, u0, u1, t);
      } else if constexpr (M == PERCAM_S) {
        add_blocks(cnt, o0, o1, t);
      } else {
        ROLLED for (int yb = u0; yb < u1; ++yb) {
          if (yb >= o0 && yb < o1) cnt[yb * THREADS + t] += 1;
        }
      }
    }
  }
  __syncthreads();
  for (int k = t; k < H * TILE; k += THREADS)
    if (cnt[k] != 0)
      atomicAdd(out + ((size_t)cam * H + k / TILE) * LANES + tile * TILE
                    + k % TILE,
                cnt[k]);
}

template <int M>
cudaError_t launch(const int* lo, const int* hi, int S, int chunks, int* out,
                   cudaStream_t stream) {
  ybounds_kernel<M><<<dim3(TB * TILES, chunks), THREADS, 0, stream>>>(
      lo, hi, S, out);
  return cudaGetLastError();
}

// chunks that keep every SM as many ybounds_kernel<M> blocks deep as fit
template <int M>
cudaError_t full_chunks(int& chunks) {
  static int cached = 0;
  if (cached == 0) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, ybounds_kernel<M>, THREADS, 0);
    if (e != cudaSuccess) return e;
    cached = std::max(1, (sms * per + TB * TILES - 1) / (TB * TILES));
  }
  chunks = cached;
  return cudaSuccess;
}

template <int... Ms>
cudaError_t dispatch(int m, const int* lo, const int* hi, int S, int chunks,
                     int* out, cudaStream_t stream,
                     std::integer_sequence<int, Ms...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((m == Ms ? (e = launch<Ms>(lo, hi, S, chunks, out, stream), 0) : 0), ...);
  return e;
}

template <int... Ms>
cudaError_t dispatch_chunks(int m, int& chunks,
                            std::integer_sequence<int, Ms...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((m == Ms ? (e = full_chunks<Ms>(chunks), 0) : 0), ...);
  return e;
}

}  // namespace

extern "C" {

// mode: the index of its name in probe_ybounds_names; lo, hi
// [S, 8, 128] i32; out [8, 200, 128] i32, zeroed by the caller (the
// chunks' counts are added into it); 1 <= chunks <= 65535
int probe_ybounds(int mode, const int* lo, const int* hi, int S, int chunks,
                  int* out, void* stream) {
  if (mode < 0 || mode >= N_MODES || S < 0 || chunks < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(mode, lo, hi, S, chunks, out, (cudaStream_t)stream,
                       std::make_integer_sequence<int, N_MODES>{});
}

// the full-card chunk count of mode `mode` into *chunks
int probe_ybounds_full_chunks(int mode, int* chunks) {
  if (mode < 0 || mode >= N_MODES) return (int)cudaErrorInvalidValue;
  return (int)dispatch_chunks(mode, *chunks,
                              std::make_integer_sequence<int, N_MODES>{});
}

const char* probe_ybounds_names() { return NAMES; }

const char* probe_ybounds_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
