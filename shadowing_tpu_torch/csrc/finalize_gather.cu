// Finalize's reads of the k winners out of y, two gathers keyed by the
// winners' flat ids (id = trajectory * n_out + start).
//
// Replaces no TPU kernel: the JAX package leaves finalize to XLA, a window
// gather and an einsum (shadowing_tpu/shadow/engine.py::_finalize_shadow and
// its _extract_paths). They
// are here because the same step as PyTorch operations (advanced indexing
// through an int64 (B, k, C, w) position tensor, the embedding as a broadcast
// product (B, k, d, C, w) written and then summed, a permuting gather of the
// paths after the sort) moved about twenty times the bytes the step needs:
// the product alone is 1.68 GB at B = 64, k = 16,384 and Identity(20).
//
//   gather_embed:    e[n, i] = sum_c sum_tau src[r, c, t0 + in_pos[tau]] * kernel[i, c, tau]
//   extract_windows: out[n, c, x] = src[r, c, t0 + x],  x < W
//
// for window n of the N ids, r = id / n_out and t0 = id % n_out; c runs over
// the kernel's C channels, the first C of src's. Every window is summed from
// 0 in one order, channel by channel and tap by tap, one fmaf each, whichever
// lane, block or plan computes it: equal windows embed bit-equal. On a CUDA
// tensor embed_windows runs through gather_embed too, each window its own row
// (n_out = 1, and null ids and in_pos: window n is id n, tap tau sample tau),
// so the context and a dataset window equal to it embed bit-equal and
// rescore to exactly 0.0. extract_windows is a copy, bit for bit. Reads past
// T - 1 are clamped there and ids to [0, R * n_out); valid ids never need it.
//
// What bounds them on an H100: bytes. At N = 64 x 16,384 windows of Identity
// (20) in 40-sample windows, gather_embed reads each window's 20 input samples
// (84 MB) and writes the embeddings (84 MB): 0.050 ms at 3.35 TB/s, against
// 4.2e8 FMA (0.013 ms at 67 TFLOP/s); extract_windows reads and writes 168 MB
// each, 0.100 ms. At N = 10,000 Foveal(1.15, 0.9, 126) windows of 378 samples
// the two move 6.4 and 30.2 MB: a few microseconds, so latency and the spread
// of a small grid over the SMs decide there.
//
// Design: a warp takes 32 consecutive windows at a time, one a lane; each
// lane splits its window's id once and leaves (row offset, start) in shared
// memory. gather_embed stages the 32 windows' samples of one channel, 32 taps
// at a time, into a padded shared tile, all 32 lanes loading in batches of 8
// (consecutive lanes read consecutive samples of a window where in_pos is
// contiguous); then each lane runs its window's taps against the kernel bank
// with DT sums in registers (8, 24 or 40: the smallest that holds d, else 40
// in passes over d). The bank is staged once a block, transposed to (C * w,
// d padded to DT) so one broadcast 16-byte read feeds 4 FMAs; where it does
// not fit beside the tiles, the lanes read it from kernel through L1, one
// broadcast read an FMA (the same sums in the same order). The embeddings
// leave through the tile as one coalesced run of 32 * d floats.
// extract_windows walks the 32 windows' C * W samples as one flat run, 4
// bytes a lane in batches of 8, in units of 1,024 samples: reads in runs of W
// consecutive samples, the writes contiguous. Both grids are persistent over
// their units (tiles, or parts of a tile's run), which go to the blocks first
// and to a block's warps second, so a small N still spreads over many SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int TW = 32;             // taps staged a chunk
constexpr int U = 8;               // loads a lane keeps in flight
constexpr int SEG = 32 * U * 4;    // samples extract_windows copies a unit
constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory of one block

// ---- the launch plan of gather_embed ----------------------------------------

struct Plan {
  int dt;       // sums a lane holds: 8, 24 or 40
  int dp;       // d zero-padded to a multiple of dt
  int ts;       // floats between two windows' rows of a warp's tile
  bool staged;  // the bank fits shared memory beside the tiles
  int smem;     // bytes of one block's shared memory
};

__host__ __device__ inline Plan make_plan(int d, int C, int w) {
  Plan p;
  p.dt = d <= 8 ? 8 : d <= 24 ? 24 : 40;
  p.dp = (d + p.dt - 1) / p.dt * p.dt;
  p.ts = (TW > p.dt ? TW : p.dt) + 1;
  // per warp: 32 row offsets, 32 starts and its tile
  const long fixed = (long)WARPS * 32 * (8 + 4 + 4 * p.ts);
  const long bank = 4L * C * w * p.dp;
  p.staged = fixed + bank <= SMEM_LIMIT;
  p.smem = (int)(fixed + (p.staged ? bank : 0));
  return p;
}

// A flat index over rows of `width` items that advances 32 at a time.
struct Walk {
  int row, col, drow, dcol, width;
  __device__ Walk(int start, int width_) : width(width_) {
    row = start / width;
    col = start - row * width;
    drow = 32 / width;
    dcol = 32 - drow * width;
  }
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// Each lane splits the id of window n0 + lane: rows[] = r * Cs * T, starts[]
// = t0 (ids clamped into range).
__device__ __forceinline__ void split_ids(const long long* __restrict__ ids,
                                          long n0, int nw, long long n_ids,
                                          int n_out, long long row_stride,
                                          long long* rows, int* starts,
                                          int lane) {
  if (lane < nw) {
    long long id = ids ? ids[n0 + lane] : n0 + lane;
    id = id < 0 ? 0 : id >= n_ids ? n_ids - 1 : id;
    const long long r = id / n_out;
    rows[lane] = r * row_stride;
    starts[lane] = (int)(id - r * n_out);
  }
  __syncwarp();
}

template <int DT, bool STAGED>
__global__ void __launch_bounds__(THREADS) gather_embed_kernel(
    const float* __restrict__ src,        // (R, Cs, T)
    const long long* __restrict__ ids,    // (N,) flat ids, or null: n
    const long long* __restrict__ in_pos, // (w,) input samples, or null: tau
    const float* __restrict__ kernel,     // (d, C, w)
    float* __restrict__ e,                // (N, d)
    long N, long long n_ids, int Cs, int T, int n_out, int C, int w, int d) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(d, C, w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long* rows = reinterpret_cast<long long*>(smem4) + warp * 32;
  int* starts = reinterpret_cast<int*>(reinterpret_cast<long long*>(smem4) +
                                       WARPS * 32) + warp * 32;
  float* tiles = reinterpret_cast<float*>(
      reinterpret_cast<int*>(reinterpret_cast<long long*>(smem4) +
                             WARPS * 32) + WARPS * 32);
  float* tile = tiles + warp * 32 * pl.ts;
  float* bank = tiles + WARPS * 32 * pl.ts;   // (C * w, dp)

  if constexpr (STAGED) {
    const int n = C * w * pl.dp;
    for (int x = tid; x < n; x += THREADS) {
      const int ct = x / pl.dp, i = x - ct * pl.dp;   // ct = c * w + tau
      bank[x] = i < d ? kernel[(size_t)i * C * w + ct] : 0.f;
    }
    __syncthreads();   // the bank is staged; no block-wide barrier follows
  }

  const long n_tiles = (N + 31) / 32;
  for (long t = blockIdx.x + (long)gridDim.x * warp; t < n_tiles;
       t += (long)gridDim.x * WARPS) {
    const long n0 = t * 32;
    const int nw = (int)(N - n0 < 32 ? N - n0 : 32);
    split_ids(ids, n0, nw, n_ids, n_out, (long long)Cs * T, rows, starts,
              lane);
    for (int i0 = 0; i0 < d; i0 += DT) {
      float acc[DT];
#pragma unroll
      for (int q = 0; q < DT; ++q) acc[q] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float* sc = src + (size_t)c * T;
        for (int tc = 0; tc < w; tc += TW) {
          const int wc = w - tc < TW ? w - tc : TW;
          // stage the nw windows' taps tc .. tc + wc - 1 of channel c
          Walk at(lane, wc);
          while (at.row < nw) {
            float v[U];
            int to[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              to[u] = -1;
              if (at.row < nw) {
                const int tau = tc + at.col;
                int pos = starts[at.row] + (in_pos ? (int)in_pos[tau] : tau);
                pos = pos < 0 ? 0 : pos < T ? pos : T - 1;
                v[u] = __ldg(sc + rows[at.row] + pos);
                to[u] = at.row * pl.ts + at.col;
              }
              at.next();
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (to[u] >= 0) tile[to[u]] = v[u];
          }
          __syncwarp();
          const float* xs = tile + lane * pl.ts;
          for (int s = 0; s < wc; ++s) {
            const float x = xs[s];
            const int ct = c * w + tc + s;
            if constexpr (STAGED) {
              const float* kb = bank + (size_t)ct * pl.dp + i0;
#pragma unroll
              for (int q = 0; q < DT; q += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(kb + q);
                acc[q] = fmaf(x, kv.x, acc[q]);
                acc[q + 1] = fmaf(x, kv.y, acc[q + 1]);
                acc[q + 2] = fmaf(x, kv.z, acc[q + 2]);
                acc[q + 3] = fmaf(x, kv.w, acc[q + 3]);
              }
            } else {
#pragma unroll
              for (int q = 0; q < DT; ++q) {
                const float kv = i0 + q < d
                    ? __ldg(kernel + (size_t)(i0 + q) * C * w + ct) : 0.f;
                acc[q] = fmaf(x, kv, acc[q]);
              }
            }
          }
          __syncwarp();   // every lane is done with the tile
        }
      }
      // the sums leave through the tile as one run of nw * dc floats
#pragma unroll
      for (int q = 0; q < DT; ++q) tile[lane * pl.ts + q] = acc[q];
      __syncwarp();
      const int dc = d - i0 < DT ? d - i0 : DT;
      float* eo = e + n0 * d + i0;
      for (Walk at(lane, dc); at.row < nw; at.next())
        eo[(size_t)at.row * d + at.col] = tile[at.row * pl.ts + at.col];
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS) extract_windows_kernel(
    const float* __restrict__ src,      // (R, C, T)
    const long long* __restrict__ ids,  // (N,) flat ids
    float* __restrict__ out,            // (N, C, W)
    long N, long long n_ids, int C, int T, int n_out, int W) {
  __shared__ long long rows_all[WARPS * 32];
  __shared__ int starts_all[WARPS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* rows = rows_all + warp * 32;
  int* starts = starts_all + warp * 32;

  // a unit: SEG samples of one tile's run, so a small N spreads too
  const int segs = (32 * C * W + SEG - 1) / SEG;
  const long n_units = (N + 31) / 32 * segs;
  for (long t = blockIdx.x + (long)gridDim.x * warp; t < n_units;
       t += (long)gridDim.x * WARPS) {
    const long n0 = t / segs * 32;
    const int nw = (int)(N - n0 < 32 ? N - n0 : 32);
    split_ids(ids, n0, nw, n_ids, n_out, (long long)C * T, rows, starts,
              lane);
    // item x of the run: row x / W = v * C + c, sample x % W
    const int x_begin = (int)(t % segs) * SEG;
    const int items = min(nw * C * W, x_begin + SEG);
    float* o = out + (size_t)n0 * C * W;
    Walk at(x_begin + lane, W);
    for (int x0 = x_begin + lane; x0 < items; x0 += 32 * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (x0 + 32 * u < items) {
          const int win = C == 1 ? at.row : at.row / C;
          const int c = at.row - win * C;
          int pos = starts[win] + at.col;
          pos = pos < T ? pos : T - 1;
          v[u] = __ldg(src + rows[win] + (size_t)c * T + pos);
        }
        at.next();
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (x0 + 32 * u < items) o[x0 + 32 * u] = v[u];
    }
    __syncwarp();   // every lane is done with rows and starts
  }
}

int sm_count() {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// as many blocks as the card holds at once, and no more than there are units
long grid_size(long units, int per_sm) {
  const long resident = (long)sm_count() * per_sm;
  return units < resident ? units : resident;
}

template <int DT, bool STAGED>
int launch_gather_embed(const Plan& pl, const float* src, const long long* ids,
                        const long long* in_pos, const float* kernel, float* e,
                        long N, long long n_ids, int Cs, int T, int n_out,
                        int C, int w, int d, cudaStream_t stream) {
  auto* fn = gather_embed_kernel<DT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                pl.smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned)grid_size((N + 31) / 32, per_sm), THREADS, pl.smem, stream>>>(
      src, ids, in_pos, kernel, e, N, n_ids, Cs, T, n_out, C, w, d);
  return (int)cudaGetLastError();
}

template <bool STAGED>
int gather_embed_dt(const Plan& pl, const float* src, const long long* ids,
                    const long long* in_pos, const float* kernel, float* e,
                    long N, long long n_ids, int Cs, int T, int n_out, int C,
                    int w, int d, cudaStream_t stream) {
  switch (pl.dt) {
    case 8:
      return launch_gather_embed<8, STAGED>(pl, src, ids, in_pos, kernel, e, N,
                                            n_ids, Cs, T, n_out, C, w, d,
                                            stream);
    case 24:
      return launch_gather_embed<24, STAGED>(pl, src, ids, in_pos, kernel, e,
                                             N, n_ids, Cs, T, n_out, C, w, d,
                                             stream);
    default:
      return launch_gather_embed<40, STAGED>(pl, src, ids, in_pos, kernel, e,
                                             N, n_ids, Cs, T, n_out, C, w, d,
                                             stream);
  }
}

}  // namespace

extern "C" int gather_embed(const float* src, const long long* ids,
                            const long long* in_pos, const float* kernel,
                            float* e, long long N, long long n_ids, int Cs,
                            int T, int n_out, int C, int w, int d,
                            void* stream) {
  if (N < 1 || n_ids < 1 || Cs < 1 || C < 1 || C > Cs || w < 1 || d < 1 ||
      n_out < 1 || n_out > T)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(d, C, w);
  return pl.staged
      ? gather_embed_dt<true>(pl, src, ids, in_pos, kernel, e, (long)N, n_ids,
                              Cs, T, n_out, C, w, d, (cudaStream_t)stream)
      : gather_embed_dt<false>(pl, src, ids, in_pos, kernel, e, (long)N,
                               n_ids, Cs, T, n_out, C, w, d,
                               (cudaStream_t)stream);
}

extern "C" int extract_windows(const float* src, const long long* ids,
                               float* out, long long N, long long n_ids, int C,
                               int T, int n_out, int W, void* stream) {
  if (N < 1 || n_ids < 1 || C < 1 || W < 1 || n_out < 1 ||
      n_out + W - 1 > T || (long long)32 * C * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                extract_windows_kernel,
                                                THREADS, 0);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long units = (N + 31) / 32 * ((32 * C * W + SEG - 1) / SEG);
  extract_windows_kernel<<<(unsigned)grid_size(units, per_sm), THREADS, 0,
                           (cudaStream_t)stream>>>(src, ids, out, (long)N,
                                                   n_ids, C, T, n_out, W);
  return (int)cudaGetLastError();
}
