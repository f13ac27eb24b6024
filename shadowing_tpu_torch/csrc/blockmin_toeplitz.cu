// Pass-1 block minima of the expansion score, one launch for a chunk of
// contexts.
//
// Replaces the TPU kernel shadowing_tpu/ops/pallas_search.py::score_blockmin
// (kernel bodies _make_kernel -> kernel_highest / kernel_bf16x3). For context
// b, trajectory row r and 128-start block j it writes
//
//     out[b, r, j] = min_{l < 128} ( norms[r, t] - 2 * sum_c sum_{s < w}
//                                    y[r, c, t + s] * g[b, c, s] ),  t = 128 j + l
//
// with starts t >= n_out scoring +inf (a block with no valid start is +inf,
// and +inf norms fold through to +inf, never NaN).
//
// What bounds it on an H100: at one context and w = 20 over 32768 x 4096
// samples it must read y (0.54 GB) and the norms (0.53 GB) once, 0.32 ms at
// 3.35 TB/s, against 2.7e9 FMA (0.08 ms at 67 TFLOP/s): memory-bound. At four
// contexts and w = 126 (the Foveal-126 width) its 6.6e10 FMA take 1.98 ms on
// the CUDA cores, six times the bytes: compute-bound. The tensor cores are not
// used: a Toeplitz operator on them would do 2-6x redundant MACs, and at
// B < 8 the work is memory-bound anyway.
//
// Design: fp32 FMAs on the CUDA cores (the TPU fed its matrix unit a banded
// Toeplitz operator in bf16x3). A persistent block of 8 warps walks tiles
// (row r, 2048 consecutive starts = 16 output blocks); a ring of STAGES slots
// (the C channels' samples with their w - 1 halo, and the norms) is filled by
// cp.async, so the next tiles load while this one is scored and the halo is
// paid once per 16 blocks. Register tiling: each thread owns 8 consecutive
// starts and slides a 16-sample register window along the taps, so a sample
// is read from shared memory once per thread for 8 taps (64 FMA per two
// 16-byte sample reads and two broadcast tap reads), not once per tap, and
// contexts are scored in pairs that share each sample read. All of a chunk's
// filters sit in shared memory, zero-padded to a multiple of 8 taps, so y and
// the norms are read once per launch whatever B is. A warp covers 256 starts
// (two output blocks): the minimum is folded in registers over a thread's 8
// starts, then by 4 shuffles over each half-warp.
//
// Any C and any w are taken. Where a tile of all C channels does not fit the
// ring beside one context's filter, the channels are grouped: a slot holds cg
// channels of a tile and the taps of one context pair for them, sized for two
// blocks per SM, and the pair's sums run on in registers from one group to
// the next, in the same order. A launch then scores at most two contexts. The
// caller sizes the context chunks (ops/search.py::toeplitz_plan).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 128;          // window starts per output block
constexpr int P = 8;            // consecutive starts per thread
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NST = THREADS * P;  // starts per tile (16 output blocks)
constexpr int STAGES = 3;
constexpr unsigned FULL = 0xffffffffu;

// ---- the launch plan (mirrored by ops/search.py::toeplitz_plan) ---------

constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory of one block
constexpr int SMEM_HALF = 113 * 1024;   // of each of two blocks on one SM

struct Plan {
  int wp;     // taps padded to a multiple of P
  int S;      // samples staged per channel and tile
  int cg;     // channels per ring slot: C, or a group of them
  int slot;   // floats per slot: cg * S samples, NST norms, grouped: 2 cg wp taps
  int smem_floats;
};

__host__ __device__ inline Plan make_plan(int C, int w, int B) {
  Plan p;
  p.wp = (w + P - 1) / P * P;
  p.S = NST + p.wp;
  if (STAGES * (C * p.S + NST) + C * p.wp <= SMEM_LIMIT / 4) {
    p.cg = C;
    p.slot = C * p.S + NST;
    p.smem_floats = B * C * p.wp + STAGES * p.slot;
  } else {
    const int most =
        max((SMEM_HALF / 4 / STAGES - NST) / (p.S + 2 * p.wp), 1);
    const int groups = (C + most - 1) / most;
    p.cg = (C + groups - 1) / groups;
    p.slot = p.cg * (p.S + 2 * p.wp) + NST;
    p.smem_floats = STAGES * p.slot;
  }
  return p;
}

// ---- PTX helpers ---------------------------------------------------------

// 16 bytes, of which the first src_bytes are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[0..7] = samples x .. x + 7, x a multiple of 8 (two 16-byte reads; a
// quarter-warp's read spans two bank rows, a 2-way conflict that costs less
// than the address arithmetic of a swizzled layout in this FMA-bound loop)
__device__ __forceinline__ void load8(const float* sc, int x, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(sc + x);
  const float4 b = *reinterpret_cast<const float4*>(sc + x + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[p] += sum_q win[p + q] * g[q] over 8 taps, win = lo ++ hi
__device__ __forceinline__ void taps8(float* acc, const float* lo,
                                      const float* hi, const float* gq) {
  const float4 g0 = *reinterpret_cast<const float4*>(gq);
  const float4 g1 = *reinterpret_cast<const float4*>(gq + 4);
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc[p] = fmaf(p + q < P ? lo[p + q] : hi[p + q - P], g[q], acc[p]);
}

// acc[i] += the sums of context i over channels 0 .. nc - 1 at the thread's
// P starts, channel by channel: the NB sets of accumulators share every
// sample read. Channel c's samples are at segs + c S, its taps for context i
// at gb + i gstride + c wp.
template <int NB>
__device__ __forceinline__ void accumulate(float (*acc)[P], const float* segs,
                                           int nc, int S, const float* gb,
                                           int gstride, int wp, int t0) {
  for (int c = 0; c < nc; ++c) {
    const float* sc = segs + c * S;
    const float* gc = gb + c * wp;
    float v0[P], v1[P];
    load8(sc, t0, v0);
    int s = 0;
    for (; s + 2 * P <= wp; s += 2 * P) {   // ping-pong: no register moves
      load8(sc, t0 + s + P, v1);
#pragma unroll
      for (int i = 0; i < NB; ++i) taps8(acc[i], v0, v1, gc + i * gstride + s);
      load8(sc, t0 + s + 2 * P, v0);
#pragma unroll
      for (int i = 0; i < NB; ++i) taps8(acc[i], v1, v0, gc + i * gstride + s + P);
    }
    if (s < wp) {
      load8(sc, t0 + s + P, v1);
#pragma unroll
      for (int i = 0; i < NB; ++i) taps8(acc[i], v0, v1, gc + i * gstride + s);
    }
  }
}

// Writes the block minima of contexts b .. b + NB - 1 from their sums.
template <int NB>
__device__ __forceinline__ void fold(float (*acc)[P], const float* nrm,
                                     float* __restrict__ out, int b, int lane,
                                     int j, int nblk, int R, int r) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    // norm - 2 acc in one rounding; +inf norms stay +inf
    float m = fmaf(-2.f, acc[i][0], nrm[0]);
#pragma unroll
    for (int p = 1; p < P; ++p) m = fminf(m, fmaf(-2.f, acc[i][p], nrm[p]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)   // within each half-warp
      m = fminf(m, __shfl_xor_sync(FULL, m, off));
    if ((lane & 15) == 0 && j < nblk)
      out[((size_t)(b + i) * R + r) * nblk + j] = m;
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (*acc)[P]) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[i][p] = 0.f;
}

// GROUPED: the ring holds channel groups (Plan::cg < C) and B <= 2.
template <bool GROUPED>
__global__ void __launch_bounds__(THREADS) blockmin_toeplitz_kernel(
    const float* __restrict__ y,      // (R, C, T)
    const float* __restrict__ norms,  // (R, n_out)
    const float* __restrict__ g,      // (B, C, w)
    float* __restrict__ out,          // (B, R, nblk)
    int R, int C, int T, int n_out, int nblk, int B, int w) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(C, w, B);
  const int wp = pl.wp, S = pl.S, cg = pl.cg;
  const int ng = GROUPED ? (C + cg - 1) / cg : 1;   // ring slots per tile
  float* gs = reinterpret_cast<float*>(smem4);   // B * C * wp filters
  float* ring = gs + (GROUPED ? 0 : B * C * wp); // STAGES slots: samples,
                                                 // norms, grouped: taps

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per_row = (nblk * L + NST - 1) / NST;
  // tile q = r * per_row + i; R * per_row + STAGES * grid < 2^32 (wrapper).
  // A block's n-th slot holds channel group n % ng of its (n / ng)-th tile.
  const unsigned total = (unsigned)R * per_row;
  auto tile = [&](unsigned n) { return blockIdx.x + n / ng * gridDim.x; };
  // 16-byte copies where every channel row starts 16-byte aligned
  const bool vec = (T & 3) == 0 && ((uintptr_t)y & 15) == 0;

  auto issue = [&](unsigned n, int stage) {
    const unsigned q = tile(n);
    if (q < total) {
      const int r = (int)(q / per_row), base = (int)(q % per_row) * NST;
      const int k = n % ng, c0 = k * cg, nc = min(cg, C - c0);
      float* dst = ring + stage * pl.slot;
      const float* yr = y + ((size_t)r * C + c0) * T;
      if (vec) {
        for (int i = tid; i < nc * (S / 4); i += THREADS) {
          const int c = i / (S / 4), x = 4 * (i % (S / 4)), pos = base + x;
          const int n4 = min(max(T - pos, 0), 4);
          cp_async16(dst + c * S + x, yr + (size_t)c * T + (n4 > 0 ? pos : 0),
                     4 * n4);
        }
      } else {
        for (int i = tid; i < nc * S; i += THREADS) {
          const int c = i / S, x = i % S, pos = base + x;
          cp_async4(dst + c * S + x, yr + (size_t)c * T + (pos < T ? pos : 0),
                    pos < T ? 4 : 0);
        }
      }
      if (k == ng - 1) {   // the norms come with the tile's last group
        const float* nr = norms + (size_t)r * n_out;
        for (int i = tid; i < NST && base + i < n_out; i += THREADS)
          cp_async4(dst + cg * S + i, nr + base + i, 4);
      }
      if (GROUPED) {       // the pair's taps of this group, zero-padded
        float* gd = dst + cg * S + NST;
        for (int i = tid; i < B * nc * wp; i += THREADS) {
          const int b = i / (nc * wp), c = i / wp % nc, s = i % wp;
          cp_async4(gd + (b * cg + c) * wp + s,
                    g + ((size_t)b * C + c0 + c) * w + (s < w ? s : 0),
                    s < w ? 4 : 0);
        }
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s, s);
  if (!GROUPED)
    for (int i = tid; i < B * C * wp; i += THREADS) {
      const int s = i % wp, bc = i / wp;
      gs[i] = s < w ? g[(size_t)bc * w + s] : 0.f;
    }

  const int t0 = warp * (32 * P) + lane * P;   // the thread's first start in a tile
  float acc[2][P];   // grouped: the pair's sums, carried from group to group
  for (unsigned n = 0; tile(n) < total; ++n) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // slot n landed; every warp is done with slot n - 1
    issue(n + STAGES - 1, (n + STAGES - 1) % STAGES);

    const unsigned q = tile(n);
    const int k = n % ng;
    const int r = (int)(q / per_row), base = (int)(q % per_row) * NST;
    if (base + warp * (32 * P) >= n_out) continue;   // no valid start in the warp
    const float* segs = ring + n % STAGES * pl.slot;
    const float* sN = segs + cg * S;
    if (GROUPED) {
      const int nc = min(cg, C - k * cg);
      if (k == 0) zero<2>(acc);
      if (B == 2) accumulate<2>(acc, segs, nc, S, sN + NST, cg * wp, wp, t0);
      else        accumulate<1>(acc, segs, nc, S, sN + NST, cg * wp, wp, t0);
      if (k < ng - 1) continue;   // the tile's sums are not complete yet
    }
    float nrm[P];
    {
      const float4 a = *reinterpret_cast<const float4*>(sN + t0);
      const float4 b = *reinterpret_cast<const float4*>(sN + t0 + 4);
      const float v[P] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < P; ++p)
        nrm[p] = base + t0 + p < n_out ? v[p] : INFINITY;
    }
    const int j = (base + warp * (32 * P)) / L + (lane >> 4);
    if (GROUPED) {
      if (B == 2) fold<2>(acc, nrm, out, 0, lane, j, nblk, R, r);
      else        fold<1>(acc, nrm, out, 0, lane, j, nblk, R, r);
      continue;
    }
    int b = 0;
    for (; b + 2 <= B; b += 2) {
      zero<2>(acc);
      accumulate<2>(acc, segs, C, S, gs + b * C * wp, C * wp, wp, t0);
      fold<2>(acc, nrm, out, b, lane, j, nblk, R, r);
    }
    if (b < B) {
      zero<1>(acc);
      accumulate<1>(acc, segs, C, S, gs + b * C * wp, C * wp, wp, t0);
      fold<1>(acc, nrm, out, b, lane, j, nblk, R, r);
    }
  }
  cp_wait<0>();
}

template <bool GROUPED>
int blocks_per_sm(int smem_bytes) {
  if (cudaFuncSetAttribute(blockmin_toeplitz_kernel<GROUPED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, blockmin_toeplitz_kernel<GROUPED>, THREADS, smem_bytes);
  return n;
}

template <bool GROUPED>
int launch(const float* y, const float* norms, const float* g, float* out,
           int R, int C, int T, int n_out, int nblk, int B, int w,
           int smem_bytes, cudaStream_t stream) {
  const int per_sm = blocks_per_sm<GROUPED>(smem_bytes);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = (long)R * ((nblk * L + NST - 1) / NST);
  long grid = (long)sms * per_sm;
  if (grid > tiles) grid = tiles;
  if (tiles + STAGES * grid >= (1L << 32))   // 32-bit tile indices
    return (int)cudaErrorInvalidValue;
  blockmin_toeplitz_kernel<GROUPED><<<(unsigned)grid, THREADS, smem_bytes,
                                      stream>>>(y, norms, g, out, R, C, T,
                                                n_out, nblk, B, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the persistent kernel that fit on one SM for a launch of B
// contexts over C channels and w taps.
extern "C" int blockmin_toeplitz_blocks_per_sm(int C, int w, int B) {
  const Plan pl = make_plan(C, w, B);
  return pl.cg < C ? blocks_per_sm<true>(4 * pl.smem_floats)
                   : blocks_per_sm<false>(4 * pl.smem_floats);
}

// smem_bytes is the wrapper's plan for this chunk of B contexts, checked
// against the kernel's own.
extern "C" int blockmin_toeplitz(const float* y, const float* norms,
                                 const float* g, float* out, int R, int C,
                                 int T, int n_out, int nblk, int B, int w,
                                 int smem_bytes, void* stream) {
  const Plan pl = make_plan(C, w, B);
  if (B < 1 || C < 1 || w < 1 || n_out < 1 || n_out > T - w + 1 ||
      (pl.cg < C && B > 2) || smem_bytes != 4 * pl.smem_floats)
    return (int)cudaErrorInvalidValue;
  return pl.cg < C
      ? launch<true>(y, norms, g, out, R, C, T, n_out, nblk, B, w, smem_bytes,
                     (cudaStream_t)stream)
      : launch<false>(y, norms, g, out, R, C, T, n_out, nblk, B, w,
                      smem_bytes, (cudaStream_t)stream);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
