// Pass 2's exact rescore of the selected blocks, one launch for all contexts.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, a one-axis
// gather of the blocks' segments and an einsum against a Toeplitz matrix
// (shadowing_tpu/ops/pallas_search.py:341-380). It is here because the same
// step as a chain of PyTorch operations (a gathered copy of the segments, one
// strided addcmul_ per tap, the index arithmetic, the norms' gather, a second
// pass for the minima) wrote a (B, cap, 128) tensor per operation and issued
// one launch per tap. For context b and selected block i, with
// (r, j) = (r[b, i], j[b, i]), it writes
//
//     s[b, i, l] = nsel - 2 * sum_c sum_{s < w} y[r, c, 128 j + l + s] * g[b, c, s]
//     exact_bmin[b, i] = min_{l < 128} s[b, i, l]
//
// where nsel = norms[r, 128 j + l] if 128 j + l < n_out and that norm is
// finite, and 1e30 (a finite loser, so no NaN follows) otherwise. Reads past
// T - 1 are clamped there; they only feed padded starts. Every window is
// summed from 0 in one order, channel by channel and tap by tap, one fmaf
// each, whichever lane, register or block computes it: equal windows score
// bit-equal and ties stay ties (ops/search.py::_candidate_cross is the plain
// version of that order). The minimum is exact, so it equals s.amin(2).
//
// What bounds it on an H100: bytes. At B = 64 contexts of cap = 16,768 blocks
// (k = 16,384) and w = 20 it must read each block's segment once ((128 + w - 1)
// x 4 B, 631 MB) and its norms once (549 MB) and write the scores once (549
// MB): 1.73 GB, 0.52 ms at 3.35 TB/s, against 2.75e9 FMA (0.08 ms at 67
// TFLOP/s), about 3 FLOP per byte, far below the fp32 ridge.
//
// Design: one pass with no intermediate in device memory. A block of 4 warps
// holds one context's taps in shared memory (staged once, zero-padded to a
// multiple of 4 per channel; where C channels of them do not fit, as past
// 129 channels at w = 385, the lanes read them from g through L1 instead,
// which costs 6-16 % more device time at the cells' shapes). Each warp walks
// its own run of consecutive candidates of that context, one (candidate,
// channel) item per slot of a 3-slot cp.async ring: the channel's segment
// (16-byte copies wherever the segment's start is 16-byte aligned, which
// 128 j always is when T is a multiple of 4; 4-byte copies otherwise and at
// the clamped end), and with the last channel the candidate's 128 norms.
// The next two segments load while one is scored, and a warp needs no
// barrier but its own. Each lane owns 4 consecutive starts and slides an
// 8-sample register window along the taps: per 4 taps one 16-byte sample
// read and one broadcast 16-byte tap read feed 16 FMAs. The sums run on in
// registers from one channel to the next; the scores leave as one 16-byte
// store per lane and the block minimum by 5 shuffles. The plan and the run
// per warp follow C, w, B * cap and the blocks an SM holds, so the grid is
// one wave of equal runs (rescore_candidates, below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 128;           // window starts per block
constexpr int P = 4;             // consecutive starts per lane
constexpr int WARPS = 4;         // warps (runs of candidates) per block
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;        // ring slots per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr float BARRED = 1e30f;  // padded starts and barred rows
constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory of one block

// ---- the launch plan -----------------------------------------------------

struct Plan {
  int wp;       // taps per channel, zero-padded to P
  int sp;       // samples per slot: the lanes' register windows read L + w + 2
  int slot;     // floats per slot: sp samples, then L norms
  bool staged;  // the context's C * wp taps fit shared memory beside the rings
  int smem;     // bytes of one block's shared memory
};

__host__ __device__ inline Plan make_plan(int C, int w) {
  Plan p;
  p.wp = (w + P - 1) / P * P;
  p.sp = (L + w + 3 + P - 1) / P * P;
  p.slot = p.sp + L;
  const int rings = WARPS * STAGES * p.slot;
  p.staged = C * p.wp + rings <= SMEM_LIMIT / 4;
  p.smem = 4 * ((p.staged ? C * p.wp : 0) + rings);
  return p;
}

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// torch's amin: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// taps s .. s + 3 of one channel: STAGED, from its zero-padded copy in shared
// memory; otherwise from g itself, the taps past w read as 0
template <bool STAGED>
__device__ __forceinline__ void load_taps(const float* gc, int s, int w,
                                          float* g) {
  if constexpr (STAGED) {
    load4(gc + s, g);
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) g[q] = s + q < w ? __ldg(gc + s + q) : 0.f;
  }
}

// acc[p] = fmaf(sample[t0 + p + s], g[s], acc[p]) for s = 0 .. w - 1 in
// order; win = lo ++ hi holds samples t0 + s .. t0 + s + 7.
template <bool STAGED>
__device__ __forceinline__ void channel_taps(float* acc, const float* sc,
                                             const float* gc, int w, int t0) {
  float lo[P], hi[P], g[P];
  load4(sc + t0, lo);
  int s = 0;
  for (; s + P <= w; s += P) {
    load4(sc + t0 + s + P, hi);
    load_taps<STAGED>(gc, s, w, g);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p)
        acc[p] = fmaf(p + q < P ? lo[p + q] : hi[p + q - P], g[q], acc[p]);
#pragma unroll
    for (int p = 0; p < P; ++p) lo[p] = hi[p];
  }
  if (s < w) {   // the last w % P taps (the padded ones are never used)
    load4(sc + t0 + s + P, hi);
    load_taps<STAGED>(gc, s, w, g);
#pragma unroll
    for (int q = 0; q < P - 1; ++q)
      if (s + q < w)
#pragma unroll
        for (int p = 0; p < P; ++p)
          acc[p] = fmaf(p + q < P ? lo[p + q] : hi[p + q - P], g[q], acc[p]);
  }
}

// STAGED: the taps go to shared memory; otherwise the lanes read them from g.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 8) rescore_candidates_kernel(
    const float* __restrict__ y,          // (R, C, T)
    const float* __restrict__ norms,      // (R, n_out)
    const float* __restrict__ g,          // (B, C, w)
    const long long* __restrict__ rsel,   // (B, cap) trajectory rows
    const long long* __restrict__ jsel,   // (B, cap) blocks in the row
    float* __restrict__ s,                // (B, cap, L)
    float* __restrict__ bmin,             // (B, cap)
    int C, int T, int n_out, int cap, int w, int per_warp,
    int blocks_per_ctx) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(C, w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* gs = reinterpret_cast<float*>(smem4);   // C * wp taps of context b
  float* ring = gs + (STAGED ? C * pl.wp : 0) + warp * STAGES * pl.slot;

  const int b = blockIdx.x / blocks_per_ctx;
  const float* taps = STAGED ? gs : g + (size_t)b * C * w;
  const int tap_stride = STAGED ? pl.wp : w;   // floats between channels
  const long first = ((long)(blockIdx.x % blocks_per_ctx) * WARPS + warp) *
                     per_warp;
  const int n_cand = (int)max(min((long)per_warp, cap - first), 0L);
  const int items = n_cand * C;   // item n: candidate n / C, channel n % C
  const size_t cand0 = (size_t)b * cap + first;
  const long long* rb = rsel + cand0;
  const long long* jb = jsel + cand0;
  const bool y16 = ((uintptr_t)y & 15) == 0;

  auto issue = [&](int n, long long r, long long j) {
    if (n < items) {
      const int c = n % C;
      float* dst = ring + n % STAGES * pl.slot;
      const size_t row = ((size_t)r * C + c) * T;
      const float* src = y + row;
      const int base = (int)j * L;   // the segment's first sample in its row
      if (y16 && ((row + base) & 3) == 0) {
        for (int x = P * lane; x < pl.sp; x += 32 * P) {
          const int pos = base + x;
          if (pos + P <= T) {
            cp_async16(dst + x, src + pos);
          } else {
#pragma unroll
            for (int e = 0; e < P; ++e)
              cp_async4(dst + x + e, src + min(pos + e, T - 1));
          }
        }
      } else {
        for (int x = lane; x < pl.sp; x += 32)
          cp_async4(dst + x, src + min(base + x, T - 1));
      }
      if (c == C - 1) {   // the norms come with the candidate's last channel
        const float* nr = norms + (size_t)r * n_out;
        for (int x = lane; x < L && base + x < n_out; x += 32)
          cp_async4(dst + pl.sp + x, nr + base + x);
      }
    }
    cp_commit();
  };

  // the first STAGES - 1 items load while the taps are staged
  long long r_next = 0, j_next = 0;
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n)
    if (n < items) issue(n, rb[n / C], jb[n / C]);
    else cp_commit();
  if (STAGES - 1 < items) {
    r_next = rb[(STAGES - 1) / C];
    j_next = jb[(STAGES - 1) / C];
  }
  if (STAGED)
    for (int x = tid; x < C * pl.wp; x += THREADS) {
      const int c = x / pl.wp, t = x % pl.wp;
      gs[x] = t < w ? g[((size_t)b * C + c) * w + t] : 0.f;
    }
  __syncthreads();   // the taps are staged; no block-wide barrier follows

  const int t0 = P * lane;
  float acc[P];
  for (int n = 0; n < items; ++n) {
    cp_wait<STAGES - 2>();
    __syncwarp();   // item n landed for every lane; every lane is done with n - 1
    issue(n + STAGES - 1, r_next, j_next);
    const int m = n + STAGES;   // its indices load while item n is scored
    if (m < items) {
      r_next = rb[m / C];
      j_next = jb[m / C];
    }
    const int i = n / C, c = n % C;
    const float* sc = ring + n % STAGES * pl.slot;
    if (c == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
    }
    channel_taps<STAGED>(acc, sc, taps + (size_t)c * tap_stride, w, t0);
    if (c < C - 1) continue;   // the candidate's sums are not complete yet

    const int base = (int)jb[i] * L + t0;
    float nv[P], sv[P];
    load4(sc + pl.sp + t0, nv);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float nsel = base + p < n_out && isfinite(nv[p]) ? nv[p] : BARRED;
      sv[p] = fmaf(-2.f, acc[p], nsel);   // = nsel - 2 acc, one rounding
    }
    *reinterpret_cast<float4*>(s + (cand0 + i) * L + t0) =
        make_float4(sv[0], sv[1], sv[2], sv[3]);
    float mn = min_nan(min_nan(sv[0], sv[1]), min_nan(sv[2], sv[3]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = min_nan(mn, __shfl_xor_sync(FULL, mn, off));
    if (lane == 0) bmin[cand0 + i] = mn;
  }
  cp_wait<0>();
}

template <bool STAGED>
int blocks_per_sm(int smem_bytes) {
  if (cudaFuncSetAttribute(rescore_candidates_kernel<STAGED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, rescore_candidates_kernel<STAGED>, THREADS, smem_bytes);
  return n;
}

}  // namespace

// Blocks of the kernel that fit on one SM for C channels and w taps.
extern "C" int rescore_candidates_blocks_per_sm(int C, int w) {
  const Plan pl = make_plan(C, w);
  return pl.staged ? blocks_per_sm<true>(pl.smem)
                   : blocks_per_sm<false>(pl.smem);
}

extern "C" int rescore_candidates(const float* y, const float* norms,
                                  const float* g, const long long* r,
                                  const long long* j, float* s, float* bmin,
                                  int C, int T, int n_out, int B, int cap,
                                  int w, void* stream) {
  if (B < 1 || cap < 1 || C < 1 || w < 1 || n_out < 1 || n_out > T - w + 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(C, w);
  const int per_sm = pl.staged ? blocks_per_sm<true>(pl.smem)
                               : blocks_per_sm<false>(pl.smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one wave: as many blocks per context as the card holds at once, each
  // warp an equal run of consecutive candidates
  const long resident = (long)sms * per_sm;
  long per_ctx = resident / B > 1 ? resident / B : 1;
  const long per_warp = (cap + per_ctx * WARPS - 1) / (per_ctx * WARPS);
  per_ctx = (cap + WARPS * per_warp - 1) / (WARPS * per_warp);
  const long grid = (long)B * per_ctx;
  if (grid >= (1L << 31)) return (int)cudaErrorInvalidValue;
  if (pl.staged)
    rescore_candidates_kernel<true><<<(unsigned)grid, THREADS, pl.smem,
                                      (cudaStream_t)stream>>>(
        y, norms, g, r, j, s, bmin, C, T, n_out, cap, w, (int)per_warp,
        (int)per_ctx);
  else
    rescore_candidates_kernel<false><<<(unsigned)grid, THREADS, pl.smem,
                                       (cudaStream_t)stream>>>(
        y, norms, g, r, j, s, bmin, C, T, n_out, cap, w, (int)per_warp,
        (int)per_ctx);
  return (int)cudaGetLastError();
}
