// Context-factored pass-1 block minima on the tensor cores, one launch for up
// to 128 contexts.
//
// Replaces the TPU kernel
// shadowing_tpu/ops/pallas_factored.py::score_blockmin_factored (kernel
// _make_kernel). The combined context filter is linear in the embedding, so
// the cross term of context b at window start t of row r is
// x_emb[b] . E[r, :, t], with E[r, k, t] = (y * kernel_k)[r, t] built once per
// engine. For each context b, row r and 128-start block j it writes
//
//     out[b, r, j] = min_{l < 128} ( norms[r, t] - 2 * sum_k x[b, k] E[r, k, t] ),
//     t = 128 j + l,
//
// with starts t >= n_out scoring +inf and +inf norms folding to +inf. The
// output has the r-major layout of blockmin_toeplitz, so pass 2 sees one
// block-id order for both kernels.
//
// What bounds it on an H100: at 32768 rows, d = 20, 4096 padded starts and
// 64 contexts it must read E (10.74 GB) and the norms (0.53 GB) once: 3.4 ms
// at 3.35 TB/s. Its 1.7e11 FMA take 5.1 ms on the CUDA cores (67 TFLOP/s)
// but 2.1 ms as 3xTF32 on the tensor cores (3 products at 495 TFLOP/s), so
// only the tensor cores let it reach the memory bound.
//
// Design: the contraction cross = E_tile^T . X runs on the tensor cores as
// wgmma m64nNk8 in TF32 with the 3xTF32 split: each fp32 value v becomes
// hi = rna_tf32(v) and lo = trunc_tf32(v - hi), and lo.hi + hi.lo + hi.hi is
// accumulated in fp32, which keeps the error near 2^-21 of each product, the
// class of the TPU kernel's bf16x3 (one TF32 pass would be ~1e-3 and overrun
// pass 2's guard floor). TF32 wgmma reads shared memory only K-major, and E
// has the window start innermost, so the E tile is the register operand A
// (M = 64 window starts, K = 8 embedding dims), split in registers as it is
// read from shared memory: E is never stored twice. The contexts are B
// (N = 64 per pass), split once per block into K-major core matrices (hi and
// lo copies) in shared memory. d is padded to a multiple of 8 with zeros.
//
// One block of 4 warps (one warpgroup) walks tiles (row r, 128-start block
// j) persistently; a ring of STAGES tiles of E (d x 128 fp32, rows padded to
// 136 floats so the fragment reads are free of bank conflicts) and their
// norms is filled by cp.async, so the loads of the next tiles overlap the
// MMAs of this one and E is read from device memory once whatever B is. The
// warpgroup covers the 128 starts as two m64 tiles (warp w owns rows
// 16 w .. 16 w + 15 of each) against 64 contexts per pass; larger B take more
// passes over the same staged tile, a ragged last pass 8, 16 or 32 contexts
// wide. Each (m64 tile, K-step) is one commit group of 3 wgmma whose A
// fragment is split into one of two register buffers while the previous
// group runs, so 16 A registers are live (98 in all, 4 blocks on an SM at 64
// contexts) and the fold of m-tile 0 overlaps the last MMAs of m-tile 1. Up
// to 64 contexts an instance with one straight-line pass of that width runs;
// 65 to 128 take the general loop of passes.
// ptxas serializes these wgmma (C7511/C7512); three K-steps per group avoid
// that but hold more registers (3 blocks on an SM) and ran no faster.
// Epilogue: s = norm - 2 acc, the minimum over a thread's fragment rows, then
// over the 8 lanes sharing a context column by a transposing butterfly (14
// shuffles for 16 values), then over the 4 warps through shared memory, read
// after the next tile's barrier: one barrier per tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 128;        // window starts per tile (one output block)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;     // E tiles in the ring of a block
constexpr int K8MAX = 6;      // 8-deep K-steps of the widest embedding (48)
constexpr int EST = L + 8;    // smem row stride of an E tile: conflict-free A reads
constexpr unsigned FULL = 0xffffffffu;

// ---- the launch plan (mirrored by ops/factored.py::factored_plan) --------

struct Plan {
  int k8, rows;               // 8-deep MMA steps, staged E rows (d padded)
  int full, tail_nt, bp;      // 64-context passes, n-tiles of the last, padded B
  int smem_floats;
};

__host__ __device__ inline Plan make_plan(int d, int B) {
  Plan p;
  p.k8 = (d + 7) / 8;
  p.rows = 8 * p.k8;
  const int nt = (B + 7) / 8;
  p.full = nt / 8;
  const int tail = nt % 8;
  p.tail_nt = tail == 0 ? 0 : tail == 1 ? 1 : tail == 2 ? 2 : tail <= 4 ? 4 : 8;
  p.bp = 8 * (8 * p.full + p.tail_nt);
  p.smem_floats = 2 * p.bp * p.rows           // contexts, hi and lo
                  + STAGES * p.rows * EST     // the E ring
                  + STAGES * L                // the norms ring
                  + 2 * WARPS * p.bp;         // per-warp minima, two tiles
  return p;
}

// ---- PTX helpers ---------------------------------------------------------

// v = hi + lo in TF32 with integer ops, which issue faster than
// cvt.rna.tf32.f32: hi rounds v to the nearest TF32 value, ties away from zero
// (add half an ulp to the magnitude bits, drop the low 13); lo is v - hi
// (exact in fp32) with its low 13 bits dropped, an error below 2^-21 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// shared-memory matrix descriptor: K-major, no swizzle; core matrices of
// 8 rows x 16 bytes, 128 bytes apart along K, sbo bytes apart along N
__device__ __forceinline__ uint64_t smem_desc(const float* p, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int M>
__device__ __forceinline__ void pin(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x N] += a[64 x 8] (registers, TF32) . b[8 x N] (shared memory, TF32)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4],
                                          const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

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

// One level of the transposing min-butterfly over lanes `OFF` apart: VC
// values become VC / 2, the lane with bit OFF set keeping the upper half
// (base tracks which value slot 0 stands for). With one value left it is a
// plain shuffle-min.
template <int VC, int OFF>
__device__ __forceinline__ void fold_level(float* v, int lane, int& base) {
  if constexpr (VC > 1) {
    constexpr int H = VC / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = fminf(keep, __shfl_xor_sync(FULL, send, OFF));
    }
    if (upper) base += H;
  } else {
    v[0] = fminf(v[0], __shfl_xor_sync(FULL, v[0], OFF));
  }
}

// ---- one pass: 8 NT contexts against the tile's 128 starts --------------

template <int NT>
__device__ __forceinline__ void pass(const float* __restrict__ sEs,
                                     const float* __restrict__ sNs,
                                     const float* xh, const float* xl,
                                     float* __restrict__ red, const Plan& p,
                                     int nt0, int t_base, int n_out) {
  constexpr int N = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;        // the warp's rows in each m64 tile
  const int kc = 2 * p.k8;         // 16-byte K chunks of a context
  float acc[2][N / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;

  // One commit group per (m64 tile, K-step): split the step's A fragment
  // into one of two register buffers, issue its 3 wgmma, and go on to split
  // the next step while they run. A buffer is rewritten only after the group
  // that read it is done, which keeps 16 A registers live, not 8 per step.
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < K8MAX; ++ks) {
      if (ks >= p.k8) break;
      const int buf = ks & 1;
      if (mt == 1 && ks == 0) {
        // the last group of m-tile 0 used buffer (k8 - 1) & 1
        if (((p.k8 - 1) & 1) == 0) wg_wait<0>(); else wg_wait<1>();
      } else if (mt == 1 || ks >= 2) {
        wg_wait<1>();
      }
      const float* e = sEs + (ks * 8 + tig) * EST + mt * 64 + m0 + g;
      split(e[0], ahi[buf][0], alo[buf][0]);             // (row g,   k tig)
      split(e[8], ahi[buf][1], alo[buf][1]);             // (row g+8, k tig)
      split(e[4 * EST], ahi[buf][2], alo[buf][2]);       // (row g,   k tig+4)
      split(e[4 * EST + 8], ahi[buf][3], alo[buf][3]);   // (row g+8, k tig+4)
      pin(acc[mt]);
      wg_fence();
      const int off = (nt0 * kc + 2 * ks) * 32;
      const uint64_t dh = smem_desc(xh + off, kc * 128);
      const uint64_t dl = smem_desc(xl + off, kc * 128);
      wgmma<N>(acc[mt], alo[buf], dh);
      wgmma<N>(acc[mt], ahi[buf], dl);
      wgmma<N>(acc[mt], ahi[buf], dh);
      wg_commit();
    }
  }

  // scores of the thread's 4 starts, minimum per context column; m-tile 0
  // is folded while m-tile 1 is still in the tensor cores
  float nrm[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = mt * 64 + m0 + g + 8 * h;
      nrm[mt][h] = t_base + s < n_out ? sNs[s] : INFINITY;
    }
  constexpr int V = 2 * NT;
  float v[V];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt == 0) {
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    pin(acc[mt]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // norm - 2 acc in one rounding, as the plain version; a +inf norm
        // (barred row, start past n_out) stays +inf since acc is finite
        float m = mt == 0 ? INFINITY : v[2 * n + c];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          m = fminf(m, fmaf(-2.f, acc[mt][4 * n + 2 * h + c], nrm[mt][h]));
        v[2 * n + c] = m;
      }
  }
  // the 8 lanes of one column are lane bits 2..4
  int base = 0;
  constexpr int V1 = V > 1 ? V / 2 : 1;
  constexpr int V2 = V1 > 1 ? V1 / 2 : 1;
  constexpr int VF = V2 > 1 ? V2 / 2 : 1;
  fold_level<V, 16>(v, lane, base);
  fold_level<V1, 8>(v, lane, base);
  fold_level<V2, 4>(v, lane, base);
#pragma unroll
  for (int i = 0; i < VF; ++i) {
    const int idx = base + i;              // value index 2 n + c
    red[warp * p.bp + (nt0 + (idx >> 1)) * 8 + 2 * tig + (idx & 1)] = v[i];
  }
}

// NT > 0: one pass of 8 NT contexts per tile (B <= 64), straight-line code;
// NT = 0: any B <= 128, 64-context passes and a ragged last pass.
template <int NT>
__global__ void __launch_bounds__(THREADS, 4) blockmin_factored_kernel(
    const float* __restrict__ E,      // (R, d, Tp)
    const float* __restrict__ norms,  // (R, n_out)
    const float* __restrict__ x,      // (B, d)
    float* __restrict__ out,          // (B, R, nblk)
    int R, int d, int Tp, int n_out, int nblk, int B) {
  extern __shared__ float4 smem4[];
  const Plan p = make_plan(d, B);
  float* xh = reinterpret_cast<float*>(smem4);  // bp x rows, core-matrix order
  float* xl = xh + p.bp * p.rows;
  float* sE = xl + p.bp * p.rows;
  float* sN = sE + STAGES * p.rows * EST;
  float* red = sN + STAGES * L;                 // two buffers of WARPS x bp

  const int tid = threadIdx.x;
  // tile q = r * nblk + j; R * nblk + STAGES * grid < 2^32 (wrapper)
  const unsigned total = (unsigned)R * nblk;

  auto issue = [&](unsigned q, int stage) {
    if (q < total) {
      const int r = (int)(q / nblk), j = (int)(q % nblk);
      const float* src = E + (size_t)r * d * Tp + (size_t)j * L;
      float* dst = sE + stage * p.rows * EST;
      for (int i = tid; i < d * 32; i += THREADS) {
        const int k = i >> 5, c = (i & 31) * 4;
        cp_async16(dst + k * EST + c, src + (size_t)k * Tp + c);
      }
      const int t = j * L + tid;
      if (t < n_out)
        cp_async4(sN + stage * L + tid, norms + (size_t)r * n_out + t);
    }
    cp_commit();
  };
  // the block minima of tile q from the 4 warps' partial minima
  auto flush = [&](const float* rd, unsigned q) {
    const int r = (int)(q / nblk), j = (int)(q % nblk);
    for (int b = tid; b < B; b += THREADS) {
      float m = rd[b];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fminf(m, rd[w * p.bp + b]);
      out[((size_t)b * R + r) * nblk + j] = m;
    }
  };

  // the first tiles start loading before the contexts are split
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);

  // contexts split once into K-major core matrices (8 contexts x 4 dims,
  // 128 bytes): context c, dim k at ((c / 8) * kc + k / 4) * 32 + (c % 8) * 4
  // + k % 4; zero past B and d
  const int kc = 2 * p.k8;
  for (int i = tid; i < p.bp * p.rows; i += THREADS) {
    const int c = i / p.rows, k = i % p.rows;
    const float v = (c < B && k < d) ? x[c * d + k] : 0.f;
    uint32_t h, l;
    split(v, h, l);
    const int at = ((c >> 3) * kc + (k >> 2)) * 32 + (c & 7) * 4 + (k & 3);
    xh[at] = __uint_as_float(h);
    xl[at] = __uint_as_float(l);
  }
  // the MMAs read the contexts through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // E rows d .. rows-1 of every stage stay zero (no copy writes them)
  for (int i = tid; i < STAGES * (p.rows - d) * L; i += THREADS) {
    const int s = i / ((p.rows - d) * L), k = d + (i / L) % (p.rows - d);
    sE[(s * p.rows + k) * EST + i % L] = 0.f;
  }

  // One barrier per tile: after it, tile q has landed, the previous tile's
  // partial minima are complete (and flushed here), and every warp is done
  // with the stage the next copy refills.
  int it = 0;
  unsigned prev = 0;
  for (unsigned q = blockIdx.x; q < total; q += gridDim.x, ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it > 0) flush(red + ((it - 1) & 1) * WARPS * p.bp, prev);
    issue(q + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);

    const int stage = it % STAGES;
    const float* sEs = sE + stage * p.rows * EST;
    const float* sNs = sN + stage * L;
    float* rd = red + (it & 1) * WARPS * p.bp;
    const int t_base = (int)(q % nblk) * L;
    if constexpr (NT > 0) {
      pass<NT>(sEs, sNs, xh, xl, rd, p, 0, t_base, n_out);
    } else {
      for (int f = 0; f < p.full; ++f)
        pass<8>(sEs, sNs, xh, xl, rd, p, 8 * f, t_base, n_out);
      const int nt0 = 8 * p.full;
      switch (p.tail_nt) {
        case 1: pass<1>(sEs, sNs, xh, xl, rd, p, nt0, t_base, n_out); break;
        case 2: pass<2>(sEs, sNs, xh, xl, rd, p, nt0, t_base, n_out); break;
        case 4: pass<4>(sEs, sNs, xh, xl, rd, p, nt0, t_base, n_out); break;
        case 8: pass<8>(sEs, sNs, xh, xl, rd, p, nt0, t_base, n_out); break;
        default: break;
      }
    }
    prev = q;
  }
  __syncthreads();
  if (it > 0) flush(red + ((it - 1) & 1) * WARPS * p.bp, prev);
  cp_wait<0>();
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, int, int, int);

// the instance for this plan: one pass of 8, 16, 32 or 64 contexts, or the
// general loop
KernelFn pick(const Plan& p) {
  const int nt = p.full == 0 ? p.tail_nt : p.full == 1 && p.tail_nt == 0 ? 8 : 0;
  switch (nt) {
    case 1: return blockmin_factored_kernel<1>;
    case 2: return blockmin_factored_kernel<2>;
    case 4: return blockmin_factored_kernel<4>;
    case 8: return blockmin_factored_kernel<8>;
    default: return blockmin_factored_kernel<0>;
  }
}

// blocks of the instance that fit on one SM at its shared memory, 0 if the
// shared memory cannot be granted
int blocks_per_sm(KernelFn fn, int smem_bytes) {
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, smem_bytes);
  return n;
}

}  // namespace

// Blocks of the persistent kernel for B contexts of d dims that fit on one SM.
extern "C" int blockmin_factored_blocks_per_sm(int d, int B) {
  const Plan p = make_plan(d, B);
  return blocks_per_sm(pick(p), 4 * p.smem_floats);
}

// B <= 128 contexts and d <= 48 per launch (the wrapper chunks contexts);
// smem_bytes is the wrapper's plan, checked against the kernel's own.
extern "C" int blockmin_factored(const float* E, const float* norms,
                                 const float* x, float* out, int R, int d,
                                 int Tp, int n_out, int nblk, int B,
                                 int smem_bytes, void* stream) {
  if (B < 1 || B > 128 || d < 1 || d > 48 || Tp != nblk * L ||
      ((uintptr_t)E & 15) != 0)   // the 16-byte copies of E
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(d, B);
  if (smem_bytes != 4 * p.smem_floats) return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick(p);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = (long)R * nblk;
  long grid = (long)sms * blocks_per_sm(fn, smem_bytes);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  if (grid > tiles) grid = tiles;
  if (tiles + STAGES * grid >= (1L << 32))   // 32-bit tile indices
    return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      E, norms, x, out, R, d, Tp, n_out, nblk, B);
  return (int)cudaGetLastError();
}
