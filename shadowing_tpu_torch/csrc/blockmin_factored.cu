// Context-factored pass-1 block minima, one launch for up to 128 contexts.
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
// with starts t >= n_out scoring +inf. The output has the r-major layout of
// blockmin_toeplitz, so pass 2 sees one block-id order for both kernels.
//
// What bounds it on an H100: at 32768 rows, d = 20 and 4096 padded starts,
// E is ~10.7 GB of fp32, read once per launch (~3.2 ms at 3.35 TB/s); at 64
// contexts the launch does ~1.7e11 FMA (~5 ms at the 67 TFLOP/s fp32 rate of
// the CUDA cores), so it is compute-bound on the CUDA cores.
//
// Design: E is fp32 with the window start innermost, so thread l of a block
// reads E[r, k, 128 j + l] coalesced and holds the d values of its window in
// registers. The block's contexts sit in shared memory, rows padded to DMAX
// floats so they are read as float4 broadcasts. Each thread scores its
// window against 32 contexts at a time into 32 registers; the 32 per-context
// warp minima then come out of one transposing butterfly (31 shuffles for 32
// contexts, instead of 5 shuffles per context), leaving lane i with context
// i's minimum. Four warps combine through shared memory. fp32 FMAs throughout:
// no TF32 or bf16, whose ~1e-3 error would overrun pass 2's 1e-5 guard floor.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 128;
constexpr int WARPS = L / 32;
constexpr unsigned FULL = 0xffffffffu;

template <int DMAX>
__global__ void __launch_bounds__(L) blockmin_factored_kernel(
    const float* __restrict__ E,      // (R, d, Tp)
    const float* __restrict__ norms,  // (R, n_out)
    const float* __restrict__ x,      // (B, d)
    float* __restrict__ out,          // (B, R, nblk)
    int R, int d, int Tp, int n_out, int nblk, int B) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // Bpad * DMAX contexts
  const int Bpad = (B + 31) & ~31;
  float* red = xs + Bpad * DMAX;                // WARPS * Bpad minima

  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int r = blockIdx.x / nblk;
  const int j = blockIdx.x % nblk;

  for (int i = l; i < Bpad * DMAX; i += L) {
    const int b = i / DMAX, k = i % DMAX;
    xs[i] = (b < B && k < d) ? x[b * d + k] : 0.f;
  }
  const int t = j * L + l;
  const bool valid = t < n_out;
  const float* Er = E + (size_t)r * d * Tp + (valid ? t : 0);
  float e[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    e[k] = (valid && k < d) ? Er[(size_t)k * Tp] : 0.f;
  const float nrm = valid ? norms[(size_t)r * n_out + t] : 0.f;
  __syncthreads();

  for (int b0 = 0; b0 < Bpad; b0 += 32) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float4* xb = reinterpret_cast<const float4*>(xs + (b0 + i) * DMAX);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < DMAX / 4; ++q) {
        const float4 xv = xb[q];
        acc = fmaf(xv.x, e[4 * q], acc);
        acc = fmaf(xv.y, e[4 * q + 1], acc);
        acc = fmaf(xv.z, e[4 * q + 2], acc);
        acc = fmaf(xv.w, e[4 * q + 3], acc);
      }
      v[i] = valid ? nrm - 2.f * acc : INFINITY;
    }
    // transposing butterfly: after the step with offset `off`, slot i of a
    // lane stands for context i + (lane's bits >= off); at the end slot 0 of
    // lane i holds the warp minimum of context b0 + i
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < off; ++i) {
        const float send = upper ? v[i] : v[i + off];
        const float keep = upper ? v[i + off] : v[i];
        v[i] = fminf(keep, __shfl_xor_sync(FULL, send, off));
      }
    }
    red[warp * Bpad + b0 + lane] = v[0];
  }
  __syncthreads();
  for (int b = l; b < B; b += L) {
    float m = red[b];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) m = fminf(m, red[q * Bpad + b]);
    out[((size_t)b * R + r) * nblk + j] = m;
  }
}

template <int DMAX>
int launch(const float* E, const float* norms, const float* x, float* out,
           int R, int d, int Tp, int n_out, int nblk, int B,
           cudaStream_t stream) {
  const int Bpad = (B + 31) & ~31;
  const size_t smem = sizeof(float) * (size_t)Bpad * (DMAX + WARPS);
  blockmin_factored_kernel<DMAX><<<(unsigned)R * nblk, L, smem, stream>>>(
      E, norms, x, out, R, d, Tp, n_out, nblk, B);
  return (int)cudaGetLastError();
}

}  // namespace

// B <= 128 contexts and d <= 48 per launch (the wrapper chunks contexts).
extern "C" int blockmin_factored(const float* E, const float* norms,
                                 const float* x, float* out, int R, int d,
                                 int Tp, int n_out, int nblk, int B,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 128) return (int)cudaErrorInvalidValue;
  if (d <= 8) return launch<8>(E, norms, x, out, R, d, Tp, n_out, nblk, B, s);
  if (d <= 16) return launch<16>(E, norms, x, out, R, d, Tp, n_out, nblk, B, s);
  if (d <= 24) return launch<24>(E, norms, x, out, R, d, Tp, n_out, nblk, B, s);
  if (d <= 32) return launch<32>(E, norms, x, out, R, d, Tp, n_out, nblk, B, s);
  if (d <= 48) return launch<48>(E, norms, x, out, R, d, Tp, n_out, nblk, B, s);
  return (int)cudaErrorInvalidValue;
}
