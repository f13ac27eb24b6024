// Pass-1 block minima of the expansion score, one launch for B contexts.
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
// samples it reads y (512 MiB) and the norms once and does ~2.7e9 FMA, so
// memory (~0.3 ms at 3.35 TB/s) and shared-memory reads (two per FMA) are the
// limits, not arithmetic.
//
// Design: the TPU kernel fed its matrix unit a banded Toeplitz operator; on
// Hopper the correlation is done directly in fp32 on the CUDA cores, which
// is more precise than the TPU's bf16x3 and keeps pass 2's self-calibrated
// guard valid. One thread block of 128 threads takes one row r and a run of
// consecutive j-blocks; thread l owns window start 128 j + l. Per block the
// y segment of 128 + w - 1 samples per channel is staged in shared memory
// (coalesced reads, conflict-free per-thread reads at l + s), and every
// context's filter is staged once per thread block and read as a broadcast.
// Each thread scores its window against ALL contexts of the launch, so y and
// the norms are read once per launch whatever B is. The minimum over the 128
// starts is a warp shuffle reduction, then a 4-way reduction through shared
// memory. Any C and any w are taken; the caller bounds the shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 128;       // window starts per block (= threads per block)
constexpr int WARPS = L / 32;

__global__ void __launch_bounds__(L) blockmin_toeplitz_kernel(
    const float* __restrict__ y,      // (R, C, T)
    const float* __restrict__ norms,  // (R, n_out)
    const float* __restrict__ g,      // (B, C, w)
    float* __restrict__ out,          // (B, R, nblk)
    int R, int C, int T, int n_out, int nblk, int B, int w, int jrun) {
  extern __shared__ float smem[];
  const int S = L + w - 1;
  float* seg = smem;               // C * S   staged samples of block j
  float* gs = seg + C * S;         // B * C * w filters
  float* red = gs + B * C * w;     // WARPS * B per-warp minima

  const int runs = (nblk + jrun - 1) / jrun;
  const int r = blockIdx.x / runs;
  const int j0 = (blockIdx.x % runs) * jrun;
  const int j1 = min(j0 + jrun, nblk);
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;

  for (int i = l; i < B * C * w; i += L) gs[i] = g[i];
  const float* yr = y + (size_t)r * C * T;
  const float* nr = norms + (size_t)r * n_out;

  for (int j = j0; j < j1; ++j) {
    const int base = j * L;
    __syncthreads();  // the previous block is done with seg and red
    for (int c = 0; c < C; ++c) {
      for (int i = l; i < S; i += L) {
        const int p = base + i;
        seg[c * S + i] = p < T ? yr[(size_t)c * T + p] : 0.f;
      }
    }
    __syncthreads();

    const int t = base + l;
    const bool valid = t < n_out;
    const float nrm = valid ? nr[t] : 0.f;
    for (int b = 0; b < B; ++b) {
      float s = INFINITY;
      if (valid) {
        const float* gb = gs + b * C * w;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) {
          const float* sc = seg + c * S + l;
          const float* gc = gb + c * w;
          for (int q = 0; q < w; ++q) acc = fmaf(sc[q], gc[q], acc);
        }
        s = nrm - 2.f * acc;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = fminf(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) red[warp * B + b] = s;
    }
    __syncthreads();
    for (int b = l; b < B; b += L) {
      float m = red[b];
#pragma unroll
      for (int q = 1; q < WARPS; ++q) m = fminf(m, red[q * B + b]);
      out[((size_t)b * R + r) * nblk + j] = m;
    }
  }
}

}  // namespace

extern "C" int blockmin_toeplitz(const float* y, const float* norms,
                                 const float* g, float* out, int R, int C,
                                 int T, int n_out, int nblk, int B, int w,
                                 int jrun, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blockmin_toeplitz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int runs = (nblk + jrun - 1) / jrun;
  blockmin_toeplitz_kernel<<<(unsigned)R * runs, L, smem_bytes,
                             (cudaStream_t)stream>>>(
      y, norms, g, out, R, C, T, n_out, nblk, B, w, jrun);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
