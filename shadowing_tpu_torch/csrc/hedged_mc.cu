// The Hedged Monte Carlo smile of one context and one maturity per block:
// the backward regression in float64, then the Black-Scholes inversion of
// its prices in float32, one launch for every context and maturity (the
// entry point at the end says when it takes more).
//
// Replaces no TPU kernel: the JAX package prices with XLA (a lax.scan over
// the steps, shadowing_tpu/pricing/hedged_mc.py). It is here because the
// same work as PyTorch operations (pricing/hedged_mc.py::_backward and
// pricing/black_scholes.py::bs_implied_vol, the plain versions) issues
// about 9,700 launches a context: ~45 a regression step and ~25 for each of
// the 80 bisection steps of each maturity, each a few microseconds of host
// for well under one of device time.
//
// For context b and maturity T = Ts[i], with paths S (N, T + 1), weights w,
// strikes K (nK), m hat functions on knots (T - 1, m) and ridge 1e-9:
//
//     C_T = d^T (S_T - K)^+;   for t = T-1 .. 1:
//       (a, h) = argmin sum_n w_n (C_{t+1} - [phi(S_t), phi(S_t) dS_t] (a, h))^2
//                + 1e-9 |(a, h)|^2,     C_t = phi(S_t) a
//     price = the constant of the same regression of C_1 on (1, dS_0)
//     vol = the bisection of pricing/black_scholes.py::bs_implied_vol
//
// with dS_t = d^(t+1) S_{t+1} - d^t S_t. Every step's normal equations are
// formed and solved in float64 (pricing/hedged_mc.py::_backward says why).
// Each path's row of [phi, phi dS] sqrt(w) has 4 non-zeros (two adjacent
// hats), so a thread adds 16 products to the 2m x 2m Gram matrix and 4 nK
// to the right-hand side, by float64 atomics in shared memory; the sums'
// order differs from the plain version's and between runs, by rounding.
// One warp solves the system by Gaussian elimination with partial pivoting
// (LAPACK's getrf pivots alike) and back substitution; then every thread
// evaluates C_t on its paths, kept in a (N, nK) float64 slice of device
// memory. The inversion mirrors the plain version operation by operation,
// each rounded once (no contraction into FMA), so it gives the same vols.
//
// What bounds it on an H100: latency. At N = 1,024 paths, T = 20 and
// nK = 9 a block does ~4 MFLOP over 20 dependent steps, each a reduction
// over the paths, a barrier and a 24 x 24 solve by one warp.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MATURITIES = 16;  // a launch's maturities, by value
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr double RIDGE = 1e-9;
constexpr float SIGMA_LO = 1e-4f;
constexpr float SIGMA_HI = 5.0f;
constexpr int BISECTIONS = 80;

// pricing/black_scholes.py::bs_call in float32, one rounding per operation
// (x / sqrt(2) as PyTorch divides by a scalar: times its float reciprocal)
__device__ float norm_cdf(float x) {
  const float inv_sqrt2 = 1.0f / 1.4142135623730951f;
  return __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(x, inv_sqrt2))));
}

__device__ float bs_call(float spot, float strike, float tau, float sigma,
                         float r) {
  const float sig_sqrt =
      __fmul_rn(fmaxf(sigma, 1e-12f), sqrtf(fmaxf(tau, 1e-12f)));
  const float drift =
      __fmul_rn(__fadd_rn(r, __fmul_rn(0.5f, __fmul_rn(sigma, sigma))), tau);
  const float d1 = __fdiv_rn(__fadd_rn(logf(__fdiv_rn(spot, strike)), drift),
                             sig_sqrt);
  const float d2 = __fsub_rn(d1, sig_sqrt);
  const float disc = expf(__fmul_rn(-r, tau));
  return __fsub_rn(__fmul_rn(spot, norm_cdf(d1)),
                   __fmul_rn(__fmul_rn(strike, disc), norm_cdf(d2)));
}

// pricing/black_scholes.py::bs_implied_vol: NaN outside the solvable bracket
__device__ float implied_vol(float price, float spot, float strike, float tau,
                             float r) {
  float lo = SIGMA_LO, hi = SIGMA_HI;
  for (int it = 0; it < BISECTIONS; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (bs_call(spot, strike, tau, mid, r) < price) lo = mid; else hi = mid;
  }
  const float tol = __fmul_rn(1e-6f, spot);
  const bool valid =
      price >= __fsub_rn(bs_call(spot, strike, tau, SIGMA_LO, r), tol) &&
      price <= __fadd_rn(bs_call(spot, strike, tau, SIGMA_HI, r), tol);
  return valid ? __fmul_rn(0.5f, __fadd_rn(lo, hi)) : __int_as_float(0x7fc00000);
}

// Hat functions on the knots kn (m, increasing) at s: the two non-zeros
// phi[idx] = 1 - frac, phi[idx + 1] = frac (pricing/hedged_mc.py::_hat_basis)
__device__ void hat(double s, const double* kn, int m, int& idx,
                    double& frac) {
  s = fmin(fmax(s, kn[0]), kn[m - 1]);
  int count = 0;                       // knots <= s (searchsorted, right)
  for (int j = 0; j < m; ++j) count += kn[j] <= s;
  idx = min(max(count - 1, 0), m - 2);
  frac = (s - kn[idx]) / fmax(kn[idx + 1] - kn[idx], 1e-12);
}

// Solve G x = R in place by one warp (lane q holds rows q, q + 32, ...):
// G is n x n (row stride ld), R is n x nk (row stride ldr); x overwrites R.
__device__ void warp_solve(double* G, int ld, double* R, int ldr, int n,
                           int nk) {
  const int lane = threadIdx.x & 31;
  for (int col = 0; col < n; ++col) {
    // pivot: the largest |G[row][col]| over rows >= col, the first of equals
    double v = -1.0;
    int row = lane;
    for (int q = lane; q < n; q += 32) {
      const double a = q >= col ? fabs(G[q * ld + col]) : -1.0;
      if (q == lane || a > v) { v = a; row = q; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int r2 = __shfl_down_sync(0xffffffffu, row, off);
      if (v2 > v || (v2 == v && r2 < row)) { v = v2; row = r2; }
    }
    const int piv = __shfl_sync(0xffffffffu, row, 0);
    if (piv != col) {
      for (int j = lane; j < n; j += 32) {
        const double t = G[col * ld + j];
        G[col * ld + j] = G[piv * ld + j];
        G[piv * ld + j] = t;
      }
      for (int j = lane; j < nk; j += 32) {
        const double t = R[col * ldr + j];
        R[col * ldr + j] = R[piv * ldr + j];
        R[piv * ldr + j] = t;
      }
    }
    __syncwarp();
    for (int q = lane; q < n; q += 32) {
      if (q <= col) continue;
      const double f = G[q * ld + col] / G[col * ld + col];
      for (int j = col + 1; j < n; ++j) G[q * ld + j] -= f * G[col * ld + j];
      for (int j = 0; j < nk; ++j) R[q * ldr + j] -= f * R[col * ldr + j];
    }
    __syncwarp();
  }
  for (int col = n - 1; col >= 0; --col) {
    for (int j = lane; j < nk; j += 32) {
      double acc = R[col * ldr + j];
      for (int q = col + 1; q < n; ++q) acc -= G[col * ld + q] * R[q * ldr + j];
      R[col * ldr + j] = acc / G[col * ld + col];
    }
    __syncwarp();
  }
}

struct Maturities {
  int T[MAX_MATURITIES];
};

__global__ void __launch_bounds__(THREADS)
hedged_mc_smile_kernel(const double* __restrict__ paths,
                       const double* __restrict__ weights,
                       const double* __restrict__ strikes,
                       const double* __restrict__ knots,
                       Maturities Ts, double* __restrict__ cbuf,
                       double* __restrict__ prices, float* __restrict__ vols,
                       int N, int H1, int nT, int ldT, int nK, int ldK, int m,
                       int n_knot_steps, double discount, double r) {
  extern __shared__ double smem[];
  const int M2 = 2 * m;
  // the Gram matrix (M2 x M2) and right-hand side (M2 x nK) of a step,
  // then the step's knots (m)
  double* G = smem;
  double* kn = G + M2 * M2 + M2 * nK;
  const int b = blockIdx.x / nT, i = blockIdx.x % nT;
  const int T = Ts.T[i];
  const double* S = paths + (size_t)b * N * H1;
  const double* W = weights + (size_t)b * N;
  const double* K = strikes + ((size_t)b * ldT + i) * ldK;
  double* c = cbuf + ((size_t)b * ldT + i) * N * ldK;
  const int tid = threadIdx.x;

  const double dT = pow(discount, (double)T);
  for (int n = tid; n < N; n += THREADS) {
    const double sT = S[(size_t)n * H1 + T];
    for (int k = 0; k < nK; ++k) c[(size_t)n * ldK + k] = fmax(sT - K[k], 0.0) * dT;
  }

  for (int t = T - 1; t >= 0; --t) {
    const int dim = t > 0 ? M2 : 2;
    __syncthreads();
    for (int j = tid; j < dim * dim + dim * nK; j += THREADS) G[j] = 0.0;
    if (t > 0 && tid == 0) {
      const double* raw = knots + ((size_t)b * n_knot_steps + (t - 1)) * m;
      const double span = (raw[m - 1] - raw[0]) + 1.0;
      for (int j = 0; j < m; ++j) kn[j] = raw[j] + ((double)j * 1e-6) * span;
    }
    __syncthreads();
    double* Rt = G + dim * dim;
    const double d0 = pow(discount, (double)t);
    const double d1 = pow(discount, (double)(t + 1));
    for (int n = tid; n < N; n += THREADS) {
      const double sw = sqrt(W[n]);
      const double s_t = S[(size_t)n * H1 + t];
      const double ds = S[(size_t)n * H1 + t + 1] * d1 - s_t * d0;
      int col[4];
      double a[4];
      int na;
      if (t > 0) {
        int idx;
        double frac;
        hat(s_t, kn, m, idx, frac);
        const double p0 = 1.0 - frac, p1 = frac;
        col[0] = idx; col[1] = idx + 1; col[2] = m + idx; col[3] = m + idx + 1;
        a[0] = p0 * sw; a[1] = p1 * sw; a[2] = (p0 * ds) * sw;
        a[3] = (p1 * ds) * sw;
        na = 4;
      } else {
        col[0] = 0; col[1] = 1;
        a[0] = sw; a[1] = ds * sw;
        na = 2;
      }
      for (int p = 0; p < na; ++p) {
        for (int q = 0; q < na; ++q)
          atomicAdd(&G[col[p] * dim + col[q]], a[p] * a[q]);
        for (int k = 0; k < nK; ++k)
          atomicAdd(&Rt[col[p] * nK + k], a[p] * (c[(size_t)n * ldK + k] * sw));
      }
    }
    __syncthreads();
    if (tid < dim) G[tid * dim + tid] += RIDGE;
    __syncthreads();
    if (tid < 32) warp_solve(G, dim, Rt, nK, dim, nK);
    __syncthreads();
    if (t > 0) {
      for (int n = tid; n < N; n += THREADS) {
        int idx;
        double frac;
        hat(S[(size_t)n * H1 + t], kn, m, idx, frac);
        for (int k = 0; k < nK; ++k)
          c[(size_t)n * ldK + k] =
              (1.0 - frac) * Rt[idx * nK + k] + frac * Rt[(idx + 1) * nK + k];
      }
    }
  }
  // the t = 0 step's constant: Rt's first row, at G + 4
  const double* price = G + 4;
  double* out = prices + ((size_t)b * ldT + i) * ldK;
  float* vout = vols + ((size_t)b * ldT + i) * ldK;
  const float tau = (float)((double)T * (1.0 / 252.0));
  const float spot = (float)S[0];
  for (int k = tid; k < nK; k += THREADS) {
    out[k] = price[k];
    vout[k] = implied_vol((float)price[k], spot, (float)K[k], tau, (float)r);
  }
}

}  // namespace

// Every context, maturity and strike: a launch for each group of up to
// MAX_MATURITIES maturities and each group of strikes that one block's
// shared memory holds (one launch at the benchmark's shapes). Strikes are
// independent columns of the same regressions, so a group of them gives
// what all of them give, up to the order of the atomic sums.
extern "C" int hedged_mc_smile(const double* paths, const double* weights,
                               const double* strikes, const double* knots,
                               const int* Ts, double* cbuf, double* prices,
                               float* vols, int B, int N, int H1, int nT,
                               int nK, int m, int n_knot_steps,
                               double discount, double r, void* stream) {
  if (B < 1 || N < 1 || nT < 1 || nK < 1 || m < 2 || H1 < 2 ||
      (long)B * MAX_MATURITIES >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nT; ++i)   // Ts is host memory: no copy to the card
    if (Ts[i] < 1 || Ts[i] > H1 - 1 || (Ts[i] > 1 && Ts[i] - 1 > n_knot_steps))
      return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // doubles: the Gram matrix 4 m^2, the knots m, then 2 m per strike
  const long fixed = 4L * m * m + m;
  const long per_group = (long)optin / (long)sizeof(double) - fixed;
  if (per_group < 2L * m) return (int)cudaErrorInvalidValue;
  const int group = (int)std::min<long>(nK, per_group / (2L * m));
  const size_t smem = sizeof(double) * (fixed + 2L * m * group);
  if (smem > DEFAULT_SMEM &&
      cudaFuncSetAttribute(hedged_mc_smile_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int i0 = 0; i0 < nT; i0 += MAX_MATURITIES) {
    const int nt = std::min(MAX_MATURITIES, nT - i0);
    Maturities mats = {};
    for (int i = 0; i < nt; ++i) mats.T[i] = Ts[i0 + i];
    for (int k0 = 0; k0 < nK; k0 += group) {
      const int nk = std::min(group, nK - k0);
      const size_t at = (size_t)i0 * nK + k0;
      hedged_mc_smile_kernel<<<(unsigned)(B * nt), THREADS,
                               sizeof(double) * (fixed + 2L * m * nk),
                               (cudaStream_t)stream>>>(
          paths, weights, strikes + at, knots, mats,
          cbuf + (size_t)i0 * N * nK + k0, prices + at, vols + at, N, H1, nt,
          nT, nk, nK, m, n_knot_steps, discount, r);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}
