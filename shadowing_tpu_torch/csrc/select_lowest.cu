// Pass 2's two selections: the exact k smallest entries of each row, by a
// radix select over the floats' order-preserving keys.
//
// Replaces no TPU kernel: the JAX package selects with XLA (lax.top_k inside
// its block-min tournament, shadowing_tpu/ops/topk.py). It is here because
// the same tournament in PyTorch falls through, at pass 2's sizes, to full
// stable sorts of (value, int64 id) pairs and then sorts the selected ids
// again; a threshold select reads each row a few times and writes the ids in
// flat order directly. For x (B, n) float32 with no NaN and 1 <= k <= n it
// writes, for each row b,
//
//     ids[b, :]  the positions of the k smallest entries under the order
//                (value, position), in ascending position order;
//     thr[b]     the k-th smallest value.
//
// Each float maps to an order-preserving uint32 key, -0.0 to the key of +0.0
// (the port holds them equal, as torch.sort does), so +inf and the 1e30
// sentinel are ordinary keys, and the entries equal to the threshold fill the
// last places in position order: the stable sort's rule. ops/topk.py's
// _lowest_set is the plain version of this contract.
//
// What bounds it on an H100: bytes. Pass 2 reads 64 x 1,048,576 block minima
// (268 MB) and 64 x 2,146,304 rescored candidates (549 MB) at k = 16,384:
// 0.24 ms at 3.35 TB/s for one read of each, and a few integer operations
// per entry.
//
// Design: the grid covers (row, tile) pairs, a block of 8 warps per tile
// and a contiguous segment of the row per warp; the wrapper picks the tiles
// per row from (B, n) so that the grid is about one wave whether B = 1 or 64.
// The key's three digits (bits 31-21, 20-10, 9-0) are found one launch each,
// without a host round trip: each block counts its digits in a shared-memory
// histogram and adds it to its row's histogram in device memory, and the
// last block of the row to finish (an atomic ticket) finds the digit that
// holds the rank still needed and clears the histogram for the next digit.
//
//   1. every entry's first digit (a read of the row, 16-byte loads, the next
//      step's loads in flight while one is counted);
//   2. the candidates, every entry whose first digit is at most the
//      threshold's (fewer than k below its bucket, and the bucket), go with
//      their keys to their segment's list in position order by warp scans,
//      and the second digit of the bucket's entries is counted (a second
//      read of the row);
//   3. the third digit, from the candidates: the threshold and the number of
//      entries equal to it still needed are known;
//   4. each segment's candidates below and equal to the threshold;
//   5. each warp sums the counts of the segments before its own and writes
//      the candidates it selects in flat order: those below the threshold,
//      and those equal to it while their rank among the equal ones is below
//      the number still needed.
//
// So two reads of each row, then lists of a few per cent of it on normal
// scores (all of it where a row shares one first digit), five launches and
// a memset; no sort, no allocation, no synchronisation. The scratch holds
// two words per entry for the lists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 8;                 // consecutive entries per lane and step
constexpr int STEP = 32 * PER;         // entries a warp reads per step
constexpr int BINS = 2048;             // 11-bit digits
constexpr int STATE = 8;               // words of state per row
constexpr unsigned FULL = 0xffffffffu;

// a row's state words
enum { TICKET, PREFIX, KREM, NEED };

struct Args {
  const float* x;       // (B, n)
  long long* ids;       // (B, k)
  float* thr;           // (B,)
  unsigned* hist;       // (B, BINS) the current digit's counts
  unsigned* state;      // (B, STATE)
  unsigned* cand;       // (B, segs) candidates per segment
  unsigned* below;      // (B, segs) candidates below the threshold
  unsigned* equal;      // (B, segs) candidates equal to it
  int* list;            // (B, n) segment s's candidates, in order, from s * ss
  unsigned* keys;       // (B, n) their keys, beside them
  int n, k, tiles, ss;  // ss: entries per segment, a multiple of STEP
};

__host__ __device__ constexpr int shift_of(int d) {
  return d == 0 ? 21 : d == 1 ? 10 : 0;
}

__device__ __forceinline__ unsigned key_of(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0;   // -0.0 is +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// the entries at pos .. pos + PER - 1 of a row that lie before end; returns
// how many
__device__ __forceinline__ int load_run(const float* row, bool vec, int pos,
                                        int end, float* v) {
  const int m = min(max(end - pos, 0), PER);
  if (vec && m == PER) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + pos));
    const float4 c = __ldg(reinterpret_cast<const float4*>(row + pos + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) v[e] = e < m ? __ldg(row + pos + e) : 0.f;
  }
  return m;
}

// The warp's segment [lo, hi) of a row, a step at a time in order: calls
// f(pos, m, v), v holding the lane's m entries from pos on, while the next
// step's loads are in flight. Every lane of the warp takes the same steps.
template <class F>
__device__ __forceinline__ void for_each_step(const float* row, bool vec,
                                              int lo, int hi, F f) {
  float v[PER], nv[PER];
  int pos = lo + PER * (threadIdx.x & 31);
  int m = lo < hi ? load_run(row, vec, pos, hi, v) : 0;
  for (int c = lo; c < hi; c += STEP) {
    const int nm = c + STEP < hi ? load_run(row, vec, pos + STEP, hi, nv) : 0;
    f(pos, m, v);
#pragma unroll
    for (int e = 0; e < PER; ++e) v[e] = nv[e];
    m = nm;
    pos += STEP;
  }
}

// the exclusive prefix of v over the block's threads in order; *total gets
// the block's sum. Every thread must call it.
__device__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned s = warp_sums[w];
    if (w < warp) base += s;
    sum += s;
  }
  __syncthreads();   // warp_sums is free for the next call
  *total = sum;
  return base + incl - v;
}

// Adds the block's histogram h to its row's; the last block of the row picks
// digit D of the threshold (the bin holding the rank still needed), records
// it and the rank left inside that bin, and clears the row's histogram.
template <int D>
__device__ void finish_digit(const Args& a, int b, const unsigned* h) {
  constexpr int NB = D == 2 ? 1024 : BINS;
  constexpr int PT = NB / THREADS;   // bins per thread
  __shared__ bool last;
  unsigned* gh = a.hist + (size_t)b * BINS;
  unsigned* st = a.state + (size_t)b * STATE;
  for (int i = threadIdx.x; i < NB; i += THREADS)
    if (h[i]) atomicAdd(&gh[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&st[TICKET], 1u) == (unsigned)a.tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned krem = D == 0 ? (unsigned)a.k : st[KREM];
  unsigned c[PT], sum = 0;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    c[i] = __ldcg(&gh[threadIdx.x * PT + i]);
    sum += c[i];
  }
  unsigned total;
  const unsigned before = block_scan(sum, &total);
  if (before < krem && krem <= before + sum) {   // one thread: the rank's bins
    unsigned run = before;
    int i = 0;
    while (i < PT - 1 && run + c[i] < krem) run += c[i++];
    const unsigned prefix = (D == 0 ? 0u : st[PREFIX]) |
                            (unsigned)(threadIdx.x * PT + i) << shift_of(D);
    st[PREFIX] = prefix;
    st[D == 2 ? NEED : KREM] = krem - run;
  }
#pragma unroll
  for (int i = 0; i < PT; ++i) gh[threadIdx.x * PT + i] = 0;
  if (threadIdx.x == 0) st[TICKET] = 0;
}

// A block's place: its row b, and its warp's segment s of that row.
struct Where {
  int b, s;
  __device__ Where(const Args& a)
      : b(blockIdx.x / a.tiles),
        s(blockIdx.x % a.tiles * WARPS + (threadIdx.x >> 5)) {}
};

// Launch 1: every entry's first digit.
__global__ void __launch_bounds__(THREADS, 4) select_lowest_digit0(Args a) {
  __shared__ unsigned h[BINS];
  const Where at(a);
  for (int i = threadIdx.x; i < BINS; i += THREADS) h[i] = 0;
  __syncthreads();
  const float* row = a.x + (size_t)at.b * a.n;
  const bool vec = ((uintptr_t)row & 15) == 0;
  const int lo = at.s * a.ss, hi = min(a.n, lo + a.ss);
  for_each_step(row, vec, lo, hi, [&](int, int m, const float* v) {
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (e < m) atomicAdd(&h[key_of(v[e]) >> shift_of(0)], 1u);
  });
  __syncthreads();
  finish_digit<0>(a, at.b, h);
}

// Launch 2: the candidates, every entry whose first digit is at most the
// threshold's, with their keys to the segment's list in order, and the second
// digit of those in the threshold's first-digit bucket.
__global__ void __launch_bounds__(THREADS, 4) select_lowest_digit1(Args a) {
  __shared__ unsigned h[BINS];
  const Where at(a);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < BINS; i += THREADS) h[i] = 0;
  const unsigned top = a.state[(size_t)at.b * STATE + PREFIX] >> shift_of(0);
  __syncthreads();
  const float* row = a.x + (size_t)at.b * a.n;
  const bool vec = ((uintptr_t)row & 15) == 0;
  const int lo = at.s * a.ss, hi = min(a.n, lo + a.ss);
  int* list = a.list + (size_t)at.b * a.n + lo;
  unsigned* keys = a.keys + (size_t)at.b * a.n + lo;
  unsigned run = 0;   // the segment's candidates so far
  for_each_step(row, vec, lo, hi, [&](int pos, int m, const float* v) {
    unsigned keep = 0;   // bit e: entry e is a candidate
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const unsigned key = key_of(v[e]);
      const unsigned d0 = key >> shift_of(0);
      if (e < m && d0 <= top) keep |= 1u << e;
      if (e < m && d0 == top)
        atomicAdd(&h[(key >> shift_of(1)) & (BINS - 1)], 1u);
    }
    if (!__any_sync(FULL, keep)) return;
    const unsigned cnt = __popc(keep);
    unsigned incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    unsigned j = run + incl - cnt;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (keep >> e & 1u) {
        list[j] = pos + e;
        keys[j++] = key_of(v[e]);
      }
    run += __shfl_sync(FULL, incl, 31);
  });
  if (lane == 0) a.cand[(size_t)at.b * a.tiles * WARPS + at.s] = run;
  __syncthreads();
  finish_digit<1>(a, at.b, h);
}

// Launch 3: the third digit, over the candidates.
__global__ void __launch_bounds__(THREADS, 4) select_lowest_digit2(Args a) {
  __shared__ unsigned h[1024];
  const Where at(a);
  for (int i = threadIdx.x; i < 1024; i += THREADS) h[i] = 0;
  const unsigned top =
      a.state[(size_t)at.b * STATE + PREFIX] >> shift_of(1);
  __syncthreads();
  const unsigned* keys = a.keys + (size_t)at.b * a.n + (size_t)at.s * a.ss;
  const unsigned n_c = a.cand[(size_t)at.b * a.tiles * WARPS + at.s];
  for (unsigned j = threadIdx.x & 31; j < n_c; j += 32) {
    const unsigned key = __ldg(keys + j);
    if (key >> shift_of(1) == top) atomicAdd(&h[key & 1023], 1u);
  }
  __syncthreads();
  finish_digit<2>(a, at.b, h);
}

// Launch 4: each segment's candidates below and equal to the threshold.
__global__ void __launch_bounds__(THREADS, 4) select_lowest_counts(Args a) {
  const Where at(a);
  const unsigned thr = a.state[(size_t)at.b * STATE + PREFIX];
  const unsigned* keys = a.keys + (size_t)at.b * a.n + (size_t)at.s * a.ss;
  const size_t seg = (size_t)at.b * a.tiles * WARPS + at.s;
  const unsigned n_c = a.cand[seg];
  unsigned lt = 0, eq = 0;
  for (unsigned j = threadIdx.x & 31; j < n_c; j += 32) {
    const unsigned key = __ldg(keys + j);
    lt += key < thr;
    eq += key == thr;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lt += __shfl_xor_sync(FULL, lt, off);
    eq += __shfl_xor_sync(FULL, eq, off);
  }
  if ((threadIdx.x & 31) == 0) {
    a.below[seg] = lt;
    a.equal[seg] = eq;
  }
}

// Launch 5: each segment's selected positions, in flat order.
__global__ void __launch_bounds__(THREADS, 4) select_lowest_write(Args a) {
  const Where at(a);
  const int lane = threadIdx.x & 31, first = at.s - (threadIdx.x >> 5);
  const unsigned* st = a.state + (size_t)at.b * STATE;
  const unsigned thr = st[PREFIX], need = st[NEED];
  const size_t segs = (size_t)a.tiles * WARPS;
  const unsigned* lt = a.below + at.b * segs;
  const unsigned* eq = a.equal + at.b * segs;
  if (at.s == 0 && lane == 0) a.thr[at.b] = value_of(thr);
  // the candidates below and equal to the threshold before this segment:
  // in the block's tiles before, then in its warps before
  unsigned nb = 0, ne = 0;
  for (int i = threadIdx.x; i < first; i += THREADS) {
    nb += lt[i];
    ne += eq[i];
  }
  block_scan(nb, &nb);
  block_scan(ne, &ne);
  for (int i = first; i < at.s; ++i) {
    nb += lt[i];
    ne += eq[i];
  }
  if (lt[at.s] == 0 && (eq[at.s] == 0 || ne >= need)) return;
  const int* list = a.list + (size_t)at.b * a.n + (size_t)at.s * a.ss;
  const unsigned* keys = a.keys + (size_t)at.b * a.n + (size_t)at.s * a.ss;
  const unsigned n_c = a.cand[at.b * segs + at.s];
  long long* out = a.ids + (size_t)at.b * a.k;
  const unsigned before_me = (1u << lane) - 1;
  for (unsigned j0 = 0; j0 < n_c; j0 += 32) {
    const unsigned j = j0 + lane;
    const int pos = j < n_c ? __ldg(list + j) : 0;
    const unsigned key = j < n_c ? __ldg(keys + j) : FULL;
    const bool is_lt = j < n_c && key < thr, is_eq = j < n_c && key == thr;
    const unsigned ml = __ballot_sync(FULL, is_lt);
    const unsigned me = __ballot_sync(FULL, is_eq);
    // a candidate's place: those below before it, and the equal ones before
    // it that are taken
    const unsigned pb = nb + __popc(ml & before_me);
    const unsigned pe = ne + __popc(me & before_me);
    if (is_lt) out[pb + min(pe, need)] = pos;
    else if (is_eq && pe < need) out[pb + pe] = pos;
    nb += __popc(ml);
    ne += __popc(me);
  }
}

}  // namespace

extern "C" int select_lowest(const float* x, long long* ids, float* thr,
                             unsigned* scratch, int B, int n, int k, int tiles,
                             void* stream) {
  if (B < 1 || n < 1 || k < 1 || k > n || n > (1 << 30) || tiles < 1 ||
      (long long)B * tiles * WARPS >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t segs = (size_t)B * tiles * WARPS;
  Args a;
  a.x = x;
  a.ids = ids;
  a.thr = thr;
  a.hist = scratch;
  a.state = a.hist + (size_t)B * BINS;
  a.cand = a.state + (size_t)B * STATE;
  a.below = a.cand + segs;
  a.equal = a.below + segs;
  a.list = reinterpret_cast<int*>(a.equal + segs);
  a.keys = a.equal + segs + (size_t)B * n;
  a.n = n;
  a.k = k;
  a.tiles = tiles;
  const int steps = (n + STEP - 1) / STEP;
  a.ss = (steps + tiles * WARPS - 1) / (tiles * WARPS) * STEP;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)B * (BINS + STATE) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(B * tiles);
  select_lowest_digit0<<<grid, THREADS, 0, s>>>(a);
  select_lowest_digit1<<<grid, THREADS, 0, s>>>(a);
  select_lowest_digit2<<<grid, THREADS, 0, s>>>(a);
  select_lowest_counts<<<grid, THREADS, 0, s>>>(a);
  select_lowest_write<<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
