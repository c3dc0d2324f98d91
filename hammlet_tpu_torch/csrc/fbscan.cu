// The two associative scans of the Forward-Backward sampler for NVIDIA
// Hopper (sm_90a): inclusive prefix products of K x K block matrices, and
// suffix compositions of index maps. One launch per call wherever all of a
// call's groups can be resident at once (the main path's shapes), three
// beyond that.
//
// (The prefix above K = 32 takes one launch at every shape: see "prefix,
// K = 33..64" and "prefix, K > 64".)
//
// Replaces the JAX package's grouped scans, which XLA compiles into a few
// fused ops on the TPU:
//   hammlet_tpu/samplers/forward_backward.py:prefix_matmul_scan_t (:94-130)
//   hammlet_tpu/samplers/forward_backward.py:suffix_compose_scan_t (:154-186)
// and computes exactly what their plain torch versions compute
// (hammlet_tpu_torch/samplers/forward_backward.py:
// prefix_matmul_scan_reference, suffix_compose_scan_reference): the same
// grouping, the same combines in the same order.
//
// Layout: the block axis is minor. Prefix: float32 (K, K, R, n); suffix:
// int64 (K, R, n); R rows (the sharded engine's local shards), each scanned
// on its own, so a row's bytes never depend on R. Element (e, r, b) lives at
// e * R * n + r * n + b, and thread b of a row touches column b, so every
// load and store of a warp is one coalesced run.
//
// What bounds each scan on this card. One call must read its input once
// and write its output once: at B = 29,696, K = 3, one row, 1.07 MB each
// way for the prefix (0.64 us at 3.35 TB/s) and 0.71 MB for the int64 maps
// (0.43 us); the float32 work is ~27 multiply-adds and 9 divides per block
// and level. So the bound is bytes, and what stands between a call and it
// is latency: launches, barriers and the chain of dependent combines (7
// in-group levels, the ~8 levels of the group totals, one broadcast
// combine), and in each combine its 9 divisions. __fdiv_rn (and the
// float64 division of the CUDA library) checks its operands and branches
// to a slow path for a zero or subnormal numerator; the branch after each
// division also keeps the 9 of a combine from overlapping. The sweep's
// matrices are half zeros and ~1 % subnormal, so nearly every warp took the
// slow path (3x the time on uniform inputs, measured on an H100).
// At K = 9-16 the combines' K^3 multiply-adds set the bound (at K = 10,
// B = 29,696: 7.5 us by float32 operations, 1.9 us by bytes), and what
// stands between a call and it is the in-group levels' reads of the
// earlier operand from shared memory (every thread of a team reads the
// whole matrix; the team instances give a thread 3 or 2 columns at K = 9
// and 10 to share those reads) and the totals' scan, a chain of grid-wide
// barriers and dependent passes through shared memory. At K = 17-32 the
// same holds (at K = 27, B = 29,696: 0.14 ms by float32 operations, 0.052
// by bytes), and a group of 128 matrices no longer fits one SM: it spreads
// over a thread block cluster (see "prefix, K = 17..32"). At K = 33..64 a
// group no longer fits a cluster, and the products themselves set the
// time (see "prefix, K = 33..64").
//
// Grouped form (n > 256 and n % 128 == 0, G = n / 128 groups per row):
//   *_one_kernel (K <= MAX_REG_K; the prefix's team instances for K =
//   MAX_REG_K + 1 .. MAX_TEAM_K, fbscan_prefix_team_one_kernel; the suffix
//   for every K <= MAX_DEEP_K), when the (G, R) grid of CTAs fits the card
//   at once (the host decides by occupancy, with the dynamic shared memory
//   the launch really takes, before the launch): one cooperative launch.
//   Each CTA takes its group into registers, one block per thread (K <=
//   MAX_REG_K; the team instances: a team of threads per matrix, columns in
//   registers, the group in shared memory, see "prefix, K = 9..16"), and
//   runs the 7 in-group Hillis-Steele levels there: at d < 32 a thread's
//   operand comes from its own warp by shuffle, and the first d lanes of a
//   warp take theirs from the last 16 lanes of the warp before, which
//   publish them in shared memory (one barrier per level); at d = 32 and
//   64 every operand goes through shared memory. The group's total goes to
//   device memory, the in-group result stays in registers. A grid-wide
//   barrier; then each CTA computes the scan of its row's totals at the one
//   position it needs (before its group for the prefix, after it for the
//   suffix; in place above MAX_WIDE_K) in shared memory: level l of the row's scan touches that
//   position's value only through the values 2^l apart, so each level
//   halves the values kept, with the same combines as the full scan (and
//   all of its levels); no second barrier (the team instances take the
//   scan's first TEAM_GRID_LEVELS levels over the whole grid, one value per
//   CTA and a grid-wide barrier each, which leaves each CTA a quarter of
//   the values to halve). Last, each block is combined
//   with its group's exclusive prefix (composition of the groups after it)
//   and written once.
//   Three launches otherwise (a row beyond one resident wave: 3,390 groups
//   at T = 250M per shard; the prefix at K = 13-16, whose group takes a
//   whole SM, beyond 132 groups; the prefix at K = MAX_TEAM_K + 1 ..
//   MAX_WIDE_K at every grouped shape, a cluster of WIDE_CL CTAs per group):
//   *_group_kernel: the in-group levels as above (the prefix's team group
//     kernel for K = 9..16, fbscan_prefix_wide_group_kernel for K =
//     17..32; the suffix's group kernel keeps the maps in shared memory,
//     as int32 up to K = 227 and int16 up to 454, and is the grouped
//     suffix's first launch at every shape above MAX_DEEP_K), the
//     in-group scan and each group's total to device memory;
//   rows scan of the totals: one CTA of 1024 threads per row where two
//     copies of a row fit in 48 KB of shared memory (K <= 8; the suffix
//     above MAX_WIDE_K up to the card's opt-in shared memory, as int16
//     where int32 would not fit), else one
//     cooperative launch spread over the whole card, a grid-wide barrier
//     between levels, ping-ponging through device scratch (the prefix at K
//     = 9..32: fbscan_prefix_team_rows_kernel, a thread per column);
//   *_combine_kernel: each block's in-group scan with its group's
//     exclusive prefix.
// Flat form (n <= 256 or n % 128 != 0, where the JAX package is flat too):
// the rows scan alone, on the input, in one CTA per row or over the whole
// card as above (a flat n reaches T when the capacity is clipped to it).
// A grouped suffix above K = 454 takes the flat form over the whole card:
// composition is exact, so its association does not change the result.
// The prefix at K = MAX_WIDE_K + 1 .. MAX_DEEP_K (-s C 6 2, -s C 4 3) is
// one cooperative launch, grouped or flat (fbscan_prefix_deep_kernel; see
// "prefix, K = 33..64"), and so is the prefix at every K > MAX_DEEP_K (-s C
// 3 4, -s C 5 3, -s C 2 7, -s C 3 5, -s C 5 4, -s C 2 10;
// fbscan_prefix_tiled_kernel, see "prefix, K > 64").
//
// Exactness: a combine is z[i,k] = sum_j e[i,j] * x[j,k] summed over j in
// order, with the _rn intrinsics (never contracted into an FMA), then
// z / max(max_ik z, 1e-35); the max propagates NaN like torch.amax (fmaxf
// alone would drop it). Each quotient is the correctly rounded float64
// quotient rounded to float32, which is the correctly rounded float32
// quotient __fdiv_rn gives, subnormal results included (53 >= 2 * 24 + 2
// bits, so double rounding is harmless; a quotient that is a float32
// midpoint is exact in float64 and the conversion breaks the tie to even).
// The float64 quotient comes from one reciprocal per combine and
// Markstein's correction (wide_quotient), with no branch: every float32
// operand is normal in float64, and a zero numerator gives its zero by a
// select. Not (double)z * (1.0 / m) alone: that is not exact at the
// midpoints. Only a lane with an infinite or NaN entry divides with
// __fdiv_rn. No atomics: the bytes do not change from run to run. Map
// composition is exact integer indexing; maps must hold indices in [0, K),
// as argmax gives them.
//
// C interface for ctypes: each hammlet_fbscan_* launch function returns the
// cudaError_t of its launches (0 = launched); none synchronizes or
// allocates: the caller hands in the workspace, whose size in elements
// hammlet_fbscan_*_workspace gives.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define GROUP 128          // the JAX package's _GROUP
#define GROUP_LEVELS 7     // log2(GROUP)
#define WARP 32
#define WARPS (GROUP / WARP)
#define EDGE 16            // lanes a warp hands to its neighbour at d < WARP
#define MAX_REG_K 8        // the register-resident instances: K = 1..8
#define TOTALS_THREADS 1024
#define GRID_THREADS 256   // per CTA of the grid-wide rows scans
#define FULL_MASK 0xffffffffu

namespace cg = cooperative_groups;

static_assert((1 << GROUP_LEVELS) == GROUP, "GROUP is 2^GROUP_LEVELS");
static_assert(2 * EDGE == WARP && (1 << 4) == EDGE, "d = 1..EDGE take the shuffle levels");

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;  // a NaN, once in m, stays
}

__device__ __forceinline__ float clamp_scale(float m) {
  return m < 1e-35f ? 1e-35f : m;  // torch.clamp(min=1e-35): NaN stays NaN
}

// z / m rounded to float32 through the correctly rounded float64 quotient,
// for finite z and a finite m >= 1e-35, with y = __drcp_rn(m): t = z * y is
// within an ulp of z / m, the residual z - m t is exact in an FMA, and
// t + residual * y rounds to the correctly rounded quotient (Markstein's
// theorem; no operand or result is subnormal in float64 here). Branch-free.
__device__ __forceinline__ float wide_quotient(float z, double m, double y) {
  const double a = z, t = __dmul_rn(a, y);
  const float q = __double2float_rn(__fma_rn(__fma_rn(-m, t, a), y, t));
  return z == 0.0f ? z : q;  // keeps the sign of a zero numerator (m > 0)
}

// Whether __fdiv_rn takes its fast path for z / m at every m a combine
// has (m >= 1e-35 and m >= z): no zero, subnormal or tiny z, no huge one.
__device__ __forceinline__ bool comfortable(float z) {
  const float a = fabsf(z);
  return a >= 0x1p-100f && a <= 0x1p100f;
}

// How a combine divides. kWide: always by wide_quotient, whose divisions
// overlap (no branch between them): for the kernels whose time is one chain
// of dependent combines (the one-launch kernels, a rows scan in one CTA).
// kByWarp: a warp whose entries are all comfortable takes __fdiv_rn's fast
// path, any other wide_quotient: for the kernels over every group or
// element of a long call, where __fdiv_rn's fewer operations count more
// than its branches.
enum Divide { kWide, kByWarp };

// z[q] / m for the N entries of a combine, m = clamp_scale(max z), each the
// correctly rounded float32 quotient that __fdiv_rn gives, as D says; by
// wide_quotient, one reciprocal serves the N of them. A lane with an
// infinite or NaN entry (m is finite when no entry is; such a lane is never
// comfortable) divides with __fdiv_rn.
template <int N, Divide D>
__device__ __forceinline__ void rescale(float* z, float m) {
  if (D == kByWarp) {
    bool awkward = false;
#pragma unroll
    for (int q = 0; q < N; ++q) awkward |= !comfortable(z[q]);
    if (!__any_sync(__activemask(), awkward)) {
#pragma unroll
      for (int q = 0; q < N; ++q) z[q] = __fdiv_rn(z[q], m);
      return;
    }
  }
  const double md = m, y = __drcp_rn(md);
  bool special = false;
  float v[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    special |= !isfinite(z[q]);
    v[q] = wide_quotient(z[q], md, y);
  }
  if (special) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = __fdiv_rn(z[q], m);
  }
#pragma unroll
  for (int q = 0; q < N; ++q) z[q] = v[q];
}

// z = normalize(e @ x) for a compile-time K; e(i, j) gives the earlier
// matrix and x(j, k) the later one, z is a register array of K * K
// (row-major).
template <int K, Divide D, class E, class X>
__device__ __forceinline__ void combine_reg(E e, X x, float* z) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = __fmul_rn(e(i, 0), x(0, k));
#pragma unroll
      for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(e(i, j), x(j, k)));
      z[i * K + k] = acc;
      m = max_nan(m, acc);
    }
  }
  rescale<K * K, D>(z, clamp_scale(m));
}

// the identity matrix as an earlier operand (the scans' padding)
struct Eye {
  __device__ __forceinline__ float operator()(int i, int j) const { return i == j ? 1.0f : 0.0f; }
};

// a register array of K * K as an operand of combine_reg
template <int K>
struct Regs {
  const float* v;
  __device__ __forceinline__ float operator()(int i, int j) const { return v[i * K + j]; }
};

// registers each thread of a one-launch kernel may take: at K = 3 the CTAs
// of a main-path call (232 at B = 29,696 and one row, 300 at P = 4's four
// rows of 9,600) and of four rows of 29,696 (928) must all be resident
#define ONE_MIN_BLOCKS(K) ((K) <= 3 ? 8 : (K) <= 5 ? 4 : 2)

// ---------------------------------------------------------------- prefix

// The 7 in-group Hillis-Steele levels of one group, thread t holding block
// t's K x K matrix in x (K <= MAX_REG_K). At d < WARP the earlier operand
// x_{t-d} comes from lane - d by __shfl_up_sync, and for the first d lanes
// of a warp from the last EDGE lanes of the warp before, which publish
// theirs in shared memory (two buffers by level parity, one barrier per
// level); at d = 32 and 64 from shared memory. The same operands as a
// shared-memory ping-pong, so the same bits. s: K * K * GROUP floats of
// shared memory, free on entry.
template <int K, Divide D>
__device__ __forceinline__ void prefix_group_levels(float* x, float* s) {
  const int t = threadIdx.x, lane = t % WARP, warp = t / WARP;
  float p[K * K], z[K * K];
#pragma unroll 1
  for (int level = 0; level < GROUP_LEVELS; ++level) {
    const int d = 1 << level;
    if (d < WARP) {
      float* edge = s + (level % 2) * K * K * WARPS * EDGE;  // [e][warp * EDGE + i]
      if (lane >= WARP - EDGE) {
#pragma unroll
        for (int e = 0; e < K * K; ++e)
          edge[e * WARPS * EDGE + warp * EDGE + lane - (WARP - EDGE)] = x[e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < K * K; ++e) p[e] = __shfl_up_sync(FULL_MASK, x[e], d);
      if (lane < d && warp > 0) {
#pragma unroll
        for (int e = 0; e < K * K; ++e)
          p[e] = edge[e * WARPS * EDGE + (warp - 1) * EDGE + EDGE - d + lane];
      }
    } else {
      __syncthreads();  // the level before has read its buffer
#pragma unroll
      for (int e = 0; e < K * K; ++e) s[e * GROUP + t] = x[e];
      __syncthreads();
      if (t >= d) {
#pragma unroll
        for (int e = 0; e < K * K; ++e) p[e] = s[e * GROUP + t - d];
      }
    }
    if (t < d) {
#pragma unroll
      for (int e = 0; e < K * K; ++e) p[e] = e / K == e % K ? 1.0f : 0.0f;
    }
    combine_reg<K, D>(Regs<K>{p}, Regs<K>{x}, z);
#pragma unroll
    for (int e = 0; e < K * K; ++e) x[e] = z[e];
  }
}

// The inclusive Hillis-Steele scan of a row's totals at one position p
// alone. After level l the value at p depends only on the values at
// p - k 2^l (k >= 0), so level l combines those in pairs, entry 2k + 1
// (earlier) with entry 2k (later), halving their number, and takes the
// identity where the earlier one would lie before the row: the combines
// the full scan makes for these positions, so the same bits. src holds the
// totals at p, p - 1, ..., 0 as entries 0..n-1 ([e][k], stride `stride`),
// dst has room for half of them; all `levels` levels of the row run.
// Returns the buffer whose entry 0 is the result. All GROUP threads take
// part.
template <int K>
__device__ __forceinline__ float* prefix_totals_at(float* src, float* dst, int n, int stride,
                                                   int levels) {
  for (int level = 0; level < levels; ++level) {
    const int half = (n + 1) / 2;
    for (int k = threadIdx.x; k < half; k += GROUP) {
      float z[K * K];
      auto later = [&](int j, int c) { return src[(j * K + c) * stride + 2 * k]; };
      if (2 * k + 1 < n) {
        combine_reg<K, kWide>(
            [&](int i, int j) { return src[(i * K + j) * stride + 2 * k + 1]; }, later, z);
      } else {
        combine_reg<K, kWide>(Eye(), later, z);
      }
#pragma unroll
      for (int e = 0; e < K * K; ++e) dst[e * stride + k] = z[e];
    }
    __syncthreads();
    float* done = dst;
    dst = src;
    src = done;
    n = half;
  }
  return src;
}

// The whole grouped prefix scan in one cooperative launch, K <= MAX_REG_K:
// grid (G, R) of GROUP threads, every CTA resident; tot holds (K, K, R, G)
// floats; dynamic shared memory max(K * K * GROUP, 2 * K * K * G) floats.
template <int K>
__global__ void __launch_bounds__(GROUP, ONE_MIN_BLOCKS(K))
fbscan_prefix_one_kernel(const float* __restrict__ in, float* __restrict__ out, float* tot, int R,
                         long long n, int levels) {
  extern __shared__ float smem_f[];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, tplane = (long long)R * G;
  const long long off = r * n + q * GROUP + t;
  float x[K * K], p[K * K], z[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) x[e] = in[e * plane + off];
  prefix_group_levels<K, kWide>(x, smem_f);
  if (t == GROUP - 1) {
#pragma unroll
    for (int e = 0; e < K * K; ++e) tot[e * tplane + r * G + q] = x[e];
  }
  cg::this_grid().sync();
  if (q > 0) {  // the inclusive scan of the row's totals at q - 1
    const int stride = (int)G;
    const float* last = tot + r * G + q - 1;
    for (int k = t; k < q; k += GROUP) {
#pragma unroll
      for (int e = 0; e < K * K; ++e) smem_f[e * stride + k] = last[e * tplane - k];
    }
    __syncthreads();
    const float* at = prefix_totals_at<K>(smem_f, smem_f + K * K * stride, (int)q, stride, levels);
#pragma unroll
    for (int e = 0; e < K * K; ++e) p[e] = at[e * stride];
  } else {
#pragma unroll
    for (int e = 0; e < K * K; ++e) p[e] = e / K == e % K ? 1.0f : 0.0f;
  }
  combine_reg<K, kWide>(Regs<K>{p}, Regs<K>{x}, z);
#pragma unroll
  for (int e = 0; e < K * K; ++e) out[e * plane + off] = z[e];
}

// In-group levels alone, K <= MAX_REG_K: grid (G, R), 128 threads; writes
// the in-group scan and each group's total.
template <int K>
__global__ void __launch_bounds__(GROUP)
fbscan_prefix_group_kernel(const float* __restrict__ in, float* __restrict__ inner,
                           float* __restrict__ tot, int R, long long n) {
  __shared__ float s[K * K * GROUP];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  float x[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) x[e] = in[e * plane + off];
  prefix_group_levels<K, kByWarp>(x, s);
#pragma unroll
  for (int e = 0; e < K * K; ++e) inner[e * plane + off] = x[e];
  if (t == GROUP - 1) {
    const long long toff = (long long)blockIdx.y * G + q;
#pragma unroll
    for (int e = 0; e < K * K; ++e) tot[e * R * G + toff] = x[e];
  }
}

// Hillis-Steele over each row's n matrices, K <= MAX_REG_K, one CTA per
// row with the row in shared memory (two buffers of K * K * n floats): each
// level takes a thread's matrices into registers, combines them and writes
// the other buffer; the last level's buffer goes to out.
template <int K>
__global__ void __launch_bounds__(TOTALS_THREADS)
fbscan_prefix_rows_smem_kernel(const float* __restrict__ in, float* __restrict__ out, int R,
                               long long n, int levels) {
  extern __shared__ float smem_f[];
  const long long row = (long long)blockIdx.x * n, plane = (long long)R * n;
  float* src = smem_f;
  float* dst = smem_f + K * K * n;
  for (long long g = threadIdx.x; g < n; g += blockDim.x) {
#pragma unroll
    for (int e = 0; e < K * K; ++e) src[e * n + g] = in[e * plane + row + g];
  }
  __syncthreads();
  for (int level = 0; level < levels; ++level) {
    const long long d = 1LL << level;
    for (long long g = threadIdx.x; g < n; g += blockDim.x) {
      float z[K * K];
      auto later = [&](int j, int k) { return src[(j * K + k) * n + g]; };
      if (g >= d) {
        combine_reg<K, kWide>([&](int i, int j) { return src[(i * K + j) * n + g - d]; },
                              later, z);
      } else {
        combine_reg<K, kWide>(Eye(), later, z);
      }
#pragma unroll
      for (int e = 0; e < K * K; ++e) dst[e * n + g] = z[e];
    }
    __syncthreads();
    float* done = dst;
    dst = src;
    src = done;
  }
  for (long long g = threadIdx.x; g < n; g += blockDim.x) {
#pragma unroll
    for (int e = 0; e < K * K; ++e) out[e * plane + row + g] = src[e * n + g];
  }
}

// The same scan spread over the whole card: a cooperative launch whose
// threads stride over all R * n matrices, a grid-wide barrier between
// levels. Level l writes out when levels - 1 - l is even, spare otherwise,
// so the last writes out. K <= MAX_REG_K, in registers.
template <int K>
__global__ void __launch_bounds__(GRID_THREADS)
fbscan_prefix_rows_grid_kernel(const float* in, float* out, float* spare, int R, long long n,
                               int levels) {
  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)R * n;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  if (levels == 0) {
    for (long long at = first; at < plane; at += step)
      for (int e = 0; e < K * K; ++e) out[e * plane + at] = in[e * plane + at];
    return;
  }
  const float* src = in;
  for (int level = 0; level < levels; ++level) {
    const long long d = 1LL << level;
    float* dst = (levels - 1 - level) % 2 == 0 ? out : spare;
    for (long long at = first; at < plane; at += step) {
      float x[K * K], z[K * K];
#pragma unroll
      for (int e = 0; e < K * K; ++e) x[e] = src[e * plane + at];
      if (at % n >= d) {
        combine_reg<K, kByWarp>(
            [&](int i, int j) { return src[(i * K + j) * plane + at - d]; }, Regs<K>{x}, z);
      } else {
        combine_reg<K, kByWarp>(Eye(), Regs<K>{x}, z);
      }
#pragma unroll
      for (int e = 0; e < K * K; ++e) dst[e * plane + at] = z[e];
    }
    grid.sync();
    src = dst;
  }
}

// out[b] = normalize(pre[q] @ inner[b]), pre[q] the product of the groups
// before q (the identity for q = 0), K <= MAX_REG_K: grid (G, R), 128
// threads.
template <int K>
__global__ void __launch_bounds__(GROUP)
fbscan_prefix_combine_kernel(const float* __restrict__ inner, const float* __restrict__ incl,
                             float* __restrict__ out, int R, long long n) {
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + threadIdx.x;
  float x[K * K], z[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) x[e] = inner[e * plane + off];
  if (q > 0) {
    const float* pre = incl + (long long)blockIdx.y * G + q - 1;
    const long long tplane = (long long)R * G;
    float p[K * K];
#pragma unroll
    for (int e = 0; e < K * K; ++e) p[e] = pre[e * tplane];
    combine_reg<K, kByWarp>(Regs<K>{p}, Regs<K>{x}, z);
  } else {
    combine_reg<K, kByWarp>(Eye(), Regs<K>{x}, z);
  }
#pragma unroll
  for (int e = 0; e < K * K; ++e) out[e * plane + off] = z[e];
}

// ------------------------------------------------- prefix, K = 9..16: teams

// A K x K matrix per thread does not fit in registers above MAX_REG_K (x,
// p and z alone are 3 K^2 floats), so the team instances (K = MAX_REG_K + 1
// .. MAX_TEAM_K) give each matrix a team of TPM = K / C threads, thread u
// of a team owning the C columns u, u + TPM, ...: z[:, c] = e @ x[:, c],
// the columns x[:, c] of the later operand in the thread's registers, the
// earlier operand e read from shared memory as 16-byte rows, each row once
// for the C columns (shared memory's bandwidth bounds the levels: every
// thread of a team reads all of e). The matrix's max goes through shared
// memory (each thread writes the max of its columns, a barrier, each reads
// the TPM of its matrix: a max is exact in any order, NaN stays NaN, and
// clamp_scale removes the sign of a zero max), then each thread divides
// its own columns. A CTA holds one group: Team<K>::THREADS = GROUP * TPM /
// ITEMS threads, thread tid in team u = tid % TPM of the matrices tid / TPM
// + (GROUP / ITEMS) n, n < ITEMS. The group's matrices sit in shared memory
// row-major with rows padded to a multiple of four floats, so the earlier
// operand's rows load as float4; a thread keeps its columns in registers
// across a level, and writes them back after the barrier that ends the
// level's reads (one buffer). An identity matrix in shared memory is the
// earlier operand where the scan pads with one, so every lane runs the
// same code and the same arithmetic as the plain version's identity.
// Above MAX_TEAM_K a group spreads over a thread block cluster of CL CTAs
// (the wide instances, see "prefix, K = 17..32"); a CTA then holds M =
// GROUP / CL of the group's matrices.
#define MAX_TEAM_K 16
#define MAX_WIDE_K 32
#define WIDE_CL 8  // CTAs per group above MAX_TEAM_K (the portable cluster size)

template <int K>
struct Team {
  static constexpr bool WIDE = K > MAX_TEAM_K;
  static constexpr int CL = WIDE ? WIDE_CL : 1;  // CTAs per group
  static constexpr int M = GROUP / CL;           // matrices per CTA
  // columns per thread and matrices per thread: K = 9 and 10 (two CTAs of
  // a call's 232 groups per SM) read e once for 3 and 2 columns; above, one
  // column of four matrices per thread keeps the group in the registers;
  // above MAX_TEAM_K one column of one matrix
  static constexpr int C = K == 9 ? 3 : K == 10 ? 2 : 1;
  static constexpr int ITEMS = WIDE ? 1 : C == 1 ? 4 : 2;
  static constexpr int TPM = K / C;              // threads per matrix
  static constexpr int THREADS = M * TPM / ITEMS;
  static constexpr int SPAN = M / ITEMS;         // matrices between a thread's items
  // CTAs per SM the registers leave room for (the team and wide group and
  // combine kernels; the wide group kernel's own up to K = 28, see WIDE_MIN)
  static constexpr int MIN_BLOCKS = K <= 12 || WIDE ? 2 : 1;
  static constexpr int KP = (K + 3) / 4 * 4;     // padded row, floats
  static constexpr int MS = K * KP;              // floats per matrix
  // dynamic shared memory of a group or combine kernel, floats: the CTA's
  // matrices, the column maxima, the identity
  static constexpr int GROUP_FLOATS = M * MS + M * TPM + MS;
  static_assert(K % C == 0 && (WIDE || THREADS % WARP == 0),
                "a team owns whole columns (and, up to MAX_TEAM_K, whole warps)");
  static_assert(GROUP % CL == 0 && M % ITEMS == 0, "a CTA holds whole items");
};

// The columns of one thread: C columns of K floats.
template <int K>
using Cols = float[Team<K>::C][K];

// z[:, c] = e @ x[:, c] for the thread's C columns, e a K x K matrix whose
// row i starts at e + i * KP, 16-byte aligned (shared memory or the padded
// totals); each z[i] summed over j in order with the _rn intrinsics.
// Returns the max of the thread's entries (max_nan).
template <int K, int C>
__device__ __forceinline__ float columns_product(const float* e, const float (&x)[C][K],
                                                 float (&z)[C][K]) {
  constexpr int KP = Team<K>::KP;
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float row[KP];
#pragma unroll
    for (int q = 0; q < KP / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(e + i * KP)[q];
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = __fmul_rn(row[0], x[c][0]);
#pragma unroll
      for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(row[j], x[c][j]));
      z[c][i] = acc;
      m = max_nan(m, acc);
    }
  }
  return m;
}

// The same for one column with e(i, j) a functor (scalar loads from any
// layout).
template <int K, class E>
__device__ __forceinline__ float column_product_at(E e, const float* x, float* z) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = __fmul_rn(e(i, 0), x[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(e(i, j), x[j]));
    z[i] = acc;
    m = max_nan(m, acc);
  }
  return m;
}

// z / clamp_scale(max of the matrix) for N entries of the matrix, the max
// taken over the T partial maxima at red[0..T-1]; as rescale<N, kWide>:
// each quotient the correctly rounded float32 one, by wide_quotient, or by
// __fdiv_rn where an entry or the max is not finite.
template <int N, int T>
__device__ __forceinline__ void rescale_part(float* z, const float* red) {
  float m = red[0];
#pragma unroll
  for (int c = 1; c < T; ++c) m = max_nan(m, red[c]);
  m = clamp_scale(m);
  bool special = !isfinite(m);
#pragma unroll
  for (int i = 0; i < N; ++i) special |= !isfinite(z[i]);
  if (special) {
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = __fdiv_rn(z[i], m);
    return;
  }
  const double md = m, y = __drcp_rn(md);
#pragma unroll
  for (int i = 0; i < N; ++i) z[i] = wide_quotient(z[i], md, y);
}

// Shared memory of a group kernel: room for `room` >= M matrices (the
// CTA's share of the group), the partial maxima (M * TPM floats), the
// identity (one matrix), which the constructor writes.
template <int K>
struct TeamSmem {
  float* s;
  float* red;
  float* eye;
  __device__ TeamSmem(float* base, long long room)
      : s(base), red(base + room * Team<K>::MS), eye(red + Team<K>::M * Team<K>::TPM) {
    for (int e = threadIdx.x; e < Team<K>::MS; e += Team<K>::THREADS)
      eye[e] = e / Team<K>::KP == e % Team<K>::KP ? 1.0f : 0.0f;
  }
};

// The CTA's M matrices of a (K, K, R, n) tensor, element (e, t) at src[e *
// plane + base + t], into shared memory (thread-consecutive t: coalesced),
// and back.
template <int K>
__device__ __forceinline__ void team_load(const float* src, float* s, long long plane,
                                          long long base) {
  constexpr int M = Team<K>::M;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < K * K * M; idx += Team<K>::THREADS) {
    const int e = idx / M, t = idx % M;
    s[t * Team<K>::MS + (e / K) * Team<K>::KP + e % K] = src[e * plane + base + t];
  }
}

template <int K>
__device__ __forceinline__ void team_store(const float* s, float* dst, long long plane,
                                           long long base) {
  constexpr int M = Team<K>::M;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < K * K * M; idx += Team<K>::THREADS) {
    const int e = idx / M, t = idx % M;
    dst[e * plane + base + t] = s[t * Team<K>::MS + (e / K) * Team<K>::KP + e % K];
  }
}

// The thread's matrix n, column slot c: matrix and column index.
template <int K>
__device__ __forceinline__ int team_matrix(int n) {
  return threadIdx.x / Team<K>::TPM + Team<K>::SPAN * n;
}
template <int K>
__device__ __forceinline__ int team_column(int c) {
  return threadIdx.x % Team<K>::TPM + Team<K>::TPM * c;
}

// The thread's columns of the group in shared memory into registers.
template <int K>
__device__ __forceinline__ void team_columns(const float* s, Cols<K> (&x)[Team<K>::ITEMS]) {
#pragma unroll
  for (int n = 0; n < Team<K>::ITEMS; ++n) {
#pragma unroll
    for (int c = 0; c < Team<K>::C; ++c) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        x[n][c][j] = s[team_matrix<K>(n) * Team<K>::MS + j * Team<K>::KP + team_column<K>(c)];
    }
  }
}

// x_t = normalize(e_t @ x_t) for the thread's matrices t, e_t = earlier(t)
// (a pointer into shared memory); then the columns are written back to s.
// Two barriers: after the products (every read of s done, the maxima
// written) and after the write-back.
template <int K, class Earlier>
__device__ __forceinline__ void team_combine(Earlier earlier, float* s, float* red,
                                             Cols<K> (&x)[Team<K>::ITEMS]) {
  constexpr int MS = Team<K>::MS, KP = Team<K>::KP, TPM = Team<K>::TPM, C = Team<K>::C;
  const int u = threadIdx.x % TPM;
#pragma unroll
  for (int n = 0; n < Team<K>::ITEMS; ++n) {
    const int t = team_matrix<K>(n);
    Cols<K> z;
    red[t * TPM + u] = columns_product<K, C>(earlier(t), x[n], z);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < K; ++i) x[n][c][i] = z[c][i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < Team<K>::ITEMS; ++n) {
    const int t = team_matrix<K>(n);
    rescale_part<C * K, TPM>(&x[n][0][0], red + t * TPM);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < K; ++i) s[t * MS + i * KP + team_column<K>(c)] = x[n][c][i];
    }
  }
  __syncthreads();
}

// The 7 in-group Hillis-Steele levels on the group in sm.s (loaded, and a
// barrier passed), the thread's columns in x on return too.
template <int K>
__device__ __forceinline__ void team_group_levels(const TeamSmem<K>& sm,
                                                  Cols<K> (&x)[Team<K>::ITEMS]) {
  team_columns<K>(sm.s, x);
#pragma unroll 1
  for (int level = 0; level < GROUP_LEVELS; ++level) {
    const int d = 1 << level;
    const float* s = sm.s;
    const float* eye = sm.eye;
    team_combine<K>([=](int t) { return t >= d ? s + (t - d) * Team<K>::MS : eye; }, sm.s,
                    sm.red, x);
  }
}

// The group's total (its last matrix: t = M - 1 of its last CTA) from the
// registers of its team into tot (matrix-major, padded rows) at matrix
// index g; called by the group's last CTA.
template <int K>
__device__ __forceinline__ void team_total(const Cols<K> (&x)[Team<K>::ITEMS], float* tot,
                                           long long g) {
  constexpr int N = Team<K>::ITEMS - 1;
  if (team_matrix<K>(N) == Team<K>::M - 1) {
#pragma unroll
    for (int c = 0; c < Team<K>::C; ++c) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        tot[g * Team<K>::MS + i * Team<K>::KP + team_column<K>(c)] = x[N][c][i];
    }
  }
}

// The first TEAM_GRID_LEVELS levels of the row's totals' scan are taken
// over the whole grid (CTA q computes the level's value at position q, a
// grid-wide barrier between levels); the rest at the one position each CTA
// needs, as prefix_totals_at does.
#define TEAM_GRID_LEVELS 2

// Matrices of shared memory the one-launch kernel's group buffer holds:
// the group, or the totals' entries left after the grid-wide levels.
__host__ __device__ constexpr long long team_room(long long G) {
  return (G + (1 << TEAM_GRID_LEVELS) - 1) >> TEAM_GRID_LEVELS > GROUP
             ? (G + (1 << TEAM_GRID_LEVELS) - 1) >> TEAM_GRID_LEVELS
             : GROUP;
}

// One Hillis-Steele level of a row's totals (padded matrices) at this
// CTA's position g: dst[g] = normalize(src[g - d] @ src[g]) (the identity
// before the row), one column per thread of the first K threads.
template <int K>
__device__ __forceinline__ void team_totals_level(const float* src, float* dst, long long g,
                                                  long long d, float* red, const float* eye) {
  constexpr int MS = Team<K>::MS, KP = Team<K>::KP;
  const int c = threadIdx.x;
  float z[1][K];
  if (c < K) {
    float x[1][K];
#pragma unroll
    for (int j = 0; j < K; ++j) x[0][j] = src[g * MS + j * KP + c];
    red[c] = columns_product<K, 1>(g >= d ? src + (g - d) * MS : eye, x, z);
  }
  __syncthreads();
  if (c < K) {
    rescale_part<K, K>(z[0], red);
#pragma unroll
    for (int i = 0; i < K; ++i) dst[g * MS + i * KP + c] = z[0][i];
  }
}

// prefix_totals_at for a team, from level `first`: the inclusive scan of a
// row's totals at position p, whose level-`first` values (row base `row`,
// padded matrices) the grid has computed at every position. The n =
// ceil((p + 1) / 2^first) values at p, p - 2^first, ... are copied into
// `scratch` (coalesced), then the levels first .. levels - 1 run there in
// place with the same combines, THREADS / K combines per pass, one column
// per thread (a pass writes entries below those any later pass of its
// level reads; its reads end at the barrier before its writes). Returns
// scratch, whose entry 0 is the result.
template <int K>
__device__ __forceinline__ const float* team_totals_at(const float* row, long long p, int first,
                                                       float* scratch, float* red,
                                                       const float* eye, int levels) {
  constexpr int MS = Team<K>::MS, KP = Team<K>::KP;
  constexpr int PASS = Team<K>::THREADS / K;  // combines per pass
  const int c = threadIdx.x % K, t0 = threadIdx.x / K;
  long long n = (p >> first) + 1;
  for (long long idx = threadIdx.x; idx < n * (MS / 4); idx += Team<K>::THREADS) {
    const long long e = idx / (MS / 4), f = idx % (MS / 4);
    reinterpret_cast<float4*>(scratch)[idx] =
        reinterpret_cast<const float4*>(row + (p - (e << first)) * MS)[f];
  }
  __syncthreads();
  for (int level = first; level < levels; ++level) {
    const long long half = (n + 1) / 2;
    for (long long base = 0; base < half; base += PASS) {
      const long long k = base + t0;
      const bool busy = t0 < PASS && k < half;
      float z[1][K];
      if (busy) {
        float x[1][K];
#pragma unroll
        for (int j = 0; j < K; ++j) x[0][j] = scratch[2 * k * MS + j * KP + c];
        red[t0 * K + c] =
            columns_product<K, 1>(2 * k + 1 < n ? scratch + (2 * k + 1) * MS : eye, x, z);
      }
      __syncthreads();
      if (busy) {
        rescale_part<K, K>(z[0], red + t0 * K);
#pragma unroll
        for (int i = 0; i < K; ++i) scratch[k * MS + i * KP + c] = z[0][i];
      }
      __syncthreads();
    }
    n = half;
  }
  return scratch;
}

// The whole grouped prefix scan in one cooperative launch, K = 9..16: grid
// (G, R) of Team<K>::THREADS threads, every CTA resident; work holds 3 R G
// padded matrices (the totals and their first grid-wide levels); dynamic
// shared memory Team<K>::GROUP_FLOATS floats, or more where the totals'
// entries need more than the group's room (team_room). The in-group scan
// stays in registers while the totals' scan uses the group's shared
// memory.
template <int K>
__global__ void __launch_bounds__(Team<K>::THREADS, Team<K>::MIN_BLOCKS)
fbscan_prefix_team_one_kernel(const float* __restrict__ in, float* __restrict__ out, float* work,
                              int R, long long n, int levels) {
  extern __shared__ __align__(16) float smem_team[];
  const long long q = blockIdx.x, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, base = r * n + q * GROUP;
  const TeamSmem<K> sm(smem_team, team_room(G));
  team_load<K>(in, sm.s, plane, base);
  __syncthreads();
  Cols<K> x[Team<K>::ITEMS];
  team_group_levels<K>(sm, x);
  float* row = work + r * G * Team<K>::MS;  // level l of the totals at row + l R G MS
  const long long level_stride = (long long)R * G * Team<K>::MS;
  team_total<K>(x, row, q);
  const int grid_levels = levels < TEAM_GRID_LEVELS ? levels : TEAM_GRID_LEVELS;
  for (int level = 0; level < grid_levels; ++level) {
    cg::this_grid().sync();
    team_totals_level<K>(row + level * level_stride, row + (level + 1) * level_stride, q,
                         1LL << level, sm.red, sm.eye);
  }
  cg::this_grid().sync();
  const float* pre = sm.eye;
  if (q > 0)
    pre = team_totals_at<K>(row + grid_levels * level_stride, q - 1, grid_levels, sm.s, sm.red,
                            sm.eye, levels);
  team_combine<K>([=](int) { return pre; }, sm.s, sm.red, x);
  team_store<K>(sm.s, out, plane, base);
}

// In-group levels alone, K = 9..16, beyond one resident wave: grid (G, R);
// writes the in-group scan to inner ((K, K, R, n)) and each group's total
// to tot (padded matrices).
template <int K>
__global__ void __launch_bounds__(Team<K>::THREADS, Team<K>::MIN_BLOCKS)
fbscan_prefix_team_group_kernel(const float* __restrict__ in, float* __restrict__ inner,
                                float* __restrict__ tot, int R, long long n) {
  extern __shared__ __align__(16) float smem_team[];
  const long long q = blockIdx.x, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, base = r * n + q * GROUP;
  const TeamSmem<K> sm(smem_team, GROUP);
  team_load<K>(in, sm.s, plane, base);
  __syncthreads();
  Cols<K> x[Team<K>::ITEMS];
  team_group_levels<K>(sm, x);
  team_total<K>(x, tot, r * G + q);
  team_store<K>(sm.s, inner, plane, base);
}

// out_b = normalize(pre_q @ inner_b), pre_q the inclusive scan of the
// totals at q - 1 (padded matrices in incl; the identity for q = 0), K =
// 9..32: grid (G CL, R), a CTA per M blocks (no cluster: each CTA reads
// pre_q itself).
template <int K>
__global__ void __launch_bounds__(Team<K>::THREADS, Team<K>::MIN_BLOCKS)
fbscan_prefix_team_combine_kernel(const float* __restrict__ inner, const float* __restrict__ incl,
                                  float* __restrict__ out, int R, long long n) {
  extern __shared__ __align__(16) float smem_team[];
  const long long q = blockIdx.x / Team<K>::CL, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, base = r * n + (long long)blockIdx.x * Team<K>::M;
  const TeamSmem<K> sm(smem_team, Team<K>::M);
  team_load<K>(inner, sm.s, plane, base);
  __syncthreads();
  Cols<K> x[Team<K>::ITEMS];
  team_columns<K>(sm.s, x);
  const float* pre = q > 0 ? incl + (r * G + q - 1) * Team<K>::MS : sm.eye;
  team_combine<K>([=](int) { return pre; }, sm.s, sm.red, x);
  team_store<K>(sm.s, out, plane, base);
}

// Hillis-Steele over each of R rows of n matrices, K = 9..32, spread over
// the card: a cooperative launch of CTAs of ROWS_THREADS(K) threads, each
// pass of a CTA combining ROWS_MATS(K) consecutive matrices (a thread per
// column; 32 up to MAX_TEAM_K, 16 up to K = 24 and 8 above, which leave a
// thread's column and its product room in the registers without spills), a
// grid-wide barrier between levels;
// level l writes out when levels - 1 - l is even, spare otherwise, so the
// last writes out. Element (i, j) of matrix g of row r lies at (i * rs + j
// * cs) + (r * n + g) * ms, in all three buffers: the (K, K, R, n) layout
// for a flat call, padded matrices for the group totals.
#define ROWS_MATS(K) ((K) <= MAX_TEAM_K ? WARP : (K) <= 24 ? WARP / 2 : WARP / 4)
#define ROWS_THREADS(K) (ROWS_MATS(K) * (K))
template <int K>
__global__ void __launch_bounds__(ROWS_THREADS(K))
fbscan_prefix_team_rows_kernel(const float* in, float* out, float* spare, int R, long long n,
                               int levels, long long rs, long long cs, long long ms) {
  constexpr int MATS = ROWS_MATS(K);
  __shared__ float red[MATS * K];
  cg::grid_group grid = cg::this_grid();
  const int c = threadIdx.x % K, t0 = threadIdx.x / K;
  const long long total = (long long)R * n;
  if (levels == 0) {
    for (long long g = (long long)blockIdx.x * MATS + t0; g < total; g += (long long)gridDim.x * MATS)
      for (int i = 0; i < K; ++i) out[i * rs + c * cs + g * ms] = in[i * rs + c * cs + g * ms];
    return;
  }
  const float* src = in;
  for (int level = 0; level < levels; ++level) {
    const long long d = 1LL << level;
    float* dst = (levels - 1 - level) % 2 == 0 ? out : spare;
    for (long long first = (long long)blockIdx.x * MATS; first < total;
         first += (long long)gridDim.x * MATS) {
      const long long g = first + t0;
      float z[K];
      if (g < total) {
        float x[K];
#pragma unroll
        for (int j = 0; j < K; ++j) x[j] = src[j * rs + c * cs + g * ms];
        if (g % n >= d) {
          const float* e = src + (g - d) * ms;
          red[t0 * K + c] =
              column_product_at<K>([=](int i, int j) { return e[i * rs + j * cs]; }, x, z);
        } else {
          red[t0 * K + c] =
              column_product_at<K>([](int i, int j) { return i == j ? 1.0f : 0.0f; }, x, z);
        }
      }
      __syncthreads();
      if (g < total) {
        rescale_part<K, K>(z, red + t0 * K);
#pragma unroll
        for (int i = 0; i < K; ++i) dst[i * rs + c * cs + g * ms] = z[i];
      }
      __syncthreads();
    }
    grid.sync();
    src = dst;
  }
}

// ------------------------------------------ prefix, K = 17..32: clusters

// A group of 128 padded matrices no longer fits one SM above K = 20 (387
// KB at K = 27, 524 KB at K = 32), nor its columns the registers of one
// SM. So a group spreads over a thread block cluster of WIDE_CL CTAs, each
// holding M = 16 consecutive matrices in shared memory and a thread per
// column (z[:, c] = e @ x[:, c] as for the teams, columns_product). At
// level d the earlier operand of matrix t lies d matrices back, in this
// CTA or (t < d) in another: each level first copies the operands from
// the other CTAs' shared memory (distributed shared memory, float4 loads
// by every thread at once, so the copy is bound by the cluster's network
// and not by its latency) into a staging buffer of M matrices, and the
// products read shared memory only locally. Two cluster barriers a level,
// each split into arrive and wait so that the products run while the
// other CTAs arrive: after a CTA's copies (no CTA writes its matrices back
// before every CTA's copies are done) and after its write-back (no CTA
// copies before every CTA's write-back is done). The identity pads as for
// the teams.

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// CTAs per SM of the wide group kernel: two up to K = 28, where a thread's
// column, its product and a row of e fit 72 registers (the prefix at K =
// 27, B = 29,696: 1.380 ms with one CTA per SM at 95 registers, 1.138 with
// two); one above, where 64 registers spill (K = 32: 1.808 against 1.942;
// fbscan_probes.py variants, on an NVIDIA H100 80GB HBM3 at 700 W).
#define WIDE_MIN(K) ((K) <= 28 ? 2 : 1)

// In-group levels, K = 17..32: grid (G WIDE_CL, R) in clusters of WIDE_CL
// CTAs, one per group; writes the in-group scan to inner ((K, K, R, n)) and
// each group's total to tot (padded matrices). Dynamic shared memory
// Team<K>::GROUP_FLOATS + M * MS floats (the staging buffer).
template <int K>
__global__ void __cluster_dims__(WIDE_CL, 1, 1) __launch_bounds__(Team<K>::THREADS, WIDE_MIN(K))
fbscan_prefix_wide_group_kernel(const float* __restrict__ in, float* __restrict__ inner,
                                float* __restrict__ tot, int R, long long n) {
  using T = Team<K>;
  constexpr int M = T::M, MS = T::MS, KP = T::KP, TPM = T::TPM, VECS = MS / 4;
  extern __shared__ __align__(16) float smem_team[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), first = rank * M;  // the CTA's first matrix
  const long long q = blockIdx.x / T::CL, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, base = r * n + (long long)blockIdx.x * M;
  const TeamSmem<K> sm(smem_team, M);
  float* stage = sm.eye + MS;  // this level's earlier operands from the other CTAs
  team_load<K>(in, sm.s, plane, base);
  __syncthreads();
  Cols<K> x[1];
  team_columns<K>(sm.s, x);
  const int t = team_matrix<K>(0), u = threadIdx.x % TPM;
  cluster_arrive();  // loaded
#pragma unroll 1
  for (int level = 0; level < GROUP_LEVELS; ++level) {
    const int d = 1 << level;
    cluster_wait();  // every CTA's matrices of the level before are in place
    const int remote = d < M ? d : M;  // operands t < remote lie in other CTAs
    for (int idx = threadIdx.x; idx < remote * VECS; idx += T::THREADS) {
      const int k = idx / VECS, g = first + k - d;
      if (g >= 0) {
        const float* src = cluster.map_shared_rank(sm.s, g / M) + (g % M) * MS;
        reinterpret_cast<float4*>(stage + k * MS)[idx % VECS] =
            reinterpret_cast<const float4*>(src)[idx % VECS];
      }
    }
    cluster_arrive();  // this CTA's reads of the other CTAs are done
    __syncthreads();   // the staging buffer is written
    const float* e = first + t < d ? sm.eye : t < d ? stage + t * MS : sm.s + (t - d) * MS;
    Cols<K> z;
    sm.red[t * TPM + u] = columns_product<K, 1>(e, x[0], z);
#pragma unroll
    for (int i = 0; i < K; ++i) x[0][0][i] = z[0][i];
    __syncthreads();  // the maxima are written
    cluster_wait();   // no CTA reads this CTA's matrices any more at this level
    rescale_part<K, TPM>(&x[0][0][0], sm.red + t * TPM);
#pragma unroll
    for (int i = 0; i < K; ++i) sm.s[t * MS + i * KP + u] = x[0][0][i];
    if (level + 1 < GROUP_LEVELS) cluster_arrive();  // written back
  }
  __syncthreads();
  if (rank == T::CL - 1) team_total<K>(x, tot, r * G + q);
  team_store<K>(sm.s, inner, plane, base);
}

// ------------------------------------ prefix, K = 33..64: tiled products

// A matrix is 4.3 to 16 KB here and a group of 128 up to 2 MB, more than a
// cluster's shared memory, and a combine is 36 K to 262 K multiply-adds:
// the products set the bound (at K = 64, B = 29,696: 1.89 ms by float32
// operations, 0.29 by bytes). So each combine is a thread block's tiled
// product: DEEP_SIDE^2 threads per matrix, thread (ti, tk) owning the T x
// T entries (ti + DEEP_SIDE a, tk + DEEP_SIDE b) of z, T = ceil(K /
// DEEP_SIDE) (K padded to KP = DEEP_SIDE T in i and k only; the j loop
// runs exactly K terms, the padded entries are computed and dropped). Both
// operands sit in shared memory row-major, rows S = KP + 4 floats apart,
// so a warp's loads of e[i][j] (4 rows) and of x[j][k] (8 consecutive
// columns) hit distinct banks, and each step of j loads 2T values for T^2
// multiply-adds. The matrix's max: max_nan over the thread's valid
// entries, the warp's by shuffles, the matrix's two warps through shared
// memory; each thread divides its own entries (rescale_part's
// arithmetic). The group's levels cannot stay on chip, so every level is
// a pass over the workspace, the matrices stored matrix-major (rows of K4
// = K rounded up to 4 floats, one 16-byte aligned run per matrix),
// ping-ponging between two buffers; a CTA takes DEEP_MATS matrices per
// step, copying both operands of each into shared memory with 16-byte
// cp.async, all in flight at once. The input's (K, K, R, n) layout goes
// through a shared-memory transpose of 32 consecutive matrices first, the
// result back through one last. The group totals' scan and the flat form
// take the same passes, all in one cooperative launch over the card, a
// grid-wide barrier after each phase and level. (A thread block cluster
// per group for the in-group phases, the totals' scan over the card
// between, was slower at every K probed: K = 64, B = 29,696, 10.15
// against 8.62 ms; fbscan_probes.py deep, an NVIDIA H100 80GB HBM3 at
// 700 W.)
#define MAX_DEEP_K 64
#define DEEP_SIDE 8     // threads per side of a matrix's thread grid
#define DEEP_MATS 2     // matrices per CTA and step
#define DEEP_TILE 32    // matrices per transpose tile
#define DEEP_BATCH 8    // loads in flight per thread in a transpose
#define DEEP_T_MIN ((MAX_WIDE_K + DEEP_SIDE) / DEEP_SIDE)
#define DEEP_T_MAX ((MAX_DEEP_K + DEEP_SIDE - 1) / DEEP_SIDE)

template <int T>
struct Deep {
  static constexpr int KP = DEEP_SIDE * T;  // padded K
  // row stride of an operand in shared memory: 16-byte rows (cp.async), and
  // S = 4 (mod 8), so the 4 rows of e a warp reads lie in distinct banks
  static constexpr int S = KP + 4;
  static constexpr int SLOT = KP * S;       // floats of one operand
  static constexpr int MAT_THREADS = DEEP_SIDE * DEEP_SIDE;
  static constexpr int MAT_WARPS = MAT_THREADS / WARP;
  static constexpr int THREADS = DEEP_MATS * MAT_THREADS;
  // operand floats: two per matrix
  static constexpr int OPERANDS = 2 * DEEP_MATS * SLOT;
  // dynamic shared memory: the operands, the warps' maxima
  static constexpr int SMEM_FLOATS = OPERANDS + DEEP_MATS * MAT_WARPS;
  // CTAs per SM the registers leave room for: 128 registers a thread up to
  // T = 6, 168 above (the T^2 entries of z, 2T operands)
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * (T <= 6 ? 128 : 168));
  static_assert(MAT_THREADS % WARP == 0 && S % 8 == 4, "whole warps per matrix, the stride");
};

// The workspace layout: K rows of K4 floats per matrix.
__host__ __device__ constexpr int deep_row(int K) { return (K + 3) / 4 * 4; }

// What every pass of a deep scan needs: the call's tensors and shape, the
// workspace's buffers (in-group or flat ping-pong wa / wb, totals ta / tb)
// and the levels.
struct DeepArgs {
  const float* in;
  float* out;
  float* wa;
  float* wb;
  float* ta;
  float* tb;
  int K, R, levels, tlevels;
  long long n, G;  // G = 0: the flat form
  float* tmax;     // K > MAX_DEEP_K with nt > 1 tiles a side: each tile's max, nt^2 per matrix
  int nt;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A workspace matrix (rows of K4 floats) into an operand slot (rows of S
// floats), by the matrix's threads (lt = 0..MAT_THREADS - 1): 16-byte
// asynchronous copies through L2 (cp.async.cg; another SM wrote them), all
// in flight at once; the caller waits (cp_async_wait_all) and syncs.
template <int T>
__device__ __forceinline__ void deep_load(const float* src, float* slot, int K, int lt) {
  const int V = deep_row(K) / 4;
  for (int idx = lt; idx < K * V; idx += Deep<T>::MAT_THREADS)
    cp_async16(slot + (idx / V) * Deep<T>::S + 4 * (idx % V), src + 4 * idx);
}

// The identity as an earlier operand: the same K products as the plain
// version's identity matrix.
template <int T>
__device__ __forceinline__ void deep_eye(float* slot, int K, int lt) {
  for (int idx = lt; idx < K * K; idx += Deep<T>::MAT_THREADS)
    slot[(idx / K) * Deep<T>::S + idx % K] = idx / K == idx % K ? 1.0f : 0.0f;
}

// z = normalize(e @ x) for the thread's tile, e and x operand slots, red
// the matrix's MAT_WARPS maxima; every thread of the CTA calls it (live:
// whether this thread's matrix exists), so that the barrier is uniform.
// Returns with z divided.
template <int T>
__device__ __forceinline__ void deep_combine(const float* e, const float* x, float* red, int K,
                                             bool live, float (&z)[T][T]) {
  using D = Deep<T>;
  const int lt = threadIdx.x % D::MAT_THREADS, ti = lt / DEEP_SIDE, tk = lt % DEEP_SIDE;
  float m = -INFINITY;
  bool special = false;
  if (live) {
    const float* er = e + ti * D::S;
    const float* xc = x + tk;
    float ev[T], xv[T];
#pragma unroll
    for (int a = 0; a < T; ++a) ev[a] = er[a * DEEP_SIDE * D::S];
#pragma unroll
    for (int b = 0; b < T; ++b) xv[b] = xc[b * DEEP_SIDE];
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) z[a][b] = __fmul_rn(ev[a], xv[b]);
    }
#pragma unroll 2
    for (int j = 1; j < K; ++j) {
#pragma unroll
      for (int a = 0; a < T; ++a) ev[a] = er[a * DEEP_SIDE * D::S + j];
#pragma unroll
      for (int b = 0; b < T; ++b) xv[b] = xc[j * D::S + b * DEEP_SIDE];
#pragma unroll
      for (int a = 0; a < T; ++a) {
#pragma unroll
        for (int b = 0; b < T; ++b) z[a][b] = __fadd_rn(z[a][b], __fmul_rn(ev[a], xv[b]));
      }
    }
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) {
        if (ti + DEEP_SIDE * a < K && tk + DEEP_SIDE * b < K) {
          m = max_nan(m, z[a][b]);
          special |= !isfinite(z[a][b]);
        }
      }
    }
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off /= 2) m = max_nan(m, __shfl_xor_sync(FULL_MASK, m, off));
  const int mat = threadIdx.x / D::MAT_THREADS;
  if (threadIdx.x % WARP == 0) red[mat * D::MAT_WARPS + lt / WARP] = m;
  __syncthreads();
  if (!live) return;
  m = red[mat * D::MAT_WARPS];
#pragma unroll
  for (int w = 1; w < D::MAT_WARPS; ++w) m = max_nan(m, red[mat * D::MAT_WARPS + w]);
  m = clamp_scale(m);
  if (special || !isfinite(m)) {
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) z[a][b] = __fdiv_rn(z[a][b], m);
    }
    return;
  }
  const double md = m, y = __drcp_rn(md);
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) z[a][b] = wide_quotient(z[a][b], md, y);
  }
}

// The thread's valid entries of z into a workspace matrix (rows of K4).
template <int T>
__device__ __forceinline__ void deep_store(const float (&z)[T][T], float* dst, int K) {
  const int lt = threadIdx.x % Deep<T>::MAT_THREADS, ti = lt / DEEP_SIDE, tk = lt % DEEP_SIDE;
  const int K4 = deep_row(K);
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const int i = ti + DEEP_SIDE * a, k = tk + DEEP_SIDE * b;
      if (i < K && k < K) dst[i * K4 + k] = z[a][b];
    }
  }
}

// One pass over the workspace matrices g in [lo, hi), this CTA taking
// DEEP_MATS of them at a time (worker of workers): dst[g] =
// normalize(earlier(g) @ xs[g]), earlier(g) a workspace matrix or nullptr
// for the identity; where tot is given and g % seg == seg - 1 (a group's
// last matrix), also tot[g / seg].
template <int T, class Earlier>
__device__ __forceinline__ void deep_pass(const float* xs, float* dst, float* tot, long long seg,
                                          long long lo, long long hi, Earlier earlier, int K,
                                          int worker, int workers, float* smem) {
  using D = Deep<T>;
  const int mat = threadIdx.x / D::MAT_THREADS, lt = threadIdx.x % D::MAT_THREADS;
  float* es = smem + mat * 2 * D::SLOT;
  float* xslot = es + D::SLOT;
  float* red = smem + D::OPERANDS;
  const long long ms = (long long)K * deep_row(K);
  for (long long first = lo + (long long)worker * DEEP_MATS; first < hi;
       first += (long long)workers * DEEP_MATS) {
    const long long g = first + mat;
    const bool live = g < hi;
    __syncthreads();  // the slots' readers of the last step are done
    if (live) {
      const float* e = earlier(g);
      if (e != nullptr) {
        deep_load<T>(e, es, K, lt);
      } else {
        deep_eye<T>(es, K, lt);
      }
      deep_load<T>(xs + g * ms, xslot, K, lt);
    }
    cp_async_wait_all();
    __syncthreads();
    float z[T][T];
    deep_combine<T>(es, xslot, red, K, live, z);
    if (live) {
      deep_store<T>(z, dst + g * ms, K);
      if (tot != nullptr && g % seg == seg - 1) deep_store<T>(z, tot + g / seg * ms, K);
    }
  }
}

// Matrices [lo, hi) between the (K, K, R, n) layout (element e of matrix
// g at e * plane + g) and the workspace's (IN: into it), DEEP_TILE
// consecutive matrices and a band of their entries at a time through
// shared memory: `rows` whole rows where a row of DEEP_TILE matrices fits
// (ROOM entries: OPERANDS / (DEEP_TILE + 1) floats), else pieces of one
// row, `cols` columns wide (a multiple of 2 WARP; K > 535 at T = 8). A
// band's entries are consecutive in the (K, K) order (entry b = r nc + c of
// the band, nc its columns, matrix m at smem[b TS + m]): on the (K, K, R,
// n) side a warp per entry and a lane per matrix, on the workspace's a
// warp per row of a matrix and a lane per column (two pieces of 32 columns
// at a time), so every warp's access is one run of consecutive floats, and
// no index is divided per element. DEEP_BATCH loads in flight per thread
// (a loop of load-then-store would wait out the memory's latency once per
// element). D: the kernel's shape (THREADS, and OPERANDS floats of shared
// memory, at least (DEEP_TILE + 1) 2 WARP).
template <class D, bool IN>
__device__ __forceinline__ void deep_transpose(const float* src, float* dst, long long plane,
                                               long long lo, long long hi, int K, int worker,
                                               int workers, float* smem) {
  constexpr int WARPS_CTA = D::THREADS / WARP, TS = DEEP_TILE + 1, ROOM = D::OPERANDS / TS;
  static_assert(ROOM >= 2 * WARP, "a band of 2 WARP columns fits the operands");
  const int K4 = deep_row(K), rows = K <= ROOM ? ROOM / K : 1;
  const int cols = K <= ROOM ? K : ROOM / (2 * WARP) * (2 * WARP);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const long long ms = (long long)K * K4;
  for (long long g0 = lo + (long long)worker * DEEP_TILE; g0 < hi;
       g0 += (long long)workers * DEEP_TILE) {
    const int tile = hi - g0 < DEEP_TILE ? (int)(hi - g0) : DEEP_TILE;
    for (int i0 = 0; i0 < K; i0 += rows) {
      const int nr = K - i0 < rows ? K - i0 : rows;
      for (int c0 = 0; c0 < K; c0 += cols) {  // once, c0 = 0, where whole rows fit
        const int nc = K - c0 < cols ? K - c0 : cols, width = nr * nc, first = i0 * K + c0;
        const int pieces = (nc + 2 * WARP - 1) / (2 * WARP);
        __syncthreads();  // the last step's reads of smem are done
        if (IN) {  // a warp per entry b: in[(first + b) plane + g0 + lane]
          for (int e0 = warp; e0 < width; e0 += WARPS_CTA * DEEP_BATCH) {
            float v[DEEP_BATCH];
#pragma unroll
            for (int u = 0; u < DEEP_BATCH; ++u) {
              const int e = e0 + u * WARPS_CTA;
              if (e < width && lane < tile) v[u] = src[(first + e) * plane + g0 + lane];
            }
#pragma unroll
            for (int u = 0; u < DEEP_BATCH; ++u) {
              const int e = e0 + u * WARPS_CTA;
              if (e < width && lane < tile) smem[e * TS + lane] = v[u];
            }
          }
        } else {  // a warp per row r of matrix m: lanes over the band's columns
          for (int p0 = warp; p0 < tile * nr; p0 += WARPS_CTA * (DEEP_BATCH / 2)) {
            for (int q0 = 0; q0 < pieces * 2 * WARP; q0 += 2 * WARP) {
              float v[DEEP_BATCH / 2][2];
#pragma unroll
              for (int u = 0; u < DEEP_BATCH / 2; ++u) {
                const int p = p0 + u * WARPS_CTA, m = p / nr, r = p % nr;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int c = q0 + lane + h * WARP;
                  if (p < tile * nr && c < nc)
                    v[u][h] = __ldcg(src + (g0 + m) * ms + (i0 + r) * K4 + c0 + c);
                }
              }
#pragma unroll
              for (int u = 0; u < DEEP_BATCH / 2; ++u) {
                const int p = p0 + u * WARPS_CTA, m = p / nr, r = p % nr;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int c = q0 + lane + h * WARP;
                  if (p < tile * nr && c < nc) smem[(r * nc + c) * TS + m] = v[u][h];
                }
              }
            }
          }
        }
        __syncthreads();
        if (IN) {  // a warp per row r of matrix m
          for (int p = warp; p < tile * nr; p += WARPS_CTA) {
            const int m = p / nr, r = p % nr;
            for (int c = lane; c < nc; c += WARP)
              dst[(g0 + m) * ms + (i0 + r) * K4 + c0 + c] = smem[(r * nc + c) * TS + m];
          }
        } else {  // a warp per entry b
          for (int e = warp; e < width; e += WARPS_CTA)
            if (lane < tile) dst[(first + e) * plane + g0 + lane] = smem[e * TS + lane];
        }
      }
    }
  }
}

// The phases of the scan, in order; a flat call runs all but the totals'
// levels and the combine. (A mask, not tests of a.G: with those, ptxas
// spills at T = 6 and 8 and the scan takes 2-3 % longer at K = 48 and 64;
// fbscan_probes.py variants, an NVIDIA H100 80GB HBM3 at 700 W.)
enum DeepPhase { kDeepIn = 1, kDeepLevels = 2, kDeepTotals = 4, kDeepOut = 8 };

// The scan, one cooperative launch of Deep<T>::THREADS threads per CTA
// over every matrix, all CTAs resident, a grid-wide barrier after each
// phase and level: the transpose into wa; the in-group (flat: the row's)
// levels, wa and wb in turns, the last in-group level also writing each
// group's total to ta; for a grouped call the totals' levels, ta and tb in
// turns, and the broadcast combine of each matrix with its group's
// exclusive prefix into the other in-group buffer; the transpose of the
// result into out.
template <int T>
__global__ void __launch_bounds__(Deep<T>::THREADS, Deep<T>::MIN_BLOCKS)
fbscan_prefix_deep_kernel(DeepArgs a, int phases) {
  extern __shared__ __align__(16) float smem_deep[];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K, worker = (int)blockIdx.x, workers = (int)gridDim.x;
  const long long ms = (long long)K * deep_row(K), plane = (long long)a.R * a.n, hi = plane;
  const long long seg = a.G > 0 ? GROUP : a.n;
  float* inner = a.levels % 2 ? a.wb : a.wa;  // the levels' result
  const float* incl = a.tlevels % 2 ? a.tb : a.ta;
  float* result = a.G > 0 ? (inner == a.wa ? a.wb : a.wa) : inner;
  if (phases & kDeepIn) {
    deep_transpose<Deep<T>, true>(a.in, a.wa, plane, 0, hi, K, worker, workers, smem_deep);
    grid.sync();
  }
  if (phases & kDeepLevels) {
    float* src = a.wa;
    float* dst = a.wb;
    for (int level = 0; level < a.levels; ++level) {
      const long long d = 1LL << level;
      const float* s = src;
      deep_pass<T>(src, dst, a.G > 0 && level + 1 == a.levels ? a.ta : nullptr, seg, 0, hi,
                   [=](long long g) { return g % seg >= d ? s + (g - d) * ms : nullptr; }, K,
                   worker, workers, smem_deep);
      grid.sync();
      float* done = dst;
      dst = src;
      src = done;
    }
  }
  if (phases & kDeepTotals) {
    float* src = a.ta;
    float* dst = a.tb;
    const long long n = a.n, G = a.G;
    for (int level = 0; level < a.tlevels; ++level) {
      const long long d = 1LL << level;
      const float* s = src;
      deep_pass<T>(src, dst, nullptr, G, 0, a.R * G,
                   [=](long long g) { return g % G >= d ? s + (g - d) * ms : nullptr; }, K,
                   worker, workers, smem_deep);
      grid.sync();
      float* done = dst;
      dst = src;
      src = done;
    }
    deep_pass<T>(inner, result, nullptr, GROUP, 0, hi,
                 [=](long long g) {
                   const long long q = g % n / GROUP;
                   return q > 0 ? incl + (g / n * G + q - 1) * ms : nullptr;
                 },
                 K, worker, workers, smem_deep);
    grid.sync();
  }
  if (phases & kDeepOut)
    deep_transpose<Deep<T>, false>(result, a.out, plane, 0, hi, K, worker, workers, smem_deep);
}

// ------------------------------- prefix, K > 64: tiled products, j streamed

// Above K = 64 a combine no longer fits Deep's shape: its 8 x 8 threads a
// matrix would own 16 x 16 entries each at K = 128 (256 accumulators), and
// both whole operands take 2 x 128 x 132 floats, a CTA's shared memory for
// one matrix. So the product is cut into output tiles of at most
// TILED_MAX x TILED_MAX, nt = ceil(K / TILED_MAX) a side, each KP =
// TILED_SIDE T wide (T = ceil(K / (nt TILED_SIDE)): 5-8), one tile per
// CTA of TILED_SIDE^2 threads, thread (ti, tk) owning the T x T entries
// (ti + TILED_SIDE a, tk + TILED_SIDE b) of the tile (K padded to nt KP in
// i and k only). j is streamed through shared memory in slabs of
// TILED_SLAB: the slab's columns of e (the tile's rows, [i][j], rows SE
// floats apart, SE not a multiple of 32, so the two rows a warp reads lie
// in distinct banks) and rows of x (the tile's columns, [j][k]), 16-byte
// cp.async copies into one stage while the CTA multiplies the slab in the
// other.
// Each z[i][k] still adds its K terms in order: z = e[i][0] x[0][k], then
// j = 1 .. K - 1, slab after slab. With one tile a side (K <= 128) the CTA
// takes the matrix's max and divides as deep_combine does; with more, each
// tile writes z undivided and its max to the workspace (a max is exact in
// any order, NaN stays NaN, and clamp_scale removes the sign of a zero
// max), and after a grid-wide barrier a pass divides each matrix by
// clamp_scale of its tiles' max. The rest is the K = 33..64 scan's: one
// cooperative launch over the card, every level a pass over the
// matrix-major workspace, the transposes in and out (where a row of
// DEEP_TILE matrices no longer fits the stages, K > 469 at T = 7 and K >
// 535 at T = 8, in pieces of a row). No K is refused: T <= TILED_T_MAX at
// every K, and every offset of a matrix or an entry plane in a call's
// tensors is 64-bit (K^2 R n passes 2^31 from K = 625, B = 5,498).
#define TILED_SIDE 16    // threads per side of a tile's thread grid
#define TILED_MAX 128    // rows and columns of a tile at most
#define TILED_SLAB 32    // values of j per slab
#define TILED_T_MIN ((MAX_DEEP_K + TILED_SIDE) / TILED_SIDE)
#define TILED_T_MAX (TILED_MAX / TILED_SIDE)

template <int T>
struct Tiled {
  static constexpr int KP = TILED_SIDE * T;         // a tile's rows and columns
  static constexpr int SE = TILED_SLAB + 4;         // row stride of the e slab [i][j]
  static constexpr int SX = KP + 4;                 // row stride of the x slab [j][k]
  static constexpr int STAGE = KP * SE + TILED_SLAB * SX;  // floats of one slab of both
  static constexpr int THREADS = TILED_SIDE * TILED_SIDE;
  static constexpr int CTA_WARPS = THREADS / WARP;
  static constexpr int OPERANDS = 2 * STAGE;        // two stages, the transposes' room too
  static constexpr int TILE_FLOATS = OPERANDS + CTA_WARPS;  // dynamic shared memory: + the warps' maxima
  // CTAs per SM the registers leave room for: 128 registers a thread (the
  // T^2 entries of z, 2T operands, the pass's state). Three CTAs (85
  // registers) spilled more at T = 5 and 6 and took 11-12 % longer at K =
  // 81 and 96; one (255) took 4-13 % longer at K = 81-128
  // (fbscan_probes.py over64's variants, an NVIDIA H100 80GB HBM3 at 700 W)
  static constexpr int MIN_BLOCKS = 2;
  static_assert(SE % 4 == 0 && SE % 32 != 0 && SX % 4 == 0, "16-byte rows, the e stride");
  static_assert(WARP % TILED_SIDE == 0, "a warp holds whole rows ti of the thread grid");
};

// Slab j0 .. j0 + jn - 1 of the tile at (i0, k0) into a stage: e's rows
// i0 + r (r < rows), the slab's columns, as [r][SE] (the identity's entries
// where e is nullptr); x's rows of the slab, columns k0 + c (c < cols), as
// [jj][SX]. Workspace rows of K4 floats: 16-byte copies through L2, the
// last of a row reaching into the row's padding (never read as a term).
template <int T>
__device__ __forceinline__ void tiled_load(const float* e, const float* x, float* stage, int K4,
                                           int i0, int k0, int rows, int cols, int j0, int jn) {
  using D = Tiled<T>;
  constexpr int VE = TILED_SLAB / 4, VX = D::KP / 4;
  float* es = stage;
  float* xs = stage + D::KP * D::SE;
  if (e != nullptr) {
    const int ve = (jn + 3) / 4;
    for (int idx = threadIdx.x; idx < rows * VE; idx += D::THREADS) {
      const int r = idx / VE, v = idx % VE;
      if (v < ve) cp_async16(es + r * D::SE + 4 * v, e + (long long)(i0 + r) * K4 + j0 + 4 * v);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * TILED_SLAB; idx += D::THREADS) {
      const int r = idx / TILED_SLAB, c = idx % TILED_SLAB;
      if (c < jn) es[r * D::SE + c] = i0 + r == j0 + c ? 1.0f : 0.0f;
    }
  }
  const int vx = (cols + 3) / 4;
  for (int idx = threadIdx.x; idx < jn * VX; idx += D::THREADS) {
    const int r = idx / VX, v = idx % VX;
    if (v < vx) cp_async16(xs + r * D::SX + 4 * v, x + (long long)(j0 + r) * K4 + k0 + 4 * v);
  }
}

// z += the terms jj = jb .. jn - 1 of the slab in `stage`, for the
// thread's entries (ti, tk): 2T loads from shared memory a term for T^2
// multiply-adds.
template <int T>
__device__ __forceinline__ void tiled_terms(const float* stage, int jb, int jn, int ti, int tk,
                                            float (&z)[T][T]) {
  using D = Tiled<T>;
  const float* er = stage + ti * D::SE;
  const float* xc = stage + D::KP * D::SE + tk;
#pragma unroll 2
  for (int jj = jb; jj < jn; ++jj) {
    float ev[T], xv[T];
#pragma unroll
    for (int a = 0; a < T; ++a) ev[a] = er[a * TILED_SIDE * D::SE + jj];
#pragma unroll
    for (int b = 0; b < T; ++b) xv[b] = xc[jj * D::SX + b * TILED_SIDE];
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) z[a][b] = __fadd_rn(z[a][b], __fmul_rn(ev[a], xv[b]));
    }
  }
}

// A tile of a pass: the operands e (nullptr: the identity) and x, the
// tile's corner (i0, k0) in the product.
struct TiledOps {
  const float* e;
  const float* x;
  int i0, k0;
};

// Slab s of tile t into `stage` (tiled_load's copies; the caller commits).
template <int T>
__device__ __forceinline__ void tiled_slab(const TiledOps& t, int K, int s, float* stage) {
  constexpr int KP = Tiled<T>::KP;
  const int j0 = s * TILED_SLAB;
  tiled_load<T>(t.e, t.x, stage, deep_row(K), t.i0, t.k0, K - t.i0 < KP ? K - t.i0 : KP,
                K - t.k0 < KP ? K - t.k0 : KP, j0, K - j0 < TILED_SLAB ? K - j0 : TILED_SLAB);
}

// The thread's entries of z = e @ x, undivided, on tile `cur`, whose slab
// 0 the caller has committed into stage `parity`: slab s + 1 copied while
// s is multiplied, and during the last slab the next tile's slab 0 (where
// has_next) into the other stage, so that a CTA's copies run ahead of its
// products from one tile to the next (in turns against the same kernel
// without it: faster at K = 81, 96 and 160, a little slower at K = 128,
// where T = 8 leaves the fewest registers; an H100 80GB HBM3 at 700 W).
// Returns the stage of the next tile's slab 0. Every thread of the CTA
// calls it.
template <int T>
__device__ __forceinline__ int tiled_product(const TiledOps& cur, const TiledOps& next,
                                             bool has_next, int K, int parity, float* smem,
                                             float (&z)[T][T]) {
  using D = Tiled<T>;
  const int ti = threadIdx.x / TILED_SIDE, tk = threadIdx.x % TILED_SIDE;
  const int slabs = (K + TILED_SLAB - 1) / TILED_SLAB;
  for (int s = 0; s < slabs; ++s) {
    const int now = (parity + s) & 1;
    const int jn = K - s * TILED_SLAB < TILED_SLAB ? K - s * TILED_SLAB : TILED_SLAB;
    if (s + 1 < slabs || has_next) {
      tiled_slab<T>(s + 1 < slabs ? cur : next, K, s + 1 < slabs ? s + 1 : 0,
                    smem + (now ^ 1) * D::STAGE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s is in its stage
    const float* stage = smem + now * D::STAGE;
    if (s == 0) {  // term 0 sets z, as the plain version's first product
      const float* er = stage + ti * D::SE;
      const float* xc = stage + D::KP * D::SE + tk;
#pragma unroll
      for (int a = 0; a < T; ++a) {
#pragma unroll
        for (int b = 0; b < T; ++b)
          z[a][b] = __fmul_rn(er[a * TILED_SIDE * D::SE], xc[b * TILED_SIDE]);
      }
    }
    tiled_terms<T>(stage, s == 0 ? 1 : 0, jn, ti, tk, z);
    __syncthreads();  // slab s is read: its stage takes slab s + 2
  }
  return (parity + slabs) & 1;
}

// The thread's valid entries of z into a workspace matrix (rows of K4).
template <int T>
__device__ __forceinline__ void tiled_store(const float (&z)[T][T], float* dst, int K, int i0,
                                            int k0) {
  const int K4 = deep_row(K), ti = threadIdx.x / TILED_SIDE, tk = threadIdx.x % TILED_SIDE;
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const int i = i0 + ti + TILED_SIDE * a, k = k0 + tk + TILED_SIDE * b;
      if (i < K && k < K) dst[i * K4 + k] = z[a][b];
    }
  }
}

// z / m for a finite scale m (y = __drcp_rn(m)) as deep_combine divides:
// wide_quotient for a finite entry, __fdiv_rn for another (the same
// correctly rounded float32 quotient wherever both apply).
__device__ __forceinline__ float tiled_quotient(float z, float m, double md, double y, bool wide) {
  return wide && isfinite(z) ? wide_quotient(z, md, y) : __fdiv_rn(z, m);
}

// One pass over the workspace matrices g in [lo, hi), one tile of one
// matrix at a time (items w = (g - lo) nt^2 + t, this CTA taking worker,
// worker + workers, ...): dst[g] = normalize(earlier(g) @ xs[g]),
// earlier(g) a workspace matrix or nullptr for the identity; where tot is
// given and g % seg == seg - 1 (a group's last matrix), also tot[g / seg].
// With nt > 1 tiles a side, dst[g] is left undivided and tile t's max goes
// to tmax[g nt^2 + t]: tiled_divide finishes the pass after a grid-wide
// barrier.
template <int T, class Earlier>
__device__ __forceinline__ void tiled_pass(const float* xs, float* dst, float* tot, long long seg,
                                           long long lo, long long hi, Earlier earlier, int K,
                                           float* tmax, int nt, int worker, int workers,
                                           float* smem) {
  using D = Tiled<T>;
  const int ti = threadIdx.x / TILED_SIDE, tk = threadIdx.x % TILED_SIDE, nt2 = nt * nt;
  const long long ms = (long long)K * deep_row(K), items = (hi - lo) * nt2;
  float* red = smem + D::OPERANDS;
  auto tile = [&](long long w) {
    const long long g = lo + w / nt2;
    const int t = (int)(w % nt2);
    return TiledOps{earlier(g), xs + g * ms, t / nt * D::KP, t % nt * D::KP};
  };
  if (worker >= items) return;
  TiledOps cur = tile(worker);
  __syncthreads();  // the stages' last readers (a transpose) are done
  tiled_slab<T>(cur, K, 0, smem);
  cp_async_commit();
  int parity = 0;
  for (long long w = worker; w < items; w += workers) {
    const long long g = lo + w / nt2;
    const int t = (int)(w % nt2), i0 = cur.i0, k0 = cur.k0;
    const bool has_next = w + workers < items;
    const TiledOps next = has_next ? tile(w + workers) : cur;
    float z[T][T];
    parity = tiled_product<T>(cur, next, has_next, K, parity, smem, z);
    cur = next;
    float m = -INFINITY;
    bool special = false;
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) {
        if (i0 + ti + TILED_SIDE * a < K && k0 + tk + TILED_SIDE * b < K) {
          m = max_nan(m, z[a][b]);
          special |= !isfinite(z[a][b]);
        }
      }
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off /= 2) m = max_nan(m, __shfl_xor_sync(FULL_MASK, m, off));
    if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = m;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int v = 1; v < D::CTA_WARPS; ++v) m = max_nan(m, red[v]);
    if (nt > 1) {
      if (threadIdx.x == 0) tmax[g * nt2 + t] = m;
      tiled_store<T>(z, dst + g * ms, K, i0, k0);
      continue;
    }
    m = clamp_scale(m);
    const double md = m, y = __drcp_rn(md);
    const bool wide = !special && isfinite(m);
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = 0; b < T; ++b) z[a][b] = tiled_quotient(z[a][b], m, md, y, wide);
    }
    tiled_store<T>(z, dst + g * ms, K, i0, k0);
    if (tot != nullptr && g % seg == seg - 1) tiled_store<T>(z, tot + g / seg * ms, K, i0, k0);
  }
}

// The division that finishes a pass of nt > 1 tiles a side: each matrix g
// in [lo, hi) (a CTA each, in turn) divided in place by clamp_scale of its
// tiles' max, and copied to tot[g / seg] where tot is given and g % seg ==
// seg - 1. The rows' padding is divided too, and never read as a value.
template <int T>
__device__ __forceinline__ void tiled_divide(float* dst, float* tot, long long seg, long long lo,
                                             long long hi, int K, const float* tmax, int nt,
                                             int worker, int workers) {
  const long long ms = (long long)K * deep_row(K);
  const int nt2 = nt * nt, V = (int)(ms / 4);
  for (long long g = lo + worker; g < hi; g += workers) {
    float m = -INFINITY;
    for (int t = 0; t < nt2; ++t) m = max_nan(m, __ldcg(tmax + g * nt2 + t));
    m = clamp_scale(m);
    const double md = m, y = __drcp_rn(md);
    const bool wide = isfinite(m);
    float4* row = reinterpret_cast<float4*>(dst + g * ms);
    float4* copy = tot != nullptr && g % seg == seg - 1
                       ? reinterpret_cast<float4*>(tot + g / seg * ms) : nullptr;
    for (int v = threadIdx.x; v < V; v += Tiled<T>::THREADS) {
      float4 q = __ldcg(row + v);
      q.x = tiled_quotient(q.x, m, md, y, wide);
      q.y = tiled_quotient(q.y, m, md, y, wide);
      q.z = tiled_quotient(q.z, m, md, y, wide);
      q.w = tiled_quotient(q.w, m, md, y, wide);
      row[v] = q;
      if (copy != nullptr) copy[v] = q;
    }
  }
}

// The scan for K > MAX_DEEP_K: fbscan_prefix_deep_kernel's phases, with a
// tile of one matrix per CTA step and, at nt > 1, a division pass and a
// grid-wide barrier after each pass.
template <int T>
__global__ void __launch_bounds__(Tiled<T>::THREADS, Tiled<T>::MIN_BLOCKS)
fbscan_prefix_tiled_kernel(DeepArgs a, int phases) {
  extern __shared__ __align__(16) float smem_tiled[];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K, nt = a.nt, worker = (int)blockIdx.x, workers = (int)gridDim.x;
  const long long ms = (long long)K * deep_row(K), plane = (long long)a.R * a.n, hi = plane;
  const long long seg = a.G > 0 ? GROUP : a.n;
  float* inner = a.levels % 2 ? a.wb : a.wa;  // the levels' result
  const float* incl = a.tlevels % 2 ? a.tb : a.ta;
  float* result = a.G > 0 ? (inner == a.wa ? a.wb : a.wa) : inner;
  if (phases & kDeepIn) {
    deep_transpose<Tiled<T>, true>(a.in, a.wa, plane, 0, hi, K, worker, workers, smem_tiled);
    grid.sync();
  }
  if (phases & kDeepLevels) {
    float* src = a.wa;
    float* dst = a.wb;
    for (int level = 0; level < a.levels; ++level) {
      const long long d = 1LL << level;
      const float* s = src;
      float* tot = a.G > 0 && level + 1 == a.levels ? a.ta : nullptr;
      tiled_pass<T>(src, dst, tot, seg, 0, hi,
                    [=](long long g) { return g % seg >= d ? s + (g - d) * ms : nullptr; }, K,
                    a.tmax, nt, worker, workers, smem_tiled);
      grid.sync();
      if (nt > 1) {
        tiled_divide<T>(dst, tot, seg, 0, hi, K, a.tmax, nt, worker, workers);
        grid.sync();
      }
      float* done = dst;
      dst = src;
      src = done;
    }
  }
  if (phases & kDeepTotals) {
    float* src = a.ta;
    float* dst = a.tb;
    const long long n = a.n, G = a.G;
    for (int level = 0; level < a.tlevels; ++level) {
      const long long d = 1LL << level;
      const float* s = src;
      tiled_pass<T>(src, dst, nullptr, G, 0, a.R * G,
                    [=](long long g) { return g % G >= d ? s + (g - d) * ms : nullptr; }, K,
                    a.tmax, nt, worker, workers, smem_tiled);
      grid.sync();
      if (nt > 1) {
        tiled_divide<T>(dst, nullptr, G, 0, a.R * G, K, a.tmax, nt, worker, workers);
        grid.sync();
      }
      float* done = dst;
      dst = src;
      src = done;
    }
    tiled_pass<T>(inner, result, nullptr, GROUP, 0, hi,
                  [=](long long g) {
                    const long long q = g % n / GROUP;
                    return q > 0 ? incl + (g / n * G + q - 1) * ms : nullptr;
                  },
                  K, a.tmax, nt, worker, workers, smem_tiled);
    grid.sync();
    if (nt > 1) {
      tiled_divide<T>(result, nullptr, GROUP, 0, hi, K, a.tmax, nt, worker, workers);
      grid.sync();
    }
  }
  if (phases & kDeepOut)
    deep_transpose<Tiled<T>, false>(result, a.out, plane, 0, hi, K, worker, workers, smem_tiled);
}

// ---------------------------------------------------------------- suffix

// x[i] for a run-time i in [0, K) without indexing a register array (which
// would put it in local memory): a K-way select.
template <int K>
__device__ __forceinline__ int pick(const int* x, int i) {
  int v = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) v = i == k ? x[k] : v;
  return v;
}

// x[i[j]] for the K entries j of a thread's map x, i[j] in [0, K): a K-way
// select each (pick) up to MAX_TEAM_K; above, where the selects would cost
// 2 K^2 instructions, through the thread's own column of shared memory
// (sx: K * GROUP ints, column threadIdx.x; a lane per bank, and no barrier,
// since no other thread touches the column).
template <int K>
__device__ __forceinline__ void compose(const int* x, int* i, int* sx) {
  if constexpr (K > MAX_TEAM_K) {
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < K; ++j) sx[j * GROUP + t] = x[j];
#pragma unroll
    for (int j = 0; j < K; ++j) i[j] = sx[i[j] * GROUP + t];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) i[j] = pick<K>(x, i[j]);
  }
}

// The 7 in-group reverse Hillis-Steele levels, new_t[j] = x_t[x_{t+d}[j]]
// (x_t[j] past the group's end), thread t holding block t's map in x
// (K <= MAX_WIDE_K): at d < WARP the later operand comes from lane + d by
// __shfl_down_sync, and for the last d lanes of a warp from the first EDGE
// lanes of the warp after, which publish theirs in shared memory; at d = 32
// and 64 from shared memory. s: K * GROUP ints of shared memory, free on
// entry; sx: compose's columns (K > MAX_TEAM_K).
template <int K>
__device__ __forceinline__ void suffix_group_levels(int* x, int* s, int* sx) {
  const int t = threadIdx.x, lane = t % WARP, warp = t / WARP;
  int y[K];
#pragma unroll 1
  for (int level = 0; level < GROUP_LEVELS; ++level) {
    const int d = 1 << level;
    if (d < WARP) {
      int* edge = s + (level % 2) * K * WARPS * EDGE;  // [j][warp * EDGE + i]
      if (lane < EDGE) {
#pragma unroll
        for (int j = 0; j < K; ++j) edge[j * WARPS * EDGE + warp * EDGE + lane] = x[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < K; ++j) y[j] = __shfl_down_sync(FULL_MASK, x[j], d);
      if (lane >= WARP - d && warp < WARPS - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          y[j] = edge[j * WARPS * EDGE + (warp + 1) * EDGE + lane + d - WARP];
      }
    } else {
      __syncthreads();  // the level before has read its buffer
#pragma unroll
      for (int j = 0; j < K; ++j) s[j * GROUP + t] = x[j];
      __syncthreads();
      if (t + d < GROUP) {
#pragma unroll
        for (int j = 0; j < K; ++j) y[j] = s[j * GROUP + t + d];
      }
    }
    if (t + d >= GROUP) {
#pragma unroll
      for (int j = 0; j < K; ++j) y[j] = j;
    }
    compose<K>(x, y, sx);
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = y[j];
  }
}

// Reverse Hillis-Steele over m maps in shared memory (src, then dst: [j][g]
// with stride m), each past the end composed with the identity; the levels
// while d < m (composition is exact, so further identity levels change
// nothing). Returns the buffer that holds the result. Any K; S, the type
// the maps take in shared memory (int, or short for K <= 32,767).
template <class S>
__device__ __forceinline__ S* suffix_totals_levels(S* src, S* dst, int K, int m, int threads) {
  for (int d = 1; d < m; d <<= 1) {
    for (int g = threadIdx.x; g < m; g += threads) {
      for (int j = 0; j < K; ++j) {
        const int idx = g + d < m ? src[j * m + g + d] : j;
        dst[j * m + g] = src[idx * m + g];
      }
    }
    __syncthreads();
    S* done = dst;
    dst = src;
    src = done;
  }
  return src;
}

// The reverse scan of a row's totals at one position p alone, as
// prefix_totals_at: src holds the maps at p, p + 1, ..., the row's last as
// entries 0..n-1 ([j][k], stride `stride`), and each level composes entry
// 2k with entry 2k + 1 (later), the identity past the row's end. Returns
// the buffer whose entry 0 is the result. Any K.
__device__ __forceinline__ int* suffix_totals_at(int* src, int* dst, int K, int n, int stride) {
  while (n > 1) {
    const int half = (n + 1) / 2;
    for (int k = threadIdx.x; k < half; k += GROUP) {
      for (int j = 0; j < K; ++j) {
        const int idx = 2 * k + 1 < n ? src[j * stride + 2 * k + 1] : j;
        dst[j * stride + k] = src[idx * stride + 2 * k];
      }
    }
    __syncthreads();
    int* done = dst;
    dst = src;
    src = done;
    n = half;
  }
  return src;
}

// suffix_totals_at for a compile-time K (the team range): the K reads of
// an entry are issued together, not one after another.
template <int K>
__device__ __forceinline__ int* suffix_totals_at_k(int* src, int* dst, int n, int stride) {
  while (n > 1) {
    const int half = (n + 1) / 2;
    for (int k = threadIdx.x; k < half; k += GROUP) {
      int idx[K];
#pragma unroll
      for (int j = 0; j < K; ++j) idx[j] = 2 * k + 1 < n ? src[j * stride + 2 * k + 1] : j;
#pragma unroll
      for (int j = 0; j < K; ++j) dst[j * stride + k] = src[idx[j] * stride + 2 * k];
    }
    __syncthreads();
    int* done = dst;
    dst = src;
    src = done;
    n = half;
  }
  return src;
}

// suffix_totals_at_k in place, for K > MAX_WIDE_K (where a second copy of
// the totals would leave room for one CTA per SM): each pass of GROUP
// entries reads its operands into registers, a barrier, then writes entry
// k, below every entry that a later pass of the level reads (a pass reads
// entries 2k and 2k + 1 only). Returns s, whose entry 0 is the result.
template <int K>
__device__ __forceinline__ int* suffix_totals_in_place(int* s, int n, int stride) {
  while (n > 1) {
    const int half = (n + 1) / 2;
    for (int base = 0; base < half; base += GROUP) {
      const int k = base + threadIdx.x;
      int v[K];
      if (k < half) {
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] = 2 * k + 1 < n ? s[j * stride + 2 * k + 1] : j;
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] = s[v[j] * stride + 2 * k];
      }
      __syncthreads();
      if (k < half) {
#pragma unroll
        for (int j = 0; j < K; ++j) s[j * stride + k] = v[j];
      }
      __syncthreads();
    }
    n = half;
  }
  return s;
}

// Ints of a row's totals the one-launch suffix kernel keeps in shared
// memory per map entry: two copies of G (in place above MAX_WIDE_K), at
// least the in-group levels' GROUP.
__host__ __device__ constexpr long long suffix_room(int K, long long G) {
  return (K > MAX_WIDE_K ? G : 2 * G) > GROUP ? (K > MAX_WIDE_K ? G : 2 * G) : GROUP;
}

// The whole grouped suffix scan in one cooperative launch, K <= MAX_DEEP_K:
// grid (G, R) of GROUP threads, every CTA resident; tot holds (K, R, G)
// int64; dynamic shared memory K * suffix_room(K, G) ints, and K * GROUP
// more above MAX_TEAM_K (compose's columns).
template <int K>
__global__ void __launch_bounds__(GROUP, ONE_MIN_BLOCKS(K))
fbscan_suffix_one_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t* tot,
                         int R, long long n) {
  extern __shared__ int smem_i[];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, tplane = (long long)R * G;
  const long long off = r * n + q * GROUP + t;
  int* sx = smem_i + K * suffix_room(K, G);
  int x[K], after[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = (int)in[j * plane + off];
  suffix_group_levels<K>(x, smem_i, sx);
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) tot[j * tplane + r * G + q] = x[j];
  }
  cg::this_grid().sync();
  if (q + 1 < G) {  // the composition of the groups after q
    const int stride = (int)G, n_after = (int)(G - q - 1);
    const int64_t* next = tot + r * G + q + 1;
    for (int k = t; k < n_after; k += GROUP) {
#pragma unroll
      for (int j = 0; j < K; ++j) smem_i[j * stride + k] = (int)next[j * tplane + k];
    }
    __syncthreads();
    const int* at;
    if constexpr (K > MAX_WIDE_K) {
      at = suffix_totals_in_place<K>(smem_i, n_after, stride);
    } else if constexpr (K > MAX_REG_K) {
      at = suffix_totals_at_k<K>(smem_i, smem_i + K * stride, n_after, stride);
    } else {
      at = suffix_totals_at(smem_i, smem_i + K * stride, K, n_after, stride);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) after[j] = at[j * stride];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) after[j] = j;
  }
  compose<K>(x, after, sx);
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * plane + off] = after[j];
}

// The in-group levels with the group's maps in shared memory as S (two
// buffers of K * 128: int32 where they fit the card's opt-in shared memory,
// K <= 227; int16 above, K <= 454), any K.
template <class S>
__global__ void __launch_bounds__(GROUP)
fbscan_suffix_group_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ inner,
                                int64_t* __restrict__ tot, int K, int R, long long n) {
  extern __shared__ __align__(16) unsigned char smem_maps[];
  S* const maps = reinterpret_cast<S*>(smem_maps);
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  S* src = maps;
  for (int j = 0; j < K; ++j) src[j * GROUP + t] = (S)in[j * plane + off];
  __syncthreads();
  src = suffix_totals_levels<S>(src, maps + K * GROUP, K, GROUP, GROUP);
  for (int j = 0; j < K; ++j) inner[j * plane + off] = src[j * GROUP + t];
  if (t == 0) {
    const long long toff = (long long)blockIdx.y * G + q;
    for (int j = 0; j < K; ++j) tot[(long long)j * R * G + toff] = src[j * GROUP];
  }
}

// Reverse Hillis-Steele over each row's n maps: one CTA per row with the
// row in shared memory as S (two buffers of K * n: int32, or int16 where
// int32 would not fit, K > MAX_WIDE_K).
template <class S>
__global__ void __launch_bounds__(TOTALS_THREADS)
fbscan_suffix_rows_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int K,
                               int R, long long n) {
  extern __shared__ __align__(16) unsigned char smem_rows[];
  S* const maps = reinterpret_cast<S*>(smem_rows);
  const long long row = (long long)blockIdx.x * n, plane = (long long)R * n;
  const int m = (int)n;
  S* src = maps;
  for (int g = threadIdx.x; g < m; g += blockDim.x)
    for (int j = 0; j < K; ++j) src[j * m + g] = (S)in[j * plane + row + g];
  __syncthreads();
  src = suffix_totals_levels<S>(src, maps + K * m, K, m, blockDim.x);
  for (int g = threadIdx.x; g < m; g += blockDim.x)
    for (int j = 0; j < K; ++j) out[j * plane + row + g] = src[j * m + g];
}

// The same scan spread over the whole card, any K: a cooperative launch,
// a grid-wide barrier between levels, the prefix's buffer parity.
__global__ void __launch_bounds__(GRID_THREADS)
fbscan_suffix_rows_grid_kernel(const int64_t* in, int64_t* out, int64_t* spare, int K, int R,
                               long long n, int levels) {
  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)R * n;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  if (levels == 0) {
    for (long long at = first; at < plane; at += step)
      for (int j = 0; j < K; ++j) out[j * plane + at] = in[j * plane + at];
    return;
  }
  const int64_t* src = in;
  for (int level = 0; level < levels; ++level) {
    const long long d = 1LL << level;
    int64_t* dst = (levels - 1 - level) % 2 == 0 ? out : spare;
    for (long long at = first; at < plane; at += step) {
      const bool inside = at % n + d < n;
      for (int j = 0; j < K; ++j) {
        const int64_t idx = inside ? src[j * plane + at + d] : j;
        dst[j * plane + at] = src[idx * plane + at];
      }
    }
    grid.sync();
    src = dst;
  }
}

// out_b[j] = inner_b[after_q[j]], after_q the composition of the groups
// after q (the identity for the last group): grid (G, R), 128 threads.
__global__ void __launch_bounds__(GROUP)
fbscan_suffix_combine_kernel(const int64_t* __restrict__ inner, const int64_t* __restrict__ incl,
                             int64_t* __restrict__ out, int K, int R, long long n) {
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + threadIdx.x;
  const int64_t* after = incl + (long long)blockIdx.y * G + q + 1;
  const long long tplane = (long long)R * G;
  for (int j = 0; j < K; ++j) {
    const int64_t idx = q + 1 < G ? after[j * tplane] : j;
    out[j * plane + off] = inner[idx * plane + off];
  }
}

// ---------------------------------------------------------------- host

namespace {

// dynamic shared memory a launch may take without cudaFuncSetAttribute
constexpr long long SMEM_BYTES = 48 * 1024;

bool grouped(long long n) { return n > 2 * GROUP && n % GROUP == 0; }

int levels_of(long long n) {  // Hillis-Steele levels: the d = 2^l < n
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

bool bad_shape(int K, int R, long long n) {
  return K < 1 || R < 1 || R > 65535 || n < 1 || (long long)K * K > (1LL << 30);
}

// floats of one group total in the workspace: K * K, padded rows for the
// team and wide instances
long long total_floats(int K) {
  return K > MAX_REG_K && K <= MAX_WIDE_K ? (long long)K * ((K + 3) / 4 * 4) : (long long)K * K;
}

template <class T>
struct as_is {  // keeps a parameter out of template argument deduction
  using type = T;
};

// The opt-in shared memory of this card, bytes per CTA.
cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Raise a kernel's dynamic shared-memory limit to the card's where `smem`
// bytes need more than the default (the same value from every thread, so
// concurrent callers agree); cudaErrorInvalidValue where the card has less.
template <class F>
cudaError_t allow_smem(F kernel, long long smem) {
  if (smem <= SMEM_BYTES) return cudaSuccess;
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

// A cooperative launch of a grid-wide kernel that wants `want` CTAs of
// `threads` with `smem` bytes of dynamic shared memory: at most as many as
// the card holds at once for that shared memory (a grid-wide barrier needs
// every CTA resident). The arguments are converted to the kernel's
// parameter types.
template <class... A>
cudaError_t launch_grid_smem(void (*kernel)(A...), long long want, int threads, long long smem,
                             cudaStream_t s, typename as_is<A>::type... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (err != cudaSuccess) return err;
  const long long most = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(want < most ? want : most);
  void* argv[] = {&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads), argv,
                                     (size_t)smem, s);
}

// The same without dynamic shared memory (the grid-wide rows scans).
template <class... A>
cudaError_t launch_grid(void (*kernel)(A...), long long want, int threads, cudaStream_t s,
                        typename as_is<A>::type... args) {
  return launch_grid_smem(kernel, want, threads, 0, s, args...);
}

// One cooperative launch of a one-launch kernel on its (G, R) grid of
// `threads` with `smem` bytes of dynamic shared memory, if every CTA can be
// resident at once on this card (by occupancy, for that shared memory);
// *launched says whether it was made.
template <class... A>
cudaError_t launch_one_wave(void (*kernel)(A...), long long G, int R, int threads, long long smem,
                            cudaStream_t s, bool* launched, typename as_is<A>::type... args) {
  *launched = false;
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess || !coop || smem > optin || G * R > (long long)sms * 32) return err;
  err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (err != cudaSuccess || (long long)per_sm * sms < G * R) return err;
  *launched = true;
  void* argv[] = {&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)G, (unsigned)R),
                                     dim3(threads), argv, (size_t)smem, s);
}

// Hillis-Steele over the n matrices of each of R rows, in -> out, in the
// (K, K, R, n) layout; spare is the grid-wide kernel's second buffer.
template <int KT>
cudaError_t prefix_scan_rows(const float* in, float* out, float* spare, int R, long long n,
                             cudaStream_t s) {
  if constexpr (KT > MAX_REG_K) {
    const long long plane = (long long)R * n;
    return launch_grid(fbscan_prefix_team_rows_kernel<KT>,
                       (plane + ROWS_MATS(KT) - 1) / ROWS_MATS(KT), ROWS_THREADS(KT), s, in, out,
                       spare, R, n, levels_of(n), KT * plane, plane, 1);
  } else {
    const long long bytes = 2LL * KT * KT * n * (long long)sizeof(float);
    if (bytes <= SMEM_BYTES) {
      fbscan_prefix_rows_smem_kernel<KT><<<R, TOTALS_THREADS, bytes, s>>>(in, out, R, n,
                                                                          levels_of(n));
      return cudaGetLastError();
    }
    return launch_grid(fbscan_prefix_rows_grid_kernel<KT>,
                       ((long long)R * n + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, s, in,
                       out, spare, R, n, levels_of(n));
  }
}

// The inclusive scan of R rows of G padded group totals (tot -> incl; the
// buffer after incl is the spare), K = 9..32, over the card.
template <int KT>
cudaError_t prefix_team_totals(const float* tot, float* incl, int R, long long G,
                               cudaStream_t s) {
  using T = Team<KT>;
  return launch_grid(fbscan_prefix_team_rows_kernel<KT>,
                     (R * G + ROWS_MATS(KT) - 1) / ROWS_MATS(KT), ROWS_THREADS(KT), s, tot, incl,
                     incl + R * G * T::MS, R, G, levels_of(G), T::KP, 1, T::MS);
}

// The grouped prefix scan for K = 9..16 (teams): one launch where every
// group's CTA fits the card at once, else the team group kernel, the rows
// scan of the (padded) totals over the card, and the team combine kernel.
template <int KT>
cudaError_t prefix_team(const float* in, float* out, float* work, int R, long long n,
                        cudaStream_t s) {
  using T = Team<KT>;
  const long long G = n / GROUP;
  const long long one_smem =
      (team_room(G) * T::MS + GROUP * T::TPM + T::MS) * (long long)sizeof(float);
  bool launched = false;
  cudaError_t err =
      launch_one_wave(fbscan_prefix_team_one_kernel<KT>, G, R, T::THREADS, one_smem, s,
                      &launched, in, out, work, R, n, levels_of(G));
  if (err != cudaSuccess || launched) return err;
  float* inner = work;
  float* tot = inner + (long long)KT * KT * R * n;
  float* incl = tot + R * G * T::MS;
  const long long smem = T::GROUP_FLOATS * (long long)sizeof(float);
  err = allow_smem(fbscan_prefix_team_group_kernel<KT>, smem);
  if (err == cudaSuccess) err = allow_smem(fbscan_prefix_team_combine_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)G, (unsigned)R);
  fbscan_prefix_team_group_kernel<KT><<<grid, T::THREADS, smem, s>>>(in, inner, tot, R, n);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = prefix_team_totals<KT>(tot, incl, R, G, s);
  if (err != cudaSuccess) return err;
  fbscan_prefix_team_combine_kernel<KT><<<grid, T::THREADS, smem, s>>>(inner, incl, out, R,
                                                                             n);
  return cudaGetLastError();
}

// The grouped prefix scan for K = 17..32: the wide group kernel (a cluster
// per group), the rows scan of the (padded) totals over the card, and the
// team combine kernel, a CTA per M blocks. Three launches at every shape.
template <int KT>
cudaError_t prefix_wide(const float* in, float* out, float* work, int R, long long n,
                        cudaStream_t s) {
  using T = Team<KT>;
  const long long G = n / GROUP;
  float* inner = work;
  float* tot = inner + (long long)KT * KT * R * n;
  float* incl = tot + R * G * T::MS;
  const long long smem = T::GROUP_FLOATS * (long long)sizeof(float);
  const long long group_smem = smem + T::M * T::MS * (long long)sizeof(float);
  cudaError_t err = allow_smem(fbscan_prefix_wide_group_kernel<KT>, group_smem);
  if (err == cudaSuccess) err = allow_smem(fbscan_prefix_team_combine_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(G * T::CL), (unsigned)R);
  fbscan_prefix_wide_group_kernel<KT><<<grid, T::THREADS, group_smem, s>>>(in, inner, tot, R, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = prefix_team_totals<KT>(tot, incl, R, G, s);
  if (err != cudaSuccess) return err;
  fbscan_prefix_team_combine_kernel<KT><<<grid, T::THREADS, smem, s>>>(inner, incl, out, R, n);
  return cudaGetLastError();
}

// The prefix scan for K = 33..64 (tiled products, T = ceil(K / DEEP_SIDE)):
// one cooperative launch of every phase, grouped or flat. Workspace: two
// buffers of R n matrices (rows of K4 floats), and two of R G for the
// totals.
template <int TT>
cudaError_t prefix_deep(const float* in, float* out, float* work, int K, int R, long long n,
                        cudaStream_t s) {
  using D = Deep<TT>;
  const bool grp = grouped(n);
  const long long G = grp ? n / GROUP : 0, ms = (long long)K * deep_row(K), total = (long long)R * n;
  float* wb = work + total * ms;
  float* ta = wb + total * ms;
  const DeepArgs a{in, out, work, wb, ta, ta + R * G * ms, K, R,
                   grp ? GROUP_LEVELS : levels_of(n), grp ? levels_of(G) : 0, n, G};
  const int phases = kDeepIn | kDeepLevels | (grp ? kDeepTotals : 0) | kDeepOut;
  return launch_grid_smem(fbscan_prefix_deep_kernel<TT>, (total + DEEP_MATS - 1) / DEEP_MATS,
                          D::THREADS, D::SMEM_FLOATS * (long long)sizeof(float), s, a, phases);
}

// prefix_deep<T> for the run-time K = k, the least tile T >= TT with
// DEEP_SIDE T >= k.
template <int TT>
cudaError_t prefix_deep_at(int k, const float* in, float* out, float* work, int R, long long n,
                           cudaStream_t s) {
  if constexpr (TT >= DEEP_T_MAX) {
    return prefix_deep<TT>(in, out, work, k, R, n, s);
  } else {
    return k <= DEEP_SIDE * TT ? prefix_deep<TT>(in, out, work, k, R, n, s)
                               : prefix_deep_at<TT + 1>(k, in, out, work, R, n, s);
  }
}

// The prefix scan for K > MAX_DEEP_K (tiled products, j streamed, T =
// ceil(K / (nt TILED_SIDE)) <= TILED_T_MAX, nt = ceil(K / TILED_MAX)): one
// cooperative launch of every phase, grouped or flat. Workspace: as
// prefix_deep's, and with nt > 1 the tiles' maxima (nt^2 R n floats).
template <int TT>
cudaError_t prefix_tiled(const float* in, float* out, float* work, int K, int R, long long n,
                         cudaStream_t s) {
  using D = Tiled<TT>;
  const bool grp = grouped(n);
  const long long G = grp ? n / GROUP : 0, ms = (long long)K * deep_row(K), total = (long long)R * n;
  const int nt = (K + TILED_MAX - 1) / TILED_MAX;
  float* wb = work + total * ms;
  float* ta = wb + total * ms;
  float* tb = ta + R * G * ms;
  const DeepArgs a{in, out, work, wb, ta, tb, K, R, grp ? GROUP_LEVELS : levels_of(n),
                   grp ? levels_of(G) : 0, n, G, tb + R * G * ms, nt};
  const int phases = kDeepIn | kDeepLevels | (grp ? kDeepTotals : 0) | kDeepOut;
  return launch_grid_smem(fbscan_prefix_tiled_kernel<TT>, total * nt * nt, D::THREADS,
                          D::TILE_FLOATS * (long long)sizeof(float), s, a, phases);
}

// prefix_tiled<T> for the run-time K = k, T = ceil(k / (nt TILED_SIDE)) >=
// TT.
template <int TT>
cudaError_t prefix_tiled_at(int k, const float* in, float* out, float* work, int R, long long n,
                            cudaStream_t s) {
  if constexpr (TT >= TILED_T_MAX) {
    return prefix_tiled<TT>(in, out, work, k, R, n, s);
  } else {
    const int nt = (k + TILED_MAX - 1) / TILED_MAX;
    return k <= nt * TILED_SIDE * TT ? prefix_tiled<TT>(in, out, work, k, R, n, s)
                                     : prefix_tiled_at<TT + 1>(k, in, out, work, R, n, s);
  }
}

// Workspace layout of a grouped prefix call: the in-group scan (K, K, R, n)
// then three buffers of R * G totals: totals, their inclusive scan, spare
// (the one-launch forms take the first buffer for their totals).
// KT = K <= MAX_REG_K, in registers; MAX_REG_K < K <= MAX_TEAM_K, teams;
// MAX_TEAM_K < K <= MAX_WIDE_K, clusters.
template <int KT>
cudaError_t prefix(const float* in, float* out, float* work, int R, long long n, cudaStream_t s) {
  if (!grouped(n)) return prefix_scan_rows<KT>(in, out, work, R, n, s);
  if constexpr (KT > MAX_TEAM_K) {
    return prefix_wide<KT>(in, out, work, R, n, s);
  } else if constexpr (KT > MAX_REG_K) {
    return prefix_team<KT>(in, out, work, R, n, s);
  } else {
    const long long G = n / GROUP, m = (long long)KT * KT * R;
    const long long floats = KT * KT * (2 * G > GROUP ? 2 * G : GROUP);
    bool launched = false;
    cudaError_t err = launch_one_wave(fbscan_prefix_one_kernel<KT>, G, R, GROUP,
                                      floats * (long long)sizeof(float), s, &launched, in, out,
                                      work, R, n, levels_of(G));
    if (err != cudaSuccess || launched) return err;
    float* inner = work;
    float* tot = inner + m * n;
    float* incl = tot + m * G;
    const dim3 grid((unsigned)G, (unsigned)R);
    fbscan_prefix_group_kernel<KT><<<grid, GROUP, 0, s>>>(in, inner, tot, R, n);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = prefix_scan_rows<KT>(tot, incl, incl + m * G, R, G, s);
    if (err != cudaSuccess) return err;
    fbscan_prefix_combine_kernel<KT><<<grid, GROUP, 0, s>>>(inner, incl, out, R, n);
    return cudaGetLastError();
  }
}

// Reverse Hillis-Steele over the n maps of each of R rows, in -> out: one
// CTA per row where two copies fit its shared memory (above MAX_WIDE_K up to
// the card's opt-in limit, as int16 where int32 would not fit; else 48 KB),
// else over the card.
cudaError_t suffix_scan_rows(const int64_t* in, int64_t* out, int64_t* spare, int K, int R,
                             long long n, cudaStream_t s) {
  const long long bytes = 2LL * K * n * (long long)sizeof(int);
  int optin = 0;
  if (K > MAX_WIDE_K) {
    const cudaError_t err = smem_optin(&optin);
    if (err != cudaSuccess) return err;
  }
  if (bytes <= SMEM_BYTES || bytes <= optin) {
    const cudaError_t err = allow_smem(fbscan_suffix_rows_smem_kernel<int>, bytes);
    if (err != cudaSuccess) return err;
    fbscan_suffix_rows_smem_kernel<int><<<R, TOTALS_THREADS, bytes, s>>>(in, out, K, R, n);
    return cudaGetLastError();
  }
  if (bytes / 2 <= optin && K <= 32767) {
    const cudaError_t err = allow_smem(fbscan_suffix_rows_smem_kernel<short>, bytes / 2);
    if (err != cudaSuccess) return err;
    fbscan_suffix_rows_smem_kernel<short><<<R, TOTALS_THREADS, bytes / 2, s>>>(in, out, K, R, n);
    return cudaGetLastError();
  }
  return launch_grid(fbscan_suffix_rows_grid_kernel,
                     ((long long)R * n + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, s, in,
                     out, spare, K, R, n, levels_of(n));
}

// prefix<K> for the run-time K = k, K = KT..MAX_WIDE_K; the tiled
// products above: Deep's up to MAX_DEEP_K, Tiled's beyond.
template <int KT>
cudaError_t prefix_at(int k, const float* in, float* out, float* work, int R, long long n,
                      cudaStream_t s) {
  if constexpr (KT > MAX_WIDE_K) {
    return k <= MAX_DEEP_K ? prefix_deep_at<DEEP_T_MIN>(k, in, out, work, R, n, s)
                           : prefix_tiled_at<TILED_T_MIN>(k, in, out, work, R, n, s);
  } else {
    return k == KT ? prefix<KT>(in, out, work, R, n, s)
                   : prefix_at<KT + 1>(k, in, out, work, R, n, s);
  }
}

// The one-launch suffix for K <= MAX_DEEP_K where it fits the card.
template <int KT>
cudaError_t suffix_one(const int64_t* in, int64_t* out, int64_t* work, int R, long long n,
                       cudaStream_t s, bool* launched) {
  const long long G = n / GROUP;
  const long long ints = suffix_room(KT, G) + (KT > MAX_TEAM_K ? GROUP : 0);
  return launch_one_wave(fbscan_suffix_one_kernel<KT>, G, R, GROUP,
                         KT * ints * (long long)sizeof(int), s, launched, in, out, work, R, n);
}

// suffix_one<K> for the run-time K = k, K = KT..MAX_DEEP_K; none above
// (*launched stays false).
template <int KT>
cudaError_t suffix_at(int k, const int64_t* in, int64_t* out, int64_t* work, int R, long long n,
                      cudaStream_t s, bool* launched) {
  if constexpr (KT > MAX_DEEP_K) {
    *launched = false;
    return cudaSuccess;
  } else {
    return k == KT ? suffix_one<KT>(in, out, work, R, n, s, launched)
                   : suffix_at<KT + 1>(k, in, out, work, R, n, s, launched);
  }
}

}  // namespace

// Elements of float32 workspace a prefix call needs: grouped, the in-group
// scan (K * K * R * n) and three buffers of R * G totals (padded matrices
// for K = 9..32); flat, one (K, K, R, n) ping-pong buffer. K > 32: two
// buffers of R * n matrices of K rows of K4 floats, (grouped) two of R *
// G, and above TILED_MAX the tiles' maxima, nt^2 per matrix.
extern "C" long long hammlet_fbscan_prefix_workspace(int K, int R, long long n) {
  const long long m = (long long)K * K * R;
  if (K > MAX_WIDE_K) {
    const long long ms = (long long)K * deep_row(K), nt = (K + TILED_MAX - 1) / TILED_MAX;
    return 2 * ms * R * n + (grouped(n) ? 2 * ms * R * (n / GROUP) : 0) +
           (nt > 1 ? nt * nt * R * n : 0);
  }
  return grouped(n) ? m * n + 3 * total_floats(K) * R * (n / GROUP) : m * n;
}

extern "C" int hammlet_fbscan_prefix(const float* in, float* out, float* work, int K, int R,
                                     long long n, int device, void* stream) {
  if (bad_shape(K, R, n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)prefix_at<1>(K, in, out, work, R, n, s);
}

// Elements of int64 workspace a suffix call needs: grouped, one (K, R, n)
// buffer and three (K, R, G); flat, one (K, R, n).
extern "C" long long hammlet_fbscan_suffix_workspace(int K, int R, long long n) {
  const long long m = (long long)K * R;
  return grouped(n) ? m * n + 3 * m * (n / GROUP) : m * n;
}

extern "C" int hammlet_fbscan_suffix(const int64_t* in, int64_t* out, int64_t* work, int K,
                                     int R, long long n, int device, void* stream) {
  if (bad_shape(K, R, n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!grouped(n)) return (int)suffix_scan_rows(in, out, work, K, R, n, s);
  bool launched = false;
  err = suffix_at<1>(K, in, out, work, R, n, s, &launched);
  int optin = 0;
  if (err == cudaSuccess && !launched) err = smem_optin(&optin);
  if (err != cudaSuccess || launched) return (int)err;
  // the group kernel with two copies of a group's maps in shared memory as
  // int32 where they fit, else as int16; above K = 454 the rows scan over
  // the whole input (exact, so the same maps as the grouped form)
  const long long bytes32 = 2LL * K * GROUP * (long long)sizeof(int),
                  bytes16 = 2LL * K * GROUP * (long long)sizeof(short);
  if (bytes16 > optin || K > 32767) return (int)suffix_scan_rows(in, out, work, K, R, n, s);
  const long long G = n / GROUP, m = (long long)K * R;
  int64_t* inner = work;
  int64_t* tot = inner + m * n;
  int64_t* incl = tot + m * G;
  const dim3 grid((unsigned)G, (unsigned)R);
  if (bytes32 <= optin) {
    err = allow_smem(fbscan_suffix_group_smem_kernel<int>, bytes32);
    if (err != cudaSuccess) return (int)err;
    fbscan_suffix_group_smem_kernel<int><<<grid, GROUP, bytes32, s>>>(in, inner, tot, K, R, n);
  } else {
    err = allow_smem(fbscan_suffix_group_smem_kernel<short>, bytes16);
    if (err != cudaSuccess) return (int)err;
    fbscan_suffix_group_smem_kernel<short><<<grid, GROUP, bytes16, s>>>(in, inner, tot, K, R, n);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) err = suffix_scan_rows(tot, incl, incl + m * G, K, R, G, s);
  if (err != cudaSuccess) return (int)err;
  fbscan_suffix_combine_kernel<<<grid, GROUP, 0, s>>>(inner, incl, out, K, R, n);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
