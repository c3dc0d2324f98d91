// The two associative scans of the Forward-Backward sampler for NVIDIA
// Hopper (sm_90a): inclusive prefix products of K x K block matrices, and
// suffix compositions of index maps. One launch per call wherever all of a
// call's groups can be resident at once (the main path's shapes), three
// beyond that.
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
//
// Grouped form (n > 256 and n % 128 == 0, G = n / 128 groups per row):
//   *_one_kernel (K <= MAX_REG_K, when the (G, R) grid of 128-thread CTAs
//   fits the card at once; the host decides by occupancy, with the dynamic
//   shared memory the launch really takes, before the launch): one
//   cooperative launch. Each CTA takes its group into registers, one block
//   per thread, and runs the 7 in-group Hillis-Steele levels there: at
//   d < 32 a thread's operand comes from its own warp by shuffle, and the
//   first d lanes of a warp take theirs from the last 16 lanes of the warp
//   before, which publish them in shared memory (one barrier per level); at
//   d = 32 and 64 every operand goes through shared memory. The group's
//   total goes to device memory, the in-group result stays in registers.
//   A grid-wide barrier; then each CTA computes the scan of its row's
//   totals at the one position it needs (before its group for the prefix,
//   after it for the suffix) in shared memory: level l of the row's scan
//   touches that position's value only through the values 2^l apart, so
//   each level halves the values kept, with the same combines as the full
//   scan (and all of its levels); no second barrier. Last, each block is
//   combined with its group's exclusive prefix (composition of the groups
//   after it) and written once.
//   Three launches otherwise (a row beyond one resident wave: 3,390 groups
//   at T = 250M per shard; K > 8):
//   *_group_kernel: the in-group levels as above (the prefix; the suffix's
//     group kernel keeps the maps in shared memory as int32, K <= 48), the
//     in-group scan and each group's total to device memory;
//   rows scan of the totals: one CTA of 1024 threads per row where two
//     copies of a row fit in 48 KB of shared memory, else one cooperative
//     launch spread over the whole card, a grid-wide barrier between
//     levels, ping-ponging through device scratch;
//   *_combine_kernel: each block's in-group scan with its group's
//     exclusive prefix.
// Flat form (n <= 256 or n % 128 != 0, where the JAX package is flat too):
// the rows scan alone, on the input, in one CTA per row or over the whole
// card as above (a flat n reaches T when the capacity is clipped to it).
// A suffix whose group does not fit in shared memory (K > 48) takes the
// flat form over the whole card: composition is exact, so its association
// does not change the result.
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
// the generic kernels write the last in-group level into `inner`
static_assert(GROUP_LEVELS % 2 == 1, "levels 0, 2, ..., GROUP_LEVELS - 1 write inner");

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

// The same for any K, in device memory, dividing by warp: element (i, k)
// of x at x[(i * K + k) * stride], of z likewise; z is written, then
// rescaled in place by the thread that wrote it.
template <class E>
__device__ __forceinline__ void combine_mem(int K, E e, const float* x, long long stride,
                                            float* z) {
  float m = -INFINITY;
  bool special = false, awkward = false;
  for (int i = 0; i < K; ++i) {
    for (int k = 0; k < K; ++k) {
      float acc = __fmul_rn(e(i, 0), x[(long long)k * stride]);
      for (int j = 1; j < K; ++j)
        acc = __fadd_rn(acc, __fmul_rn(e(i, j), x[(long long)(j * K + k) * stride]));
      z[(long long)(i * K + k) * stride] = acc;
      m = max_nan(m, acc);
      special |= !isfinite(acc);
      awkward |= !comfortable(acc);
    }
  }
  m = clamp_scale(m);  // then as rescale
  if (!__any_sync(__activemask(), awkward) || special) {
    for (int q = 0; q < K * K; ++q) {
      const long long at = (long long)q * stride;
      z[at] = __fdiv_rn(z[at], m);
    }
    return;
  }
  const double md = m, y = __drcp_rn(md);
  for (int q = 0; q < K * K; ++q) {
    const long long at = (long long)q * stride;
    z[at] = wide_quotient(z[at], md, y);
  }
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

// In-group levels, any K: levels 0, 2, 4, 6 write inner, 1, 3, 5 spare.
__global__ void __launch_bounds__(GROUP)
fbscan_prefix_group_any_kernel(const float* in, float* inner, float* spare, float* tot, int K,
                               int R, long long n) {
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  const float* src = in;
  for (int level = 0; level < GROUP_LEVELS; ++level) {
    const int d = 1 << level;
    float* dst = level % 2 == 0 ? inner : spare;
    if (t >= d) {
      const float* prev = src + off - d;
      combine_mem(K, [&](int i, int j) { return prev[(long long)(i * K + j) * plane]; },
                  src + off, plane, dst + off);
    } else {
      combine_mem(K, Eye(), src + off, plane, dst + off);
    }
    __syncthreads();
    src = dst;
  }
  if (t == GROUP - 1) {
    const long long toff = (long long)blockIdx.y * G + q;
    for (int e = 0; e < K * K; ++e) tot[(long long)e * R * G + toff] = inner[e * plane + off];
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
// so the last writes out. K = 0: any K (Kr), combined in device memory;
// else K <= MAX_REG_K, in registers.
template <int K>
__global__ void __launch_bounds__(GRID_THREADS)
fbscan_prefix_rows_grid_kernel(const float* in, float* out, float* spare, int Kr, int R,
                               long long n, int levels) {
  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)R * n;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const int KK = K > 0 ? K * K : Kr * Kr;
  if (levels == 0) {
    for (long long at = first; at < plane; at += step)
      for (int e = 0; e < KK; ++e) out[e * plane + at] = in[e * plane + at];
    return;
  }
  const float* src = in;
  for (int level = 0; level < levels; ++level) {
    const long long d = 1LL << level;
    float* dst = (levels - 1 - level) % 2 == 0 ? out : spare;
    for (long long at = first; at < plane; at += step) {
      const bool later = at % n >= d;
      if constexpr (K > 0) {
        float x[K * K], z[K * K];
#pragma unroll
        for (int e = 0; e < K * K; ++e) x[e] = src[e * plane + at];
        if (later) {
          combine_reg<K, kByWarp>(
              [&](int i, int j) { return src[(i * K + j) * plane + at - d]; }, Regs<K>{x}, z);
        } else {
          combine_reg<K, kByWarp>(Eye(), Regs<K>{x}, z);
        }
#pragma unroll
        for (int e = 0; e < K * K; ++e) dst[e * plane + at] = z[e];
      } else {
        if (later) {
          const float* prev = src + at - d;
          combine_mem(Kr, [&](int i, int j) { return prev[(long long)(i * Kr + j) * plane]; },
                      src + at, plane, dst + at);
        } else {
          combine_mem(Kr, Eye(), src + at, plane, dst + at);
        }
      }
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

__global__ void __launch_bounds__(GROUP)
fbscan_prefix_combine_any_kernel(const float* inner, const float* incl, float* out, int K, int R,
                                 long long n) {
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + threadIdx.x;
  if (q > 0) {
    const float* pre = incl + (long long)blockIdx.y * G + q - 1;
    const long long tplane = (long long)R * G;
    combine_mem(K, [&](int i, int j) { return pre[(long long)(i * K + j) * tplane]; },
                inner + off, plane, out + off);
  } else {
    combine_mem(K, Eye(), inner + off, plane, out + off);
  }
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

// The 7 in-group reverse Hillis-Steele levels, new_t[j] = x_t[x_{t+d}[j]]
// (x_t[j] past the group's end), thread t holding block t's map in x
// (K <= MAX_REG_K): at d < WARP the later operand comes from lane + d by
// __shfl_down_sync, and for the last d lanes of a warp from the first EDGE
// lanes of the warp after, which publish theirs in shared memory; at d = 32
// and 64 from shared memory. s: K * GROUP ints of shared memory, free on
// entry.
template <int K>
__device__ __forceinline__ void suffix_group_levels(int* x, int* s) {
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
#pragma unroll
    for (int j = 0; j < K; ++j) y[j] = pick<K>(x, y[j]);
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = y[j];
  }
}

// Reverse Hillis-Steele over m maps in shared memory (src, then dst: [j][g]
// with stride m), each past the end composed with the identity; the levels
// while d < m (composition is exact, so further identity levels change
// nothing). Returns the buffer that holds the result. Any K.
__device__ __forceinline__ int* suffix_totals_levels(int* src, int* dst, int K, int m,
                                                     int threads) {
  for (int d = 1; d < m; d <<= 1) {
    for (int g = threadIdx.x; g < m; g += threads) {
      for (int j = 0; j < K; ++j) {
        const int idx = g + d < m ? src[j * m + g + d] : j;
        dst[j * m + g] = src[idx * m + g];
      }
    }
    __syncthreads();
    int* done = dst;
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

// The whole grouped suffix scan in one cooperative launch, K <= MAX_REG_K:
// grid (G, R) of GROUP threads, every CTA resident; tot holds (K, R, G)
// int64; dynamic shared memory max(K * GROUP, 2 * K * G) ints.
template <int K>
__global__ void __launch_bounds__(GROUP, ONE_MIN_BLOCKS(K))
fbscan_suffix_one_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t* tot,
                         int R, long long n) {
  extern __shared__ int smem_i[];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, r = blockIdx.y, G = n / GROUP;
  const long long plane = (long long)R * n, tplane = (long long)R * G;
  const long long off = r * n + q * GROUP + t;
  int x[K], after[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = (int)in[j * plane + off];
  suffix_group_levels<K>(x, smem_i);
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
    const int* at = suffix_totals_at(smem_i, smem_i + K * stride, K, n_after, stride);
#pragma unroll
    for (int j = 0; j < K; ++j) after[j] = at[j * stride];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) after[j] = j;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * plane + off] = pick<K>(x, after[j]);
}

// The in-group levels with the group's maps in shared memory as int32 (two
// buffers of K * 128 within SMEM_BYTES), any K.
__global__ void __launch_bounds__(GROUP)
fbscan_suffix_group_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ inner,
                                int64_t* __restrict__ tot, int K, int R, long long n) {
  extern __shared__ int smem_i[];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  int* src = smem_i;
  for (int j = 0; j < K; ++j) src[j * GROUP + t] = (int)in[j * plane + off];
  __syncthreads();
  src = suffix_totals_levels(src, smem_i + K * GROUP, K, GROUP, GROUP);
  for (int j = 0; j < K; ++j) inner[j * plane + off] = src[j * GROUP + t];
  if (t == 0) {
    const long long toff = (long long)blockIdx.y * G + q;
    for (int j = 0; j < K; ++j) tot[(long long)j * R * G + toff] = src[j * GROUP];
  }
}

// Reverse Hillis-Steele over each row's n maps: one CTA per row with the
// row in shared memory as int32 (two buffers of K * n within SMEM_BYTES).
__global__ void __launch_bounds__(TOTALS_THREADS)
fbscan_suffix_rows_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int K,
                               int R, long long n) {
  extern __shared__ int smem_i[];
  const long long row = (long long)blockIdx.x * n, plane = (long long)R * n;
  const int m = (int)n;
  int* src = smem_i;
  for (int g = threadIdx.x; g < m; g += blockDim.x)
    for (int j = 0; j < K; ++j) src[j * m + g] = (int)in[j * plane + row + g];
  __syncthreads();
  src = suffix_totals_levels(src, smem_i + K * m, K, m, blockDim.x);
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

template <class T>
struct as_is {  // keeps a parameter out of template argument deduction
  using type = T;
};

// A cooperative launch of a grid-wide rows scan over `work` elements per
// plane: as many CTAs of GRID_THREADS as the work needs, at most as many
// as the card holds at once (a grid-wide barrier needs every CTA
// resident). The arguments are converted to the kernel's parameter types.
template <class... A>
cudaError_t launch_grid(void (*kernel)(A...), long long work, cudaStream_t s,
                        typename as_is<A>::type... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GRID_THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long want = (work + GRID_THREADS - 1) / GRID_THREADS;
  const long long most = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(want < most ? want : most);
  void* argv[] = {&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(GRID_THREADS), argv,
                                     0, s);
}

// One cooperative launch of a one-launch kernel on its (G, R) grid of GROUP
// threads with `smem` bytes of dynamic shared memory, if every CTA can be
// resident at once on this card (by occupancy, for that shared memory);
// *launched says whether it was made. Above 48 KB the kernel's dynamic
// shared-memory limit is raised to the card's (the same value from every
// thread, so concurrent callers agree).
template <class... A>
cudaError_t launch_one_wave(void (*kernel)(A...), long long G, int R, long long smem,
                            cudaStream_t s, bool* launched, typename as_is<A>::type... args) {
  *launched = false;
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess || !coop || smem > optin || G * R > (long long)sms * 32) return err;
  if (smem > SMEM_BYTES)
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GROUP, (size_t)smem);
  if (err != cudaSuccess || (long long)per_sm * sms < G * R) return err;
  *launched = true;
  void* argv[] = {&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)G, (unsigned)R),
                                     dim3(GROUP), argv, (size_t)smem, s);
}

// Hillis-Steele over the n matrices of each of R rows, in -> out; spare is
// the grid-wide kernel's second buffer. KT = 0: any K.
template <int KT>
cudaError_t prefix_scan_rows(const float* in, float* out, float* spare, int K, int R,
                             long long n, cudaStream_t s) {
  const long long bytes = 2LL * K * K * n * (long long)sizeof(float);
  if constexpr (KT > 0) {
    if (bytes <= SMEM_BYTES) {
      fbscan_prefix_rows_smem_kernel<KT><<<R, TOTALS_THREADS, bytes, s>>>(in, out, R, n,
                                                                          levels_of(n));
      return cudaGetLastError();
    }
  }
  return launch_grid(fbscan_prefix_rows_grid_kernel<KT>, (long long)R * n, s, in, out, spare, K,
                     R, n, levels_of(n));
}

// Workspace layout of a grouped prefix call: the in-group scan (K, K, R, n)
// then three (K, K, R, G) buffers: totals, their inclusive scan, spare (the
// one-launch form takes the first (K, K, R, G) for its totals).
// KT = K <= MAX_REG_K, in registers, or 0: any K, in device memory.
template <int KT>
cudaError_t prefix(const float* in, float* out, float* work, int K, int R, long long n,
                   cudaStream_t s) {
  if (!grouped(n)) return prefix_scan_rows<KT>(in, out, work, K, R, n, s);
  const long long G = n / GROUP, m = (long long)K * K * R;
  if constexpr (KT > 0) {
    const long long floats = KT * KT * (2 * G > GROUP ? 2 * G : GROUP);
    bool launched = false;
    const cudaError_t err =
        launch_one_wave(fbscan_prefix_one_kernel<KT>, G, R, floats * (long long)sizeof(float), s,
                        &launched, in, out, work, R, n, levels_of(G));
    if (err != cudaSuccess || launched) return err;
  }
  float* inner = work;
  float* tot = inner + m * n;
  float* incl = tot + m * G;
  const dim3 grid((unsigned)G, (unsigned)R);
  if constexpr (KT > 0) {
    fbscan_prefix_group_kernel<KT><<<grid, GROUP, 0, s>>>(in, inner, tot, R, n);
  } else {
    // `out` is the odd levels' buffer until the combine overwrites it
    fbscan_prefix_group_any_kernel<<<grid, GROUP, 0, s>>>(in, inner, out, tot, K, R, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = prefix_scan_rows<KT>(tot, incl, incl + m * G, K, R, G, s);
  if (err != cudaSuccess) return err;
  if constexpr (KT > 0) {
    fbscan_prefix_combine_kernel<KT><<<grid, GROUP, 0, s>>>(inner, incl, out, R, n);
  } else {
    fbscan_prefix_combine_any_kernel<<<grid, GROUP, 0, s>>>(inner, incl, out, K, R, n);
  }
  return cudaGetLastError();
}

// Reverse Hillis-Steele over the n maps of each of R rows, in -> out.
cudaError_t suffix_scan_rows(const int64_t* in, int64_t* out, int64_t* spare, int K, int R,
                             long long n, cudaStream_t s) {
  const long long bytes = 2LL * K * n * (long long)sizeof(int);
  if (bytes <= SMEM_BYTES) {
    fbscan_suffix_rows_smem_kernel<<<R, TOTALS_THREADS, bytes, s>>>(in, out, K, R, n);
    return cudaGetLastError();
  }
  return launch_grid(fbscan_suffix_rows_grid_kernel, (long long)R * n, s, in, out, spare, K, R, n,
                     levels_of(n));
}

// The one-launch suffix for K <= MAX_REG_K where it fits the card.
template <int KT>
cudaError_t suffix_one(const int64_t* in, int64_t* out, int64_t* work, int R, long long n,
                       cudaStream_t s, bool* launched) {
  const long long G = n / GROUP, ints = 2 * G > GROUP ? 2 * G : GROUP;
  return launch_one_wave(fbscan_suffix_one_kernel<KT>, G, R, KT * ints * (long long)sizeof(int),
                         s, launched, in, out, work, R, n);
}

}  // namespace

// Elements of float32 workspace a prefix call needs: grouped, the in-group
// scan (K * K * R * n) and three (K, K, R, G) buffers; flat, one (K, K, R,
// n) ping-pong buffer.
extern "C" long long hammlet_fbscan_prefix_workspace(int K, int R, long long n) {
  const long long m = (long long)K * K * R;
  return grouped(n) ? m * n + 3 * m * (n / GROUP) : m * n;
}

extern "C" int hammlet_fbscan_prefix(const float* in, float* out, float* work, int K, int R,
                                     long long n, int device, void* stream) {
  if (bad_shape(K, R, n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  static_assert(MAX_REG_K == 8, "the switch below instantiates K = 1..MAX_REG_K");
  switch (K) {
    case 1: return (int)prefix<1>(in, out, work, K, R, n, s);
    case 2: return (int)prefix<2>(in, out, work, K, R, n, s);
    case 3: return (int)prefix<3>(in, out, work, K, R, n, s);
    case 4: return (int)prefix<4>(in, out, work, K, R, n, s);
    case 5: return (int)prefix<5>(in, out, work, K, R, n, s);
    case 6: return (int)prefix<6>(in, out, work, K, R, n, s);
    case 7: return (int)prefix<7>(in, out, work, K, R, n, s);
    case 8: return (int)prefix<8>(in, out, work, K, R, n, s);
    default: return (int)prefix<0>(in, out, work, K, R, n, s);
  }
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
  const long long group_bytes = 2LL * K * GROUP * (long long)sizeof(int);
  // flat, or a group too large for shared memory: the rows scan over the
  // whole input (exact, so the same maps as the grouped form)
  if (!grouped(n) || group_bytes > SMEM_BYTES) return (int)suffix_scan_rows(in, out, work, K, R, n, s);
  bool launched = false;
  static_assert(MAX_REG_K == 8, "the switch below instantiates K = 1..MAX_REG_K");
  switch (K) {
    case 1: err = suffix_one<1>(in, out, work, R, n, s, &launched); break;
    case 2: err = suffix_one<2>(in, out, work, R, n, s, &launched); break;
    case 3: err = suffix_one<3>(in, out, work, R, n, s, &launched); break;
    case 4: err = suffix_one<4>(in, out, work, R, n, s, &launched); break;
    case 5: err = suffix_one<5>(in, out, work, R, n, s, &launched); break;
    case 6: err = suffix_one<6>(in, out, work, R, n, s, &launched); break;
    case 7: err = suffix_one<7>(in, out, work, R, n, s, &launched); break;
    case 8: err = suffix_one<8>(in, out, work, R, n, s, &launched); break;
    default: break;
  }
  if (err != cudaSuccess || launched) return (int)err;
  const long long G = n / GROUP, m = (long long)K * R;
  int64_t* inner = work;
  int64_t* tot = inner + m * n;
  int64_t* incl = tot + m * G;
  const dim3 grid((unsigned)G, (unsigned)R);
  fbscan_suffix_group_smem_kernel<<<grid, GROUP, group_bytes, s>>>(in, inner, tot, K, R, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = suffix_scan_rows(tot, incl, incl + m * G, K, R, G, s);
  if (err != cudaSuccess) return (int)err;
  fbscan_suffix_combine_kernel<<<grid, GROUP, 0, s>>>(inner, incl, out, K, R, n);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
