// The two associative scans of the Forward-Backward sampler for NVIDIA
// Hopper (sm_90a): inclusive prefix products of K x K block matrices, and
// suffix compositions of index maps. At most three launches per call.
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
// Grouped form (n > 256 and n % 128 == 0, G = n / 128 groups), three
// kernels:
//   *_group_kernel: one CTA of 128 threads per (group, row), one thread per
//     block; the 7 in-group Hillis-Steele levels. The prefix's small-K
//     instances (K <= MAX_REG_K) keep each matrix in registers and swap them
//     through shared memory between levels, any larger K ping-pongs through
//     two device buffers that stay in L1/L2 (a CTA's group is a few KB); the
//     suffix keeps the group's maps in shared memory as int32 (K <= 48).
//     Writes the in-group scan and each group's total.
//   rows scan (the totals): the Hillis-Steele scan of each row's G group
//     totals. Where two copies of a row fit in 48 KB of shared memory, one
//     CTA of 1024 threads per row runs every level there (the prefix's
//     small-K instances take each matrix into registers for a combine).
//     Otherwise (G reaches ~3,400 per shard at T = 250M) one cooperative
//     launch spreads every level over the whole card, a grid-wide barrier
//     between levels, ping-ponging through device scratch.
//   *_combine_kernel: one thread per block; combines each block's in-group
//     scan with its group's exclusive prefix (the prefix of the groups
//     before it, the composition of the groups after it).
// Flat form (n <= 256 or n % 128 != 0, where the JAX package is flat too):
// the rows scan alone, on the input, in one CTA per row or over the whole
// card as above (a flat n reaches T when the capacity is clipped to it).
// A suffix whose group does not fit in shared memory (K > 48) takes the
// flat form over the whole card: composition is exact, so its association
// does not change the result.
//
// What bounds it on this card: bytes, and at the main path's shapes the
// launches. One call must read its input once and write its output once:
// at B = 29,696, K = 3, one row, 1.07 MB each way for the prefix (0.64 us at
// 3.35 TB/s) and 0.71 MB for the int64 maps (0.43 us); the float32 work is
// ~27 multiply-adds per block and level. The design keeps every level's
// intermediates out of device memory where it can (registers and shared
// memory for the levels, L1/L2-resident ping-pong buffers where they do
// not fit) and makes three launches instead of the ~120 of the flat torch
// levels; what is left is the latency of three short kernels, of which the
// one-CTA totals scan is the longest. A row too long for one CTA's shared
// memory is spread over every SM (one CTA would move all of its levels'
// bytes through one SM). The time depends on the data:
// __fdiv_rn takes a slow path for a subnormal numerator, and the sweep's
// products hold ~1 % subnormal entries, which makes the prefix kernels
// 3-4x slower than on normal inputs (measured on an H100). A float64
// quotient for those entries is exact but slower still, as every warp
// that holds one pays for both paths.
//
// Exactness: a combine is z[i,k] = sum_j e[i,j] * x[j,k] summed over j in
// order, with the _rn intrinsics (never contracted into an FMA), then
// z / max(max_ik z, 1e-35) with __fdiv_rn; the max propagates NaN like
// torch.amax (fmaxf alone would drop it). No atomics: the bytes do not
// change from run to run. Map composition is exact integer indexing.
// Maps must hold indices in [0, K), as argmax gives them.
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
#define MAX_REG_K 8        // the prefix's register-resident instances: K = 1..8
#define TOTALS_THREADS 1024
#define GRID_THREADS 256   // per CTA of the grid-wide rows scans

namespace cg = cooperative_groups;

static_assert((1 << GROUP_LEVELS) == GROUP, "GROUP is 2^GROUP_LEVELS");
// the generic kernels write the last in-group level into `inner`
static_assert(GROUP_LEVELS % 2 == 1, "levels 0, 2, ..., GROUP_LEVELS - 1 write inner");

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;  // a NaN, once in m, stays
}

__device__ __forceinline__ float clamp_scale(float m) {
  return m < 1e-35f ? 1e-35f : m;  // torch.clamp(min=1e-35): NaN stays NaN
}

// z = normalize(e @ x) for a compile-time K; e(i, j) gives the earlier
// matrix, x and z are register arrays of K * K (row-major).
template <int K, class E>
__device__ __forceinline__ void combine_reg(E e, const float* x, float* z) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = __fmul_rn(e(i, 0), x[k]);
#pragma unroll
      for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(e(i, j), x[j * K + k]));
      z[i * K + k] = acc;
      m = max_nan(m, acc);
    }
  }
  m = clamp_scale(m);
#pragma unroll
  for (int q = 0; q < K * K; ++q) z[q] = __fdiv_rn(z[q], m);
}

// The same for any K, in device memory: element (i, k) of x at
// x[(i * K + k) * stride], of z likewise; z is written, then rescaled in
// place by the thread that wrote it.
template <class E>
__device__ __forceinline__ void combine_mem(int K, E e, const float* x, long long stride,
                                            float* z) {
  float m = -INFINITY;
  for (int i = 0; i < K; ++i) {
    for (int k = 0; k < K; ++k) {
      float acc = __fmul_rn(e(i, 0), x[(long long)k * stride]);
      for (int j = 1; j < K; ++j)
        acc = __fadd_rn(acc, __fmul_rn(e(i, j), x[(long long)(j * K + k) * stride]));
      z[(long long)(i * K + k) * stride] = acc;
      m = max_nan(m, acc);
    }
  }
  m = clamp_scale(m);
  for (int q = 0; q < K * K; ++q) {
    const long long at = (long long)q * stride;
    z[at] = __fdiv_rn(z[at], m);
  }
}

// the identity matrix as an earlier operand (the scans' padding)
struct Eye {
  __device__ __forceinline__ float operator()(int i, int j) const { return i == j ? 1.0f : 0.0f; }
};

// ---------------------------------------------------------------- prefix

// In-group levels, K <= MAX_REG_K: grid (G, R), 128 threads.
template <int K>
__global__ void __launch_bounds__(GROUP)
fbscan_prefix_group_kernel(const float* __restrict__ in, float* __restrict__ inner,
                           float* __restrict__ tot, int R, long long n) {
  __shared__ float s[K * K][GROUP];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  float x[K * K], z[K * K];
#pragma unroll
  for (int e = 0; e < K * K; ++e) x[e] = in[e * plane + off];
#pragma unroll 1
  for (int d = 1; d < GROUP; d <<= 1) {
#pragma unroll
    for (int e = 0; e < K * K; ++e) s[e][t] = x[e];
    __syncthreads();
    if (t >= d) {
      combine_reg<K>([&](int i, int j) { return s[i * K + j][t - d]; }, x, z);
    } else {
      combine_reg<K>(Eye(), x, z);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < K * K; ++e) x[e] = z[e];
  }
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
      float x[K * K], z[K * K];
#pragma unroll
      for (int e = 0; e < K * K; ++e) x[e] = src[e * n + g];
      if (g >= d) {
        combine_reg<K>([&](int i, int j) { return src[(i * K + j) * n + g - d]; }, x, z);
      } else {
        combine_reg<K>(Eye(), x, z);
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
          combine_reg<K>([&](int i, int j) { return src[(i * K + j) * plane + at - d]; }, x, z);
        } else {
          combine_reg<K>(Eye(), x, z);
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
    combine_reg<K>([&](int i, int j) { return p[i * K + j]; }, x, z);
  } else {
    combine_reg<K>(Eye(), x, z);
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

// The in-group levels with the group's maps in shared memory as int32 (two
// buffers of K * 128 within SMEM_BYTES).
__global__ void __launch_bounds__(GROUP)
fbscan_suffix_group_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ inner,
                                int64_t* __restrict__ tot, int K, int R, long long n) {
  extern __shared__ int smem_i[];
  const int t = threadIdx.x;
  const long long q = blockIdx.x, G = n / GROUP, plane = (long long)R * n;
  const long long off = (long long)blockIdx.y * n + q * GROUP + t;
  int* src = smem_i;
  int* dst = smem_i + K * GROUP;
  for (int j = 0; j < K; ++j) src[j * GROUP + t] = (int)in[j * plane + off];
  __syncthreads();
  for (int d = 1; d < GROUP; d <<= 1) {
    for (int j = 0; j < K; ++j) {
      const int idx = t + d < GROUP ? src[j * GROUP + t + d] : j;
      dst[j * GROUP + t] = src[idx * GROUP + t];
    }
    __syncthreads();
    int* done = dst;
    dst = src;
    src = done;
  }
  for (int j = 0; j < K; ++j) inner[j * plane + off] = src[j * GROUP + t];
  if (t == 0) {
    const long long toff = (long long)blockIdx.y * G + q;
    for (int j = 0; j < K; ++j) tot[(long long)j * R * G + toff] = src[j * GROUP];
  }
}

// Reverse Hillis-Steele over each row's n maps, new_g[j] = x_g[x_{g+d}[j]]
// (x_g[j] past the row's end): one CTA per row with the row in shared
// memory as int32 (two buffers of K * n within SMEM_BYTES).
__global__ void __launch_bounds__(TOTALS_THREADS)
fbscan_suffix_rows_smem_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int K,
                               int R, long long n, int levels) {
  extern __shared__ int smem_i[];
  const long long row = (long long)blockIdx.x * n, plane = (long long)R * n;
  const int m = (int)n;
  int* src = smem_i;
  int* dst = smem_i + K * m;
  for (int g = threadIdx.x; g < m; g += blockDim.x)
    for (int j = 0; j < K; ++j) src[j * m + g] = (int)in[j * plane + row + g];
  __syncthreads();
  for (int level = 0; level < levels; ++level) {
    const int d = 1 << level;
    for (int g = threadIdx.x; g < m; g += blockDim.x) {
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
// then three (K, K, R, G) buffers: totals, their inclusive scan, spare.
// KT = K <= MAX_REG_K, in registers, or 0: any K, in device memory.
template <int KT>
cudaError_t prefix(const float* in, float* out, float* work, int K, int R, long long n,
                   cudaStream_t s) {
  if (!grouped(n)) return prefix_scan_rows<KT>(in, out, work, K, R, n, s);
  const long long G = n / GROUP, m = (long long)K * K * R;
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
    fbscan_suffix_rows_smem_kernel<<<R, TOTALS_THREADS, bytes, s>>>(in, out, K, R, n,
                                                                    levels_of(n));
    return cudaGetLastError();
  }
  return launch_grid(fbscan_suffix_rows_grid_kernel, (long long)R * n, s, in, out, spare, K, R, n,
                     levels_of(n));
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
