// Haar maxlet transform for NVIDIA Hopper (sm_90a): two kernels, one pass
// over the data.
//
// Replaces the Pallas TPU kernel
//   hammlet_tpu/ops/wavelet_pallas.py:_maxlet_chunk_kernel (:41)
// and the XLA cross-chunk loop and support mask of its wrapper (:130-151),
// and computes exactly what they compute: coeffs[t] (t in [0, T)) is the max
// over dims of norm[l-1] * |left_sum - right_sum| for the Haar wavelet
// centred at t, l = ctz(t) + 1, with pairwise-dyadic float32 sums; +inf at
// t = 0 and wherever t + lowbit(t) > T (the wavelet's support leaves the
// data).
//
// maxlet_chunk_kernel: one CTA of 512 threads per 8192-position chunk. It
//   reads the caller's (T, dim) float32 rows directly (zeros past T), each
//   thread 16 consecutive positions with 16-byte loads, all issued before
//   any arithmetic. Levels 1-4 run in the thread's registers, levels 5-9
//   across the warp's 32 lanes by a __shfl_xor_sync butterfly, levels 10-13
//   across the 16 warp totals by one warp. Every thread ends with its 16
//   coefficients in registers; the max over dims and the support mask are
//   applied there, and the 16 coefficients leave in four 16-byte stores. It
//   writes +inf at each chunk's first position and the chunk's per-dim total
//   to totals (n_chunks, dim).
// maxlet_cross_kernel: one CTA. Levels 14 and up on the chunk totals, in
//   place in a scratch copy (node i of level m lives at row i << m, so no two
//   threads of a level touch the same row), writing the masked coefficient at
//   every chunk start c * 8192 (c >= 1) whose wavelet the tree forms; the
//   others keep the chunk kernel's +inf.
//
// What bounds it on the card: memory. The chunk kernel reads 4 * dim bytes
// and writes 4 bytes per position and does ~4 flops per position and dim
// (T = 4M, dim 1: 32 MB, 9.6 us at 3.35 TB/s, against 0.24 us of float32
// work). The design touches device memory once: each input byte is read
// once, each coefficient written once, and no level pyramid, padded copy,
// transpose or mask array goes through device memory. The cross kernel
// moves n_chunks * dim * 4 bytes (2 KB at T = 4M) and costs its launch and
// one barrier per level.
//
// Exactness: a butterfly step computes the node sum on both partner lanes;
// a + b == b + a and |a - b| == |b - a| hold exactly in IEEE arithmetic, so
// every lane holds the bits of the reference's left + right. The adds,
// subtracts and multiplies use the _rn intrinsics, which the compiler never
// contracts into an FMA, and the normalizers are the float32 chain of
// ops/wavelet.py:_level_normalizers, passed from the host. The max over dims
// propagates NaN like torch.amax / jnp.max (fmaxf alone would drop it).
//
// C interface for ctypes: each hammlet_maxlet_* returns the cudaError_t of
// its launch (0 = launched); none synchronizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHUNK_BITS 13
#define CHUNK (1 << CHUNK_BITS)
#define THREADS 512
#define PER_THREAD (CHUNK / THREADS)  // 16 consecutive positions
#define WARPS (THREADS / 32)          // 16: levels 10-13 run over their totals
#define MAX_LEVELS 64
#define CROSS_THREADS 1024

static_assert(PER_THREAD == 16 && WARPS == 16, "levels 1-4 / 5-9 / 10-13 split");

struct LevelNorms {
  float v[MAX_LEVELS];  // v[l-1] = (1/sqrt2)^l as a float32 chain
};

__device__ __forceinline__ float max_propagate_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float detail(float norm, float left, float right) {
  return __fmul_rn(norm, fabsf(__fsub_rn(left, right)));
}

// DIM > 0: rows of DIM floats, 16-byte aligned, loaded as float4; DIM == 0:
// any dim, scalar loads one dim at a time.
template <int DIM>
__global__ void __launch_bounds__(THREADS, DIM == 1 ? 2 : 1)
maxlet_chunk_kernel(const float* __restrict__ data, long long T, int dim,
                    LevelNorms norms, float* __restrict__ coeffs,
                    float* __restrict__ totals) {
  __shared__ float warp_sum[WARPS];
  __shared__ float warp_coef[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunk = blockIdx.x;
  const long long p0 = chunk * CHUNK + (long long)threadIdx.x * PER_THREAD;
  const bool full = p0 + PER_THREAD <= T;
  const int n_dims = DIM > 0 ? DIM : dim;

  float v[DIM > 0 ? PER_THREAD * DIM : 1];
  if constexpr (DIM > 0) {
    const float* src = data + p0 * DIM;
    if (full) {
#pragma unroll
      for (int k = 0; k < PER_THREAD * DIM / 4; ++k) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src) + k);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER_THREAD * DIM; ++e)
        v[e] = (p0 + e / DIM < T) ? src[e] : 0.0f;
    }
  }

  float c[PER_THREAD];  // max over dims of each position's coefficient
#pragma unroll
  for (int d = 0; d < n_dims; ++d) {
    float x[PER_THREAD];
    if constexpr (DIM > 0) {
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) x[i] = v[i * DIM + d];
    } else {
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i)
        x[i] = (p0 + i < T) ? data[(p0 + i) * dim + d] : 0.0f;
    }

    // levels 1-4 in registers: x[a] becomes the sum of its node in place
    float det[PER_THREAD];
#pragma unroll
    for (int l = 1; l <= 4; ++l) {
      const int half = 1 << (l - 1);
#pragma unroll
      for (int a = 0; a < PER_THREAD; a += 2 * half) {
        det[a + half] = detail(norms.v[l - 1], x[a], x[a + half]);
        x[a] = __fadd_rn(x[a], x[a + half]);
      }
    }

    // levels 5-9 across the warp: at step j every lane holds its aligned
    // 2^j-lane group's sum; the lane with ctz(lane) == j is the centre of
    // the level-(5+j) wavelet and owns its coefficient (its slot 0)
    float s = x[0];
    det[0] = INFINITY;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, s, 1 << j);
      if ((lane & ((2 << j) - 1)) == (1 << j)) det[0] = detail(norms.v[4 + j], other, s);
      s = __fadd_rn(s, other);
    }

    // levels 10-13 across the 16 warp totals, by warp 0 (lanes 16-31 mirror
    // lanes 0-15; xor by 1..8 stays inside each half); warp w's centre
    // coefficient goes to slot 0 of its lane 0, +inf for warp 0 (the chunk
    // start, left to the cross kernel)
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    if (warp == 0) {
      float w = warp_sum[lane & (WARPS - 1)];
      float cw = INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float other = __shfl_xor_sync(0xffffffffu, w, 1 << j);
        if ((lane & ((2 << j) - 1)) == (1 << j)) cw = detail(norms.v[9 + j], other, w);
        w = __fadd_rn(w, other);
      }
      if (lane < WARPS) warp_coef[lane] = cw;
      if (lane == 0) totals[chunk * n_dims + d] = w;
    }
    __syncthreads();  // warp_coef ready; warp_sum free for the next dim
    if (lane == 0) det[0] = warp_coef[warp];

#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      c[i] = (d == 0) ? det[i] : max_propagate_nan(c[i], det[i]);
  }

  // support mask: t holds the level-(ctz(t)+1) wavelet, complete iff
  // t + lowbit(t) <= T (t = 0 is a chunk start and already +inf)
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long t = p0 + i;
    if (t + (t & -t) > T) c[i] = INFINITY;
  }
  float* dst = coeffs + p0;
  if (full) {
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (p0 + i < T) dst[i] = c[i];
  }
}

// Levels 14 and up. Plain (not restrict, not read-only) loads: scratch is
// read after other threads of the block wrote it, behind __syncthreads.
__global__ void __launch_bounds__(CROSS_THREADS)
maxlet_cross_kernel(const float* totals, long long n_chunks, int dim, long long T,
                    LevelNorms norms, float* coeffs, float* scratch) {
  long long n = n_chunks;
  for (int m = 1; n >= 2; ++m) {
    const long long pairs = n >> 1;
    const long long half = 1LL << (m - 1);
    const float norm = norms.v[CHUNK_BITS + m - 1];
    const float* src = (m == 1) ? totals : scratch;
    for (long long i = threadIdx.x; i < pairs; i += CROSS_THREADS) {
      const long long left = (i << m) * dim;
      const long long right = left + half * dim;
      float best = 0.0f;
      for (int d = 0; d < dim; ++d) {
        const float l = src[left + d];
        const float r = src[right + d];
        const float det = detail(norm, l, r);
        best = (d == 0) ? det : max_propagate_nan(best, det);
        scratch[left + d] = __fadd_rn(l, r);
      }
      // the wavelet's centre is the right node's first chunk start
      const long long t = ((i << m) + half) << CHUNK_BITS;
      coeffs[t] = (t + (half << CHUNK_BITS) <= T) ? best : INFINITY;
    }
    n = pairs;
    __syncthreads();
  }
}

static LevelNorms load_norms(const float* host) {
  LevelNorms norms;
  for (int i = 0; i < MAX_LEVELS; ++i) norms.v[i] = host[i];
  return norms;
}

extern "C" int hammlet_maxlet_chunks(const float* data, long long T, int dim,
                                     const float* norms_host, float* coeffs,
                                     float* totals, int device, void* stream) {
  if (T <= 0 || dim < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T + CHUNK - 1) / CHUNK;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const LevelNorms norms = load_norms(norms_host);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)data & 15) == 0;
  const unsigned grid = (unsigned)n_chunks;
  switch (aligned ? dim : 0) {
    case 1:
      maxlet_chunk_kernel<1><<<grid, THREADS, 0, s>>>(data, T, dim, norms, coeffs, totals);
      break;
    case 3:
      maxlet_chunk_kernel<3><<<grid, THREADS, 0, s>>>(data, T, dim, norms, coeffs, totals);
      break;
    default:
      maxlet_chunk_kernel<0><<<grid, THREADS, 0, s>>>(data, T, dim, norms, coeffs, totals);
  }
  return (int)cudaGetLastError();
}

extern "C" int hammlet_maxlet_cross(const float* totals, long long n_chunks, int dim,
                                    long long T, const float* norms_host, float* coeffs,
                                    float* scratch, int device, void* stream) {
  if (dim < 1 || T <= 0 || n_chunks != (T + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  maxlet_cross_kernel<<<1, CROSS_THREADS, 0, (cudaStream_t)stream>>>(
      totals, n_chunks, dim, T, load_norms(norms_host), coeffs, scratch);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
