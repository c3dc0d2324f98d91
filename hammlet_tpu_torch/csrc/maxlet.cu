// Haar maxlet transform, chunk-local levels, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   hammlet_tpu/ops/wavelet_pallas.py:_maxlet_chunk_kernel
// and computes exactly what it computes: for every 8192-position chunk of the
// (dim, Tp) float32 input, every Haar detail coefficient of levels 1..13
// (the coefficient at t = a*2^l + 2^(l-1) is the max over dims of
// norm[l-1] * |left_sum - right_sum|, with pairwise-dyadic float32 sums),
// plus each chunk's per-dim total. The wrapper (ops/wavelet_cuda.py) finishes
// the levels above 13 on the chunk totals and applies the +inf support mask.
//
// What bounds it on the card: it reads 4*dim bytes and writes 4 bytes of
// device memory per position, with a handful of flops per position, so it is
// memory-bound (~100 MB moved at T = 4M, dim = 1). The design keeps all 13
// levels of a chunk in shared memory: device memory is read once per dim and
// each coefficient is written once (read back once more per extra dim, for
// the max). The level pyramid runs in place in 32 KB of static shared memory,
// one CTA per chunk, a barrier between levels.
//
// Exactness: each (level, node) pair is owned by one thread, which also owns
// the coefficient position it writes, so no two threads touch the same value.
// The adds, subtracts and multiplies use the _rn intrinsics, which the
// compiler never contracts into an FMA, so the bits equal the float32 tree of
// the JAX and torch versions. The max over dims propagates NaN like
// jnp.max / torch.amax (fmaxf alone would drop it).
//
// C interface for ctypes: hammlet_maxlet_chunks returns the cudaError_t of
// the launch (0 = launched); it never synchronizes.

#include <cuda_runtime.h>
#include <math.h>

#define CHUNK_BITS 13
#define CHUNK (1 << CHUNK_BITS)
#define THREADS 512

struct LevelNorms {
  float v[CHUNK_BITS];
};

__device__ __forceinline__ float max_propagate_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__global__ void __launch_bounds__(THREADS)
maxlet_chunk_kernel(const float* __restrict__ data, long long Tp, int dim,
                    LevelNorms norms, float* __restrict__ coeffs,
                    float* __restrict__ totals) {
  __shared__ float s[CHUNK];
  const long long base = (long long)blockIdx.x * CHUNK;
  for (int d = 0; d < dim; ++d) {
    const float* src = data + (long long)d * Tp + base;
    for (int i = threadIdx.x; i < CHUNK; i += THREADS) s[i] = src[i];
    __syncthreads();
#pragma unroll 1
    for (int level = 1; level <= CHUNK_BITS; ++level) {
      const int half = 1 << (level - 1);
      const int nodes = CHUNK >> level;
      const float nrm = norms.v[level - 1];
      for (int i = threadIdx.x; i < nodes; i += THREADS) {
        const int a = i << level;
        const float l = s[a];
        const float r = s[a + half];
        const float det = __fmul_rn(nrm, fabsf(__fsub_rn(l, r)));
        float* c = coeffs + base + a + half;
        *c = (d == 0) ? det : max_propagate_nan(*c, det);
        s[a] = __fadd_rn(l, r);  // node sum, read by the next level
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      totals[(long long)blockIdx.x * dim + d] = s[0];
      if (d == 0) coeffs[base] = INFINITY;  // no wavelet is centred there
    }
    __syncthreads();  // s[0] is read before the next dim overwrites s
  }
}

extern "C" int hammlet_maxlet_chunks(const float* data, long long Tp, int dim,
                                     const float* norms_host, float* coeffs,
                                     float* totals, int device, void* stream) {
  if (Tp <= 0 || Tp % CHUNK != 0 || dim < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LevelNorms norms;
  for (int i = 0; i < CHUNK_BITS; ++i) norms.v[i] = norms_host[i];
  const long long n_chunks = Tp / CHUNK;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  maxlet_chunk_kernel<<<(unsigned)n_chunks, THREADS, 0, (cudaStream_t)stream>>>(
      data, Tp, dim, norms, coeffs, totals);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
