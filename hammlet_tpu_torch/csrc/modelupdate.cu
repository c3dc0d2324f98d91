// The conjugate model update of a Gibbs sweep for NVIDIA Hopper (sm_90a):
// the sweep statistics (the reference's pass 3, ForwardBackward.hpp:170-212)
// and the conjugate resample of theta, A and pi (HMM.hpp:111-115).
//
// Replaces the JAX package's functions, which XLA compiles into a few fused
// ops on the TPU:
//   hammlet_tpu/samplers/sweep.py:accumulate_sweep_stats (:100)
//   hammlet_tpu/models/hmm.py:resample_model (:128), with
//   hammlet_tpu/models/distributions.py:nig_update (:18) and
//   gamma_fixed_tries (:55) inside it
// and computes exactly what their plain torch versions compute
// (hammlet_tpu_torch/samplers/sweep.py:sweep_stats_reference,
// hammlet_tpu_torch/models/hmm.py:resample_model_reference), bit for bit.
//
// Sweep statistics: R rows (the sharded engine's local shards; 1 on one
// device), each summed on its own, so a row's bytes never depend on R.
// Per row, every output is a fixed sum of per-block terms (term j of block
// b is mask * value, mask in {0, 1}, 0 past n_blocks):
//   state k:        (s == k)             * size
//   diag k:         (s == k)             * (size - 1)
//   pair (i, j):    (prev == i, s == j)    (prev of block 0 is state 0)
//   theta (d, q, p): (mapping[s, d] == p) * (sum, sum of squares, size)[q]
// summed over the block axis by a pairwise tree, padded with zeros to the
// next power of two Bp, pairs (2i, 2i + 1) at each level; then trans =
// pairs + diag (0 off the diagonal) and theta[q, p] = ((0 + t_0) + t_1) +
// ... over d. The tree splits exactly into trees over aligned tiles of
// 2^k blocks and a tree over the tiles, so two launches reproduce it:
//   modelupdate_stats_tile_kernel, grid (tiles, R): a CTA takes a tile of
//     2048 blocks, 8 per thread; for each term the in-thread levels (node
//     sizes 2-8), warp shuffles (16-256) and the 8 warps (512-2048) sum
//     the tile; each tile's term sums go to device memory.
//   modelupdate_stats_total_kernel, one CTA per row: the tree over the
//     row's tiles, zero-padded to a power of two, one warp per term, then
//     the assembly into (theta sums, sums of squares, counts, trans,
//     state counts).
// Every level combines only while its node size is at most Bp, so a row
// shorter than a tile stops at its own root: adding a padding zero would
// turn a -0.0 sum into +0.0. No atomics: the bytes do not change from run
// to run. What bounds it: bytes. At B = 29,696, dim 1, one row, it reads
// states and sizes (int64) and the block statistics (2 x float32), about
// 0.71 MB (0.21 us at 3.35 TB/s); the terms are 24 adds per block. So
// the time is the two launches and the tree's dependent steps.
//
// Resample: one CTA of RESAMPLE_THREADS, one launch. Thread i takes Gamma
// shape i of the n = P + K*K + K (the NIG posterior's alpha for the P
// emission parameters, then A's Dirichlet rows, then pi's), draws it with
// the fixed-depth Marsaglia-Tsang sampler from the pre-drawn noise (8
// proposal normals and acceptance uniforms, one boost uniform), and for
// i < P writes var = beta' / g and mean = mu0' + sqrt(var / nu') z; after a
// barrier each entry of A and pi divides by its row's sum taken left to
// right over the K columns. A few dozen values: the bound is latency.
//
// Bits: each operation repeats the CUDA arithmetic of the torch operation
// it stands for, one rounding each, with the _rn intrinsics (never
// contracted into an FMA): a torch division by a tensor is __fdiv_rn,
// `1.0 / t` is torch.reciprocal (a correctly rounded 1 / t), `t / 8.0` is
// torch's multiply by the reciprocal of a CPU scalar (t * 0.125, the same
// value), `** 3` is (w * w) * w, `ub ** e` is powf, torch.log1p / log /
// sqrt are log1pf / logf / the correctly rounded square root, clamp and
// minimum propagate NaN as torch's CUDA kernels do, and a Python float
// constant is the double rounded to float. The build keeps fast math off
// and subnormals (the uniforms' floor 1e-38 is one).
//
// C interface for ctypes: each launch function returns the cudaError_t of
// its launches (0 = launched); none synchronizes or allocates: the caller
// hands in the workspace (hammlet_sweep_stats_workspace floats) and the
// outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xffffffffu
#define STATS_THREADS 256
#define STATS_WARPS (STATS_THREADS / WARP)
#define PER_THREAD 8
#define TILE (STATS_THREADS * PER_THREAD)  // blocks per CTA of the tile kernel
#define TOTAL_THREADS 256
#define RESAMPLE_THREADS 256
#define TRIES 8  // gamma_fixed_tries' fixed depth
#define MAX_STACK 40  // levels of one lane's sequential tree in the total kernel

static_assert(PER_THREAD == 8 && STATS_WARPS == 8, "the in-thread and cross-warp trees have 3 levels");

namespace {

// torch.clamp(v, min=lo) on CUDA: NaN stays NaN, else ::max
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

// torch.minimum on CUDA: the first NaN operand, else ::min
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// One tree level over values held two per pair: the left node takes the sum
// when the combined node (size `size`) is at most Bp.
__device__ __forceinline__ float combine(float left, float right, long long size, long long Bp) {
  return size <= Bp ? __fadd_rn(left, right) : left;
}

// The tile's tree over one term: the thread's 8 leaves (node sizes 2, 4,
// 8), then the warp (16-256); lane 0 stores the warp's node.
__device__ __forceinline__ void reduce_term(float (&v)[PER_THREAD], long long Bp, int lane,
                                            float* slot) {
  v[0] = combine(v[0], v[1], 2, Bp);
  v[2] = combine(v[2], v[3], 2, Bp);
  v[4] = combine(v[4], v[5], 2, Bp);
  v[6] = combine(v[6], v[7], 2, Bp);
  v[0] = combine(v[0], v[2], 4, Bp);
  v[4] = combine(v[4], v[6], 4, Bp);
  float x = combine(v[0], v[4], 8, Bp);
  long long size = 16;
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1, size <<= 1) {
    const float other = __shfl_down_sync(FULL_MASK, x, off);
    if ((lane & (2 * off - 1)) == 0) x = combine(x, other, size, Bp);
  }
  if (lane == 0) *slot = x;
}

}  // namespace

// Partial sums of every term over each tile of TILE blocks of each row.
// states, sizes: (R, B) int64; n_blocks: (R,) int64; bstats: (dim, 2, R, B)
// float32; mapping: (K, dim) int64; partials: (R, n_terms, tiles) float32.
__global__ void __launch_bounds__(STATS_THREADS)
modelupdate_stats_tile_kernel(const int64_t* __restrict__ states,
                              const int64_t* __restrict__ sizes,
                              const int64_t* __restrict__ n_blocks,
                              const float* __restrict__ bstats,
                              const int64_t* __restrict__ mapping, float* __restrict__ partials,
                              int R, long long B, long long Bp, int K, int dim, int P,
                              int n_terms, int tiles) {
  extern __shared__ float smem[];
  float* warp_sums = smem;                                   // [n_terms][STATS_WARPS]
  int* map = (int*)(smem + (long long)n_terms * STATS_WARPS);  // [K][dim]
  for (int i = threadIdx.x; i < K * dim; i += blockDim.x) map[i] = (int)mapping[i];

  const int r = blockIdx.y, tile = blockIdx.x, lane = threadIdx.x % WARP,
            warp = threadIdx.x / WARP;
  const long long row = (long long)r * B, n = n_blocks[r];
  const long long first = (long long)tile * TILE + (long long)threadIdx.x * PER_THREAD;
  int s[PER_THREAD], prev[PER_THREAD];
  float size[PER_THREAD];
  unsigned in_row = 0, valid = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long b = first + i;
    s[i] = 0;
    size[i] = 0.0f;
    if (b < B) {
      in_row |= 1u << i;
      s[i] = (int)states[row + b];
      size[i] = (float)sizes[row + b];  // sizes.to(float32): round to nearest
      if (b < n) valid |= 1u << i;
    }
  }
  prev[0] = (first > 0 && first - 1 < B) ? (int)states[row + first - 1] : 0;
#pragma unroll
  for (int i = 1; i < PER_THREAD; ++i) prev[i] = s[i - 1];
  __syncthreads();  // map

  float v[PER_THREAD];
  // state counts and the self-transitions of the diagonal
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const float m = ((valid >> i) & 1u) && s[i] == k ? 1.0f : 0.0f;
      v[i] = ((in_row >> i) & 1u) ? __fmul_rn(m, size[i]) : 0.0f;
    }
    reduce_term(v, Bp, lane, &warp_sums[k * STATS_WARPS + warp]);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const float m = ((valid >> i) & 1u) && s[i] == k ? 1.0f : 0.0f;
      v[i] = ((in_row >> i) & 1u) ? __fmul_rn(m, __fsub_rn(size[i], 1.0f)) : 0.0f;
    }
    reduce_term(v, Bp, lane, &warp_sums[(K + k) * STATS_WARPS + warp]);
  }
  // one prev -> cur transition per valid block
  for (int ij = 0; ij < K * K; ++ij) {
    const int from = ij / K, to = ij % K;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      v[i] = ((valid >> i) & 1u) && prev[i] == from && s[i] == to ? 1.0f : 0.0f;
    reduce_term(v, Bp, lane, &warp_sums[(2 * K + ij) * STATS_WARPS + warp]);
  }
  // theta statistics through the mapping, per data dimension
  const int theta0 = 2 * K + K * K;
  for (int d = 0; d < dim; ++d) {
    int pm[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) pm[i] = (s[i] >= 0 && s[i] < K) ? map[s[i] * dim + d] : -1;
    for (int q = 0; q < 3; ++q) {
      float x[PER_THREAD];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i)
        x[i] = q == 2 ? size[i]
                      : (((in_row >> i) & 1u) ? bstats[((long long)(d * 2 + q) * R + r) * B + first + i]
                                              : 0.0f);
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
          const float m = ((valid >> i) & 1u) && pm[i] == p ? 1.0f : 0.0f;
          v[i] = ((in_row >> i) & 1u) ? __fmul_rn(m, x[i]) : 0.0f;
        }
        reduce_term(v, Bp, lane, &warp_sums[(theta0 + (d * 3 + q) * P + p) * STATS_WARPS + warp]);
      }
    }
  }
  __syncthreads();
  // the 8 warps' nodes (sizes 512, 1024, 2048), one term per thread
  for (int j = threadIdx.x; j < n_terms; j += blockDim.x) {
    float w[STATS_WARPS];
#pragma unroll
    for (int i = 0; i < STATS_WARPS; ++i) w[i] = warp_sums[j * STATS_WARPS + i];
    w[0] = combine(w[0], w[1], 512, Bp);
    w[2] = combine(w[2], w[3], 512, Bp);
    w[4] = combine(w[4], w[5], 512, Bp);
    w[6] = combine(w[6], w[7], 512, Bp);
    w[0] = combine(w[0], w[2], 1024, Bp);
    w[4] = combine(w[4], w[6], 1024, Bp);
    partials[((long long)r * n_terms + j) * tiles + tile] = combine(w[0], w[4], 2048, Bp);
  }
}

// The tree over each row's tile sums (zero-padded to tiles_p, a power of
// two) and the assembly: out (R, 3P + K*K + K) = theta sums, sums of
// squares, counts (each summed over d in order from 0), trans (pairs +
// diag), state counts.
__global__ void __launch_bounds__(TOTAL_THREADS)
modelupdate_stats_total_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               int K, int dim, int P, int n_terms, int tiles, long long tiles_p) {
  extern __shared__ float term[];  // [n_terms]
  const int r = blockIdx.x, lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const long long chunk = tiles_p > WARP ? tiles_p / WARP : 1;
  const int active = (int)(tiles_p / chunk);
  int levels = 0;
  while ((1LL << levels) < chunk) ++levels;
  for (int j = warp; j < n_terms; j += TOTAL_THREADS / WARP) {
    const float* leaves = partials + ((long long)r * n_terms + j) * tiles;
    float x = 0.0f;
    if (lane < active) {
      // a sequential pairwise tree over the lane's chunk: stack[l] holds the
      // pending left node of size 2^l
      float stack[MAX_STACK];
      for (long long i = 0; i < chunk; ++i) {
        const long long t = lane * chunk + i;
        float node = t < tiles ? leaves[t] : 0.0f;
        int l = 0;
        for (long long c = i; c & 1; c >>= 1) node = __fadd_rn(stack[l++], node);
        stack[l] = node;
      }
      x = stack[levels];
    }
    for (int off = 1; off < active; off <<= 1) {
      const float other = __shfl_down_sync(FULL_MASK, x, off);
      if ((lane & (2 * off - 1)) == 0) x = __fadd_rn(x, other);
    }
    if (lane == 0) term[j] = x;
  }
  __syncthreads();
  const int n_out = 3 * P + K * K + K, theta0 = 2 * K + K * K;
  float* o = out + (long long)r * n_out;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    if (t < 3 * P) {
      const int q = t / P, p = t % P;
      float acc = 0.0f;
      for (int d = 0; d < dim; ++d) acc = __fadd_rn(acc, term[theta0 + (d * 3 + q) * P + p]);
      o[t] = acc;
    } else if (t < 3 * P + K * K) {
      const int ij = t - 3 * P, i = ij / K, j = ij % K;
      o[t] = __fadd_rn(term[2 * K + ij], i == j ? term[K + i] : 0.0f);
    } else {
      o[t] = term[t - 3 * P - K * K];
    }
  }
}

namespace {

// (float) of the double the Python source writes
#define F32(x) ((float)(x))

// gamma_fixed_tries for one shape a: x, u strided by n (TRIES of each), ub.
__device__ float gamma_fixed(float a, const float* x, const float* u, float ub, int n) {
  const bool boost = a < 1.0f;
  const float a_eff = boost ? __fadd_rn(a, 1.0f) : a;
  const float d = __fsub_rn(a_eff, F32(1.0 / 3.0));
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fmul_rn(d, 9.0f)));  // reciprocal(sqrt(9 d))
  bool found = false;
  float g = d;  // the mode, when every try is rejected
  for (int k = 0; k < TRIES; ++k) {
    const float xk = x[k * n], uk = clamp_min(u[k * n], F32(1e-38));
    const float t = __fmul_rn(c, xk);
    const float w = __fadd_rn(t, 1.0f);
    const float v = __fmul_rn(__fmul_rn(w, w), w);
    float s = __fsub_rn(F32(1.0 / 7.0), __fmul_rn(t, 0.125f));
    s = __fsub_rn(F32(1.0 / 6.0), __fmul_rn(t, s));
    s = __fsub_rn(F32(1.0 / 5.0), __fmul_rn(t, s));
    s = __fsub_rn(F32(1.0 / 4.0), __fmul_rn(t, s));
    s = __fsub_rn(F32(1.0 / 3.0), __fmul_rn(t, s));
    s = __fsub_rn(F32(1.0 / 2.0), __fmul_rn(t, s));
    const float tt = __fmul_rn(t, t);
    const float series = __fmul_rn(-tt, s);
    const float logged = __fsub_rn(log1pf(clamp_min(t, F32(-0.999999))), t);
    const float lmt = fabsf(t) < F32(0.1) ? series : logged;
    const float quad = __fmul_rn(__fmul_rn(xk, 0.5f), xk);
    const float inner = __fsub_rn(__fmul_rn(lmt, 3.0f), __fmul_rn(tt, __fadd_rn(t, 3.0f)));
    const float stat = __fadd_rn(quad, __fmul_rn(d, inner));
    const bool ok = v > 0.0f && logf(uk) < stat;
    if (ok && !found) {  // the first accepted try (argmax of the mask)
      found = true;
      g = __fmul_rn(d, clamp_min(v, 0.0f));
    }
  }
  if (boost) {
    const float e = __fdiv_rn(1.0f, clamp_min(a, F32(1e-6)));  // reciprocal(clamp(a, 1e-6))
    g = __fmul_rn(g, powf(clamp_min(ub, F32(1e-38)), e));
  }
  return g;
}

}  // namespace

// nig (P, 4), a_alphas (K, K), pi_alphas (K,); the statistics; the noise x,
// u (TRIES, n), ub (n,), z (P,); outputs mean, var (P,), A (K, K), pi (K,).
__global__ void __launch_bounds__(RESAMPLE_THREADS)
modelupdate_resample_kernel(const float* __restrict__ nig, const float* __restrict__ a_alphas,
                            const float* __restrict__ pi_alphas, const float* __restrict__ sums,
                            const float* __restrict__ sumsqs, const float* __restrict__ counts,
                            const float* __restrict__ trans, const float* __restrict__ state,
                            const float* __restrict__ x, const float* __restrict__ u,
                            const float* __restrict__ ub, const float* __restrict__ z,
                            float* __restrict__ mean, float* __restrict__ var,
                            float* __restrict__ A, float* __restrict__ pi, int P, int K) {
  extern __shared__ float g[];  // [n]
  const int KK = K * K, n = P + KK + K;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < P) {
      // nig_update (Conjugate.hpp:120-168)
      const float alpha = nig[4 * i], beta = nig[4 * i + 1], mu0 = nig[4 * i + 2],
                  nu = nig[4 * i + 3];
      const float cnt = counts[i], sm = sums[i], sq = sumsqs[i];
      const float safe_n = clamp_min(cnt, 1.0f);
      const float xbar = __fdiv_rn(sm, safe_n);
      const float ssn = minimum(__fdiv_rn(__fmul_rn(sm, sm), safe_n), sq);
      const float dev = __fsub_rn(xbar, mu0);
      const float new_alpha = __fadd_rn(alpha, __fmul_rn(cnt, 0.5f));
      const float shrink = __fdiv_rn(__fmul_rn(cnt, nu), __fadd_rn(cnt, nu));
      const float spread = __fsub_rn(__fadd_rn(sq, __fmul_rn(shrink, __fmul_rn(dev, dev))), ssn);
      const float new_beta = __fadd_rn(beta, __fmul_rn(spread, 0.5f));
      const float new_mu0 = __fdiv_rn(__fadd_rn(__fmul_rn(nu, mu0), sm), __fadd_rn(nu, cnt));
      const float new_nu = __fadd_rn(nu, cnt);
      const bool seen = cnt > 0.0f;
      const float a = seen ? new_alpha : alpha, b = seen ? new_beta : beta,
                  m0 = seen ? new_mu0 : mu0, n0 = seen ? new_nu : nu;
      const float gi = gamma_fixed(a, x + i, u + i, ub[i], n);
      const float vi = __fdiv_rn(b, gi);
      var[i] = vi;
      mean[i] = __fadd_rn(m0, __fmul_rn(__fsqrt_rn(__fdiv_rn(vi, n0)), z[i]));
      g[i] = gi;
    } else {
      const float a = i < P + KK ? __fadd_rn(a_alphas[i - P], trans[i - P])
                                 : __fadd_rn(pi_alphas[i - P - KK], state[i - P - KK]);
      g[i] = gamma_fixed(a, x + i, u + i, ub[i], n);
    }
  }
  __syncthreads();
  // A's rows and pi, each over its sum taken left to right
  for (int i = P + threadIdx.x; i < n; i += blockDim.x) {
    const int first = i < P + KK ? P + (i - P) / K * K : P + KK;
    float total = g[first];
    for (int j = 1; j < K; ++j) total = __fadd_rn(total, g[first + j]);
    const float q = __fdiv_rn(g[i], total);
    if (i < P + KK)
      A[i - P] = q;
    else
      pi[i - P - KK] = q;
  }
}

namespace {

// dynamic shared memory a launch may take without cudaFuncSetAttribute
constexpr long long SMEM_BYTES = 48 * 1024;

cudaError_t allow_smem(const void* kernel, long long bytes) {
  if (bytes <= SMEM_BYTES) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

long long next_pow2(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

int stats_terms(int K, int dim, int P) { return 2 * K + K * K + 3 * P * dim; }

long long stats_tiles(long long B) { return (B + TILE - 1) / TILE; }

}  // namespace

// Floats of workspace a statistics call needs: the (R, n_terms, tiles)
// tile sums.
extern "C" long long hammlet_sweep_stats_workspace(int R, long long B, int K, int dim, int P) {
  return (long long)R * stats_terms(K, dim, P) * stats_tiles(B);
}

extern "C" int hammlet_sweep_stats(const int64_t* states, const int64_t* sizes,
                                   const int64_t* n_blocks, const float* bstats,
                                   const int64_t* mapping, float* out, float* work, int R,
                                   long long B, int K, int dim, int P, int device, void* stream) {
  if (R < 1 || B < 1 || K < 1 || dim < 1 || P < 1 || R > 65535 || stats_tiles(B) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_terms = stats_terms(K, dim, P);
  const long long tiles = stats_tiles(B), Bp = next_pow2(B);
  const long long tile_smem = (long long)n_terms * STATS_WARPS * sizeof(float) + K * dim * sizeof(int);
  err = allow_smem((const void*)modelupdate_stats_tile_kernel, tile_smem);
  if (err != cudaSuccess) return (int)err;
  modelupdate_stats_tile_kernel<<<dim3((unsigned)tiles, (unsigned)R), STATS_THREADS, tile_smem, s>>>(
      states, sizes, n_blocks, bstats, mapping, work, R, B, Bp, K, dim, P, n_terms, (int)tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total_smem = (long long)n_terms * sizeof(float);
  err = allow_smem((const void*)modelupdate_stats_total_kernel, total_smem);
  if (err != cudaSuccess) return (int)err;
  modelupdate_stats_total_kernel<<<R, TOTAL_THREADS, total_smem, s>>>(
      work, out, K, dim, P, n_terms, (int)tiles, next_pow2(tiles));
  return (int)cudaGetLastError();
}

extern "C" int hammlet_resample_model(const float* nig, const float* a_alphas,
                                      const float* pi_alphas, const float* sums,
                                      const float* sumsqs, const float* counts,
                                      const float* trans, const float* state, const float* x,
                                      const float* u, const float* ub, const float* z, float* mean,
                                      float* var, float* A, float* pi, int P, int K, int device,
                                      void* stream) {
  if (P < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long smem = (long long)(P + K * K + K) * sizeof(float);
  err = allow_smem((const void*)modelupdate_resample_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  modelupdate_resample_kernel<<<1, RESAMPLE_THREADS, smem, (cudaStream_t)stream>>>(
      nig, a_alphas, pi_alphas, sums, sumsqs, counts, trans, state, x, u, ub, z, mean, var, A, pi,
      P, K);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
