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
// ... over d. The tree splits exactly at every aligned power-of-two node,
// so one cooperative launch of modelupdate_stats_kernel reproduces it:
//   1. A persistent grid, sized by occupancy. A CTA takes a run of RUN
//      aligned tiles of TILE blocks of one row (RUN a power of two, the
//      least that gives every run of every row its own CTA, or where the
//      terms' run stacks no longer fit beside the stages, the least within
//      MAX_RUNS, each CTA then taking several runs in turn) and a slice of
//      the terms: where rows x runs leave CTAs idle, the float terms in
//      slices (at the settled P = 1 capacity, B = 29,696, 29 tiles: 145
//      CTAs of one tile and 3 terms each); where a CTA's shared memory
//      cannot hold every term's stack, the float terms and the K*K pair
//      terms both in slices (K = 81, dim 4, B = 4M: two slices of the pair
//      terms). It stages tile c + 1 into shared memory (16-byte
//      cp.async copies, neighbouring threads on neighbouring addresses)
//      while it sums tile c. Per tile, each thread forms the nodes of its
//      PER_THREAD neighbouring blocks in registers (node sizes 2-8) for
//      every float term (state, diag, theta); the nodes go to shared
//      memory as [term][thread], and the cross-thread levels (node sizes
//      16 to TILE) run over (term, pair) work items shared among all
//      threads, one barrier per level: 7 dependent levels for a group of
//      TERM_GROUP terms at once, groups one after another, each tree in
//      the same order. The pair terms are counts of one-hot leaves, exact
//      integers within a tile whatever the order, so one shared-memory
//      histogram per tile (of the slice's pair terms) gives their tile
//      sums. A tile's sums join the run's tree on per-term stacks in
//      shared memory (the binary counter of the tile's position in the
//      run; a stack for each term of the CTA's slice); the run's sums go
//      to device memory.
//   2. A grid-wide barrier (no counter in device memory: the workspace is
//      torch.empty per call, and calls from several threads share a card).
//   3. One CTA per output of a row: a warp per term the output needs (the
//      tree over the row's run sums, zero-padded to a power of two: each
//      lane's neighbouring sums in registers, then shuffles), then the
//      assembly.
// Every level combines only while its node size is at most Bp, so a row
// shorter than a tile stops at its own root: adding a padding zero would
// turn a -0.0 sum into +0.0. No atomics on floats: the bytes do not change
// from run to run. What bounds it: bytes where B is large (B = 4M, dim 1:
// 96 MB of int64 states and sizes and float32 block statistics, 28.7 us
// at 3.35 TB/s; the float terms take a compare, a select and an add per
// block each), and at the settled capacity (0.71 MB, 0.21 us) the launch,
// the grid barrier, two round trips to memory and the tree's dependent
// levels.
//
// Resample: one CTA, one launch. Eight lanes per Gamma shape, in aligned
// groups of eight within a warp: shape i of the n = P + K*K + K (the NIG
// posterior's alpha for the P emission parameters, then A's Dirichlet
// rows, then pi's), lane k its try k of the fixed-depth Marsaglia-Tsang
// sampler from the pre-drawn noise (8 proposal normals and acceptance
// uniforms, one boost uniform); shapes beyond one CTA's threads in a loop.
// The group's ballot picks its first accepted try (the mode when none is),
// the value comes by shuffle, and lane 0 of the group applies the boost
// and, for i < P, writes var = beta' / g and mean = mu0' + sqrt(var / nu')
// z; every lane of a theta shape's group computes the same NIG update.
// After a barrier each entry of A and pi divides by its row's sum taken
// left to right over the K columns. The draws wait for that in shared
// memory; where the n of them do not fit (K >= 241: 232,448 bytes), the
// shapes go in passes of whole rows, each pass's draws, barrier and
// divisions before the next. A few dozen values at K <= 10: the bound is
// latency, one chain of a try's transcendentals.
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
// its launch (0 = launched); none synchronizes or allocates: the caller
// hands in the workspace (hammlet_sweep_stats_workspace floats) and the
// outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xffffffffu
#define STATS_THREADS 128
#define STATS_WARPS (STATS_THREADS / WARP)
#define PER_THREAD 8    // neighbouring blocks per thread, summed in registers
#define TILE (STATS_THREADS * PER_THREAD)  // blocks per tile
#define TERM_GROUP 16   // terms whose tile trees run together in shared memory
#define MAX_RUNS 1024   // run sums per row and term at most (a power of two)
#define LANE_RUNS (MAX_RUNS / WARP)  // run sums per lane in the tree over a row's runs
#define MAX_STAGED_DIM 8  // block statistics staged in shared memory up to this dim
#define MIN_SLICE_TERMS 3  // terms a CTA takes at least when a call has fewer tiles than CTAs
#define RESAMPLE_THREADS 1024
#define TRIES 8  // gamma_fixed_tries' fixed depth: lanes per Gamma shape

namespace cg = cooperative_groups;

static_assert(STATS_THREADS == 128, "7 cross-thread levels: the last one writes the second buffer");
static_assert(PER_THREAD == 8, "three in-thread levels");
static_assert(TERM_GROUP <= STATS_THREADS, "thread k takes term k of a group at the top");
static_assert(TERM_GROUP * (STATS_THREADS + STATS_THREADS / 2) <= 4 * TILE,
              "a group's two tree buffers fit where a tile's states and sizes were staged");
static_assert(TRIES == 8 && WARP % TRIES == 0, "a warp holds whole groups of tries");

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

// A thread's 8 leaves of one term, node sizes 2, 4, 8.
__device__ __forceinline__ float thread_tree(const float (&v)[PER_THREAD], long long Bp) {
  if (Bp >= PER_THREAD) {
    return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                     __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
  }
  return combine(combine(combine(v[0], v[1], 2, Bp), combine(v[2], v[3], 2, Bp), 4, Bp),
                 combine(combine(v[4], v[5], 2, Bp), combine(v[6], v[7], 2, Bp), 4, Bp), 8, Bp);
}

// 16 (8) bytes from device memory into shared memory, asynchronously
// (waited for by cp_async_wait_all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements e0 .. e0 + TILE - 1 of a row of B into dst (0 past the row):
// 16-byte copies, neighbouring threads on neighbouring addresses, where
// the row is 16-byte aligned and the chunk lies in it.
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ row, long long e0, long long B) {
  constexpr int per = 16 / sizeof(T), chunks = TILE / per;
  static_assert(chunks % STATS_THREADS == 0, "whole chunks per thread");
  if (aligned16(row) && e0 + TILE <= B) {  // the whole tile in the row: no checks per chunk
#pragma unroll
    for (int i = 0; i < chunks / STATS_THREADS; ++i) {
      const int c = threadIdx.x + i * STATS_THREADS;
      cp_async16(dst + c * per, row + e0 + c * per);
    }
    return;
  }
  for (int c = threadIdx.x; c < chunks; c += STATS_THREADS) {
    const long long e = e0 + (long long)c * per;
    if (aligned16(row) && e + per <= B) {
      cp_async16(dst + c * per, row + e);
    } else {
      for (int m = 0; m < per; ++m) dst[c * per + m] = e + m < B ? row[e + m] : T(0);
    }
  }
}

// One level of a compact tree in shared memory: out[k] = in[2k] + in[2k + 1]
// for k < items, the pairs read as one float2 (bank-conflict free).
__device__ __forceinline__ void tree_level(const float* in, float* out, int items, bool add) {
  const float2* pairs = reinterpret_cast<const float2*>(in);
  for (int k = threadIdx.x; k < items; k += STATS_THREADS) {
    const float2 p = pairs[k];
    out[k] = add ? __fadd_rn(p.x, p.y) : p.x;
  }
}

// The pairwise tree over one row's `runs` run sums of one term (in device
// memory, written by other CTAs before the grid barrier), zero-padded to
// runs_p <= MAX_RUNS, by one warp: each lane loads its runs_p / 32 (at
// least 1) neighbouring sums at once, sums them in registers, then the
// lanes by shuffles. Every lane returns the root.
__device__ float warp_tree(const float* part, int runs, int runs_p, int lane) {
  const int chunk = runs_p > WARP ? runs_p / WARP : 1, active = runs_p / chunk;
  float x;
  if (chunk == 1) {  // a sum per lane (the settled capacity's 29 runs)
    x = lane < runs ? __ldcg(part + lane) : 0.0f;
  } else {
    float v[LANE_RUNS];
#pragma unroll
    for (int i = 0; i < LANE_RUNS; ++i) {
      const int t = lane * chunk + i;
      v[i] = (i < chunk && t < runs) ? __ldcg(part + t) : 0.0f;
    }
#pragma unroll
    for (int width = 1; width < LANE_RUNS; width <<= 1) {
      if (2 * width <= chunk) {
#pragma unroll
        for (int i = 0; i < LANE_RUNS; i += 2 * width) v[i] = __fadd_rn(v[i], v[i + width]);
      }
    }
    x = v[0];
  }
  for (int off = 1; off < active; off <<= 1) {
    const float other = __shfl_down_sync(FULL_MASK, x, off);
    if ((lane & (2 * off - 1)) == 0) x = __fadd_rn(x, other);
  }
  return __shfl_sync(FULL_MASK, x, 0);
}

}  // namespace

// The statistics of R rows in one cooperative launch (see the top).
// states, sizes: (R, B) int64; n_blocks: (R,) int64; bstats: (dim, 2, R,
// B) float32; mapping: (K, dim) int64; partials: (R, n_terms, runs)
// float32 workspace; out: (R, 3P + K*K + K) float32. The float terms
// (state, diag, theta: f = 0 .. 2K + 3 P dim - 1, term j = f below 2K,
// else f + K*K) go through the trees; the K*K pair terms are counts of
// one-hot leaves, so a tile's pair sums are exact integers (at most TILE)
// whatever the order: one shared-memory histogram per tile takes their
// place, and above the tile they join the same run and row trees. Work
// items (row, run, slice): a CTA sums the float terms [slice *
// slice_terms, + slice_terms) and the pair terms [slice * pair_terms, +
// pair_terms) of a run of RUN = 2^run_log tiles, staging tile c + 1 while
// it sums tile c. Dynamic shared memory (floats): two stages of
// `stage_floats` (a tile's states and sizes as int64, whose place the two
// tree buffers take once they are read, its block statistics when
// `staged`, the state before it), the run stacks ((slice_terms +
// pair_terms) * depth: the slice's float terms, then its pair terms), the
// mapping (K * dim int64), the slice's pair histogram (pair_terms ints).
__global__ void __launch_bounds__(STATS_THREADS)
modelupdate_stats_kernel(const int64_t* __restrict__ states, const int64_t* __restrict__ sizes,
                         const int64_t* __restrict__ n_blocks, const float* __restrict__ bstats,
                         const int64_t* __restrict__ mapping, float* __restrict__ partials,
                         float* __restrict__ out, int R, long long B, long long Bp, int K,
                         int dim, int P, int n_terms, long long tiles, int run_log, int runs,
                         int runs_p, int slices, int slice_terms, int pair_terms, int stage_floats,
                         int depth, bool staged) {
  extern __shared__ float smem[];
  float* stacks = smem + 2 * stage_floats;  // [slice_terms + pair_terms][depth]
  int64_t* map = reinterpret_cast<int64_t*>(
      stacks + ((slice_terms + pair_terms) * depth + 1) / 2 * 2);  // [K][dim]
  int* hist = reinterpret_cast<int*>(map + K * dim);  // [pair_terms]
  const int tid = threadIdx.x, KK = K * K, theta0 = 2 * K + KK, n_float = n_terms - KK;
  // one more node of the run tree of the slice's term j (float terms first,
  // then pair terms) at tile c of the run (the binary counter of c: each
  // full level adds its left node)
  auto push = [&](int j, long long c, float node) {
    float* st = stacks + j * depth;
    int l = 0;
    for (long long cc = c; cc & 1; cc >>= 1) node = __fadd_rn(st[l++], node);
    st[l] = node;
  };
  for (int i = tid; i < K * dim; i += STATS_THREADS) cp_async8(map + i, mapping + i);

  const long long RUN = 1LL << run_log;
  for (int w = blockIdx.x; w < R * runs * slices; w += gridDim.x) {
    const int slice = w % slices, run = w / slices % runs, r = w / slices / runs;
    const int t0 = slice * slice_terms,
              t1 = t0 + slice_terms < n_float ? t0 + slice_terms : n_float;
    const int p0 = slice * pair_terms, p1 = p0 + pair_terms < KK ? p0 + pair_terms : KK;
    const bool pairs = p0 < p1;
    const long long n = n_blocks[r];
    const int64_t* st_row = states + (long long)r * B;
    const int64_t* sz_row = sizes + (long long)r * B;
    // stage tile `tile` of this row into stage `buf`
    auto fetch = [&](long long tile, int buf) {
      float* base = smem + buf * stage_floats;
      const long long e0 = tile * TILE;
      stage(reinterpret_cast<int64_t*>(base), st_row, e0, B);
      stage(reinterpret_cast<int64_t*>(base) + TILE, sz_row, e0, B);
      if (staged) {
        for (int dq = 0; dq < 2 * dim; ++dq)
          stage(base + 4 * TILE + dq * TILE, bstats + ((long long)dq * R + r) * B, e0, B);
      }
      int64_t* before = reinterpret_cast<int64_t*>(base + stage_floats - 2);
      if (tid == 0) {
        if (e0 > 0)
          cp_async8(before, st_row + e0 - 1);
        else
          *before = 0;
      }
    };
    const long long first = (long long)run * RUN;
    __syncthreads();  // the last item's trees and stages are read
    if (first < tiles) fetch(first, 0);
    for (long long c = 0; c < RUN; ++c) {
      const long long tile = first + c;
      if (tile >= tiles) {  // padding past the row: the tile's sum is +0.0
        for (int f = t0 + tid; tid < TERM_GROUP && f < t1; f += TERM_GROUP) push(f - t0, c, 0.0f);
        for (int ij = p0 + tid; ij < p1; ij += STATS_THREADS) push(slice_terms + ij - p0, c, 0.0f);
        continue;
      }
      cp_async_wait_all();
      __syncthreads();  // tile c is staged; the other stage is free
      if (c + 1 < RUN && tile + 1 < tiles) fetch(tile + 1, (int)((c + 1) & 1));
      float* base = smem + (c & 1) * stage_floats;
      const int64_t* stage_s = reinterpret_cast<const int64_t*>(base);
      const int64_t* stage_z = stage_s + TILE;
      const float* stage_x = base + 4 * TILE;

      // this thread's blocks b0 .. b0 + 7: state (-1 unless valid), transition
      // code prev * K + s (-1 unless valid), size and size - 1 as float32 (+0.0
      // past the row). A leaf whose mask is 0 is 0 * value (-0.0 for a negative
      // value, NaN for NaN), as the plain version's mask * value.
      const long long b0 = tile * TILE + (long long)tid * PER_THREAD;
      int s[PER_THREAD], se[PER_THREAD], code[PER_THREAD];
      float size[PER_THREAD], sm1[PER_THREAD];
#pragma unroll
      for (int i = 0; i < PER_THREAD; i += 2) {
        const longlong2 sv = reinterpret_cast<const longlong2*>(stage_s + tid * PER_THREAD)[i / 2];
        const longlong2 zv = reinterpret_cast<const longlong2*>(stage_z + tid * PER_THREAD)[i / 2];
        s[i] = (int)sv.x;
        s[i + 1] = (int)sv.y;
        size[i] = (float)zv.x;  // sizes.to(float32): round to nearest
        size[i + 1] = (float)zv.y;
      }
      int prev = (int)(tid > 0 ? stage_s[tid * PER_THREAD - 1]
                               : *reinterpret_cast<const int64_t*>(base + stage_floats - 2));
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const bool in_row = b0 + i < B, valid = in_row && b0 + i < n;
        const bool known = s[i] >= 0 && s[i] < K, prev_known = prev >= 0 && prev < K;
        se[i] = valid ? s[i] : -1;
        code[i] = valid && known && prev_known ? prev * K + s[i] : -1;
        sm1[i] = in_row ? __fsub_rn(size[i], 1.0f) : 0.0f;
        prev = s[i];
        if (!valid || !known) s[i] = -1;  // for the mapping: no parameter
      }
      for (int q = tid; q < p1 - p0; q += STATS_THREADS) hist[q] = 0;
      __syncthreads();  // the staged states and sizes are read: the trees take their place
      float* tree_a = base;  // [group][STATS_THREADS], then [group][STATS_THREADS / 2]
      if (pairs) {  // one prev -> cur transition per valid block, those of the slice
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i)
          if (code[i] >= p0 && code[i] < p1) atomicAdd(hist + code[i] - p0, 1);
      }

      for (int g0 = t0; g0 < t1; g0 += TERM_GROUP) {
        const int g1 = t1 - g0 < TERM_GROUP ? t1 : g0 + TERM_GROUP, gn = g1 - g0;
        float v[PER_THREAD];
        auto emit = [&](int j) { tree_a[(j - g0) * STATS_THREADS + tid] = thread_tree(v, Bp); };
        // state counts, then the self-transitions of the diagonal
        for (int k = max(g0, 0); k < min(g1, K); ++k) {
#pragma unroll
          for (int i = 0; i < PER_THREAD; ++i)
            v[i] = se[i] == k ? size[i] : __fmul_rn(0.0f, size[i]);
          emit(k);
        }
        for (int k = max(g0 - K, 0); k < min(g1 - K, K); ++k) {
#pragma unroll
          for (int i = 0; i < PER_THREAD; ++i) v[i] = se[i] == k ? sm1[i] : __fmul_rn(0.0f, sm1[i]);
          emit(K + k);
        }
        // theta statistics through the mapping: term theta0 + (d * 3 + q) * P + p
        if (g1 > 2 * K) {
          const int lo = max(g0, 2 * K) - 2 * K;
          int d = lo / (3 * P), q = lo / P % 3, p = lo % P;
          int pm[PER_THREAD];
          float x[PER_THREAD], x0[PER_THREAD];
          for (int f = 2 * K + lo; f < g1; ++f) {
            if (f == 2 * K + lo || p == 0) {  // a new (d, q): its values, and for a new d the mapping
              if (f == 2 * K + lo || q == 0) {
#pragma unroll
                for (int i = 0; i < PER_THREAD; ++i) pm[i] = s[i] >= 0 ? (int)map[s[i] * dim + d] : -1;
              }
              if (q == 2) {
#pragma unroll
                for (int i = 0; i < PER_THREAD; ++i) x[i] = size[i];
              } else if (staged) {
                const float4* row = reinterpret_cast<const float4*>(
                    stage_x + (d * 2 + q) * TILE + tid * PER_THREAD);
                const float4 lo4 = row[0], hi4 = row[1];
                x[0] = lo4.x, x[1] = lo4.y, x[2] = lo4.z, x[3] = lo4.w;
                x[4] = hi4.x, x[5] = hi4.y, x[6] = hi4.z, x[7] = hi4.w;
              } else {
                const float* row = bstats + ((long long)(d * 2 + q) * R + r) * B;
#pragma unroll
                for (int i = 0; i < PER_THREAD; ++i) x[i] = b0 + i < B ? row[b0 + i] : 0.0f;
              }
#pragma unroll
              for (int i = 0; i < PER_THREAD; ++i) x0[i] = __fmul_rn(0.0f, x[i]);
            }
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i) v[i] = pm[i] == p ? x[i] : x0[i];
            emit(f);
            if (++p == P) {
              p = 0;
              if (++q == 3) {
                q = 0;
                ++d;
              }
            }
          }
        }
        __syncthreads();
        // the cross-thread levels over (term, pair) items, node sizes 16..TILE
        float *src = tree_a, *dst = tree_a + gn * STATS_THREADS;
        long long size = 2 * PER_THREAD;
        for (int nodes = STATS_THREADS / 2; nodes >= 1; nodes >>= 1, size <<= 1) {
          tree_level(src, dst, gn * nodes, size <= Bp);
          __syncthreads();
          float* t = src;
          src = dst;
          dst = t;
        }
        // the tile's sums (an odd number of levels up: not in tree_a) join the run's trees
        if (tid < gn) push(g0 + tid - t0, c, src[tid]);
      }
      // the tile's pair counts (read after the groups' barriers; a slice of
      // pair terms alone has none)
      if (pairs && t0 >= t1) __syncthreads();
      for (int ij = p0 + tid; ij < p1; ij += STATS_THREADS)
        push(slice_terms + ij - p0, c, (float)hist[ij - p0]);
    }
    // the run's sums: thread k wrote the stacks of float terms t0 + k, t0 + k +
    // TERM_GROUP, ... and of pair terms p0 + k, p0 + k + STATS_THREADS, ...
    float* row_part = partials + (long long)r * n_terms * runs + run;
    for (int f = t0 + tid; tid < TERM_GROUP && f < t1; f += TERM_GROUP) {
      const int j = f < 2 * K ? f : f + KK;
      row_part[(long long)j * runs] = stacks[(f - t0) * depth + run_log];
    }
    for (int ij = p0 + tid; ij < p1; ij += STATS_THREADS)
      row_part[(long long)(2 * K + ij) * runs] = stacks[(slice_terms + ij - p0) * depth + run_log];
  }

  cp_async_wait_all();  // a CTA without items still has the mapping in flight
  cg::this_grid().sync();

  // one CTA per output of a row: a warp per term it needs (the tree over
  // the row's run sums), then the assembly: out (R, 3P + K*K + K) = theta
  // sums, sums of squares, counts (each summed over d in order from 0),
  // trans (pairs + diag), state counts
  const int n_out = 3 * P + K * K + K, lane = tid % WARP;
  float* sums = smem;  // [dim] the output's term totals
  for (int w = blockIdx.x; w < R * n_out; w += gridDim.x) {
    const int r = w / n_out, o = w % n_out;
    const float* part = partials + (long long)r * n_terms * runs;
    const bool theta = o < 3 * P, pairs = !theta && o < 3 * P + K * K;
    const int ij = o - 3 * P, diag = pairs && ij / K == ij % K;
    const int count = theta ? dim : 1 + diag;
    __syncthreads();  // the last output's totals are read
    for (int m = tid / WARP; m < count; m += STATS_WARPS) {
      const int j = theta ? theta0 + (m * 3 + o / P) * P + o % P
                          : (pairs ? (m == 0 ? 2 * K + ij : K + ij / K) : o - 3 * P - K * K);
      const float total = warp_tree(part + (long long)j * runs, runs, runs_p, lane);
      if (lane == 0) sums[m] = total;
    }
    __syncthreads();
    if (tid == 0) {
      float value = theta ? 0.0f : sums[0];
      if (theta) {
        for (int d = 0; d < dim; ++d) value = __fadd_rn(value, sums[d]);
      } else if (pairs) {
        value = __fadd_rn(value, diag ? sums[1] : 0.0f);
      }
      out[(long long)r * n_out + o] = value;
    }
  }
}

namespace {

// (float) of the double the Python source writes
#define F32(x) ((float)(x))

// Try k of gamma_fixed_tries for the shape whose mode is d (c = 1 /
// sqrt(9 d)), from its proposal normal xk and acceptance uniform uk:
// whether it is accepted, and its candidate d * max(v, 0).
__device__ __forceinline__ bool gamma_try(float d, float c, float xk, float uk_raw, float* cand) {
  const float uk = clamp_min(uk_raw, F32(1e-38));
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
  *cand = __fmul_rn(d, clamp_min(v, 0.0f));
  return v > 0.0f && logf(uk) < stat;
}

}  // namespace

// nig (P, 4), a_alphas (K, K), pi_alphas (K,); the statistics; the noise x,
// u (TRIES, n), ub (n,), z (P,); outputs mean, var (P,), A (K, K), pi (K,).
// blockDim.x: a multiple of WARP (every lane takes part in the votes).
// Dynamic shared memory: `cap` floats (cap >= P, cap >= K), the draws of
// one pass: shapes [lo, hi), hi the last row boundary (P, P + K, ..., P +
// K*K, n) within lo + cap. PASSES = false: one pass of all n (cap = n),
// the loop compiled away (in passes, the index arithmetic made the
// one-pass calls of K = 3 0.1-0.3 us slower, fbscan_probes.py turns).
template <bool PASSES>
__global__ void __launch_bounds__(RESAMPLE_THREADS)
modelupdate_resample_kernel(const float* __restrict__ nig, const float* __restrict__ a_alphas,
                            const float* __restrict__ pi_alphas, const float* __restrict__ sums,
                            const float* __restrict__ sumsqs, const float* __restrict__ counts,
                            const float* __restrict__ trans, const float* __restrict__ state,
                            const float* __restrict__ x, const float* __restrict__ u,
                            const float* __restrict__ ub, const float* __restrict__ z,
                            float* __restrict__ mean, float* __restrict__ var,
                            float* __restrict__ A, float* __restrict__ pi, int P, int K,
                            int cap) {
  extern __shared__ float g[];  // [cap]: draw i of the pass at g[i - lo]
  const int KK = K * K, n = P + KK + K, lane = threadIdx.x % WARP, k = threadIdx.x % TRIES;
  const int lead = lane - k;  // the group's first lane
  for (int lo = 0, hi; lo < n; lo = hi) {
    hi = !PASSES || lo + cap >= n ? n : P + (lo + cap - P) / K * K;
    for (int base = lo; base < hi; base += blockDim.x / TRIES) {  // the same trips for every thread
      const int i = base + threadIdx.x / TRIES;
      const bool live = i < hi, theta = live && i < P, row = live && i >= P;
      const int at = live ? i : 0;
      // every load of the trip first, so that they travel together
      const float xk = x[k * n + at], uk = u[k * n + at], ubi = ub[at];
      const float zi = theta ? z[i] : 0.0f;
      const float alpha = theta ? nig[4 * i] : 0.0f, beta = theta ? nig[4 * i + 1] : 0.0f,
                  mu0 = theta ? nig[4 * i + 2] : 0.0f, nu = theta ? nig[4 * i + 3] : 1.0f;
      const float cnt = theta ? counts[i] : 0.0f, sm = theta ? sums[i] : 0.0f,
                  sq = theta ? sumsqs[i] : 0.0f;
      const float prior = row ? (i < P + KK ? a_alphas[i - P] : pi_alphas[i - P - KK]) : 1.0f;
      const float seen_n = row ? (i < P + KK ? trans[i - P] : state[i - P - KK]) : 0.0f;
      float a = 1.0f, b = 0.0f, m0 = 0.0f, n0 = 1.0f;
      if (theta) {
        // nig_update (Conjugate.hpp:120-168), the same in every lane of the group
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
        a = seen ? new_alpha : alpha;
        b = seen ? new_beta : beta;
        m0 = seen ? new_mu0 : mu0;
        n0 = seen ? new_nu : nu;
      } else if (row) {
        a = __fadd_rn(prior, seen_n);
      }
      // gamma_fixed_tries for shape a: this lane's try, and the boost for a < 1
      const bool boost = a < 1.0f;
      const float a_eff = boost ? __fadd_rn(a, 1.0f) : a;
      const float d = __fsub_rn(a_eff, F32(1.0 / 3.0));
      const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fmul_rn(d, 9.0f)));  // reciprocal(sqrt(9 d))
      float cand = 0.0f;
      const bool ok = live && gamma_try(d, c, xk, uk, &cand);
      const float e = __fdiv_rn(1.0f, clamp_min(a, F32(1e-6)));  // reciprocal(clamp(a, 1e-6))
      const float lift = boost && k == 0 ? powf(clamp_min(ubi, F32(1e-38)), e) : 1.0f;
      // the first accepted try (argmax of the mask), else the mode
      const unsigned votes = (__ballot_sync(FULL_MASK, ok) >> lead) & ((1u << TRIES) - 1);
      const float first = __shfl_sync(FULL_MASK, cand, lead + (votes ? __ffs(votes) - 1 : 0));
      if (live && k == 0) {
        float gi = votes ? first : d;
        if (boost) gi = __fmul_rn(gi, lift);
        if (theta) {
          const float vi = __fdiv_rn(b, gi);
          var[i] = vi;
          mean[i] = __fadd_rn(m0, __fmul_rn(__fsqrt_rn(__fdiv_rn(vi, n0)), zi));
        }
        g[i - lo] = gi;
      }
    }
    __syncthreads();
    // the pass's rows of A and pi, each over its sum taken left to right
    for (int i = (lo > P ? lo : P) + threadIdx.x; i < hi; i += blockDim.x) {
      const int first = (i < P + KK ? P + (i - P) / K * K : P + KK) - lo;
      float total = g[first];
      for (int j = 1; j < K; ++j) total = __fadd_rn(total, g[first + j]);
      const float q = __fdiv_rn(g[i - lo], total);
      if (i < P + KK)
        A[i - P] = q;
      else
        pi[i - P - KK] = q;
    }
    if (hi < n) __syncthreads();  // the pass's draws are read before the next pass's
  }
}

namespace {

// dynamic shared memory a launch may take without cudaFuncSetAttribute
constexpr long long SMEM_BYTES = 48 * 1024;

long long stats_terms(int K, int dim, int P) { return 2LL * K + (long long)K * K + 3LL * P * dim; }

long long stats_tiles(long long B) { return (B + TILE - 1) / TILE; }

int log2_ceil(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

// Run sums per row of a call at most: the workspace holds (R, n_terms,
// this) floats whatever the run length the card's occupancy picks.
long long stats_runs_most(long long B) {
  const long long tiles = stats_tiles(B);
  return tiles < MAX_RUNS ? tiles : MAX_RUNS;
}

}  // namespace

// Floats of workspace a statistics call needs: the (R, n_terms, runs)
// run sums.
extern "C" long long hammlet_sweep_stats_workspace(int R, long long B, int K, int dim, int P) {
  return (long long)R * stats_terms(K, dim, P) * stats_runs_most(B);
}

// One cooperative launch of the statistics kernel: as many CTAs as rows x
// runs x slices, at most as many as the card holds at once (the grid
// barrier needs every CTA resident); runs of RUN = 2^run_log tiles, the
// least RUN with rows x runs within that and runs within MAX_RUNS, or,
// where a CTA's shared memory cannot hold the run stacks of every term
// (K = 81, dim 4 at B = 4M), the least within MAX_RUNS, the terms in
// slices whose stacks and histogram fit. The block statistics are staged
// where their two stages take at most half the card's shared memory.
// Above 48 KB of shared memory the kernel's limit is raised to the card's
// (the same value from every thread, so concurrent callers agree). A
// shape whose least slice does not fit returns cudaErrorInvalidValue; a
// card that refuses the cooperative launch returns its error.
extern "C" int hammlet_sweep_stats(const int64_t* states, const int64_t* sizes,
                                   const int64_t* n_blocks, const float* bstats,
                                   const int64_t* mapping, float* out, float* work, int R,
                                   long long B, int K, int dim, int P, int device, void* stream) {
  const long long n_out = 3LL * P + (long long)K * K + K;
  if (R < 1 || B < 1 || K < 1 || dim < 1 || P < 1 || stats_tiles(B) > 0x7fffffffLL ||
      (long long)R * MAX_RUNS > 0x7fffffffLL || R * n_out > 0x7fffffffLL ||
      stats_terms(K, dim, P) > 0x7fffffffLL / MAX_RUNS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_terms = (int)stats_terms(K, dim, P), KK = K * K, n_float = n_terms - KK;
  const long long tiles = stats_tiles(B), Bp = 1LL << log2_ceil(B);
  int sms = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // two stages (states and sizes as int64, then the two tree buffers; the
  // block statistics where staged; the state before the tile in the last 8
  // bytes), the run stacks (run_log + 1 levels: a run of 2^run_log tiles
  // carries that far), the mapping, the pair histogram; after the grid
  // barrier an output's term totals
  const long long staged_floats = 4 * TILE + 2LL * dim * TILE + 4;
  const bool staged = dim <= MAX_STAGED_DIM && 2 * staged_floats * (long long)sizeof(float) <= optin / 2;
  const int stage_floats = (int)(staged ? staged_floats : 4 * TILE + 4);
  const long long fixed = (2LL * stage_floats + (dim > 2 * stage_floats ? dim : 0) + 1) *
                              (long long)sizeof(float) + (long long)K * dim * sizeof(int64_t);
  // the terms a CTA's slice may take at this depth: every term, else half
  // the room for pair terms (a stack and a histogram count each), the rest
  // for float terms; false where not even one of each fits
  int fcap = n_float, pcap = KK;
  bool limited = false;
  auto caps = [&](int depth) {
    const long long room = (optin - fixed) / (long long)sizeof(float);
    limited = (long long)n_float * depth + (long long)KK * (depth + 1) > room;
    if (!limited) {
      fcap = n_float, pcap = KK;
    } else {
      const long long p = room / 2 / (depth + 1);
      pcap = (int)(p < KK ? p : KK);
      const long long f = (room - (long long)pcap * (depth + 1)) / depth;
      fcap = (int)(f < n_float ? f : n_float);
    }
    return pcap >= 1 && fcap >= 1;
  };
  auto smem_of = [&](int depth) {
    return fixed - (long long)sizeof(float) +
           ((long long)(fcap + pcap) * depth + 1) / 2 * 2 * (long long)sizeof(float) +
           (long long)pcap * sizeof(int);
  };
  const void* kernel = (const void*)modelupdate_stats_kernel;
  // the least run_log whose rows x runs the card holds at once (with that
  // run's stacks), or the least where the stacks take slices, and whose
  // runs are within MAX_RUNS
  int run_log = 0;
  long long runs = tiles, smem = 0, resident = 0;
  for (;;) {
    if (!caps(run_log + 1)) return (int)cudaErrorInvalidValue;
    smem = smem_of(run_log + 1);
    if (smem > optin) return (int)cudaErrorInvalidValue;
    if (smem > SMEM_BYTES)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STATS_THREADS,
                                                          (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    resident = (long long)per_sm * sms;
    if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if ((1LL << run_log) >= tiles ||
        (runs <= MAX_RUNS && ((long long)R * runs <= resident || limited)))
      break;
    ++run_log;
    runs = (tiles + (1LL << run_log) - 1) >> run_log;
  }
  const int depth = run_log + 1;
  // where rows x runs leave CTAs idle, each run's float terms go in slices
  // of at least MIN_SLICE_TERMS, one CTA each; every slice within the caps
  long long slices = 1;
  if ((long long)R * runs < resident) {
    slices = resident / ((long long)R * runs);
    const long long most = (n_float + MIN_SLICE_TERMS - 1) / MIN_SLICE_TERMS;
    if (slices > most) slices = most;
  }
  int slice_terms = (int)((n_float + slices - 1) / slices);
  if (slice_terms > fcap) slice_terms = fcap;
  const long long float_slices = (n_float + slice_terms - 1) / slice_terms,
                  pair_slices = (KK + pcap - 1) / pcap;
  slices = float_slices > pair_slices ? float_slices : pair_slices;
  const long long items = (long long)R * runs * slices;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  int iR = R, iK = K, idim = dim, iP = P, iterms = n_terms, irun_log = run_log, iruns = (int)runs,
      iruns_p = 1 << log2_ceil(runs), islices = (int)slices, islice_terms = slice_terms,
      ipair_terms = pcap, istage = stage_floats, idepth = depth;
  bool bstaged = staged;
  long long lB = B, lBp = Bp, ltiles = tiles;
  void* argv[] = {&states, &sizes, &n_blocks, &bstats, &mapping, &work, &out, &iR, &lB, &lBp,
                  &iK, &idim, &iP, &iterms, &ltiles, &irun_log, &iruns, &iruns_p, &islices,
                  &islice_terms, &ipair_terms, &istage, &idepth, &bstaged};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(STATS_THREADS), argv,
                                          (size_t)smem, (cudaStream_t)stream);
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
  const long long n = (long long)P + (long long)K * K + K;
  if (n > 0x7fffffffLL / TRIES) return (int)cudaErrorInvalidValue;
  // the draws in shared memory: all n where they fit the card's opt-in
  // shared memory, else passes of whole rows of at most that
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const long long most = optin / (long long)sizeof(float), cap = n < most ? n : most;
  if (cap < P || cap < K) return (int)cudaErrorInvalidValue;
  const long long smem = cap * (long long)sizeof(float);
  auto kernel = cap < n ? modelupdate_resample_kernel<true> : modelupdate_resample_kernel<false>;
  if (smem > SMEM_BYTES) {  // the card's limit from every thread, so concurrent callers agree
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lanes = (TRIES * n + WARP - 1) / WARP * WARP;
  const int threads = (int)(lanes < RESAMPLE_THREADS ? lanes : RESAMPLE_THREADS);
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(nig, a_alphas, pi_alphas, sums, sumsqs,
                                                     counts, trans, state, x, u, ub, z, mean, var,
                                                     A, pi, P, K, (int)cap);
  return (int)cudaGetLastError();
}

extern "C" const char* hammlet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
