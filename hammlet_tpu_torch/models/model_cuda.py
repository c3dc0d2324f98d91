"""The conjugate model update through the hand-written Hopper kernels
(csrc/modelupdate.cu).

Port of the JAX package's sweep statistics and conjugate resample
(hammlet_tpu/samplers/sweep.py:100 ``accumulate_sweep_stats``,
hammlet_tpu/models/hmm.py:128 ``resample_model``). ``sweep_stats_cuda``
launches two kernels (the tile sums, then each row's total and assembly) on
(R, B) rows of a sweep's blocks; ``resample_model_cuda`` launches one, a
single CTA, on the statistics and the pre-drawn noise. Each returns what
its plain version returns, bit for bit:
``samplers.sweep.sweep_stats_reference`` and
``models.hmm.resample_model_reference``. Outputs and workspace come from
``torch.empty``, so that under CUDA graph capture they land in the graph's
pool. The library is built and loaded at the first call, which the engines
make during a capture's eager warm-up.
"""

from __future__ import annotations

import ctypes

import torch

from hammlet_tpu_torch import _build
from hammlet_tpu_torch.ops.wavelet_cuda import _check_launch, _count

SOURCES = [_build.CSRC_DIR / "modelupdate.cu"]
TRIES = 8  # the Gamma sampler's fixed depth; csrc/modelupdate.cu uses the same

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use and bound once per process
    under the build lock."""
    global _lib
    with _build.LOCK:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build().path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the library's functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hammlet_sweep_stats.argtypes = [
        ptr, ptr, ptr,  # states, sizes (R, B) int64; n_blocks (R,) int64
        ptr, ptr,  # block stats (dim, 2, R, B) float32; mapping (K, dim) int64
        ptr, ptr,  # out (R, 3P + K*K + K) float32; workspace float32
        i32, ctypes.c_longlong, i32, i32, i32,  # R, B, K, dim, P
        i32, ptr,  # device index, cudaStream_t
    ]
    lib.hammlet_sweep_stats.restype = i32
    lib.hammlet_sweep_stats_workspace.argtypes = [i32, ctypes.c_longlong, i32, i32, i32]
    lib.hammlet_sweep_stats_workspace.restype = ctypes.c_longlong
    lib.hammlet_resample_model.argtypes = [
        ptr, ptr, ptr,  # priors: nig (P, 4), a_alphas (K, K), pi_alphas (K,)
        ptr, ptr, ptr, ptr, ptr,  # theta sums, sums of squares, counts (P,); trans (K, K); state (K,)
        ptr, ptr, ptr, ptr,  # noise: normals, uniforms (TRIES, n); boost uniforms (n,); normals (P,)
        ptr, ptr, ptr, ptr,  # out: mean, var (P,), A (K, K), pi (K,)
        i32, i32, i32, ptr,  # P, K, device index, cudaStream_t
    ]
    lib.hammlet_resample_model.restype = i32
    lib.hammlet_cuda_error_string.argtypes = [i32]
    lib.hammlet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> _build.BuildResult:
    """Compile csrc/modelupdate.cu for sm_90a (no-op when already built)."""
    return _build.build("modelupdate", SOURCES)


def _need(x: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str) -> torch.Tensor:
    """``x`` as a contiguous CUDA tensor of ``dtype`` and ``shape``, or raise."""
    if not x.is_cuda:
        raise ValueError(f"the model-update kernels need CUDA tensors, got {what} on {x.device}")
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"the model-update kernels need {what} as {dtype} {shape}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def sweep_stats_cuda(
    states: torch.Tensor,
    sizes: torch.Tensor,
    n_blocks: torch.Tensor,
    block_stats_t: torch.Tensor,
    mapping: torch.Tensor,
    nr_params: int,
) -> torch.Tensor:
    """Launch the statistics kernels on R rows: states and sizes (R, B)
    int64, n_blocks (R,) int64, block_stats_t (dim, 2, R, B) float32,
    mapping (K, dim) int64, all on the card. Returns (R, 3 P + K*K + K)
    float32 rows of theta sums, sums of squares and counts (P each), the
    K x K transition counts and the K state counts: what
    ``sweep_stats_reference`` returns. Runs on the current stream, no sync."""
    R, B = states.shape
    K, dim = mapping.shape
    states = _need(states, torch.int64, (R, B), "states")
    sizes = _need(sizes, torch.int64, (R, B), "sizes")
    n_blocks = _need(n_blocks, torch.int64, (R,), "n_blocks")
    block_stats_t = _need(block_stats_t, torch.float32, (dim, 2, R, B), "block_stats_t")
    mapping = _need(mapping, torch.int64, (K, dim), "mapping")
    out = _stats(states, sizes, n_blocks, block_stats_t, mapping, nr_params)
    _count(sweep_stats_cuda)
    return out


def _stats(states, sizes, n_blocks, block_stats_t, mapping, nr_params: int) -> torch.Tensor:
    """Launch the statistics kernels on checked, contiguous inputs."""
    (R, B), (K, dim) = states.shape, mapping.shape
    lib = _library()
    out = torch.empty((R, 3 * nr_params + K * K + K), dtype=torch.float32, device=states.device)
    work = torch.empty(lib.hammlet_sweep_stats_workspace(R, B, K, dim, nr_params),
                       dtype=torch.float32, device=states.device)
    err = lib.hammlet_sweep_stats(
        states.data_ptr(), sizes.data_ptr(), n_blocks.data_ptr(), block_stats_t.data_ptr(),
        mapping.data_ptr(), out.data_ptr(), work.data_ptr(), R, B, K, dim, nr_params,
        states.device.index or 0, torch.cuda.current_stream(states.device).cuda_stream,
    )
    _check_launch(lib, err, "sweep statistics kernels")
    return out


def resample_model_cuda(priors, stats, noise) -> tuple[torch.Tensor, ...]:
    """Launch the resample kernel: ``priors`` (HMMPriors), ``stats``
    (SweepStats) and ``noise`` = (normals (TRIES, n), uniforms (TRIES, n),
    boost uniforms (n,), mean normals (P,)), n = P + K*K + K, all float32 on
    the card. Returns (theta_mean, theta_var, A, pi): what
    ``resample_model_reference`` returns. Runs on the current stream, no
    sync."""
    P, K = priors.nig.shape[0], priors.pi_alphas.shape[0]
    n = P + K * K + K
    f32 = torch.float32
    args = [
        _need(priors.nig, f32, (P, 4), "nig"),
        _need(priors.a_alphas, f32, (K, K), "a_alphas"),
        _need(priors.pi_alphas, f32, (K,), "pi_alphas"),
        _need(stats.theta_sums, f32, (P,), "theta_sums"),
        _need(stats.theta_sumsqs, f32, (P,), "theta_sumsqs"),
        _need(stats.theta_counts, f32, (P,), "theta_counts"),
        _need(stats.trans_counts, f32, (K, K), "trans_counts"),
        _need(stats.state_counts, f32, (K,), "state_counts"),
    ] + [_need(t, f32, shape, what) for t, shape, what in zip(
        noise, ((TRIES, n), (TRIES, n), (n,), (P,)),
        ("proposal normals", "acceptance uniforms", "boost uniforms", "mean normals"))]
    out = _resample(*args)
    _count(resample_model_cuda)
    return out


def _resample(*args: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Launch the resample kernel on checked, contiguous inputs: the
    priors' three tensors, the statistics' five and the noise's four."""
    P, K, dev, f32 = args[0].shape[0], args[2].shape[0], args[0].device, torch.float32
    lib = _library()
    out = (torch.empty(P, dtype=f32, device=dev), torch.empty(P, dtype=f32, device=dev),
           torch.empty((K, K), dtype=f32, device=dev), torch.empty(K, dtype=f32, device=dev))
    err = lib.hammlet_resample_model(
        *(t.data_ptr() for t in args + out), P, K,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(lib, err, "resample kernel")
    return out


#: calls that launched the kernels since the last reset (two kernels per
#: statistics call, one per resample call)
sweep_stats_cuda.launches = 0
resample_model_cuda.launches = 0
