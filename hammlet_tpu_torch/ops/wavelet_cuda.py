"""Maxlet transform through the hand-written Hopper kernels (csrc/maxlet.cu).

Port of hammlet_tpu/ops/wavelet_pallas.py. Two kernels make the transform:
``maxlet_chunks_cuda`` computes every chunk-local coefficient (levels
1..CHUNK_BITS of 2^CHUNK_BITS-position chunks) from the caller's (T, dim)
rows, with the +inf support mask applied and +inf at every chunk start, plus
each chunk's per-dim total; ``maxlet_cross_cuda`` runs the levels above
CHUNK_BITS on those totals and writes the chunk starts. The result is
bit-identical to ops.wavelet.maxlet_transform and the golden model.

``maxlet_transform_cuda`` launches both kernels for a CUDA tensor (or
raises) and runs their plain torch versions, ``maxlet_chunks_reference`` and
``maxlet_cross_reference``, for a CPU tensor, so the CPU tests reach all of
the layout, masking and cross-chunk logic that the kernels implement.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from hammlet_tpu_torch import _build
from hammlet_tpu_torch.ops.wavelet import _level_normalizers

CHUNK_BITS = 13  # 8192 positions per chunk; csrc/maxlet.cu uses the same
MAX_LEVELS = 64  # normalizers handed to the kernels: any T < 2^63
SOURCES = [_build.CSRC_DIR / "maxlet.cu"]

_lib: ctypes.CDLL | None = None
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use and bound once per process
    under the build lock (threads may reach the first use together)."""
    global _lib
    with _build.LOCK:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build().path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the library's functions."""
    lib.hammlet_maxlet_chunks.argtypes = [
        ctypes.c_void_p,  # data (T, dim) float32, device
        ctypes.c_longlong,  # T
        ctypes.c_int,  # dim
        ctypes.c_void_p,  # level normalizers (MAX_LEVELS,) float32, host
        ctypes.c_void_p,  # coeffs (T,) float32, device
        ctypes.c_void_p,  # totals (n_chunks, dim) float32, device
        ctypes.c_int,  # device index
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.hammlet_maxlet_cross.argtypes = [
        ctypes.c_void_p,  # totals (n_chunks, dim) float32, device
        ctypes.c_longlong,  # n_chunks
        ctypes.c_int,  # dim
        ctypes.c_longlong,  # T
        ctypes.c_void_p,  # level normalizers (MAX_LEVELS,) float32, host
        ctypes.c_void_p,  # coeffs (T,) float32, device, updated in place
        ctypes.c_void_p,  # scratch (n_chunks, dim) float32, device
        ctypes.c_int,  # device index
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.hammlet_maxlet_chunks.restype = ctypes.c_int
    lib.hammlet_maxlet_cross.restype = ctypes.c_int
    lib.hammlet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hammlet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _norms() -> np.ndarray:
    return np.asarray(_level_normalizers(MAX_LEVELS), dtype=np.float32)


def build() -> _build.BuildResult:
    """Compile csrc/maxlet.cu for sm_90a (no-op when already built)."""
    return _build.build("maxlet", SOURCES)


def _n_chunks(T: int) -> int:
    return -(-T // (1 << CHUNK_BITS))


def _as_rows(data: torch.Tensor) -> torch.Tensor:
    """(T,) or (T, dim) contiguous float32 -> (T, dim) view."""
    if data.dtype != torch.float32 or data.ndim not in (1, 2) or not data.is_contiguous():
        raise ValueError("the maxlet transform needs a contiguous (T,) or (T, dim) float32 tensor")
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[0] == 0 or data.shape[1] == 0:
        raise ValueError(f"the maxlet transform needs T, dim >= 1, got {tuple(data.shape)}")
    return data


def _count(wrapper) -> None:
    """One more launch on ``wrapper``'s counter (chains in threads count
    together)."""
    with _count_lock:
        wrapper.launches += 1


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.hammlet_cuda_error_string(err).decode()}")


def maxlet_chunks_reference(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the chunk kernel.

    data: (T, dim) float32. Returns coeffs (T,) — the chunk-local levels
    with the support mask applied, +inf at each chunk's first position — and
    totals (n_chunks, dim), the pairwise sums of each chunk zero-padded past
    T."""
    T, dim = data.shape
    chunk = 1 << CHUNK_BITS
    n_chunks = _n_chunks(T)
    norms = _level_normalizers(CHUNK_BITS)
    sums = torch.nn.functional.pad(data.T, (0, n_chunks * chunk - T)).reshape(dim, n_chunks, chunk)
    coeffs = torch.full((n_chunks, chunk), math.inf, dtype=torch.float32, device=data.device)
    for level in range(1, CHUNK_BITS + 1):
        left = sums[..., 0::2]
        right = sums[..., 1::2]
        coeffs[:, (1 << (level - 1)) :: (1 << level)] = torch.amax(
            float(norms[level - 1]) * torch.abs(left - right), dim=0
        )
        sums = left + right
    # t holds the level-(ctz(t)+1) wavelet; it is complete iff t + lowbit(t) <= T
    t = torch.arange(T, dtype=torch.int64, device=data.device)
    coeffs = torch.where(t + (t & -t) <= T, coeffs.reshape(-1)[:T], math.inf)
    return coeffs, sums[..., 0].T.contiguous()


def maxlet_cross_reference(coeffs: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the cross-chunk kernel: the levels above
    CHUNK_BITS on the chunk totals (n_chunks, dim). Writes the masked
    coefficient at every chunk start whose wavelet the tree forms into
    coeffs (T,), in place, and returns it."""
    T = coeffs.shape[0]
    norms = _level_normalizers(MAX_LEVELS)
    sums = totals
    level = CHUNK_BITS + 1
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        detail = torch.amax(float(norms[level - 1]) * torch.abs(left - right), dim=1)
        half = 1 << (level - 1)
        t = torch.arange(n_pairs, dtype=torch.int64, device=coeffs.device) * (2 * half) + half
        coeffs[t] = torch.where(t + half <= T, detail, math.inf)
        sums = left + right
        level += 1
    return coeffs


def maxlet_chunks_cuda(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk kernel on (T, dim) float32 device rows; same outputs
    as ``maxlet_chunks_reference``. Runs on the current stream, no sync."""
    if not data.is_cuda:
        raise ValueError(f"maxlet kernel needs a CUDA tensor, got {data.device}")
    data = _as_rows(data)
    T, dim = data.shape
    lib = _library()
    coeffs = torch.empty((T,), dtype=torch.float32, device=data.device)
    totals = torch.empty((_n_chunks(T), dim), dtype=torch.float32, device=data.device)
    err = lib.hammlet_maxlet_chunks(
        data.data_ptr(), T, dim, _norms().ctypes.data, coeffs.data_ptr(), totals.data_ptr(),
        data.device.index or 0, torch.cuda.current_stream(data.device).cuda_stream,
    )
    _check_launch(lib, err, "maxlet chunk kernel")
    _count(maxlet_chunks_cuda)
    return coeffs, totals


def maxlet_cross_cuda(coeffs: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Launch the cross-chunk kernel: same effect on coeffs (T,) as
    ``maxlet_cross_reference``, in place. Runs on the current stream, no
    sync."""
    if not (coeffs.is_cuda and totals.is_cuda):
        raise ValueError(f"maxlet kernel needs CUDA tensors, got {coeffs.device}, {totals.device}")
    T = coeffs.shape[0]
    n_chunks, dim = totals.shape
    if (
        coeffs.dtype != torch.float32 or totals.dtype != torch.float32
        or coeffs.ndim != 1 or not coeffs.is_contiguous() or not totals.is_contiguous()
        or n_chunks != _n_chunks(T) or coeffs.device != totals.device
    ):
        raise ValueError("maxlet cross kernel needs contiguous float32 coeffs (T,) and "
                         "totals (ceil(T / 2^CHUNK_BITS), dim) on one device")
    lib = _library()
    scratch = torch.empty_like(totals)
    err = lib.hammlet_maxlet_cross(
        totals.data_ptr(), n_chunks, dim, T, _norms().ctypes.data, coeffs.data_ptr(),
        scratch.data_ptr(), coeffs.device.index or 0,
        torch.cuda.current_stream(coeffs.device).cuda_stream,
    )
    _check_launch(lib, err, "maxlet cross kernel")
    _count(maxlet_cross_cuda)
    return coeffs


def maxlet_transform_cuda(data: torch.Tensor) -> torch.Tensor:
    """data: (T,) or (T, dim) contiguous float32 -> maxlet coefficients (T,)
    float32.

    Bit-identical to ops.wavelet.maxlet_transform. A CUDA tensor goes
    through the two Hopper kernels; a CPU tensor through their plain
    versions."""
    data = _as_rows(data)
    if data.is_cuda:
        coeffs, totals = maxlet_chunks_cuda(data)
        maxlet_cross_cuda(coeffs, totals)
        _count(maxlet_transform_cuda)
        return coeffs
    if data.device.type != "cpu":
        raise ValueError(f"unsupported device {data.device}")
    coeffs, totals = maxlet_chunks_reference(data)
    return maxlet_cross_reference(coeffs, totals)


#: launches since the last reset: transforms that went through the kernels,
#: and each kernel's own launches
maxlet_transform_cuda.launches = 0
maxlet_chunks_cuda.launches = 0
maxlet_cross_cuda.launches = 0
