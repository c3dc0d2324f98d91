"""Maxlet transform through the hand-written Hopper kernel (csrc/maxlet.cu).

Port of hammlet_tpu/ops/wavelet_pallas.py. The kernel computes every
chunk-local coefficient (levels 1..CHUNK_BITS) of 2^CHUNK_BITS-position
chunks plus each chunk's per-dim total; the few cross-chunk levels finish
here in torch on the chunk totals (they touch only T / 2^CHUNK_BITS values),
then the +inf support mask is applied. The result is bit-identical to
ops.wavelet.maxlet_transform and the golden model.

``maxlet_transform_cuda`` launches the kernel for a CUDA tensor (or raises)
and runs the kernel's plain torch version, ``maxlet_chunks_reference``, for
a CPU tensor, so the CPU tests reach all of the padding, layout and
cross-chunk code around the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from hammlet_tpu_torch import _build
from hammlet_tpu_torch.ops.wavelet import _level_normalizers

CHUNK_BITS = 13  # 8192 positions per chunk; csrc/maxlet.cu uses the same
SOURCES = [_build.CSRC_DIR / "maxlet.cu"]


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = ctypes.CDLL(str(build().path))
    lib.hammlet_maxlet_chunks.argtypes = [
        ctypes.c_void_p,  # data (dim, Tp) float32, device
        ctypes.c_longlong,  # Tp
        ctypes.c_int,  # dim
        ctypes.c_void_p,  # level normalizers (CHUNK_BITS,) float32, host
        ctypes.c_void_p,  # coeffs (Tp,) float32, device
        ctypes.c_void_p,  # totals (n_chunks, dim) float32, device
        ctypes.c_int,  # device index
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.hammlet_maxlet_chunks.restype = ctypes.c_int
    lib.hammlet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hammlet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> _build.BuildResult:
    """Compile csrc/maxlet.cu for sm_90a (no-op when already built)."""
    return _build.build("maxlet", SOURCES)


def maxlet_chunks_reference(data_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the chunk kernel.

    data_t: (dim, Tp) float32, Tp a multiple of 2^CHUNK_BITS.
    Returns coeffs (Tp,) — chunk-local levels, +inf at each chunk's first
    position — and totals (n_chunks, dim)."""
    dim, Tp = data_t.shape
    chunk = 1 << CHUNK_BITS
    n_chunks = Tp // chunk
    norms = _level_normalizers(CHUNK_BITS)
    sums = data_t.reshape(dim, n_chunks, chunk)
    coeffs = torch.full(
        (n_chunks, chunk), math.inf, dtype=torch.float32, device=data_t.device
    )
    for level in range(1, CHUNK_BITS + 1):
        left = sums[..., 0::2]
        right = sums[..., 1::2]
        coeffs[:, (1 << (level - 1)) :: (1 << level)] = torch.amax(
            float(norms[level - 1]) * torch.abs(left - right), dim=0
        )
        sums = left + right
    return coeffs.reshape(Tp), sums[..., 0].T.contiguous()


def maxlet_chunks_cuda(data_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (dim, Tp) float32 device data; same outputs as
    ``maxlet_chunks_reference``. Runs on the current stream, no sync."""
    if not data_t.is_cuda:
        raise ValueError(f"maxlet kernel needs a CUDA tensor, got {data_t.device}")
    if data_t.dtype != torch.float32 or data_t.ndim != 2 or not data_t.is_contiguous():
        raise ValueError("maxlet kernel needs a contiguous (dim, Tp) float32 tensor")
    dim, Tp = data_t.shape
    chunk = 1 << CHUNK_BITS
    if Tp == 0 or Tp % chunk:
        raise ValueError(f"Tp={Tp} must be a positive multiple of {chunk}")
    lib = _library()
    coeffs = torch.empty((Tp,), dtype=torch.float32, device=data_t.device)
    totals = torch.empty((Tp // chunk, dim), dtype=torch.float32, device=data_t.device)
    norms = np.asarray(_level_normalizers(CHUNK_BITS), dtype=np.float32)
    stream = torch.cuda.current_stream(data_t.device).cuda_stream
    err = lib.hammlet_maxlet_chunks(
        data_t.data_ptr(), Tp, dim, norms.ctypes.data, coeffs.data_ptr(),
        totals.data_ptr(), data_t.device.index or 0, stream,
    )
    if err:
        raise RuntimeError(
            f"maxlet kernel launch failed: {lib.hammlet_cuda_error_string(err).decode()}"
        )
    maxlet_transform_cuda.launches += 1
    return coeffs, totals


def maxlet_transform_cuda(data: torch.Tensor) -> torch.Tensor:
    """data: (T,) or (T, dim) float32 -> maxlet coefficients (T,) float32.

    Bit-identical to ops.wavelet.maxlet_transform. A CUDA tensor goes
    through the Hopper kernel; a CPU tensor through its plain version."""
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    chunk = 1 << CHUNK_BITS
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    # (dim, Tp): position axis contiguous, zero-padded to whole chunks
    data_t = torch.nn.functional.pad(
        data.to(torch.float32).T, (0, Tp - T)
    ).contiguous()
    if data_t.is_cuda:
        coeffs, totals = maxlet_chunks_cuda(data_t)
    elif data_t.device.type == "cpu":
        coeffs, totals = maxlet_chunks_reference(data_t)
    else:
        raise ValueError(f"unsupported device {data_t.device}")

    # cross-chunk levels on the chunk totals: node a at total-level m is
    # data level m + CHUNK_BITS and writes at a*2^(m+c) + 2^(m+c-1)
    sums = totals
    norms = _level_normalizers(CHUNK_BITS + max(1, n_chunks).bit_length() + 1)
    level = CHUNK_BITS + 1
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        coeffs[(1 << (level - 1)) :: (1 << level)][:n_pairs] = torch.amax(
            float(norms[level - 1]) * torch.abs(left - right), dim=1
        )
        sums = left + right
        level += 1

    # invalidate wavelets whose support is incomplete: index t holds the
    # level-(ctz(t)+1) wavelet; it is complete iff t + lowbit(t) <= T
    t = torch.arange(Tp, dtype=torch.int64, device=coeffs.device)
    valid = (t + (t & -t) <= T) & (t > 0)
    return torch.where(valid, coeffs, math.inf)[:T]


#: kernel launches since the last reset (one per maxlet_chunks_cuda call)
maxlet_transform_cuda.launches = 0
