"""The FB sampler's two scans through the hand-written Hopper kernels
(csrc/fbscan.cu).

Port of the JAX package's grouped scans
(hammlet_tpu/samplers/forward_backward.py:94-130 and :154-186).
``prefix_matmul_scan_cuda`` takes a float32 (K, K, *batch, B) stack of
block matrices, ``suffix_compose_scan_cuda`` an int64 (K, *batch, B) stack
of index maps; each launches one kernel on the current stream where all of
a call's groups fit the card at once (the main path's shapes, K = 3, and
configuration 4's K = 9; the suffix up to K = 64), else three (the grouped
prefix at K = 17-32 always, the grouped suffix above K = 64 always), and
returns what the plain versions in samplers/forward_backward.py
(``prefix_matmul_scan_reference``, ``suffix_compose_scan_reference``)
return. The prefix has instances for K = 1-8 (a matrix per thread), 9-16
(a team of threads per matrix), 17-32 (a thread block cluster per group of
128 matrices, a thread per column), 33-64 (a thread block's tiled product
per combine, every pass one cooperative launch over the card) and every K
above 64 (the same with output tiles of up to 128 x 128 and j streamed
through shared memory in slabs: one launch per call; from K = 513 the
transposes into and out of its workspace take a row of matrices in
pieces); no generic form is left, and no K is refused. Its tensors grow as
K^2 a block: at K = 625 an F sweep holds ~6.6 MiB a block, so the card's
memory, not the kernel, limits a call. The suffix has one instance per K
up to 64 and above that the group kernel with the maps in shared memory
(int32 to K = 227, int16 to 454), the totals' rows scan and the combine. The kernels are
chosen by K and shape alone: a refused launch raises. A
non-contiguous input is made contiguous first (the sharded
engine's cross-shard scans pass a permuted and a transposed view, which
come out contiguous from the gathers they read). Outputs and the
kernels' workspace come from ``torch.empty``, so that under CUDA graph
capture they land in the graph's pool. The library is built and loaded at
the first call, which the engines make during a capture's eager warm-up.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hammlet_tpu_torch import _build
from hammlet_tpu_torch.ops.wavelet_cuda import _check_launch, _count

SOURCES = [_build.CSRC_DIR / "fbscan.cu"]

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
    for kind in ("prefix", "suffix"):
        launch = getattr(lib, f"hammlet_fbscan_{kind}")
        launch.argtypes = [
            ctypes.c_void_p,  # input (K, K, R, n) float32 / (K, R, n) int64, device
            ctypes.c_void_p,  # output, same shape and type
            ctypes.c_void_p,  # workspace, same type
            ctypes.c_int,  # K
            ctypes.c_int,  # R
            ctypes.c_longlong,  # n
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # cudaStream_t
        ]
        launch.restype = ctypes.c_int
        size = getattr(lib, f"hammlet_fbscan_{kind}_workspace")
        size.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        size.restype = ctypes.c_longlong
    lib.hammlet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hammlet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> _build.BuildResult:
    """Compile csrc/fbscan.cu for sm_90a (no-op when already built)."""
    return _build.build("fbscan", SOURCES)


def _scan(kind: str, x: torch.Tensor, lead: int, what: str) -> torch.Tensor:
    """Launch the ``kind`` scan on ``x``, whose first ``lead`` axes are the
    K x K matrix (2) or the K-entry map (1), then the batch rows, then the
    block axis; returns a new contiguous tensor of x's shape."""
    K, n = x.shape[0], x.shape[-1]
    R = math.prod(x.shape[lead:-1])
    if x.numel() == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    x = x.contiguous()
    lib = _library()
    out = torch.empty_like(x)
    work = torch.empty(
        getattr(lib, f"hammlet_fbscan_{kind}_workspace")(K, R, n), dtype=x.dtype, device=x.device
    )
    err = getattr(lib, f"hammlet_fbscan_{kind}")(
        x.data_ptr(), out.data_ptr(), work.data_ptr(), K, R, n,
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, err, what)
    return out


def prefix_matmul_scan_cuda(Mt: torch.Tensor) -> torch.Tensor:
    """Launch the prefix-scan kernels on a float32 (K, K, *batch, B) CUDA
    stack; same result as ``prefix_matmul_scan_reference``. Runs on the
    current stream, no sync."""
    if not Mt.is_cuda:
        raise ValueError(f"the prefix-scan kernels need a CUDA tensor, got {Mt.device}")
    if Mt.dtype != torch.float32 or Mt.dim() < 3 or Mt.shape[0] != Mt.shape[1]:
        raise ValueError("the prefix-scan kernels need a float32 (K, K, *batch, B) tensor, "
                         f"got {Mt.dtype} {tuple(Mt.shape)}")
    out = _scan("prefix", Mt, 2, "FB prefix-scan kernels")
    _count(prefix_matmul_scan_cuda)
    return out


def suffix_compose_scan_cuda(maps_t: torch.Tensor) -> torch.Tensor:
    """Launch the suffix-scan kernels on an int64 (K, *batch, B) CUDA stack
    of maps into [0, K); same result as ``suffix_compose_scan_reference``.
    Runs on the current stream, no sync."""
    if not maps_t.is_cuda:
        raise ValueError(f"the suffix-scan kernels need a CUDA tensor, got {maps_t.device}")
    if maps_t.dtype != torch.int64 or maps_t.dim() < 2:
        raise ValueError("the suffix-scan kernels need an int64 (K, *batch, B) tensor, "
                         f"got {maps_t.dtype} {tuple(maps_t.shape)}")
    out = _scan("suffix", maps_t, 1, "FB suffix-scan kernels")
    _count(suffix_compose_scan_cuda)
    return out


#: calls that launched the kernels since the last reset (each call launches
#: one kernel on a flat B or a grouped B whose groups fit the card at once,
#: the prefix at K <= 16, the suffix at K <= 64; the prefix above K = 32 one
#: at every shape; three on a longer grouped B, the grouped prefix at K =
#: 17-32, and the grouped suffix above K = 64)
prefix_matmul_scan_cuda.launches = 0
suffix_compose_scan_cuda.launches = 0
