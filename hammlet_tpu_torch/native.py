"""ctypes bindings for the native ingest library (native/ingest.cpp).

The library is optional: every function has a NumPy/PyTorch fallback. It covers
the host-side, I/O-bound ingest (fast float parsing, streaming maxlet
transform, breakpoint weights, prefix-sum construction) — the part of the
pipeline the reference implements as C++ streaming code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
#: first loads from several threads (-M chains) wait for one build and load
_LOAD_LOCK = threading.Lock()

#: the shared C++ library at the repository root (also used by hammlet_tpu)
_SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "native")


def _load():
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.abspath(os.path.join(_SRC_DIR, "libhammlet_ingest.so"))
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_SRC_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.hammlet_parse_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hammlet_parse_file.restype = ctypes.c_int
    lib.hammlet_free.argtypes = [ctypes.c_void_p]
    lib.hammlet_maxlet.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.hammlet_breakpoint_weights.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.hammlet_noise_std.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.hammlet_noise_std.restype = ctypes.c_double
    lib.hammlet_prefix_stats.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.hammlet_stream_open.argtypes = [ctypes.c_char_p]
    lib.hammlet_stream_open.restype = ctypes.c_void_p
    lib.hammlet_stream_close.argtypes = [ctypes.c_void_p]
    lib.hammlet_stream_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.hammlet_stream_read.restype = ctypes.c_int64
    lib.hammlet_count_values.argtypes = [ctypes.c_char_p]
    lib.hammlet_count_values.restype = ctypes.c_int64
    lib.hammlet_format_int_lines.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.hammlet_format_int_lines.restype = ctypes.c_int64
    lib.hammlet_format_rle_lines.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hammlet_format_rle_lines.restype = ctypes.c_int64
    lib.hammlet_reassemble_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hammlet_reassemble_blocks.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _out_buffer(size: int) -> np.ndarray:
    """A formatter's output buffer. np.empty, not
    ctypes.create_string_buffer: that zero-fills ~100 MB per settled chunk
    while holding the GIL, which the launching thread needs while the drain
    worker formats."""
    return np.empty(size, dtype=np.uint8)


def _chars(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.c_char_p)


def format_int_lines(vals: np.ndarray, ns: np.ndarray) -> bytes | None:
    """(R, cap) int32 + per-row counts -> R tab-joined CSV lines."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    ns = np.ascontiguousarray(ns, dtype=np.int64)
    R, cap = vals.shape
    buf = _out_buffer(int(12 * ns.sum() + R + 1))
    n = lib.hammlet_format_int_lines(
        _i32(vals), _i64(ns), R, cap, _chars(buf), len(buf)
    )
    return buf[:n].tobytes() if n >= 0 else None


def format_rle_lines(
    states: np.ndarray, sizes: np.ndarray, ns: np.ndarray
) -> tuple[bytes, np.ndarray] | None:
    """(R, cap) block states+sizes -> R 'SIZE:STATE' RLE lines (equal-state
    runs merged) and the per-row segment counts."""
    lib = _load()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, dtype=np.int32)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    ns = np.ascontiguousarray(ns, dtype=np.int64)
    R, cap = states.shape
    buf = _out_buffer(int(25 * ns.sum() + R + 1))
    nsegs = np.zeros(R, dtype=np.int64)
    n = lib.hammlet_format_rle_lines(
        _i32(states), _i32(sizes), _i64(ns), R, cap, _chars(buf), len(buf), _i64(nsegs)
    )
    if n < 0:
        return None
    return buf[:n].tobytes(), nsegs


def reassemble_blocks(
    z: np.ndarray,
    nbs: np.ndarray,
    pos: np.ndarray,
    rank: np.ndarray,
    T: int,
    T_local: int,
):
    """Batch drain reconstruction: (R, P, cap) per-shard states + (R, P)
    block counts + static per-shard candidates -> dense (R, maxn)
    states/sizes in global block order plus per-row totals (see
    native/ingest.cpp:hammlet_reassemble_blocks). None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    z = np.ascontiguousarray(z, dtype=np.int32)
    nbs = np.ascontiguousarray(nbs, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    rank = np.ascontiguousarray(rank, dtype=np.int32)
    R, P, cap = z.shape
    ns = np.zeros(R, dtype=np.int64)
    ns_tot = nbs.sum(axis=1)
    maxn = int(ns_tot.max()) if R else 0
    states = np.zeros((R, max(maxn, 1)), dtype=np.int32)
    sizes = np.zeros((R, max(maxn, 1)), dtype=np.int32)
    if maxn == 0:
        return states[:, :0], sizes[:, :0], ns
    rc = lib.hammlet_reassemble_blocks(
        _i32(z), _i64(nbs), _i32(pos), _i32(rank),
        R, P, cap, T, T_local, maxn,
        _i32(states), _i32(sizes), _i64(ns),
    )
    if rc != 0:
        return None
    return states, sizes, ns


def available() -> bool:
    return _load() is not None


def parse_file(path: str) -> np.ndarray | None:
    """Fast parse of a (possibly gzipped) whitespace-separated float file."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    count = ctypes.c_int64()
    rc = lib.hammlet_parse_file(path.encode(), ctypes.byref(out), ctypes.byref(count))
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(count.value,)).copy()
    finally:
        lib.hammlet_free(out)
    return arr


def count_values(path: str) -> int | None:
    """Count whitespace-separated tokens in a (possibly gzipped) file
    without materializing anything."""
    lib = _load()
    if lib is None:
        return None
    n = lib.hammlet_count_values(path.encode())
    return None if n < 0 else int(n)


class TokenStream:
    """Sequential token stream over one (possibly gzipped) file; forward
    skips run at scan speed, backward requests rewind the decompressor."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise OSError("native library unavailable")
        self._lib = lib
        self._h = lib.hammlet_stream_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def read(self, skip_to: int, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        got = self._lib.hammlet_stream_read(
            self._h, skip_to, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if got < 0:
            raise OSError("stream read failed")
        return out[:got]

    def close(self) -> None:
        if self._h:
            self._lib.hammlet_stream_close(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


def maxlet(data: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    coeffs = np.empty(T, dtype=np.float32)
    lib.hammlet_maxlet(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        dim,
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return coeffs


def breakpoint_weights(coeffs: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    w = np.ascontiguousarray(coeffs, dtype=np.float32).copy()
    lib.hammlet_breakpoint_weights(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(w)
    )
    return w


def noise_std(coeffs: np.ndarray) -> float | None:
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(coeffs, dtype=np.float32)
    return float(lib.hammlet_noise_std(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(c)
    ))


def prefix_stats(data: np.ndarray, cell_bits: int = 16):
    """(r, q2) arrays as in ops.blocks.build_prefix_stats (q2 in float64)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    cell = 1 << cell_bits
    n_cells = (T + cell - 1) // cell
    r = np.empty((T + 1, dim, 2), dtype=np.float32)
    q2 = np.empty((n_cells + 1, dim, 2), dtype=np.float64)
    lib.hammlet_prefix_stats(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        dim,
        cell_bits,
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        q2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return r, q2
