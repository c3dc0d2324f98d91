"""Input readers: whitespace-separated value streams, optionally gzipped.

Replaces the reference's istream ingest (wavelet.hpp:131, main.cpp:261-289):
values fill dimensions first, then positions. Multiple files are
concatenated. The native C++ fast reader (hammlet_tpu_torch.native) is used when
built; this NumPy path is the portable fallback.
"""

from __future__ import annotations

import gzip
import io
import sys

import numpy as np


def _read_stream(fh) -> np.ndarray:
    return np.loadtxt(fh, dtype=np.float32).ravel()


# ---- streaming (bounded-memory) ingest -------------------------------------

_WS = b"\t\n\x0b\x0c\r "


def _count_tokens_py(path: str) -> int:
    """Count whitespace-separated tokens by chunked scan (pure-Python
    fallback for native.count_values; ~GB/s via numpy edge counting)."""
    table = np.zeros(256, dtype=bool)
    table[list(_WS)] = True
    opener = gzip.open if path.endswith(".gz") else open
    n = 0
    prev_space = True
    with opener(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 22)
            if not chunk:
                break
            sp = table[np.frombuffer(chunk, dtype=np.uint8)]
            nonsp = ~sp
            first = nonsp[0] and prev_space
            n += int((nonsp[1:] & sp[:-1]).sum()) + int(first)
            prev_space = bool(sp[-1])
    return n


class _PyTokenStream:
    """Pure-Python sequential token stream (same semantics as
    native.TokenStream): forward skips at scan speed, backward rewinds."""

    def __init__(self, path: str):
        self.path = path
        self._open()

    def _open(self):
        opener = gzip.open if self.path.endswith(".gz") else open
        self._fh = opener(self.path, "rb")
        self._cursor = 0
        self._carry = b""
        self._pending: list[bytes] = []
        self._eof = False

    def _refill(self) -> bool:
        """Pull the next chunk's complete tokens into _pending."""
        while not self._pending:
            chunk = self._fh.read(1 << 20)
            if not chunk:
                if self._carry:
                    self._pending = [self._carry]
                    self._carry = b""
                    return True
                self._eof = True
                return False
            data = self._carry + chunk
            toks = data.split()
            if toks and not chr(data[-1]).isspace():
                self._carry = toks.pop()  # partial trailing token
            else:
                self._carry = b""
            self._pending = toks
        return True

    def read(self, skip_to: int, n: int) -> np.ndarray:
        if skip_to < self._cursor:
            self._fh.close()
            self._open()
        while self._cursor < skip_to:
            if not self._refill():
                return np.empty(0, dtype=np.float32)
            k = min(skip_to - self._cursor, len(self._pending))
            del self._pending[:k]
            self._cursor += k
        out: list[bytes] = []
        while len(out) < n:
            if not self._refill():
                break
            k = min(n - len(out), len(self._pending))
            out.extend(self._pending[:k])
            del self._pending[:k]
            self._cursor += k
        return np.array(out, dtype=np.float32)

    def close(self) -> None:
        self._fh.close()


class ValueStream:
    """Bounded-memory value provider over one or more (possibly gzipped)
    whitespace-separated text files.

    The reference's defining property is single-pass istream ingest of
    100M+ points (wavelet.hpp:98-188, main.cpp:261-289); this is the
    equivalent front door for the sharded engine: ``provider(start, stop)``
    returns positions [start, stop) as a (n, dim) float32 array, reading
    only that token range. The sharded ingest's access pattern is two
    ascending passes per process plus one small look-ahead per shard, so
    with the sequential streams underneath each process scans only its own
    byte ranges ~2-3 times and never materializes more than one shard.

    Callable with ``(start, stop)`` in POSITIONS (dimension-major values,
    matching wavelet.hpp:131 fill order).
    """

    #: serve-from-cache limit: look-ahead peeks (<= one prefix cell, 65536
    #: values) are cached so the following shard read does not rewind; full
    #: shard reads are not cached (keeps resident memory O(cell), not
    #: O(T_local) extra)
    _CACHE_MAX = 1 << 20

    def __init__(self, paths: list[str], nr_dim: int = 1):
        from hammlet_tpu_torch import native

        if not paths:
            raise ValueError("ValueStream requires at least one input file")
        self.paths = list(paths)
        self.nr_dim = nr_dim
        counts = []
        for p in self.paths:
            n = native.count_values(p) if native.available() else None
            if n is None:
                n = _count_tokens_py(p)
            counts.append(n)
        self._bases = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        total = int(self._bases[-1])
        if total % nr_dim != 0:
            raise ValueError(
                "Input stream did not contain enough values to fill all "
                "dimensions at last position!"
            )
        self.T = total // nr_dim
        self.dim = nr_dim
        self._streams: dict[int, object] = {}
        self._cache: tuple[int, np.ndarray] | None = None  # (vstart, values)

    def _stream(self, i: int):
        if i not in self._streams:
            from hammlet_tpu_torch import native

            if native.available():
                self._streams[i] = native.TokenStream(self.paths[i])
            else:
                self._streams[i] = _PyTokenStream(self.paths[i])
        return self._streams[i]

    def _read_values(self, v0: int, v1: int) -> np.ndarray:
        parts = []
        if self._cache is not None:
            cstart, cvals = self._cache
            if cstart <= v0 < cstart + len(cvals):
                take = cvals[v0 - cstart : v1 - cstart]
                parts.append(take)
                v0 += len(take)
        lo = int(np.searchsorted(self._bases, v0, side="right")) - 1
        while v0 < v1 and lo < len(self.paths):
            fstart, fend = int(self._bases[lo]), int(self._bases[lo + 1])
            a, b = v0 - fstart, min(v1, fend) - fstart
            if b > a:
                got = self._stream(lo).read(a, b - a)
                if len(got) != b - a:
                    raise ValueError(
                        f"{self.paths[lo]}: expected {b - a} values at "
                        f"offset {a}, got {len(got)}"
                    )
                parts.append(got)
                v0 += b - a
            lo += 1
        if v0 < v1:
            raise ValueError("value range past end of input")
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def __call__(self, start: int, stop: int) -> np.ndarray:
        v0, v1 = start * self.nr_dim, stop * self.nr_dim
        vals = self._read_values(v0, v1)
        if v1 - v0 <= self._CACHE_MAX:
            self._cache = (v0, vals)
        return vals.reshape(-1, self.nr_dim)

    def close(self) -> None:
        for s in self._streams.values():
            s.close()
        self._streams.clear()
        self._cache = None


def read_values(paths: list[str] | None, nr_dim: int = 1) -> np.ndarray:
    """Read values from files (or stdin if paths is falsy) -> (T, dim).

    Raises if the total value count is not a multiple of nr_dim
    (wavelet.hpp:179-181).
    """
    from hammlet_tpu_torch import native

    chunks = []
    if paths:
        for p in paths:
            vals = native.parse_file(p) if native.available() else None
            if vals is not None:
                chunks.append(vals)
                continue
            opener = gzip.open if p.endswith(".gz") else open
            with opener(p, "rt") as fh:
                chunks.append(_read_stream(fh))
    else:
        chunks.append(_read_stream(io.StringIO(sys.stdin.read())))
    vals = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.float32)
    if len(vals) % nr_dim != 0:
        raise ValueError(
            "Input stream did not contain enough values to fill all "
            "dimensions at last position!"
        )
    return vals.reshape(-1, nr_dim)
