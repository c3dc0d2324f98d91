"""Run-length-encoded arrays for HaMMLET output post-processing.

Python-3 equivalent of the reference's bin/pyhammlet/RLE.py (Python 2): a
RunLengthArray stores per-segment values (1-D or 2-D rows) with cumulative
end positions for O(log n) random access.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np


def subdiff(ends: np.ndarray) -> np.ndarray:
    """Segment sizes from cumulative end positions."""
    ends = np.asarray(ends)
    out = ends.copy()
    out[1:] = ends[1:] - ends[:-1]
    return out


class RunLengthArray:
    """A run-length-compressed array.

    Construct from ``sizes`` (per-segment lengths) and ``array`` (per-segment
    values, shape (n_segments,) or (n_segments, k)), or from ``ends``
    (cumulative) and ``array``.
    """

    def __init__(self, sizes=None, array=None, ends=None):
        if array is None:
            raise ValueError("array is required")
        self.values_arr = np.asarray(array)
        if ends is not None:
            self.ends = np.asarray(ends, dtype=np.int64)
        elif sizes is not None:
            self.ends = np.cumsum(np.asarray(sizes, dtype=np.int64))
        else:
            raise ValueError("need sizes or ends")
        if len(self.ends) != len(self.values_arr):
            raise ValueError("sizes and array must have equal length")

    # -- construction helpers --------------------------------------------

    @classmethod
    def loadtxt(cls, filename, dtype=int) -> "RunLengthArray":
        m = np.loadtxt(filename, dtype=dtype, ndmin=2)
        return cls(sizes=m[:, 0], array=m[:, 1:])

    def compress(self) -> "RunLengthArray":
        """Merge adjacent segments with equal values."""
        v = self.values_arr
        if len(v) <= 1:
            return self
        if v.ndim == 1:
            same = v[1:] == v[:-1]
        else:
            same = (v[1:] == v[:-1]).all(axis=1)
        keep = np.concatenate([~same, [True]])
        return RunLengthArray(ends=self.ends[keep], array=v[keep])

    # -- accessors --------------------------------------------------------

    @property
    def shape(self):
        n = int(self.ends[-1]) if len(self.ends) else 0
        if self.values_arr.ndim == 1:
            return (n,)
        return (n, self.values_arr.shape[1])

    def __len__(self):
        return int(self.ends[-1]) if len(self.ends) else 0

    def nrSegments(self) -> int:
        return len(self.ends)

    def values(self) -> np.ndarray:
        return self.values_arr

    def blocksizes(self) -> np.ndarray:
        return subdiff(self.ends)

    def getSegment(self, index: int):
        return self.values_arr[index]

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.decompress(key.start, key.stop)[:: key.step]
        i = bisect_right(self.ends, key)
        return self.values_arr[i]

    def decompress(self, start=None, end=None) -> np.ndarray:
        start = 0 if start is None else start
        end = len(self) if end is None else end
        full = np.repeat(self.values_arr, self.blocksizes(), axis=0)
        return full[start:end]

    # -- statistics -------------------------------------------------------

    def argmax(self) -> "RunLengthArray":
        """Per-segment argmax over columns (2-D only)."""
        return RunLengthArray(ends=self.ends, array=self.values_arr.argmax(axis=1))

    def mode(self) -> "RunLengthArray":
        return self.argmax()

    def __str__(self):
        return "\n".join(
            f"{s}\t{v}" for s, v in zip(self.blocksizes(), self.values_arr)
        )


def shatter(A: RunLengthArray, B: RunLengthArray):
    """Refine both arrays onto the union of their segment boundaries."""
    if len(A) != len(B):
        raise ValueError("arrays must have equal decompressed length")
    ends = np.union1d(A.ends, B.ends)
    idx_a = np.searchsorted(A.ends, ends, side="left")
    idx_b = np.searchsorted(B.ends, ends, side="left")
    return (
        RunLengthArray(ends=ends, array=A.values_arr[idx_a]),
        RunLengthArray(ends=ends, array=B.values_arr[idx_b]),
    )
