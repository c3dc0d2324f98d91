"""Readers for HaMMLET output files (Python-3 pyhammlet.io equivalent)."""

from __future__ import annotations

import numpy as np

from hammlet_tpu_torch.pyhammlet.rle import RunLengthArray, subdiff


def readMarginals(filename) -> RunLengthArray:
    """marginals CSV (segsize, counts per state) -> RunLengthArray."""
    m = np.loadtxt(filename, dtype=int, ndmin=2)
    return RunLengthArray(sizes=m[:, 0], array=m[:, 1:])


def readCompressedStateSequences(filename) -> list[RunLengthArray]:
    """sequences CSV (tab-separated SIZE:STATE tokens per recorded sweep)."""
    result = []
    with open(filename) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            toks = [t.split(":") for t in line.split()]
            sizes = np.array([int(a) for a, _ in toks])
            states = np.array([int(b) for _, b in toks])
            result.append(RunLengthArray(sizes=sizes, array=states))
    return result


def readMapping(filename) -> np.ndarray:
    """mapping CSV (-O D: one row per state, one emission-parameter index
    per data dimension) -> (K, dim) int array."""
    return np.loadtxt(filename, dtype=int, ndmin=2)


def readBlockSizes(filename) -> RunLengthArray:
    """blocks CSV -> per-position block-size matrix (positions x sweeps),
    run-length-compressed over the union of all block boundaries."""
    lines = []
    with open(filename) as fh:
        for line in fh:
            if line.strip():
                lines.append(np.cumsum(np.array(line.split(), dtype=int)))
    if not lines:
        return RunLengthArray(sizes=np.zeros(0, int), array=np.zeros((0, 0), int))
    T = lines[0][-1]
    for i, ln in enumerate(lines[1:], start=2):
        if ln[-1] != T:
            raise ValueError(
                f"Block structure in input line {i} does not match the "
                "previous ones in total size!"
            )
    ends = np.array(sorted(set().union(*[set(l.tolist()) for l in lines])), dtype=int)
    data = np.zeros((len(ends), len(lines)), dtype=int)
    for it, ln in enumerate(lines):
        # for each refined segment, the size of the covering block
        seg_idx = np.searchsorted(ln, ends, side="left")
        sizes_this = subdiff(ln)
        data[:, it] = sizes_this[seg_idx]
    return RunLengthArray(ends=ends, array=data)
