"""Windowed mean of a value stream (reference: src/tools/avg.cpp).

Usage: hammlet-torch-avg WINDOWSIZE < values > means
Prints the mean of each non-overlapping window; a final partial window is
averaged over its actual length.
"""

import sys

import numpy as np


def run(window: int, instream=sys.stdin, outstream=sys.stdout) -> None:
    data = np.array(instream.read().split(), dtype=float)
    n_full = len(data) // window
    for i in range(n_full):
        outstream.write(f"{data[i * window:(i + 1) * window].mean():g}\n")
    rem = data[n_full * window:]
    if len(rem):
        outstream.write(f"{rem.mean():g}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Not enough arguments!", file=sys.stderr)
        return 1
    run(int(argv[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
