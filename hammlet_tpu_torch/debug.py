"""Runtime invariant checks.

Port of hammlet_tpu/debug.py's save-time check. The per-sweep error bitmask
of the JAX package is not ported yet (see ROADMAP.md); the ``diag`` of a
phase chunk keeps its slot at 0.
"""

from __future__ import annotations

import numpy as np


def check_marginal_sums(seg_counts, n_records: int) -> None:
    """The reference's save-time invariant: every marginal row's counts sum
    to the number of recorded sweeps (StateMarginals.hpp:306-308)."""
    sums = np.asarray(seg_counts).sum(axis=1)
    if len(sums) and not (sums == int(n_records)).all():
        bad = int((sums != int(n_records)).sum())
        raise RuntimeError(
            f"Number of counts ({int(sums[0])} at the first of {bad} bad "
            f"segments) does not match number of iterations "
            f"({int(n_records)})!"
        )
