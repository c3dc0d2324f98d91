"""Runtime invariant checks (debug mode).

Port of hammlet_tpu/debug.py. The reference guards its numerics with
runtime_error throws: finiteness/positivity on every parameter setter
(Observation.hpp:374-392), negative backward variables
(ForwardBackward.hpp:147-149), and the marginal-sum invariant at save
(StateMarginals.hpp:306-308). On the device a NaN would otherwise propagate
silently into wrong marginals.

Equivalent here:
- HAMMLET_DEBUG=1 (the JAX package's switch; default ON under pytest via
  tests/conftest.py) adds an error bitmask to every sweep: non-finite or
  non-positive parameters and non-finite block statistics are OR-reduced on
  the device across each phase chunk and surfaced through the chunk's single
  host sync, where the engine raises. With the switch off the sweep issues
  none of these ops.
- the marginal-sum invariant (every segment's counts sum to the number of
  recorded sweeps) is checked unconditionally at save time, like the
  reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ERR_THETA_MEAN = 1  # non-finite resampled emission mean
ERR_THETA_VAR = 2  # non-finite or non-positive resampled emission variance
ERR_TRANS = 4  # non-finite transition/initial probabilities
ERR_BLOCK_STATS = 8  # non-finite block sufficient statistics

_NAMES = {
    ERR_THETA_MEAN: "non-finite emission mean",
    ERR_THETA_VAR: "non-positive emission variance",
    ERR_TRANS: "non-finite transition/initial distribution",
    ERR_BLOCK_STATS: "non-finite block statistics",
}


def debug_enabled() -> bool:
    return os.environ.get("HAMMLET_DEBUG", "0") == "1"


def _bit(ok: torch.Tensor, bit: int) -> torch.Tensor:
    """() int32: 0 where the () bool ``ok`` holds, else ``bit``."""
    return (~ok).to(torch.int32) * bit


def model_error_bits(model, bstats: torch.Tensor | None = None) -> torch.Tensor:
    """() int32 bitmask of violated invariants (0 = all good), on the
    model's device (no host sync)."""
    err = _bit(torch.isfinite(model.theta_mean).all(), ERR_THETA_MEAN)
    err = err | _bit(
        (torch.isfinite(model.theta_var) & (model.theta_var > 0)).all(),
        ERR_THETA_VAR,
    )
    err = err | _bit(
        torch.isfinite(model.A).all() & torch.isfinite(model.pi).all(), ERR_TRANS
    )
    if bstats is not None:
        err = err | _bit(torch.isfinite(bstats).all(), ERR_BLOCK_STATS)
    return err


def raise_on_error(err: int) -> None:
    """Decode a sweep error bitmask into the loud failure the reference
    would have thrown (Observation.hpp:374-392 etc.)."""
    if not err:
        return
    what = [name for bit, name in _NAMES.items() if err & bit]
    raise FloatingPointError(
        "invariant violation during Gibbs sweep: " + "; ".join(what)
        + " (HAMMLET_DEBUG=1)"
    )


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
