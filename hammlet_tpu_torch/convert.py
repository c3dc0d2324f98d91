"""Carry state from the JAX package (or its checkpoints) into the port.

Each function takes any object with the JAX structure's field names whose
values are array-likes — the JAX NamedTuple itself, or a namespace of numpy
arrays read from a checkpoint — and returns the port's structure on
``device``. Index arrays become int64 (torch's index type); everything else
keeps its dtype. Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from hammlet_tpu_torch.models.hmm import HMMPriors, HMMState
from hammlet_tpu_torch.ops.blocks import PrefixStats, RankedWeights
from hammlet_tpu_torch.samplers.sweep import RecordBuffers


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(x)  # always a fresh, writable host copy
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def prefix_stats(src, device="cpu") -> PrefixStats:
    return PrefixStats(
        _t(src.r_t, device), _t(src.q2_hi, device), _t(src.q2_lo, device)
    )


def ranked_weights(src, device="cpu") -> RankedWeights:
    return RankedWeights(
        _t(src.neg_w_sorted, device), _t(src.pos_by_rank, device, torch.int64)
    )


def candidates(cand_pos, cand_rank, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The (cand_pos, cand_rank) pair of ops.blocks.bucket_candidates."""
    return _t(cand_pos, device, torch.int64), _t(cand_rank, device, torch.int64)


def hmm_priors(src, device="cpu") -> HMMPriors:
    return HMMPriors(
        _t(src.nig, device), _t(src.a_alphas, device), _t(src.pi_alphas, device)
    )


def hmm_state(src, device="cpu") -> HMMState:
    return HMMState(
        _t(src.theta_mean, device), _t(src.theta_var, device),
        _t(src.A, device), _t(src.pi, device),
    )


def record_buffers(src, device="cpu") -> RecordBuffers:
    return RecordBuffers(
        counts=_t(src.counts, device, torch.int32),
        ever_boundary=_t(src.ever_boundary, device, torch.bool),
        n_records=_t(src.n_records, device, torch.int32),
        n_boundaries=_t(src.n_boundaries, device, torch.int32),
    )
