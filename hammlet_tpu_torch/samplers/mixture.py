"""Mixture (burn-in) state sampling: per-block independent categorical draws.

Port of hammlet_tpu/samplers/mixture.py (src/StateSequence/Mixture.hpp:
31-144). Transitions and the initial distribution are ignored; each block's
state is drawn from the softmax of its emission log-weights via the
Gumbel-max trick.
"""

from __future__ import annotations

import torch

from hammlet_tpu_torch.models.distributions import emission_log_weights_t, gumbel


def categorical_states(
    log_e_t: torch.Tensor,
    n_blocks: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B,) int64 Gumbel-max draws from (K, B) log-weights; padded blocks
    (b >= n_blocks) get state 0. ``noise``: pre-drawn (K, B) Gumbels."""
    K, B = log_e_t.shape
    if noise is None:
        noise = gumbel(generator, (K, B), log_e_t.device)
    states = torch.argmax(log_e_t + noise, dim=0)
    valid = torch.arange(B, device=log_e_t.device) < n_blocks
    return torch.where(valid, states, 0)


def mixture_sample_states(
    generator: torch.Generator | None,
    block_stats_t: torch.Tensor,  # (dim, 2, B) — ops.blocks.block_sufficient_stats_t
    sizes: torch.Tensor,
    n_blocks: torch.Tensor,
    theta_mean: torch.Tensor,
    theta_var: torch.Tensor,
    mapping: torch.Tensor,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B,) int64 per-block states (padded blocks get state 0)."""
    log_e_t = emission_log_weights_t(
        block_stats_t, sizes, theta_mean, theta_var, mapping
    )
    return categorical_states(log_e_t, n_blocks, generator, noise)
