"""Automatic NIG hyper-priors from compressed block means.

Port of hammlet_tpu/models/autopriors.py (src/AutoPriors.hpp:18-110 and the
noise estimator at main.cpp:304-311). The host functions are numpy; the
device pass runs one fixed-capacity block decomposition plus reductions.
"""

from __future__ import annotations

import numpy as np
import torch

from hammlet_tpu_torch.ops.blocks import (
    PrefixStats,
    RankedWeights,
    block_sufficient_stats,
    make_blocks_ranked,
)


def noise_std_estimate(coeffs) -> float:
    """Sigma estimate from the finest-level maxlet coefficients: mean of
    odd-position coefficients divided by sqrt(2/pi), double accumulation
    (main.cpp:304-311)."""
    odd = np.asarray(coeffs)[1::2].astype(np.float64)
    est = odd.sum() / len(odd)
    return float(est / 0.797884560802865355879892119868763736951717262329869315331)


def nig_autoprior(s2: float, p: float, data_mean: float, data_var: float) -> np.ndarray:
    """Closed-form NIG auto-prior (AutoPriors.hpp:38-48): alpha = 2, beta
    from the desired variance s2 and tail probability p via fitted constants
    M1..M3, mu0 = mean of block means, nu = beta / variance of block means."""
    if not (0.0 <= p <= 1.0):
        raise ValueError("autoprior p must be a probability in [0, 1]")
    if s2 <= 0:
        raise ValueError("autoprior s2 must be positive")
    if data_var <= 0:
        raise ValueError("data variance for autoprior must be positive")
    M1, M2, M3 = 0.3361, -0.0042, -0.0201
    b = -np.log(p)
    alpha = 2.0
    beta = s2 * (
        (2.0 * np.sqrt(b))
        / (M1 * np.sqrt(b) + np.sqrt(2.0) * (M2 * b * np.exp(M3 * np.sqrt(b)) + 1))
        + b
    )
    mu0 = data_mean
    nu = beta / data_var
    out = np.array([alpha, beta, mu0, nu], dtype=np.float32)
    if not np.all(np.isfinite(out)) or beta <= 0 or nu <= 0:
        raise ValueError("autoprior yields non-finite or non-positive values")
    return out


def autoprior_host(
    s2: float,
    p: float,
    data: np.ndarray,
    weights: np.ndarray,
    noise_std: float,
) -> np.ndarray:
    """Host-side auto-prior (one-time O(T) NumPy). Same math as
    ``autoprior``."""
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    thr = np.float32(np.sqrt(2.0 * np.log(float(T))) * noise_std)
    starts = np.flatnonzero(np.asarray(weights) >= thr)
    if len(starts) == 0 or starts[0] != 0:
        starts = np.concatenate([[0], starts])
    ends = np.concatenate([starts[1:], [T]])
    sums = np.add.reduceat(data, starts, axis=0)
    sizes = (ends - starts)[:, None]
    means = (sums / sizes).ravel()
    n = means.size
    mean = means.sum() / n
    var = (means * means).sum() / n - mean * mean
    return nig_autoprior(s2, p, float(mean), float(var))


def autoprior(
    s2: float,
    p: float,
    ranked: RankedWeights,
    prefix: PrefixStats,
    noise_std: float,
    capacity: int,
    cell_bits: int = 16,
) -> np.ndarray:
    """Full auto-prior pipeline (AutoPriors.hpp:86-107): compress at
    threshold sqrt(2 ln T) * sigma_noise, take per-(block, dim) means, feed
    their mean/variance into the closed form."""
    T = prefix.T
    thr = np.float32(np.sqrt(2.0 * np.log(float(T))) * noise_std)
    mean, var = _block_mean_moments(ranked, prefix, thr, capacity, cell_bits)
    return nig_autoprior(s2, p, float(mean), float(var))


def _block_mean_moments(ranked, prefix, thr, capacity, cell_bits):
    """Device pass: float32 mean and variance of the per-(block, dim) means
    at threshold ``thr``."""
    blocks = make_blocks_ranked(ranked, thr, capacity)
    stats = block_sufficient_stats(prefix, blocks, cell_bits)  # (B, dim, 2)
    sizes = blocks.sizes.to(torch.float32)
    valid = blocks.sizes > 0
    means = torch.where(
        valid[:, None], stats[..., 0] / torch.clamp(sizes, min=1.0)[:, None], 0.0
    )  # (B, dim)
    n = torch.sum(valid) * prefix.dim
    mean = torch.sum(means) / n
    var = torch.sum(means * means) / n - mean * mean
    return mean.item(), var.item()
