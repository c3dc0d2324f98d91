"""Golden NumPy model of the reference algorithms (test oracle only).

The port's own copy of hammlet_tpu/golden/reference.py (numpy only), so that
a machine without JAX can hold the port against it; tests/test_torch_golden.py
checks that both copies give the same results. Each function re-derives, in the reference's exact floating-point operation
order, one of the algorithms of HaMMLET:

- ``maxlet_transform``     : streaming maxlet transform (wavelet.hpp:98-188)
- ``breakpoint_weights``   : top-down dyadic max-propagation (wavelet.hpp:68-93)
- ``block_starts``         : threshold blocks (Blocks/BreakpointArray.hpp:216-235)
- ``noise_std_estimate``   : MAD-based sigma estimate (main.cpp:304-311)
- ``nig_posterior``        : NIG conjugate update (Conjugate.hpp:120-168)
- ``nig_autoprior``        : closed-form auto-prior (AutoPriors.hpp:18-80)
- ``fb_gibbs_sweep``       : sequential block FB-Gibbs draw
                             (StateSequence/ForwardBackward.hpp:16-213)
- ``mixture_sweep``        : per-block mixture draw (StateSequence/Mixture.hpp)

They are written as straightforward sequential NumPy, NOT copied from the C++.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
INF = np.float32(np.inf)
SQRT2HALF = np.float32(np.float32(np.sqrt(np.float64(2.0))) / np.float32(2.0))


def maxlet_transform(data: np.ndarray) -> np.ndarray:
    """Maxlet transform of ``data`` with shape (T, dim) -> coeffs (T,) float32.

    coeffs[t] is the absolute Haar detail coefficient (max across dims) of the
    unique wavelet whose central discontinuity sits at position t; positions
    whose wavelet support is not fully contained in [0, T) (and position 0)
    hold +inf. Summation follows the streaming stack merge order of the
    reference, i.e. pairwise dyadic float32 adds.
    """
    data = np.asarray(data, dtype=F32)
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    coeffs = np.full(T, INF, dtype=F32)
    sums = data.copy()  # level-0 partial sums, one row per node
    level = 1
    normalizer = SQRT2HALF
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        # detail coefficient, max across dims, computed before merging sums
        detail = np.max(
            np.float32(normalizer) * np.abs(left - right), axis=1
        ).astype(F32)
        # node a at this level covers [a*2^l, (a+1)*2^l); its coefficient is
        # recorded at the discontinuity a*2^l + 2^(l-1), and only exists if
        # the support is complete (streaming merge happened)
        idx = (np.arange(n_pairs) << level) + (1 << (level - 1))
        complete = (np.arange(n_pairs) << level) + (1 << level) <= T
        coeffs[idx[complete]] = detail[complete]
        sums = (left + right).astype(F32)  # odd tail node is dropped; it can
        # never complete at a higher level either (its right sibling is
        # missing), matching the streaming stack which leaves it unmerged.
        # NOTE the tail node *can* merge at higher levels in the streaming
        # version only if paired with data that doesn't exist -> never.
        level += 1
        normalizer = F32(normalizer * SQRT2HALF)
    coeffs[0] = INF
    return coeffs


def breakpoint_weights(coeffs: np.ndarray) -> np.ndarray:
    """Breakpoint weights from maxlet coefficients (in the reference's
    top-down propagation order). w[t] = max |coeff| over all wavelets with a
    discontinuity at t."""
    w = np.asarray(coeffs, dtype=F32).copy()
    size = len(w)
    p = 1  # interval starts at ceilPow2(size) / 2
    while p < size:
        p *= 2
    interval = p // 2
    while interval >= 1:
        for index in range(interval, size, 2 * interval):
            L = index - interval
            R = index + interval
            if R < size:
                w[R] = max(w[R], w[index])
            else:
                w[L] = INF
                w[index] = INF
            w[L] = max(w[L], w[index])
        interval //= 2
    return w


def block_starts(weights: np.ndarray, threshold: float) -> np.ndarray:
    """Indices of block start positions for a threshold. A new block starts at
    every position whose weight is >= threshold (w[0] = inf guarantees 0)."""
    w = np.asarray(weights)
    starts = np.flatnonzero(w >= F32(threshold))
    if len(starts) == 0 or starts[0] != 0:
        starts = np.concatenate([[0], starts])
    return starts


def block_stats(data: np.ndarray, starts: np.ndarray):
    """Per-block (sum, sumsq, N) computed in float64 (accuracy oracle)."""
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    ends = np.concatenate([starts[1:], [T]])
    sums = np.add.reduceat(data, starts, axis=0)
    sumsqs = np.add.reduceat(data * data, starts, axis=0)
    return sums, sumsqs, (ends - starts)


def noise_std_estimate(coeffs: np.ndarray) -> float:
    """Noise sigma estimate: mean of odd-position (level-1) maxlet
    coefficients divided by sqrt(2/pi); double accumulation."""
    odd = np.asarray(coeffs[1::2], dtype=np.float64)
    est = odd.sum() / len(odd)
    return float(est / 0.797884560802865355879892119868763736951717262329869315331)


def nig_posterior(prior, stats_sum, stats_sumsq, counts):
    """NIG conjugate update. prior = (alpha, beta, mu0, nu) float32.
    Returns updated (alpha, beta, mu0, nu), float32 arithmetic with the
    reference's cancellation guard."""
    alpha, beta, mu0, nu = (F32(x) for x in prior)
    if counts == 0:
        return np.array([alpha, beta, mu0, nu], dtype=F32)
    s = F32(stats_sum)
    sq = F32(stats_sumsq)
    N = np.float64(counts)
    xbar = F32(s / N)
    ssN = F32((s * s) / N)
    if ssN > sq:
        ssN = sq
    new_alpha = F32(alpha + N / 2.0)
    new_beta = F32(
        beta
        + ((sq + F32(N * nu / (N + nu)) * F32((xbar - mu0) * (xbar - mu0))) - ssN)
        / F32(2.0)
    )
    new_mu0 = F32((nu * mu0 + s) / (nu + F32(N)))
    new_nu = F32(nu + N)
    return np.array([new_alpha, new_beta, new_mu0, new_nu], dtype=F32)


def nig_autoprior(s2: float, p: float, data_mean: float, data_var: float):
    """Closed-form NIG auto-prior (AutoPriors.hpp:38-48)."""
    M1 = 0.3361
    M2 = -0.0042
    M3 = -0.0201
    b = -np.log(p)
    alpha = 2.0
    beta = s2 * (
        (2.0 * np.sqrt(b))
        / (M1 * np.sqrt(b) + np.sqrt(2.0) * (M2 * b * np.exp(M3 * np.sqrt(b)) + 1))
        + b
    )
    mu0 = data_mean
    nu = beta / data_var
    return np.array([alpha, beta, mu0, nu], dtype=F32)


def autoprior_from_blocks(s2, p, data, weights, noise_std):
    """Auto-prior pipeline (AutoPriors.hpp:86-107): block means at threshold
    sqrt(2 log T) * sigma_noise, then closed form."""
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    thr = np.sqrt(2.0 * np.log(float(T))) * noise_std
    starts = block_starts(weights, thr)
    sums, _, N = block_stats(data, starts)
    means = (sums / N[:, None]).ravel()  # per block per dim
    n = means.size
    m = means.sum() / n
    v = (means * means).sum() / n - m * m
    return nig_autoprior(s2, p, m, v), starts


def _emission_logweight(sums, sumsqs, N, theta_mean, theta_var, mapping, state):
    """log emission weight E for one block and state (without self-trans)."""
    E = 0.0
    for d in range(sums.shape[0]):
        p = mapping[state][d]
        mu, var = theta_mean[p], theta_var[p]
        E += (2.0 * mu * sums[d] - sumsqs[d]) / (2.0 * var)
        E -= N * (np.log(np.sqrt(var)) + mu * mu / (2.0 * var))
    return E


def fb_forward_columns(
    sums, sumsqs, N, theta_mean, theta_var, A, pi, mapping,
    use_self_transitions=True,
):
    """Deterministic part of the FB sweep: the trellis columns after the
    retroactive self-transition scaling, plus the unscaled final column."""
    B = len(N)
    K = len(pi)
    logA = np.log(np.diag(A))
    trellis = np.zeros((B + 1, K))
    trellis[0] = pi
    prevN = 1.0
    for b in range(B):
        E = np.array(
            [
                _emission_logweight(
                    sums[b], sumsqs[b], N[b], theta_mean, theta_var, mapping, s
                )
                + (use_self_transitions * (N[b] - 1.0) * logA[s])
                for s in range(K)
            ]
        )
        w = np.exp(E - E.max())
        fwd = w * (trellis[b] @ A)
        tot = fwd.sum()
        fwd = fwd / tot if tot != 0 else np.full(K, 1.0 / K)
        if use_self_transitions:
            trellis[b] = trellis[b] * np.exp((prevN - 1.0) * logA)
        trellis[b + 1] = fwd
        prevN = float(N[b])
    last_col = trellis[B].copy()
    cols = trellis[1:].copy()
    if use_self_transitions:
        # the final column is stored unscaled; scale all previous ones
        cols[B - 1] = last_col
    return cols, last_col


def fb_gibbs_sweep(
    sums, sumsqs, N, theta_mean, theta_var, A, pi, mapping, rng,
    use_self_transitions=True,
):
    """One sequential FB-Gibbs state-sequence draw over blocks.

    sums/sumsqs: (B, dim); N: (B,); A: (K, K); pi: (K,)
    Returns sampled per-block states (B,) int.
    Mirrors the reference semantics including the retroactive self-transition
    scaling of trellis columns (ForwardBackward.hpp:115-119).
    """
    B = len(N)
    K = len(pi)
    logA = np.log(np.diag(A))
    trellis = np.zeros((B + 1, K))
    trellis[0] = pi
    prevN = 1.0
    for b in range(B):
        E = np.array(
            [
                _emission_logweight(
                    sums[b], sumsqs[b], N[b], theta_mean, theta_var, mapping, s
                )
                + (use_self_transitions * (N[b] - 1.0) * logA[s])
                for s in range(K)
            ]
        )
        w = np.exp(E - E.max())
        fwd = w * (trellis[b] @ A)
        tot = fwd.sum()
        fwd = fwd / tot if tot != 0 else np.full(K, 1.0 / K)
        if use_self_transitions:
            trellis[b] = trellis[b] * np.exp((prevN - 1.0) * logA)
        trellis[b + 1] = fwd
        prevN = float(N[b])
    states = np.zeros(B, dtype=np.int64)
    j = rng.choice(K, p=trellis[B] / trellis[B].sum())
    states[B - 1] = j
    for tt in range(B - 1, 0, -1):
        col = trellis[tt] * A[:, j]
        col = col / col.sum()
        j = rng.choice(K, p=col)
        states[tt - 1] = j
    return states


def mixture_sweep(sums, sumsqs, N, theta_mean, theta_var, mapping, K, rng):
    """Per-block independent mixture draw (Mixture.hpp:90-129)."""
    B = len(N)
    states = np.zeros(B, dtype=np.int64)
    for b in range(B):
        E = np.array(
            [
                _emission_logweight(
                    sums[b], sumsqs[b], N[b], theta_mean, theta_var, mapping, s
                )
                for s in range(K)
            ]
        )
        w = np.exp(E - E.max())
        states[b] = rng.choice(K, p=w / w.sum())
    return states


def accumulate_counts(states, N, K):
    """Reference pass-3 count accumulation: per-state position counts,
    transition counts (diag gets N-1 self transitions per block, plus a
    single prev->cur transition with prev of the first block = 0)."""
    state_counts = np.zeros(K)
    trans = np.zeros((K, K))
    prev = 0
    for b in range(len(N)):
        s = states[b]
        trans[s, s] += N[b] - 1
        trans[prev, s] += 1
        state_counts[s] += N[b]
        prev = s
    return state_counts, trans
