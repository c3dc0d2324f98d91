"""Conjugate updates and posterior draws as plain torch functions.

Port of hammlet_tpu/models/distributions.py: the Normal family the sampler
uses and the Beta/Geometric family the reference carries but main.cpp does
not wire (kept for the same capability surface). Random draws come from an explicit
``torch.Generator``; every sampler also accepts its noise pre-drawn, so a
test can feed it the JAX package's draws and demand the same result.
"""

from __future__ import annotations

import torch

#: smallest uniform draw, as jax.random.uniform(minval=1e-38)
_U_MIN = 1e-38


def nig_update(
    prior: torch.Tensor, sums: torch.Tensor, sumsqs: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Batch Normal-Inverse-Gamma conjugate update.

    prior:  (P, 4) float32 rows (alpha, beta, mu0, nu)
    sums/sumsqs/counts: (P,) aggregated observation statistics per parameter
    Returns the (P, 4) posterior. Parameters with zero observations keep the
    prior. Mirrors Conjugate.hpp:120-168 including the guard clamping the
    naive (sum^2/N) term at sumSq to avoid negative sample variance.
    """
    alpha, beta, mu0, nu = prior.unbind(1)
    n = counts.to(torch.float32)
    safe_n = torch.clamp(n, min=1.0)
    xbar = sums / safe_n
    ssn = torch.minimum((sums * sums) / safe_n, sumsqs)
    dev = xbar - mu0
    new_alpha = alpha + n / 2.0
    new_beta = beta + ((sumsqs + (n * nu / (n + nu)) * (dev * dev)) - ssn) / 2.0
    new_mu0 = (nu * mu0 + sums) / (nu + n)
    new_nu = nu + n
    post = torch.stack([new_alpha, new_beta, new_mu0, new_nu], dim=1)
    return torch.where((counts > 0)[:, None], post, prior)


def _uniform(generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device).clamp_(min=_U_MIN)


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), as jax.random.gumbel."""
    return -torch.log(-torch.log(_uniform(generator, shape, device)))


def nig_sample(
    generator: torch.Generator | None,
    params: torch.Tensor,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw (mean, var) per parameter from NIG rows (alpha, beta, mu0, nu).

    var ~ InvGamma(alpha, beta) = beta / Gamma(alpha, 1);
    mean ~ Normal(mu0, sqrt(var / nu)).  (Distribution.hpp:76-87)
    ``noise`` = (Gamma(alpha, 1) draws, standard normal draws), both (P,).
    """
    alpha, beta, mu0, nu = params.unbind(1)
    if noise is None:
        g = torch._standard_gamma(alpha, generator=generator)
        z = torch.randn(alpha.shape, generator=generator, device=params.device)
    else:
        g, z = noise
    var = beta / g
    mean = mu0 + torch.sqrt(var / nu) * z
    return mean, var


def gamma_fixed_tries(
    generator: torch.Generator | None,
    alphas: torch.Tensor,
    tries: int = 8,
    noise: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Gamma(alpha, 1) draws with a FIXED-depth Marsaglia-Tsang rejection
    sampler: ``tries`` independent proposals, the first accepted one wins
    (acceptance >= 0.95 per try for alpha >= 1, so total rejection has
    probability < 1e-10; the fallback is the mode). alpha < 1 uses the
    alpha+1 boost G(a) = G(a+1) * U^(1/a).

    ``noise`` = (normal (tries, *shape), uniform (tries, *shape), uniform
    (*shape)) — the proposal normals, acceptance uniforms and boost
    uniforms; the uniforms are floored at 1e-38 here, as drawn ones are."""
    a = alphas.to(torch.float32)
    shape = tuple(a.shape)
    boost_needed = a < 1.0
    a_eff = torch.where(boost_needed, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    if noise is None:
        x = torch.randn((tries,) + shape, generator=generator, device=a.device)
        u = torch.rand((tries,) + shape, generator=generator, device=a.device)
        ub = torch.rand(shape, generator=generator, device=a.device)
    else:
        x, u, ub = noise
    u, ub = torch.clamp(u, min=_U_MIN), torch.clamp(ub, min=_U_MIN)
    t = c * x
    v = (1.0 + t) ** 3
    # acceptance statistic 0.5 x^2 + d (1 - v + log v), expanded in t = c x
    # so every term is O(x^2) and stays accurate at alphas ~1e7; log1p(t) - t
    # switches to its Taylor series where it cancels (|t| < 0.1)
    series = -(t * t) * (
        1.0 / 2.0
        - t * (1.0 / 3.0 - t * (1.0 / 4.0 - t * (1.0 / 5.0
            - t * (1.0 / 6.0 - t * (1.0 / 7.0 - t / 8.0)))))
    )
    log1p_m_t = torch.where(
        torch.abs(t) < 0.1, series, torch.log1p(torch.clamp(t, min=-0.999999)) - t
    )
    accept_stat = 0.5 * x * x + d * (3.0 * log1p_m_t - t * t * (3.0 + t))
    ok = (v > 0.0) & (torch.log(u) < accept_stat)
    cand = d * torch.clamp(v, min=0.0)
    # first accepted proposal; fall back to the mode (= d) if all rejected
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    g = torch.where(
        ok.any(dim=0), torch.gather(cand, 0, first[None])[0], d
    )
    return torch.where(
        boost_needed, g * ub ** (1.0 / torch.clamp(a, min=1e-6)), g
    )


def dirichlet_sample(
    generator: torch.Generator | None,
    alphas: torch.Tensor,
    gamma: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dirichlet draw(s) via normalized Gammas (Distribution.hpp:116-139).
    alphas: (..., K); normalizes over the last axis. ``gamma``: pre-drawn
    Gamma(alphas, 1) variates."""
    g = torch._standard_gamma(alphas, generator=generator) if gamma is None else gamma
    return g / torch.sum(g, dim=-1, keepdim=True)


def emission_log_weights(
    block_stats: torch.Tensor,
    sizes: torch.Tensor,
    theta_mean: torch.Tensor,
    theta_var: torch.Tensor,
    mapping: torch.Tensor,
) -> torch.Tensor:
    """emission_log_weights_t in the block-major layout: block_stats is
    (B, dim, 2) (ops.blocks.block_sufficient_stats) and the result (B, K)."""
    return emission_log_weights_t(
        block_stats.permute(1, 2, 0), sizes, theta_mean, theta_var, mapping
    ).T


def emission_log_weights_t(
    block_stats_t: torch.Tensor,
    sizes: torch.Tensor,
    theta_mean: torch.Tensor,
    theta_var: torch.Tensor,
    mapping: torch.Tensor,
) -> torch.Tensor:
    """Per-(state, block) log emission weight E (without self-transitions),
    block axis minor:

    E_b(s) = sum_d [ (2 mu sum_x - sum_x2) / (2 var) ]_{p = mapping[s,d]}
             - N_b * sum_d logNormalizer(p)
    (EFD.hpp:23-38, ForwardBackward.hpp:75)

    block_stats_t: (dim, 2, B) (ops.blocks.block_sufficient_stats_t);
    sizes: (B,); theta_*: (P,); mapping: (K, dim). Returns (K, B) float32.
    """
    a = theta_mean / theta_var
    b = 0.5 / theta_var
    c = 0.5 * torch.log(theta_var) + theta_mean * theta_mean * b
    A = a[mapping]  # (K, dim)
    Bc = b[mapping]
    C = torch.sum(c[mapping], dim=1)  # (K,)
    ip = A @ block_stats_t[:, 0, :] - Bc @ block_stats_t[:, 1, :]
    return ip - C[:, None] * sizes.to(torch.float32)[None, :]


# -- Beta / Geometric family -------------------------------------------------
# The reference carries a Geometric-emission/Beta-conjugate family in its
# probability kernel (SufficientStatistics.hpp:310-388, Conjugate.hpp:209-215,
# Distribution.hpp:94-107, EFD.hpp:64-77, Theta.hpp:248-257) although main.cpp
# only wires the Normal family.


def beta_update(prior: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Beta conjugate update for Geometric observations: rows (alpha, beta);
    alpha += N, beta += sum (Conjugate.hpp:209-215)."""
    return torch.stack([prior[:, 0] + counts.to(torch.float32), prior[:, 1] + sums], dim=1)


def beta_sample(
    generator: torch.Generator | None,
    params: torch.Tensor,
    gammas: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Beta(alpha, beta) draws per row via two Gammas (Distribution.hpp:
    94-107). ``gammas``: pre-drawn Gamma(alpha, 1) and Gamma(beta, 1)."""
    if gammas is None:
        a = torch._standard_gamma(params[:, 0].contiguous(), generator=generator)
        b = torch._standard_gamma(params[:, 1].contiguous(), generator=generator)
    else:
        a, b = gammas
    return a / (a + b)


def geometric_log_weights(
    sums: torch.Tensor, sizes: torch.Tensor, theta_value: torch.Tensor
) -> torch.Tensor:
    """Per-(block, param) Geometric log emission weight, (B, P):
    innerProduct = sum * value, logNormalizer = log(value) (EFD.hpp:64-77)."""
    return (
        sums[:, None] * theta_value[None, :]
        - sizes.to(torch.float32)[:, None] * torch.log(theta_value)[None, :]
    )


def beta_threshold_value(theta_value: torch.Tensor) -> torch.Tensor:
    """Compression threshold statistic for Beta emissions: min over params of
    (1 - p) / p^2 (Theta.hpp:248-257)."""
    return torch.min((1.0 - theta_value) / (theta_value * theta_value))
