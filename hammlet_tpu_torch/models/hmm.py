"""Model state of the wavelet-compressed Bayesian HMM, as tuples of tensors.

Port of hammlet_tpu/models/hmm.py: what the reference spreads over
Theta/Transitions/Initial plus their hyper-parameter objects (src/Theta.hpp,
src/Transitions.hpp, src/Initial.hpp) gathered into two NamedTuples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hammlet_tpu_torch.models import distributions as dist
from hammlet_tpu_torch.models import model_cuda
from hammlet_tpu_torch.models.mapping import combinations_mapping


class ModelSpec(NamedTuple):
    """Static model configuration."""

    nr_params: int
    nr_data_dim: int
    use_self_transitions: bool = True

    @property
    def nr_states(self) -> int:
        return self.nr_params**self.nr_data_dim

    def mapping(self) -> np.ndarray:
        return combinations_mapping(self.nr_data_dim, self.nr_params)


class HMMPriors(NamedTuple):
    """Prior hyper-parameters (constants of a run).

    nig:       (P, 4) float32 — (alpha, beta, mu0, nu) per emission parameter
    a_alphas:  (K, K) float32 — Dirichlet alphas per transition row
               (off-diagonal = -t value 1, diagonal = value 2; main.cpp:146-155)
    pi_alphas: (K,) float32   — Dirichlet alphas of the initial distribution
    """

    nig: torch.Tensor
    a_alphas: torch.Tensor
    pi_alphas: torch.Tensor

    @staticmethod
    def create(
        nig: np.ndarray,
        nr_states: int,
        trans: float = 0.5,
        self_trans: float = 0.5,
        initial_alpha: float = 0.5,
        device: torch.device | str = "cpu",
    ) -> "HMMPriors":
        a = np.full((nr_states, nr_states), trans, dtype=np.float32)
        np.fill_diagonal(a, self_trans)
        return HMMPriors(
            nig=torch.as_tensor(np.asarray(nig, dtype=np.float32), device=device),
            a_alphas=torch.as_tensor(a, device=device),
            pi_alphas=torch.full(
                (nr_states,), initial_alpha, dtype=torch.float32, device=device
            ),
        )


class HMMState(NamedTuple):
    """Sampled model state (one Gibbs iterate).

    theta_mean/theta_var: (P,) emission Normal parameters
    A:  (K, K) transition matrix
    pi: (K,) initial state distribution
    """

    theta_mean: torch.Tensor
    theta_var: torch.Tensor
    A: torch.Tensor
    pi: torch.Tensor

    def threshold(self, T: int) -> torch.Tensor:
        """Compression threshold sqrt(2 ln T * min variance) in float32
        (BreakpointArray.hpp:196-199, Theta.hpp:227-244), on the device.
        Host callers use ``threshold_host``; the two stay in lockstep."""
        # float32 log T on the host: a device scalar built from a host value
        # would cost a host-device copy per sweep
        log_t = float(np.log(np.float32(T)))
        return torch.sqrt(2.0 * log_t * torch.min(self.theta_var))


def threshold_host(theta_var, T: int) -> float:
    """Host-side compression threshold — HMMState.threshold's formula in
    float64, from a host copy of the variances (callers size capacities
    with it)."""
    v = float(np.asarray(theta_var).min())
    if not v >= 0.0:  # NaN or negative variance: no valid threshold
        return math.nan
    return math.sqrt(2.0 * math.log(max(2.0, float(T))) * v)


def sample_from_priors(generator: torch.Generator | None, priors: HMMPriors) -> HMMState:
    """Draw a full model state from the prior (the reference's 'P' token /
    initial sampling, main.cpp:397-400)."""
    mean, var = dist.nig_sample(generator, priors.nig)
    A = dist.dirichlet_sample(generator, priors.a_alphas)
    pi = dist.dirichlet_sample(generator, priors.pi_alphas)
    return HMMState(mean, var, A, pi)


class SweepStats(NamedTuple):
    """Aggregated per-sweep observation statistics (the reference's pass 3,
    ForwardBackward.hpp:170-212)."""

    theta_sums: torch.Tensor  # (P,)
    theta_sumsqs: torch.Tensor  # (P,)
    theta_counts: torch.Tensor  # (P,)
    trans_counts: torch.Tensor  # (K, K)
    state_counts: torch.Tensor  # (K,)


def resample_model(
    generator: torch.Generator | None,
    priors: HMMPriors,
    stats: SweepStats,
    noise: tuple[torch.Tensor, ...] | None = None,
) -> HMMState:
    """Conjugate posterior draws for theta, A, pi given sweep statistics
    (HMM.hpp:111-115: theta.sample, pi.sample, A.sample with posterior
    reset). All Gamma variates (InvGamma for theta variances, Dirichlet rows
    for A and pi) come from one fixed-depth Marsaglia-Tsang draw
    (dist.gamma_fixed_tries).

    The noise is drawn from ``generator`` in one order: the proposal
    normals (TRIES, n), the acceptance uniforms (TRIES, n), the boost
    uniforms (n,), then the mean normals (P,), n = P + K*K + K; ``noise``
    hands them in pre-drawn instead (a test feeds the JAX package's). On a
    card the resample is one kernel (model_cuda.resample_model_cuda), or
    raises; on the CPU its plain version, resample_model_reference."""
    P, K = priors.nig.shape[0], priors.pi_alphas.shape[0]
    dev = priors.nig.device
    if noise is None:
        n = P + K * K + K
        noise = (
            torch.randn((model_cuda.TRIES, n), generator=generator, device=dev),
            torch.rand((model_cuda.TRIES, n), generator=generator, device=dev),
            torch.rand((n,), generator=generator, device=dev),
            torch.randn((P,), generator=generator, device=dev),
        )
    if dev.type == "cuda":
        return HMMState(*model_cuda.resample_model_cuda(priors, stats, noise))
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return resample_model_reference(priors, stats, noise)


def _sum_columns(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, one add per column: the same
    order on every device (a torch reduction's is not pinned on the card)."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def resample_model_reference(
    priors: HMMPriors, stats: SweepStats, noise: tuple[torch.Tensor, ...]
) -> HMMState:
    """Plain torch version of the resample kernel (csrc/modelupdate.cu),
    given ``noise`` = (proposal normals (TRIES, n), acceptance uniforms
    (TRIES, n), boost uniforms (n,), mean normals (P,)): the NIG and
    Dirichlet posteriors, the Gamma draws, var = beta' / g, A's rows and pi
    each over its sum taken left to right, mean = mu0' + sqrt(var / nu') z."""
    x, u, ub, z = noise
    nig_post = dist.nig_update(
        priors.nig, stats.theta_sums, stats.theta_sumsqs, stats.theta_counts
    )
    P = nig_post.shape[0]
    K = priors.pi_alphas.shape[0]
    a_post = priors.a_alphas + stats.trans_counts
    pi_post = priors.pi_alphas + stats.state_counts
    alphas = torch.cat([nig_post[:, 0], a_post.reshape(-1), pi_post])
    g = dist.gamma_fixed_tries(None, alphas, model_cuda.TRIES, noise=(x, u, ub))
    var = nig_post[:, 1] / g[:P]
    A_g = g[P : P + K * K].reshape(K, K)
    A = A_g / _sum_columns(A_g)[:, None]
    pi_g = g[P + K * K :]
    pi = pi_g / _sum_columns(pi_g)
    mean = nig_post[:, 2] + torch.sqrt(var / nig_post[:, 3]) * z
    return HMMState(mean, var, A, pi)
