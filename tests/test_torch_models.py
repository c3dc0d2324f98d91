"""The port's conjugate updates, samplers, model state and auto-priors
against the JAX package (hammlet_tpu/models/)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_ulp, to_np, to_torch, toy_problem
from hammlet_tpu.models import autopriors as jap
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.models import hmm as jhmm
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu_torch import convert
from hammlet_tpu_torch.models import autopriors as tap
from hammlet_tpu_torch.models import distributions as td
from hammlet_tpu_torch.models import hmm as thmm
from hammlet_tpu_torch.ops import blocks as tb

torch.set_num_threads(1)


def test_nig_update_bitwise():
    """Tolerance: bitwise (the 1-ulp allowance is not needed: the port does
    the JAX package's float32 ops in its order; checked with max_ulp=0)."""
    rng = np.random.default_rng(3)
    prior = (np.abs(rng.normal(2, 1, size=(64, 4))) + 0.5).astype(np.float32)
    sums = rng.normal(0, 50, size=64).astype(np.float32)
    counts = rng.choice([0, 1, 5, 100, 10000, 3e6], size=64).astype(np.float32)
    sumsqs = (sums**2 / np.maximum(counts, 1) + counts * 1.7).astype(np.float32)
    want = jd.nig_update(*(jnp.asarray(a) for a in (prior, sums, sumsqs, counts)))
    got = td.nig_update(*(torch.from_numpy(a) for a in (prior, sums, sumsqs, counts)))
    assert_ulp(got, want, max_ulp=0)


@pytest.mark.parametrize("dim", [1, 2])
def test_emission_log_weights_within_rtol(dim):
    """Tolerance: rtol 1e-5 (log and matmul orders differ)."""
    p = toy_problem(B=40, K=3, dim=dim, seed=2)
    mapping = p["mapping"] if dim == 1 else np.array(
        [[0, 0], [1, 2], [2, 1]], dtype=np.int32
    )
    args = (p["stats_t"], p["sizes"], p["theta_mean"], p["theta_var"], mapping)
    want = jd.emission_log_weights_t(*(jnp.asarray(a) for a in args))
    got = td.emission_log_weights_t(
        *(torch.from_numpy(np.asarray(a)) for a in args[:4]),
        torch.from_numpy(mapping.astype(np.int64)),
    )
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_gamma_fixed_tries_matches_jax_given_its_noise():
    """Tolerance: rtol 1e-5. Fed the JAX package's proposal normals and
    uniforms (its key splits, distributions.py:77-81 and :106), the port's
    fixed-depth sampler returns the same variates."""
    key = jax.random.PRNGKey(7)
    alphas = np.array([0.5, 0.9, 1.0, 3.5, 120.0, 5e4, 1e7], dtype=np.float32)
    shape = alphas.shape
    k_n, k_u, k_b = jax.random.split(key, 3)
    x = jax.random.normal(k_n, (8,) + shape, dtype=jnp.float32)
    u = jax.random.uniform(k_u, (8,) + shape, dtype=jnp.float32, minval=1e-38)
    ub = jax.random.uniform(k_b, shape, dtype=jnp.float32, minval=1e-38)
    want = jd.gamma_fixed_tries(key, jnp.asarray(alphas))
    got = td.gamma_fixed_tries(
        None, torch.from_numpy(alphas),
        noise=tuple(to_torch(a) for a in (x, u, ub)),
    )
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5)


def test_gamma_fixed_tries_moments():
    """Moments (tests/test_samplers.py:191): mean a and variance a."""
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    for a in [0.5, 1.0, 3.5, 120.0, 5e4, 1e7]:
        g = to_np(td.gamma_fixed_tries(gen, torch.full((n,), a))).astype(np.float64)
        assert (g > 0).all()
        assert abs(g.mean() - a) < 5 * np.sqrt(a / n), (a, g.mean())
        assert abs(g.var() - a) / a < 0.05, (a, g.var())


def test_nig_sample_moments():
    """Moments (tests/test_samplers.py:63)."""
    n = 200_000
    params = torch.tensor([[5.0, 8.0, 1.5, 4.0]]).repeat(n, 1)
    mean, var = td.nig_sample(torch.Generator().manual_seed(1), params)
    assert abs(float(var.mean()) - 2.0) < 0.05  # beta / (alpha - 1)
    assert abs(float(mean.mean()) - 1.5) < 0.01
    assert abs(float(mean.var()) - 2.0 / 4.0) < 0.05  # E[var] / nu


def test_dirichlet_sample_moments():
    """Moments: E = alpha / sum(alpha), Var = a_i (a0 - a_i) / (a0^2 (a0+1))."""
    n = 100_000
    alpha = torch.tensor([0.5, 2.0, 4.5])
    d = to_np(td.dirichlet_sample(torch.Generator().manual_seed(2), alpha.repeat(n, 1)))
    a = to_np(alpha).astype(np.float64)
    a0 = a.sum()
    np.testing.assert_allclose(d.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(d.mean(axis=0), a / a0, atol=0.005)
    np.testing.assert_allclose(
        d.var(axis=0), a * (a0 - a) / (a0**2 * (a0 + 1)), rtol=0.05
    )


def test_threshold_matches_jax():
    """Tolerance: rtol 1e-6 for the device threshold, and threshold_host
    equal to the JAX package's host formula."""
    for T, var in [(100, [0.3, 1.7, 0.9]), (4_000_000, [2.5]), (7, [1e-6, 4.0])]:
        v = np.asarray(var, np.float32)
        jm = jhmm.HMMState(jnp.zeros(len(var)), jnp.asarray(v), jnp.eye(2), jnp.ones(2) / 2)
        tm = thmm.HMMState(torch.zeros(len(var)), torch.from_numpy(v), torch.eye(2), torch.ones(2) / 2)
        np.testing.assert_allclose(float(tm.threshold(T)), float(jm.threshold(T)), rtol=1e-6)
        assert thmm.threshold_host(v, T) == jhmm.threshold_host(v, T)


def test_priors_and_model_draws_are_valid():
    """HMMPriors.create equals the JAX package's; a prior draw and a
    posterior resample give finite positive variances and stochastic A, pi."""
    nig = np.tile(np.array([2.0, 0.4, 0.1, 0.3], np.float32), (3, 1))
    jp = jhmm.HMMPriors.create(nig, 3, 0.5, 0.7, 0.5)
    tp = thmm.HMMPriors.create(nig, 3, 0.5, 0.7, 0.5)
    for f in ("nig", "a_alphas", "pi_alphas"):
        np.testing.assert_array_equal(to_np(getattr(tp, f)), np.asarray(getattr(jp, f)))
    gen = torch.Generator().manual_seed(3)
    m = thmm.sample_from_priors(gen, tp)
    stats = thmm.SweepStats(
        torch.tensor([10.0, -5.0, 0.0]), torch.tensor([60.0, 30.0, 0.0]),
        torch.tensor([10.0, 5.0, 0.0]), torch.ones(3, 3), torch.tensor([5.0, 5.0, 5.0]),
    )
    for model in (m, thmm.resample_model(gen, tp, stats)):
        assert (to_np(model.theta_var) > 0).all()
        assert np.isfinite(to_np(model.theta_mean)).all()
        np.testing.assert_allclose(to_np(model.A).sum(axis=1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(model.pi.sum()), 1.0, rtol=1e-5)


def test_autoprior_matches_jax():
    """Tolerance: rtol 1e-4 on the NIG row (float32 block-mean reductions
    in another order); the host auto-prior (numpy in both) is bitwise."""
    from hammlet_tpu.golden import reference as gold

    data = np.random.default_rng(9).normal(0, 1, size=(6000, 1)).astype(np.float32)
    data[2000:4000] += 3.0
    coeffs = gold.maxlet_transform(data)
    w = gold.breakpoint_weights(coeffs)
    noise = jap.noise_std_estimate(coeffs)
    assert tap.noise_std_estimate(coeffs) == noise
    np.testing.assert_array_equal(
        tap.autoprior_host(0.2, 0.9, data, w, noise),
        jap.autoprior_host(0.2, 0.9, data, w, noise),
    )
    jr, jp = jb.build_ranked_weights(w), jb.build_prefix_stats_device(jnp.asarray(data))
    want = jap.autoprior(0.2, 0.9, jr, jp, noise, 600, cell_bits=jb.DEVICE_CELL_BITS)
    got = tap.autoprior(
        0.2, 0.9, tb.build_ranked_weights(w), convert.prefix_stats(jp), noise, 600,
        cell_bits=tb.DEVICE_CELL_BITS,
    )
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_convert_carries_jax_state():
    """convert.* turn the JAX package's structures into the port's with the
    same values (index arrays as int64)."""
    nig = np.tile(np.array([2.0, 0.4, 0.1, 0.3], np.float32), (3, 1))
    jp = jhmm.HMMPriors.create(nig, 3)
    jm = jhmm.sample_from_priors(jax.random.PRNGKey(0), jp)
    tp, tm = convert.hmm_priors(jp), convert.hmm_state(jm)
    for j, t in ((jp, tp), (jm, tm)):
        for f in j._fields:
            np.testing.assert_array_equal(to_np(getattr(t, f)), np.asarray(getattr(j, f)))
    w = np.random.default_rng(0).exponential(size=500).astype(np.float32)
    tr = convert.ranked_weights(jb.build_ranked_weights(w))
    assert tr.pos_by_rank.dtype == torch.int64
    np.testing.assert_array_equal(to_np(tr.pos_by_rank), to_np(tb.build_ranked_weights(w).pos_by_rank))
    # the port's threshold of a carried-over state matches the JAX one
    np.testing.assert_allclose(float(tm.threshold(500)), float(jm.threshold(500)), rtol=1e-6)
