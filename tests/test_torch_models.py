"""The port's conjugate updates, samplers, model state and auto-priors
against the JAX package (hammlet_tpu/models/)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import VOTE_CASES, assert_ulp, to_np, to_torch, toy_problem, vote_noise
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


def _resample_case(K: int, seed: int):
    """Priors and sweep statistics whose Gamma shapes run from 0.5 to 1e7
    (HMMPriors.create's alphas plus counts of 0 to 1e7), as numpy arrays."""
    rng = np.random.default_rng(seed)
    P = K
    nig = np.tile(np.array([2.0, 0.4, 0.1, 0.3], np.float32), (P, 1))
    spread = np.array([0.0, 1.0, 7.0, 120.0, 5e4, 1e7], np.float32)
    counts = rng.choice(spread, size=P).astype(np.float32)
    counts[0] = 0.0  # a parameter without observations keeps its prior
    sums = (rng.normal(0.3, 1.0, size=P) * counts).astype(np.float32)
    sumsqs = (counts * 1.7 + sums**2 / np.maximum(counts, 1)).astype(np.float32)
    trans = rng.choice(spread, size=(K, K)).astype(np.float32)
    state = rng.choice(spread, size=K).astype(np.float32)
    return nig, (sums, sumsqs, counts, trans, state)


@pytest.mark.parametrize("K", [3, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_resample_model_matches_jax_given_its_noise(K, seed):
    """Tolerance: rtol 1e-5, the Gamma test's (the row sums of A and pi
    are taken left to right here and by XLA's reduction in JAX). Fed the
    JAX package's draws (resample_model's split into k_gamma, k_normal,
    then gamma_fixed_tries' split of k_gamma into 3: hammlet_tpu/models/
    hmm.py:146, distributions.py:77-81 and :106), the port's resample
    returns the same model at Gamma shapes from 0.5 to 1e7."""
    nig, stats = _resample_case(K, seed)
    P, n = K, 2 * K + K * K
    key = jax.random.PRNGKey(11 + seed)
    jp, tp = jhmm.HMMPriors.create(nig, K), thmm.HMMPriors.create(nig, K)
    want = jhmm.resample_model(key, jp, jhmm.SweepStats(*(jnp.asarray(a) for a in stats)))
    k_gamma, k_normal = jax.random.split(key)
    k_n, k_u, k_b = jax.random.split(k_gamma, 3)
    noise = (
        jax.random.normal(k_n, (8, n), dtype=jnp.float32),
        jax.random.uniform(k_u, (8, n), dtype=jnp.float32, minval=1e-38),
        jax.random.uniform(k_b, (n,), dtype=jnp.float32, minval=1e-38),
        jax.random.normal(k_normal, (P,)),
    )
    got = thmm.resample_model(
        None, tp, thmm.SweepStats(*(torch.from_numpy(a) for a in stats)),
        noise=tuple(to_torch(a) for a in noise),
    )
    for name in thmm.HMMState._fields:
        np.testing.assert_allclose(
            to_np(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-5, err_msg=name
        )


@pytest.mark.parametrize("case", VOTE_CASES)
@pytest.mark.parametrize("K", [3, 10])
def test_resample_votes_match_jax_on_constructed_noise(case, K, monkeypatch):
    """Tolerance: rtol 1e-5, as above. On noise built so that no try is
    accepted (the mode), only try 7 is, all are, or a NaN sits in a try
    (_torch_helpers.vote_noise), the plain resample returns JAX's
    resample_model, which draws that noise here: its normal and uniform
    draws are replaced, in the order it makes them, by the constructed
    arrays. These are the cases the kernel's first-accepted-try vote
    reproduces."""
    nig, stats = _resample_case(K, 3)
    P, n = K, 2 * K + K * K
    noise = vote_noise(case, P, n, 20 + K)
    queue = {"normal": [noise[0], noise[3]], "uniform": [noise[1], noise[2]]}

    def drawn(kind):
        def draw(key, shape, dtype=jnp.float32, **kw):
            a = queue[kind].pop(0)
            assert a.shape == tuple(shape), (kind, a.shape, shape)
            return jnp.asarray(a, dtype)
        return draw

    monkeypatch.setattr(jax.random, "normal", drawn("normal"))
    monkeypatch.setattr(jax.random, "uniform", drawn("uniform"))
    jp, tp = jhmm.HMMPriors.create(nig, K), thmm.HMMPriors.create(nig, K)
    want = jhmm.resample_model(jax.random.PRNGKey(0), jp,
                               jhmm.SweepStats(*(jnp.asarray(a) for a in stats)))
    assert not queue["normal"] and not queue["uniform"]
    got = thmm.resample_model_reference(
        tp, thmm.SweepStats(*(torch.from_numpy(a) for a in stats)),
        tuple(torch.from_numpy(a) for a in noise))
    for name in thmm.HMMState._fields:
        np.testing.assert_allclose(
            to_np(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-5, err_msg=name
        )
    if case == "none":  # every shape took its mode: var = beta' / d, with the boost below 1
        g = to_np(td.gamma_fixed_tries(None, torch.full((1,), 50.0), noise=tuple(
            torch.from_numpy(a[..., :1]) for a in noise[:3])))
        assert g[0] == np.float32(np.float32(50.0) - np.float32(1 / 3))


def test_resample_model_draws_its_noise_in_one_order():
    """Exact: without ``noise`` the resample draws, from its generator, the
    proposal normals (8, n), the acceptance uniforms (8, n), the boost
    uniforms (n,) and then the mean normals (P,), the order of the stream
    before the kernel (gamma_fixed_tries' three draws, then the normals)."""
    nig, stats = _resample_case(3, 4)
    tp = thmm.HMMPriors.create(nig, 3)
    st = thmm.SweepStats(*(torch.from_numpy(a) for a in stats))
    n = 3 + 9 + 3
    gen = torch.Generator().manual_seed(9)
    drawn = (torch.randn((8, n), generator=gen), torch.rand((8, n), generator=gen),
             torch.rand((n,), generator=gen), torch.randn((3,), generator=gen))
    got = thmm.resample_model(torch.Generator().manual_seed(9), tp, st)
    want = thmm.resample_model(None, tp, st, noise=drawn)
    for a, b in zip(got, want):
        assert_ulp(a, b, max_ulp=0)


def test_resample_rows_sum_left_to_right():
    """Exact: the plain resample normalises each row of A and pi by its sum
    taken left to right over the K columns (one add per column, the order
    the kernel repeats), and draws the Gammas with gamma_fixed_tries."""
    nig, stats = _resample_case(10, 2)
    tp = thmm.HMMPriors.create(nig, 10)
    st = thmm.SweepStats(*(torch.from_numpy(a) for a in stats))
    n = 10 + 100 + 10
    gen = torch.Generator().manual_seed(3)
    noise = (torch.randn((8, n), generator=gen), torch.rand((8, n), generator=gen),
             torch.rand((n,), generator=gen), torch.randn((10,), generator=gen))
    got = thmm.resample_model_reference(tp, st, noise)
    post = td.nig_update(tp.nig, *st[:3])
    alphas = torch.cat([post[:, 0], (tp.a_alphas + st.trans_counts).reshape(-1),
                        tp.pi_alphas + st.state_counts])
    g = to_np(td.gamma_fixed_tries(None, alphas, noise=noise[:3]))
    rows = g[10:110].reshape(10, 10)
    total = rows[:, 0].copy()
    for j in range(1, 10):
        total = (total + rows[:, j]).astype(np.float32)
    assert_ulp(got.A, rows / total[:, None], max_ulp=0)
    pis, s = g[110:], g[110]
    for j in range(1, 10):
        s = np.float32(s + pis[j])
    assert_ulp(got.pi, pis / s, max_ulp=0)


def test_nan_statistics_propagate_through_the_resample():
    """A NaN theta sum poisons that parameter's mean and variance (and a
    NaN transition count its row of A), as in the JAX package, which the
    debug bitmask relies on; a NaN count keeps the prior (counts > 0 is
    false), as there."""
    nig, stats = _resample_case(3, 5)
    sums, sumsqs, counts, trans, state = (a.copy() for a in stats)
    counts[1] = 40.0
    sums[1] = np.nan
    trans[2, 0] = np.nan
    counts[2] = np.nan
    tp = thmm.HMMPriors.create(nig, 3)
    got = thmm.resample_model(torch.Generator().manual_seed(1), tp, thmm.SweepStats(
        *(torch.from_numpy(a) for a in (sums, sumsqs, counts, trans, state))))
    mean, var, A = to_np(got.theta_mean), to_np(got.theta_var), to_np(got.A)
    assert np.isnan(mean[1]) and np.isnan(var[1])
    assert np.isfinite(var[2]) and var[2] > 0  # NaN count: the prior
    assert np.isnan(A[2]).all() and np.isfinite(A[:2]).all()


class _CardTensor:
    """Stands in for a CUDA tensor on a machine without one: what the
    dispatch and the wrappers read before they reach the kernel library."""

    device = torch.device("cuda", 0)
    is_cuda = True

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def contiguous(self):
        return self


def _card_inputs(K=3, P=3, B=64, R=2):
    """Fake card tensors for one statistics call and one resample call."""
    i64 = torch.int64
    stats_args = (_CardTensor((R, B), i64), _CardTensor((R, B), i64), _CardTensor((R,), i64),
                  _CardTensor((1, 2, R, B)), _CardTensor((K, 1), i64))
    n = P + K * K + K
    priors = thmm.HMMPriors(_CardTensor((P, 4)), _CardTensor((K, K)), _CardTensor((K,)))
    stats = thmm.SweepStats(_CardTensor((P,)), _CardTensor((P,)), _CardTensor((P,)),
                            _CardTensor((K, K)), _CardTensor((K,)))
    noise = (_CardTensor((8, n)), _CardTensor((8, n)), _CardTensor((n,)), _CardTensor((P,)))
    return stats_args, priors, stats, noise


def test_cpu_tensors_never_reach_the_model_kernels(monkeypatch):
    """CPU tensors take the plain versions: the kernel library is never
    loaded and no wrapper counts a launch."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep as tsw

    def no_library():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(model_cuda, "_library", no_library)
    counters = (model_cuda.sweep_stats_cuda, model_cuda.resample_model_cuda)
    before = [f.launches for f in counters]
    nig, stats = _resample_case(3, 0)
    st = tsw.accumulate_sweep_stats(
        torch.zeros(16, dtype=torch.int64), torch.ones(16, dtype=torch.int64), torch.tensor(9),
        torch.ones((1, 2, 16)), torch.arange(3).reshape(3, 1), 3,
    )
    assert float(st.state_counts.sum()) == 9.0
    thmm.resample_model(torch.Generator().manual_seed(0), thmm.HMMPriors.create(nig, 3),
                        thmm.SweepStats(*(torch.from_numpy(a) for a in stats)))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("kind", ["stats", "resample"])
def test_card_tensors_without_library_raise(kind, monkeypatch, tmp_path):
    """Card tensors go to the kernels or raise: with no nvcc to build the
    library the call raises, and the plain version is never run."""
    from hammlet_tpu_torch import _build
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep as tsw

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(model_cuda, "_lib", None)

    def fell_back(*_):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(tsw, "sweep_stats_reference", fell_back)
    monkeypatch.setattr(thmm, "resample_model_reference", fell_back)
    stats_args, priors, stats, noise = _card_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if kind == "stats":
            tsw.accumulate_sweep_stats(*stats_args, 3)
        else:
            thmm.resample_model(None, priors, stats, noise=noise)


def test_model_update_refuses_other_devices_and_types():
    """Any device but the card and the CPU raises; the wrappers refuse host
    tensors and the wrong dtype or shape."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep as tsw

    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsw.accumulate_sweep_stats(
            torch.zeros((2, 8), dtype=torch.int64, **meta), torch.zeros((2, 8), dtype=torch.int64, **meta),
            torch.zeros(2, dtype=torch.int64, **meta), torch.zeros((1, 2, 2, 8), **meta),
            torch.zeros((3, 1), dtype=torch.int64, **meta), 3,
        )
    nig, stats = _resample_case(3, 0)
    to_meta = lambda a: torch.from_numpy(a).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        thmm.resample_model(
            None, thmm.HMMPriors(to_meta(nig), torch.zeros((3, 3), **meta), torch.zeros(3, **meta)),
            thmm.SweepStats(*(to_meta(a) for a in stats)),
            noise=(torch.zeros((8, 15), **meta), torch.zeros((8, 15), **meta),
                   torch.zeros(15, **meta), torch.zeros(3, **meta)),
        )
    i64 = torch.int64
    with pytest.raises(ValueError, match="CUDA tensors"):
        model_cuda.sweep_stats_cuda(torch.zeros((1, 8), dtype=i64), torch.zeros((1, 8), dtype=i64),
                                    torch.zeros(1, dtype=i64), torch.zeros((1, 2, 1, 8)),
                                    torch.zeros((3, 1), dtype=i64), 3)
    stats_args, priors, stats, noise = _card_inputs()
    with pytest.raises(ValueError, match="int64"):
        model_cuda.sweep_stats_cuda(_CardTensor((2, 64), torch.int32), *stats_args[1:], 3)
    with pytest.raises(ValueError, match="proposal normals"):
        model_cuda.resample_model_cuda(priors, stats, (_CardTensor((7, 15)),) + noise[1:])
