"""The port's FB-Gibbs, mixture and sweep-statistics/recording code against
the JAX package (hammlet_tpu/samplers/) and the golden sequential model."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import to_np, to_torch, toy_problem
from hammlet_tpu.golden import reference as gold
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import forward_backward as jfb
from hammlet_tpu.samplers import mixture as jmix
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import convert
from hammlet_tpu_torch.ops import blocks as tb
from hammlet_tpu_torch.samplers import forward_backward as tfb
from hammlet_tpu_torch.samplers import mixture as tmix
from hammlet_tpu_torch.samplers import sweep as tsw

torch.set_num_threads(1)


def _log_e(p):
    return jd.emission_log_weights_t(
        jnp.asarray(p["stats_t"]), jnp.asarray(p["sizes"]),
        jnp.asarray(p["theta_mean"]), jnp.asarray(p["theta_var"]),
        jnp.asarray(p["mapping"]),
    )


@pytest.mark.parametrize("use_self", [True, False])
@pytest.mark.parametrize("B,pad", [(12, 5), (700, 324)])
def test_forward_columns_within_rtol(use_self, B, pad):
    """Tolerance: rtol 1e-5, atol 1e-30. At B + pad = 1024 the JAX package
    takes its grouped two-level scan and the port the flat Hillis-Steele
    scan: the products are rescaled in another order. XLA on the CPU
    flushes subnormal floats to zero and torch keeps them (3e-44 vs 0 seen
    here), hence the absolute floor."""
    p = toy_problem(B=B, seed=11, pad=pad)
    log_e = _log_e(p)
    want_cols, want_last = jfb.forward_columns_t(
        log_e, jnp.asarray(p["sizes"]), jnp.int32(B),
        jnp.asarray(p["A"]), jnp.asarray(p["pi"]), use_self,
    )
    got_cols, got_last = tfb.forward_columns_t(
        to_torch(log_e), to_torch(p["sizes"]), torch.tensor(B),
        to_torch(p["A"]), to_torch(p["pi"]), use_self,
    )
    np.testing.assert_allclose(to_np(got_cols)[:, :B], np.asarray(want_cols)[:, :B], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(to_np(got_last), np.asarray(want_last), rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("B,n_blocks", [(17, 12), (1024, 700)])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_sample_exact_given_jax_noise(B, n_blocks, seed):
    """Tolerance: exact. Fed the JAX forward columns and the JAX draws (its
    key splits, forward_backward.py:237-245), the port samples the same
    path."""
    p = toy_problem(B=n_blocks, seed=seed + 3, pad=B - n_blocks)
    cols, last = jfb.forward_columns_t(
        _log_e(p), jnp.asarray(p["sizes"]), jnp.int32(n_blocks),
        jnp.asarray(p["A"]), jnp.asarray(p["pi"]), True,
    )
    key = jax.random.PRNGKey(100 + seed)
    want = jfb.backward_sample_t(key, cols, last, jnp.int32(n_blocks), jnp.asarray(p["A"]))
    k_last, k_maps = jax.random.split(key)
    g_last = jax.random.gumbel(k_last, (1, 3), dtype=jnp.float32)  # categorical's
    g_maps = jax.random.gumbel(k_maps, (3, 3, B), dtype=jnp.float32)
    got = tfb.backward_sample_t(
        None, to_torch(cols), to_torch(last), torch.tensor(n_blocks),
        to_torch(p["A"]), noise=(to_torch(g_last), to_torch(g_maps)),
    )
    np.testing.assert_array_equal(to_np(got)[:n_blocks], np.asarray(want)[:n_blocks])


@pytest.mark.parametrize("B", [8, 256, 1024])
def test_scans_match_jax(B):
    """Map suffix composition: exact. Prefix products: rtol 1e-5."""
    rng = np.random.default_rng(B)
    maps = rng.integers(0, 3, size=(3, B)).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))),
        np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps))),
    )
    M = rng.uniform(0.1, 1.0, size=(3, 3, B)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


def test_mixture_exact_given_jax_log_weights_and_noise():
    """Tolerance: exact. Fed the JAX log-weights and the JAX Gumbels
    (mixture.py:32), the port draws the same states."""
    p = toy_problem(B=40, seed=9, pad=8)
    key = jax.random.PRNGKey(5)
    want = jmix.mixture_sample_states(
        key, jnp.asarray(p["stats_t"]), jnp.asarray(p["sizes"]), jnp.int32(40),
        jnp.asarray(p["theta_mean"]), jnp.asarray(p["theta_var"]), jnp.asarray(p["mapping"]),
    )
    g = jax.random.gumbel(key, (3, 48), dtype=jnp.float32)
    got = tmix.categorical_states(to_torch(_log_e(p)), torch.tensor(40), noise=to_torch(g))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_fb_sampler_distribution_matches_golden():
    """Statistical (tests/test_samplers.py:102): per-block state frequencies
    of the port's sampler match the sequential golden sampler within
    Monte-Carlo error."""
    p = toy_problem(B=10, K=3, seed=5)
    n_draws = 3000
    gen = torch.Generator().manual_seed(42)
    args = [to_torch(p[k]) for k in ("stats_t", "sizes")] + [torch.tensor(p["B"])] + [
        to_torch(p[k]) for k in ("theta_mean", "theta_var", "A", "pi")
    ] + [to_torch(p["mapping"], torch.int64)]
    ours = np.stack([
        to_np(tfb.fb_sample_states(gen, *args, True))[: p["B"]] for _ in range(n_draws)
    ])
    rng = np.random.default_rng(7)
    theirs = np.stack([
        gold.fb_gibbs_sweep(
            p["sums"], p["sumsqs"], p["N"], p["theta_mean"], p["theta_var"],
            p["A"], p["pi"], p["mapping"], rng, True,
        )
        for _ in range(n_draws)
    ])
    for b in range(p["B"]):
        f_ours = np.bincount(ours[:, b], minlength=3) / n_draws
        f_theirs = np.bincount(theirs[:, b], minlength=3) / n_draws
        se = np.sqrt(np.maximum(f_theirs * (1 - f_theirs), 1e-4) / n_draws)
        assert np.all(np.abs(f_ours - f_theirs) < 6 * se + 0.01), (b, f_ours, f_theirs)


def test_mixture_sampler_frequencies():
    """Statistical (tests/test_samplers.py:137): softmax frequencies."""
    p = toy_problem(B=6, K=3, seed=9)
    log_e = np.asarray(_log_e(p)).T[: p["B"]]
    probs = np.exp(log_e - log_e.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    n_draws = 4000
    gen = torch.Generator().manual_seed(1)
    log_e_t = to_torch(_log_e(p)).repeat(1, n_draws)  # n_draws copies, one call
    draws = to_np(tmix.categorical_states(log_e_t, torch.tensor(log_e_t.shape[1]), gen))
    draws = draws.reshape(n_draws, -1)[:, : p["B"]]
    for b in range(p["B"]):
        f = np.bincount(draws[:, b], minlength=3) / n_draws
        se = np.sqrt(np.maximum(probs[b] * (1 - probs[b]), 1e-4) / n_draws)
        assert np.all(np.abs(f - probs[b]) < 6 * se + 0.01), (b, f, probs[b])


@pytest.mark.parametrize("integer_stats", [True, False])
def test_accumulate_sweep_stats_matches_jax(integer_stats):
    """Tolerance: exact for counts and transitions, and for the theta sums
    when the block stats are integer-valued (any summation order is then
    exact); rtol 1e-6 for float stats (matmul orders differ)."""
    p = toy_problem(B=30, K=3, seed=13, pad=10)
    stats_t = np.round(p["stats_t"]) if integer_stats else p["stats_t"]
    states = np.random.default_rng(0).integers(0, 3, size=40).astype(np.int32)
    want = jsw.accumulate_sweep_stats(
        jnp.asarray(states), jnp.asarray(p["sizes"]), jnp.int32(30),
        jnp.asarray(stats_t), jnp.asarray(p["mapping"]), 3,
    )
    got = tsw.accumulate_sweep_stats(
        to_torch(states, torch.int64), to_torch(p["sizes"]), torch.tensor(30),
        to_torch(stats_t), to_torch(p["mapping"], torch.int64), 3,
    )
    for f in ("state_counts", "trans_counts", "theta_counts"):
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))
    for f in ("theta_sums", "theta_sumsqs"):
        if integer_stats:
            np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))
        else:
            np.testing.assert_allclose(to_np(getattr(got, f)), np.asarray(getattr(want, f)), rtol=1e-6)


def test_record_sweep_exact():
    """Tolerance: exact. A sequence of recorded sweeps (including a disabled
    one and padded blocks) leaves the same flat counts, boundary union and
    counters in both packages; the port updates in place."""
    T, K, capacity = 2000, 3, 256
    w = np.random.default_rng(1).exponential(1.0, size=T).astype(np.float32)
    w[0] = np.inf
    jr, tr = jb.build_ranked_weights(w), tb.build_ranked_weights(w)
    jpos, jrank = jb.bucket_candidates(jr, capacity)
    tpos, trank = convert.candidates(jpos, jrank)
    jbuf = jsw.RecordBuffers.create(T, K)
    tbuf = tsw.RecordBuffers.create(T, K)
    rng = np.random.default_rng(2)
    for i, thr in enumerate([3.0, 2.5, 4.0, 3.3, 2.8]):
        jblk = jb.make_blocks_bucketed(jpos, jrank, jr, jnp.float32(thr))
        tblk = tb.make_blocks_bucketed(tpos, trank, tr, torch.tensor(np.float32(thr)))
        states = rng.integers(0, K, size=capacity).astype(np.int32)
        enabled = i != 3
        jbuf = jsw.record_sweep(jbuf, jnp.asarray(states), jblk.starts, jblk.n_blocks, enabled)
        out = tsw.record_sweep(
            tbuf, to_torch(states, torch.int64), tblk.starts, tblk.n_blocks, torch.tensor(enabled)
        )
        assert out is tbuf
    np.testing.assert_array_equal(to_np(tbuf.counts), np.asarray(jbuf.counts))
    np.testing.assert_array_equal(to_np(tbuf.ever_boundary), np.asarray(jbuf.ever_boundary))
    assert int(tbuf.n_records) == int(jbuf.n_records) == 4
    assert int(tbuf.n_boundaries) == int(jbuf.n_boundaries)
    back = convert.record_buffers(jbuf)
    np.testing.assert_array_equal(to_np(back.counts), to_np(tbuf.counts))


def test_stream_seeds_are_distinct_and_stable():
    """The per-sweep generator seeds depend on (seed, counter, index) only:
    a replay with the same counter redraws the same stream."""
    seeds = {tsw.stream_seed(s, c, i) for s in range(3) for c in range(5) for i in range(-1, 20)}
    assert len(seeds) == 3 * 5 * 21
    assert all(0 <= s < 2**63 for s in seeds)
    a = torch.rand(4, generator=tsw.make_generator(torch.device("cpu"), 7, 3, 2))
    b = torch.rand(4, generator=tsw.make_generator(torch.device("cpu"), 7, 3, 2))
    assert torch.equal(a, b)
