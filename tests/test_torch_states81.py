"""Four tracks at once, three emission parameters per track, K = 3^4 = 81
states (-s C 3 4), at a small T through both packages on the CPU: the path
of chip_smoke.py's [states81] phase (chip_smoke.states81_steps: the 81
means (a, b, c, d), a, b, c, d in {-3, 0, 3}, segments of 800, seed 8),
whose FB prefix scan takes the K > 64 tiled-product instances with j
streamed of csrc/fbscan.cu on a card, its suffix the grouped form, its
model update the statistics kernel with the pair terms in slices (here
their plain versions). The JAX engine's state is carried into the port
with convert.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_bitwise, cpu_requested, to_np, to_torch  # noqa: F401
from chip_smoke import map_agreement, states81_steps
from hammlet_tpu import runner as jrun
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import forward_backward as jfb
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import convert, runner
from hammlet_tpu_torch.models import distributions as td
from hammlet_tpu_torch.ops import blocks as tb
from hammlet_tpu_torch.samplers import forward_backward as tfb
from hammlet_tpu_torch.samplers import sweep as tsw

torch.set_num_threads(1)

T = 12_000  # x 4 tracks: 15 segments of 800
K = 81
# a grouped capacity (4 groups of 128 blocks; the plain versions' K^3 products take ~5 s per
# prefix scan at 512 on one CPU thread)
CAP = 512


@pytest.fixture(scope="module")
def engines():
    """The data, a JAX engine after M 6 0 (its model and threshold are the
    inputs below), and the port's engine on the same data (its ingest)."""
    data, truth = states81_steps(T)
    je = jrun.make_engine(data, nr_params=3, nr_data_dim=4, seed=8)
    je.run("M", 6, 0)
    te = runner.make_engine(data, nr_params=3, nr_data_dim=4, seed=8, device="cpu")
    assert je.spec.nr_states == te.spec.nr_states == K
    return data, truth, je, te


def _blocks(je, te, thr):
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, CAP)
    tpos, trank = tb.bucket_candidates(te.ing.ranked, CAP)
    want = jb.make_blocks_bucketed(jpos, jrank, je.ing.ranked, jnp.float32(thr))
    got = tb.make_blocks_bucketed(tpos, trank, te.ing.ranked, torch.tensor(np.float32(thr)))
    return want, got


def _thresholds(je):
    """Thresholds whose block counts fit CAP: quantiles of the finite
    breakpoint weights (the top 3 %, 2 % and 0.5 % of T's ~12,000)."""
    w = -np.asarray(je.ing.ranked.neg_w_sorted)
    w = w[np.isfinite(w)]
    return [np.float32(np.quantile(w, q)) for q in (0.97, 0.98, 0.995)]


def test_states81_blocks_and_stats_bitwise(engines):
    """Exact: the two packages' host ingest of the four tracks (the weight
    ranking and the prefix statistics), and at three thresholds the block
    boundaries of make_blocks_bucketed and the (dim, 2, B) statistics of
    block_sufficient_stats_t."""
    _, _, je, te = engines
    assert_bitwise(te.ing.ranked.neg_w_sorted, je.ing.ranked.neg_w_sorted)
    np.testing.assert_array_equal(to_np(te.ing.ranked.pos_by_rank), to_np(je.ing.ranked.pos_by_rank))
    for f in ("r_t", "q2_hi", "q2_lo"):
        assert_bitwise(getattr(te.ing.prefix, f), getattr(je.ing.prefix, f))
    for thr in _thresholds(je):
        want, got = _blocks(je, te, thr)
        assert 1 < int(got.n_blocks) == int(want.n_blocks) <= CAP
        for f in ("starts", "ends", "sizes"):
            np.testing.assert_array_equal(to_np(getattr(got, f)), to_np(getattr(want, f)))
        assert_bitwise(tb.block_sufficient_stats_t(te.ing.prefix, got, te.ing.cell_bits),
                       jb.block_sufficient_stats_t(je.ing.prefix, want, je.ing.cell_bits))


def test_states81_emissions_and_forward_columns_within_rtol(engines):
    """The JAX engine's model after M 6 0 (convert.hmm_state), the blocks
    of the middle threshold: emission log-weights within rtol 1e-5, atol
    1e-4 (test_torch_models.py's: log and matmul orders differ), and the
    forward columns of the grouped prefix scan at B = CAP (81 x 81 matrices)
    within rtol 1e-5, atol 1e-30 (test_torch_fbscan.py's), with
    self-transitions on and off."""
    _, _, je, te = engines
    want_b, _ = _blocks(je, te, _thresholds(je)[1])
    n = int(want_b.n_blocks)
    stats_j = jb.block_sufficient_stats_t(je.ing.prefix, want_b, je.ing.cell_bits)
    model = convert.hmm_state(je.model)
    mapping = je.spec.mapping().astype(np.int32)
    want_e = jd.emission_log_weights_t(stats_j, want_b.sizes, je.model.theta_mean,
                                       je.model.theta_var, jnp.asarray(mapping))
    got_e = td.emission_log_weights_t(to_torch(stats_j), to_torch(want_b.sizes), model.theta_mean,
                                      model.theta_var, torch.from_numpy(mapping.astype(np.int64)))
    assert got_e.shape == (K, CAP)
    np.testing.assert_allclose(to_np(got_e)[:, :n], np.asarray(want_e)[:, :n], rtol=1e-5, atol=1e-4)
    for use_self in (True, False):
        want_cols, want_last = jfb.forward_columns_t(
            want_e, want_b.sizes, jnp.int32(n), je.model.A, je.model.pi, use_self)
        got_cols, got_last = tfb.forward_columns_t(
            to_torch(want_e), to_torch(want_b.sizes), torch.tensor(n), model.A, model.pi, use_self)
        np.testing.assert_allclose(to_np(got_cols)[:, :n], np.asarray(want_cols)[:, :n],
                                   rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(to_np(got_last), np.asarray(want_last), rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("method", ["F", "M"])
def test_states81_sweep_given_jax_noise(engines, method):
    """Exact: one gibbs_sweep of the port at K = 81, dim 4, capacity CAP
    (the grouped scans), from the JAX engine's model, priors and ingest
    (convert.py), fed the Gumbels the JAX sweep draws from its key
    (sweep.py:261, forward_backward.py:237-245), samples the JAX sweep's
    states with the same block sizes, count and threshold, and records the
    same buffers. The model update draws from another stream and is not
    compared. On a card the same sweep's prefix scan is the K = 81 tiled
    product with j streamed (chip_smoke.py [states81])."""
    _, _, je, _ = engines
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, CAP)
    key = jax.random.PRNGKey(29)
    mapping = je.spec.mapping().astype(np.int32)
    _, jbuf, out = jsw.gibbs_sweep(
        key, je.model, je.priors, je.ing.ranked, jpos, jrank, je.ing.prefix,
        jsw.RecordBuffers.create(T, K), jnp.bool_(True), jnp.bool_(True),
        jnp.float32(0.0), method=method, capacity=CAP, spec_nr_params=3,
        mapping_tuple=tuple(map(tuple, mapping.tolist())), use_self_transitions=True,
    )
    k_states, _ = jax.random.split(key)
    if method == "M":
        noise = to_torch(jax.random.gumbel(k_states, (K, CAP), dtype=jnp.float32))
    else:
        k_last, k_maps = jax.random.split(k_states)
        noise = (to_torch(jax.random.gumbel(k_last, (1, K), dtype=jnp.float32)),
                 to_torch(jax.random.gumbel(k_maps, (K, K, CAP), dtype=jnp.float32)))
    tpos, trank = convert.candidates(jpos, jrank)
    tbuf = tsw.RecordBuffers.create(T, K)
    _, buf, got = tsw.gibbs_sweep(
        torch.Generator().manual_seed(0), convert.hmm_state(je.model), convert.hmm_priors(je.priors),
        convert.ranked_weights(je.ing.ranked), tpos, trank, convert.prefix_stats(je.ing.prefix),
        tbuf, method=method, nr_params=3, mapping=torch.from_numpy(mapping.astype(np.int64)),
        noise=noise,
    )
    n = int(out.n_blocks)
    assert int(got.n_blocks) == n and 10 < n <= CAP
    assert len(np.unique(np.asarray(out.states)[:n])) > 3  # more than one track's worth of states
    np.testing.assert_array_equal(to_np(got.states)[:n], np.asarray(out.states)[:n])
    np.testing.assert_array_equal(to_np(got.sizes), np.asarray(out.sizes))
    assert float(got.threshold) == float(out.threshold)
    np.testing.assert_array_equal(to_np(buf.counts), np.asarray(jbuf.counts))
    np.testing.assert_array_equal(to_np(buf.ever_boundary), np.asarray(jbuf.ever_boundary))


def test_states81_engine_map_agreement_from_jax_burn_in():
    """Statistical: at T the JAX engine after the card's burn-in (M 64 0)
    runs F 16 4, and the port's engine on the CPU, given the JAX engine's
    burn-in model (convert.hmm_state), runs its own F 16 4; both at engine
    seed 0, their marginal rows counting the 4 recorded sweeps. The port
    must come within 0.02 of the JAX engine's own MAP agreement
    (chip_smoke.map_agreement, linear_sum_assignment over the 81 labels;
    both reached 1.0 when this test was written). The card's [states81]
    holds the port to MAP_AGREEMENT_MIN at T = 4M."""
    data, truth = states81_steps(T)
    je = jrun.make_engine(data, nr_params=3, nr_data_dim=4, seed=0)
    je.run("M", 64, 0)
    te = runner.make_engine(data, nr_params=3, nr_data_dim=4, seed=0, device="cpu")
    te.model = convert.hmm_state(je.model)
    je.run("F", 16, 4)
    te.run("F", 16, 4)
    agreement = []
    for starts, counts in (jrun.compact_marginals(je.buffers),
                           runner.compact_marginals(te.buffers)):
        starts, counts = to_np(starts), to_np(counts)
        sizes = np.diff(np.append(starts, T))
        assert counts.shape[1] == K and set(counts.sum(axis=1).tolist()) == {4}
        agreement.append(map_agreement(sizes, counts, truth))
    assert agreement[1] >= agreement[0] - 0.02, agreement
