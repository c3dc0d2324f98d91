"""Four tracks at once, five emission parameters per track, K = 5^4 = 625
states (-s C 5 4), at a small T through both packages on the CPU: the path
of chip_smoke.py's [states625] phase (chip_smoke.states625_steps: the 625
means (a, b, c, d), a, b, c, d in {-6, -3, 0, 3, 6}, segments of 800, seed
9), whose FB prefix scan takes the tiled kernel with j streamed of
csrc/fbscan.cu on a card, its transposes taking each row of matrices in
pieces (here the plain versions). The JAX engine's state is carried into
the port with convert.py. The plain versions' K^3 combines take ~1 s
each on one thread at K = 625 and B = 8, so the blocks fit a flat
capacity of 8. T is 4,097 and not 4,000: the wavelets whose support
leaves [0, T) give infinite weights, which cut blocks at every threshold,
11 of them at T = 4,000 and 2 at 4,097."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_bitwise, cpu_requested, to_np, to_torch  # noqa: F401
from chip_smoke import STATES625_K, states625_steps
from hammlet_tpu import runner as jrun
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import forward_backward as jfb
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import convert, runner
from hammlet_tpu_torch.ops import blocks as tb
from hammlet_tpu_torch.samplers import forward_backward as tfb
from hammlet_tpu_torch.samplers import sweep as tsw

torch.set_num_threads(1)

T = 4_097  # x 4 tracks: 5 segments of 800 and one of 97
K = STATES625_K
LEVELS = (-6.0, -3.0, 0.0, 3.0, 6.0)  # every track's, in STATES625_MEANS
CAP = 8  # flat: the plain scans' K^3 combines at B <= 8


@pytest.fixture(scope="module")
def engines():
    """The data, a JAX engine on it (its model, set as a burn-in leaves it,
    its priors and ingest are the inputs below), the port's engine on the same data, and the thresholds
    (halfway between consecutive distinct breakpoint weights, from the
    largest) whose blocks fit CAP, each with its block count."""
    data, truth = states625_steps(T)
    je = jrun.make_engine(data, nr_params=5, nr_data_dim=4, seed=9)
    # a model as a burn-in leaves it: the data's levels and noise, self-transitions of 0.999
    # (segments of 800). The prior draw's (variances of 0.04-0.13, self-transitions down to
    # 1e-5) scales every column but the last to 0 (forward_backward.py:219-223), whose floor
    # of 1e-38 XLA flushes to zero on the CPU and torch keeps (ROADMAP, "Not faults")
    off = np.float32(1e-3 / (K - 1))
    A = np.full((K, K), off, np.float32)
    np.fill_diagonal(A, np.float32(0.999))
    je.model = je.model._replace(theta_mean=jnp.asarray(LEVELS, jnp.float32),
                                 theta_var=jnp.ones(5, jnp.float32), A=jnp.asarray(A))
    te = runner.make_engine(data, nr_params=5, nr_data_dim=4, seed=9, device="cpu")
    assert je.spec.nr_states == te.spec.nr_states == K
    w = -np.asarray(je.ing.ranked.neg_w_sorted)
    u = np.unique(w[np.isfinite(w)])[::-1]
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, CAP)
    fits = []
    for hi, lo in zip(u[:-1], u[1:]):
        thr = np.float32((hi + lo) / 2)
        n = int(jb.make_blocks_bucketed(jpos, jrank, je.ing.ranked, jnp.float32(thr)).n_blocks)
        if n > CAP:
            break
        fits.append((thr, n))
    assert len(fits) >= 3 and fits[-1][1] >= 6
    return data, truth, je, te, fits


def _blocks(je, te, thr):
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, CAP)
    tpos, trank = tb.bucket_candidates(te.ing.ranked, CAP)
    want = jb.make_blocks_bucketed(jpos, jrank, je.ing.ranked, jnp.float32(thr))
    got = tb.make_blocks_bucketed(tpos, trank, te.ing.ranked, torch.tensor(np.float32(thr)))
    return want, got


def test_states625_blocks_and_stats_bitwise(engines):
    """Exact: the two packages' host ingest of the four tracks (the weight
    ranking and the prefix statistics), and at the last three thresholds
    whose blocks fit CAP the block boundaries of make_blocks_bucketed and
    the (dim, 2, B) statistics of block_sufficient_stats_t."""
    _, _, je, te, fits = engines
    assert_bitwise(te.ing.ranked.neg_w_sorted, je.ing.ranked.neg_w_sorted)
    np.testing.assert_array_equal(to_np(te.ing.ranked.pos_by_rank), to_np(je.ing.ranked.pos_by_rank))
    for f in ("r_t", "q2_hi", "q2_lo"):
        assert_bitwise(getattr(te.ing.prefix, f), getattr(je.ing.prefix, f))
    for thr, n in fits[-3:]:
        want, got = _blocks(je, te, thr)
        assert int(got.n_blocks) == int(want.n_blocks) == n
        for f in ("starts", "ends", "sizes"):
            np.testing.assert_array_equal(to_np(getattr(got, f)), to_np(getattr(want, f)))
        assert_bitwise(tb.block_sufficient_stats_t(te.ing.prefix, got, te.ing.cell_bits),
                       jb.block_sufficient_stats_t(je.ing.prefix, want, je.ing.cell_bits))


@pytest.fixture
def flushing():
    """The port's CPU arithmetic flushing subnormals to zero, as XLA's CPU
    backend runs the JAX package (torch.set_flush_denormal; cli_map_survey.py
    does the same). At K = 625 a block that straddles two segments gives
    emission weights between e^-87 and e^-103, subnormal in float32, and a
    combine's rescaling lifts what they add to ~1e-27, above the atol of
    1e-30 that absorbs them at K <= 243."""
    if not torch.set_flush_denormal(True):
        pytest.fail("this CPU cannot flush subnormals to zero")
    yield
    torch.set_flush_denormal(False)


def test_states625_sweep_given_jax_noise(engines, flushing, monkeypatch):
    """One F sweep at K = 625, dim 4, capacity CAP, at the last threshold
    whose blocks fit it (static), from the JAX engine's model, priors and
    ingest (convert.py), both packages flushing subnormals (``flushing``).
    The port's sweep's emission log-weights are within rtol 1e-5, atol
    1e-4 of the JAX package's (test_torch_models.py's: log and matmul
    orders differ), the forward columns it takes of them within rtol 1e-5,
    atol 1e-30 (test_torch_fbscan.py's) of the JAX package's on the same
    emissions, and the port's gibbs_sweep, fed the Gumbels the JAX sweep draws from its key
    (sweep.py:261, forward_backward.py:237-245), samples the JAX sweep's
    states exactly, with the same block sizes and count, and records the
    same buffers. The model update draws from another stream and is not
    compared. On a card the same sweep's prefix scan is the tiled kernel
    with j streamed (chip_smoke.py [states625]), which keeps subnormals as
    the plain version does."""
    _, _, je, _, fits = engines
    thr, n = fits[-1]
    model = convert.hmm_state(je.model)
    mapping = je.spec.mapping().astype(np.int32)
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, CAP)
    want_b = jb.make_blocks_bucketed(jpos, jrank, je.ing.ranked, jnp.float32(thr))
    stats_j = jb.block_sufficient_stats_t(je.ing.prefix, want_b, je.ing.cell_bits)
    want_e = jd.emission_log_weights_t(stats_j, want_b.sizes, je.model.theta_mean,
                                       je.model.theta_var, jnp.asarray(mapping))
    taken = []  # the sweep's own forward columns (the plain K^3 scan runs once)
    real = tfb.forward_columns_t

    def keep(log_e_t, *args):
        taken.append((log_e_t, real(log_e_t, *args)))
        return taken[-1][1]

    monkeypatch.setattr(tfb, "forward_columns_t", keep)
    key = jax.random.PRNGKey(29)
    _, jbuf, out = jsw.gibbs_sweep(
        key, je.model, je.priors, je.ing.ranked, jpos, jrank, je.ing.prefix,
        jsw.RecordBuffers.create(T, K), jnp.bool_(True), jnp.bool_(False), jnp.float32(thr),
        method="F", capacity=CAP, spec_nr_params=5,
        mapping_tuple=tuple(map(tuple, mapping.tolist())), use_self_transitions=True,
    )
    k_last, k_maps = jax.random.split(jax.random.split(key)[0])
    noise = (to_torch(jax.random.gumbel(k_last, (1, K), dtype=jnp.float32)),
             to_torch(jax.random.gumbel(k_maps, (K, K, CAP), dtype=jnp.float32)))
    tpos, trank = convert.candidates(jpos, jrank)
    _, buf, got = tsw.gibbs_sweep(
        torch.Generator().manual_seed(0), model, convert.hmm_priors(je.priors),
        convert.ranked_weights(je.ing.ranked), tpos, trank, convert.prefix_stats(je.ing.prefix),
        tsw.RecordBuffers.create(T, K), float(thr), method="F", nr_params=5,
        mapping=torch.from_numpy(mapping.astype(np.int64)), noise=noise,
    )
    assert int(got.n_blocks) == int(out.n_blocks) == n and len(taken) == 1
    (log_e_t, (got_cols, got_last)), = taken
    np.testing.assert_allclose(to_np(log_e_t)[:, :n], np.asarray(want_e)[:, :n], rtol=1e-5, atol=1e-4)
    want_cols, want_last = jax.jit(jfb.forward_columns_t, static_argnames="use_self_transitions")(
        jnp.asarray(to_np(log_e_t)), want_b.sizes, jnp.int32(n), je.model.A, je.model.pi,
        use_self_transitions=True)
    assert got_cols.shape == (K, CAP)
    np.testing.assert_allclose(to_np(got_cols)[:, :n], np.asarray(want_cols)[:, :n],
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(to_np(got_last), np.asarray(want_last), rtol=1e-5, atol=1e-30)
    np.testing.assert_array_equal(to_np(got.states)[:n], np.asarray(out.states)[:n])
    np.testing.assert_array_equal(to_np(got.sizes), np.asarray(out.sizes))
    assert float(got.threshold) == float(out.threshold)
    np.testing.assert_array_equal(to_np(buf.counts), np.asarray(jbuf.counts))
    np.testing.assert_array_equal(to_np(buf.ever_boundary), np.asarray(jbuf.ever_boundary))
