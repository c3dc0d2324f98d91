"""The port's FB-Gibbs, mixture and sweep-statistics/recording code against
the JAX package (hammlet_tpu/samplers/) and the golden sequential model."""

import re

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


def _np_pairwise(v: np.ndarray) -> np.float32:
    """float32 pairwise tree: zero-padded to a power of two, (2i, 2i + 1)
    added at each level."""
    width = 1
    while width < len(v):
        width *= 2
    x = np.zeros(width, np.float32)
    x[: len(v)] = v
    while len(x) > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _np_sweep_stats(states, sizes, nb, bstats, mapping, P):
    """One row's statistics in the fixed order, written out in numpy
    float32: each term's per-block values (mask * value, masked past nb),
    a pairwise tree over the blocks, then trans = pairs + diag and the
    theta statistics summed over d from 0."""
    B, (K, dim) = len(states), mapping.shape
    valid = np.arange(B) < nb
    size = sizes.astype(np.float32)
    prev = np.concatenate([[0], states[:-1]])
    f = np.float32
    state = [_np_pairwise(f(1) * ((states == k) & valid) * size) for k in range(K)]
    diag = [_np_pairwise(f(1) * ((states == k) & valid) * (size - f(1))) for k in range(K)]
    trans = np.zeros((K, K), np.float32)
    for i in range(K):
        for j in range(K):
            pair = _np_pairwise(((prev == i) & (states == j) & valid).astype(np.float32))
            trans[i, j] = pair + (diag[i] if i == j else f(0))
    theta = np.zeros((3, P), np.float32)
    for d in range(dim):
        routed = [(mapping[states, d] == p) & valid for p in range(P)]
        for q, x in enumerate((bstats[d, 0], bstats[d, 1], size)):
            for p in range(P):
                theta[q, p] = theta[q, p] + _np_pairwise(f(1) * routed[p] * x)
    return np.concatenate([theta.reshape(-1), trans.reshape(-1), np.array(state, np.float32)])


@pytest.mark.parametrize("B,n_blocks,K,dim", [
    (1, 1, 3, 1), (7, 7, 3, 1), (40, 30, 3, 1), (300, 300, 2, 1), (300, 301, 3, 1),
    (517, 260, 4, 2), (2100, 1999, 8, 3),
])
def test_sweep_stats_reference_is_the_pairwise_tree(B, n_blocks, K, dim):
    """Exact: the plain statistics (the order the kernels repeat) equal, bit
    for bit, a numpy float32 pairwise tree over each term written out here,
    on signed block statistics (so masked terms are -0.0), a masked tail,
    an overflowing count (n_blocks = B + 1) and mappings of 1-3 dims."""
    rng = np.random.default_rng(B + K)
    P = int(round(K ** (1 / dim)))
    mapping = np.array(np.unravel_index(np.arange(K), (P,) * dim)).T.astype(np.int64)
    states = rng.integers(0, K, size=B)
    sizes = rng.integers(1, 500, size=B)
    bstats = rng.normal(0, 40, size=(dim, 2, B)).astype(np.float32)
    bstats[:, 1] = np.abs(bstats[:, 1])
    want = _np_sweep_stats(states, sizes, n_blocks, bstats, mapping, P)
    got = tsw.sweep_stats_reference(
        torch.from_numpy(states)[None], torch.from_numpy(sizes)[None], torch.tensor([n_blocks]),
        torch.from_numpy(bstats)[:, :, None], torch.from_numpy(mapping), P,
    )[0]
    np.testing.assert_array_equal(to_np(got).view(np.int32), want.view(np.int32))


def test_batched_stats_equal_one_row_calls():
    """Exact: one call over S = 4 rows (the sharded engine's local shards:
    different block counts, an empty row, an overflowing one) equals four
    one-row calls byte for byte, and the unbatched API's one row."""
    S, B, K = 4, 700, 3
    rng = np.random.default_rng(8)
    states = torch.from_numpy(rng.integers(0, K, size=(S, B)))
    sizes = torch.from_numpy(rng.integers(1, 900, size=(S, B)))
    nb = torch.tensor([700, 333, 0, 701])
    bstats = torch.from_numpy(rng.normal(0, 30, size=(1, 2, S, B)).astype(np.float32))
    mapping = torch.arange(K).reshape(K, 1)
    rows = tsw.accumulate_sweep_stats(states, sizes, nb, bstats, mapping, K)
    for s in range(S):
        one = tsw.accumulate_sweep_stats(
            states[s : s + 1], sizes[s : s + 1], nb[s : s + 1], bstats[:, :, s : s + 1].clone(),
            mapping, K,
        )
        flat = tsw.accumulate_sweep_stats(states[s], sizes[s], nb[s], bstats[:, :, s], mapping, K)
        for field in tsw.SweepStats._fields:
            got = to_np(getattr(rows, field)[s]).tobytes()
            assert got == to_np(getattr(one, field)[0]).tobytes(), (s, field)
            assert got == to_np(getattr(flat, field)).tobytes(), (s, field)
    assert float(rows.state_counts[2].sum()) == 0.0


def _kernel_constants() -> dict:
    """The statistics kernel's tiling, read from csrc/modelupdate.cu so that
    the emulation below follows the source."""
    from hammlet_tpu_torch import _build

    text = (_build.CSRC_DIR / "modelupdate.cu").read_text()
    names = ("STATS_THREADS", "PER_THREAD", "TERM_GROUP", "MAX_RUNS")
    return {n: int(re.search(rf"^#define {n} (\d+)", text, re.M).group(1)) for n in names}


def _np_combine(left, right, size, Bp):
    """One level of the kernel's tree: the left node takes the sum while
    the combined node (size ``size``) is at most Bp."""
    return left + right if size <= Bp else left


def _np_kernel_stats(states, sizes, nb, bstats, mapping, P, resident):
    """The statistics kernel's decomposition in numpy float32, row by row:
    for the float terms (state, diag, theta) each thread's in-register
    levels over its PER_THREAD blocks and the cross-thread levels of a tile
    (terms in groups of TERM_GROUP); for the pair terms the tile's count
    (an integer histogram); each CTA's run of RUN tiles summed on a stack
    (the binary counter of the tile's position in the run), then the tree
    over the row's run sums, zero-padded to a power of two, and the
    assembly. RUN is the least power of two with rows x runs at most
    ``resident`` (the CTAs the card holds at once) and runs at most
    MAX_RUNS, as the host picks it."""
    c = _kernel_constants()
    threads, per, group, max_runs = (c[n] for n in ("STATS_THREADS", "PER_THREAD", "TERM_GROUP",
                                                    "MAX_RUNS"))
    tile = threads * per
    R, B = states.shape
    K, dim = mapping.shape
    f = np.float32
    Bp = 1 << max(B - 1, 0).bit_length()
    tiles = -(-B // tile)
    run_log = 0
    runs = tiles
    while (1 << run_log) < tiles and (runs > max_runs or R * runs > resident):
        run_log += 1
        runs = -(-tiles // (1 << run_log))
    RUN, runs_p = 1 << run_log, 1 << max(runs - 1, 0).bit_length()
    rows = []
    for r in range(R):
        s, size = states[r], sizes[r].astype(f)
        valid = np.arange(B) < nb[r]
        prev = np.concatenate([[0], s[:-1]])
        leaves = [f(1) * ((s == k) & valid) * size for k in range(K)]
        leaves += [f(1) * ((s == k) & valid) * (size - f(1)) for k in range(K)]
        leaves += [((prev == i) & (s == j) & valid).astype(f) for i in range(K) for j in range(K)]
        for d in range(dim):
            for q, x in enumerate((bstats[d, 0, r], bstats[d, 1, r], size)):
                leaves += [f(1) * ((mapping[s, d] == p) & valid) * x for p in range(P)]
        leaves = np.stack(leaves).astype(f)
        n_terms = leaves.shape[0]
        padded = np.zeros((n_terms, tiles * tile), f)
        padded[:, :B] = leaves
        floats = [j for j in range(n_terms) if not 2 * K <= j < 2 * K + K * K]
        tile_sums = np.zeros((n_terms, tiles), f)
        pair_leaves = padded[2 * K:2 * K + K * K].reshape(K * K, tiles, tile)
        tile_sums[2 * K:2 * K + K * K] = (pair_leaves > 0).sum(axis=2)  # exact counts
        for g0 in range(0, len(floats), group):  # the tile trees of one group of float terms
            x = padded[floats[g0:g0 + group]].reshape(-1, tiles, threads, per)
            size_l = 1
            while x.shape[-1] > 1:  # in-thread levels
                size_l *= 2
                x = _np_combine(x[..., 0::2], x[..., 1::2], size_l, Bp)
            x = x[..., 0]
            while x.shape[-1] > 1:  # cross-thread levels
                size_l *= 2
                x = _np_combine(x[..., 0::2], x[..., 1::2], size_l, Bp)
            tile_sums[floats[g0:g0 + group]] = x[..., 0]
        in_runs = np.zeros((n_terms, runs * RUN), f)
        in_runs[:, :tiles] = tile_sums
        in_runs = in_runs.reshape(n_terms, runs, RUN)
        stack = np.zeros((n_terms, runs, run_log + 1), f)
        for pos in range(RUN):  # each CTA's run, one tile after another
            node, level = in_runs[:, :, pos], 0
            cc = pos
            while cc & 1:
                node = stack[:, :, level] + node
                level += 1
                cc >>= 1
            stack[:, :, level] = node
        run_sums = np.zeros((n_terms, runs_p), f)
        run_sums[:, :runs] = stack[:, :, run_log]
        while run_sums.shape[-1] > 1:
            run_sums = run_sums[:, 0::2] + run_sums[:, 1::2]
        term = run_sums[:, 0]
        theta = np.zeros(3 * P, f)
        for d in range(dim):
            at = 2 * K + K * K + 3 * P * d
            theta = theta + term[at:at + 3 * P]
        diag = np.diag(term[K:2 * K]).astype(f)
        trans = term[2 * K:2 * K + K * K].reshape(K, K) + diag
        rows.append(np.concatenate([theta, trans.reshape(-1), term[:K]]).astype(f))
    return np.stack(rows)


@pytest.mark.parametrize("B", [1, 30, 255, 256, 257, 2049, 29_696, 100_000])
@pytest.mark.parametrize("K,dim,resident", [(3, 1, 1056), (3, 1, 7), (5, 2, 132)])
def test_kernel_decomposition_is_the_pairwise_tree(B, K, dim, resident):
    """Exact: the statistics kernel's decomposition (in-thread levels,
    cross-thread levels per term group, pair counts per tile, runs of tiles
    on a stack, the tree over run sums; tile sizes from
    csrc/modelupdate.cu) equals
    sweep_stats_reference bit for bit, on signed block statistics past a
    masked tail (-0.0 leaves), rows shorter than a tile, an overflowing
    count and an empty row (whose theta leaves are all -0.0), with RUN = 1 (a card-sized grid), long runs (a
    grid of 7 CTAs), and 22 float terms (two term groups: K = 5, dim 2)."""
    R = 3
    rng = np.random.default_rng(B + 31 * K + resident)
    P = 2 if dim > 1 else K
    mapping = rng.integers(0, P, size=(K, dim))
    states = rng.integers(0, K, size=(R, B))
    sizes = rng.integers(1, 500, size=(R, B))
    nb = np.array([B, B // 2 + 1, 0]) if B > 1 else np.array([1, 2, 0])
    bstats = rng.normal(0, 40, size=(dim, 2, R, B)).astype(np.float32)
    bstats[:, 1] = np.abs(bstats[:, 1])
    bstats[:, 0, 2] = -np.abs(bstats[:, 0, 2])  # the empty row's theta leaves: -0.0 only
    want = _np_kernel_stats(states, sizes, nb, bstats, mapping, P, resident)
    got = tsw.sweep_stats_reference(*map(torch.from_numpy, (states, sizes, nb, bstats, mapping)), P)
    if K == 5:  # the case that needs term groups
        assert 2 * K + 3 * P * dim > _kernel_constants()["TERM_GROUP"]
    np.testing.assert_array_equal(to_np(got).view(np.int32), want.view(np.int32))


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
