"""The engine's phase chunks on fixed storage (samplers/phase_graph.py).

On the CPU the sweep step that a card captures as CUDA graphs runs eagerly
on the same slots, through the same replay loop; it is held bit for bit
against the eager gibbs_phase (samplers/sweep.py), the engine and the CLI
against the engine driven by gibbs_phase, and a chunk against the JAX
package's jitted gibbs_phase (hammlet_tpu/samplers/sweep.py:310). The
card's side is tests/test_torch_cuda.py."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import eager_engine, synth_segments, to_np, cpu_requested  # noqa: F401
from hammlet_tpu import runner as jrun
from hammlet_tpu.models.hmm import HMMPriors as JHMMPriors
from hammlet_tpu.models.hmm import HMMState as JHMMState
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import cli, convert, runner
from hammlet_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.models.hmm import HMMPriors
from hammlet_tpu_torch.ops import blocks as tb
from hammlet_tpu_torch.samplers import phase_graph, sweep

torch.set_num_threads(1)

STREAMS = ["marginals", "sequences", "parameters", "blocks", "compression", "mapping", "segments"]


def assert_same(got, want) -> None:
    """Same dtype, shape and bytes (float32 bit patterns included)."""
    g, w = to_np(got), to_np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes()


def assert_same_buffers(a, b) -> None:
    for name in ("counts", "ever_boundary", "n_records", "n_boundaries"):
        assert_same(getattr(a, name), getattr(b, name))


def phase_graphs(eng) -> phase_graph.PhaseGraphs:
    return phase_graph.PhaseGraphs(phase_graph.OneDeviceSweep(
        eng.seed, eng.priors, eng.ing.ranked, eng.ing.prefix, eng._mapping,
        nr_params=eng.spec.nr_params, use_self_transitions=True, cell_bits=eng.ing.cell_bits,
    ))


@pytest.fixture(scope="module")
def base():
    """An engine after a short burn-in (its state is only read)."""
    eng = runner.make_engine(synth_segments(6000, 3, seglen=300)[0], seed=2, device="cpu")
    eng.run("M", 4, 0)
    return eng


@pytest.mark.parametrize("variant", ["plain", "blocks", "debug", "static"])
@pytest.mark.parametrize("thinning", [0, 1, 4])
@pytest.mark.parametrize("method", ["F", "M"])
def test_chunk_bitwise_vs_gibbs_phase(base, method, thinning, variant):
    """Exact: two chunks in a row through PhaseGraphs.run_chunk (the slots
    carry over) give gibbs_phase's diag, recorded rows, block stacks, model
    and buffers, byte for byte; a chunk that does not record returns no
    rows (the engine reads none)."""
    eng = base
    cand_pos, cand_rank = eng._candidates()
    static = float(eng.model.threshold(eng.T)) if variant == "static" else None
    kw = dict(method=method, thinning=thinning, record=True,
              want_blocks=variant == "blocks", debug=variant == "debug")
    pg = phase_graphs(eng)
    mine, theirs = eng.buffers.clone(), eng.buffers.clone()
    model_g = model_e = eng.model
    for counter in (7, 8):
        got = pg.run_chunk(counter, model_g, mine, cand_pos, cand_rank, static, n_iters=8, **kw)
        want = sweep.gibbs_phase(
            eng.seed, counter, model_e, eng.priors, eng.ing.ranked, cand_pos, cand_rank,
            eng.ing.prefix, theirs, static, nr_params=3, mapping=eng._mapping,
            use_self_transitions=True, n_iters=8, cell_bits=eng.ing.cell_bits, **kw,
        )
        assert_same(got[0], want[3])
        if thinning:
            for g, w in zip(got[1:4], want[4:7]):
                assert_same(g, w)
        else:
            assert [len(g) for g in got[1:4]] == [0, 0, 0]
        assert (got[4] is None) == (want[7] is None) == (variant != "blocks" or not thinning)
        if got[4] is not None:
            for g, w in zip(got[4], want[7]):
                assert_same(g, w)
        model_g, model_e = pg.model_copy(), want[0]
        for g, w in zip(model_g, model_e):
            assert_same(g, w)
        assert_same_buffers(mine, theirs)
    assert int(mine.n_records) == (16 // thinning if thinning else 0)
    if variant == "debug":
        assert int(got[0][2]) == 0


def test_restore_buffers_copies_the_snapshot_back(base):
    """Exact: after a recording chunk, restore_buffers puts the pre-chunk
    contents back into the same tensors; after a chunk that does not
    record it changes nothing."""
    eng = base
    cand_pos, cand_rank = eng._candidates()
    pg = phase_graphs(eng)
    buf = eng.buffers.clone()
    before = buf.clone()
    tensors = (buf.counts, buf.ever_boundary, buf.n_records, buf.n_boundaries)
    pg.run_chunk(3, eng.model, buf, cand_pos, cand_rank, None, method="F", n_iters=4,
                 thinning=2, record=True, want_blocks=False, debug=False)
    assert int(buf.n_records) == int(before.n_records) + 2
    pg.restore_buffers(buf)
    assert_same_buffers(buf, before)
    assert (buf.counts, buf.ever_boundary, buf.n_records, buf.n_boundaries) == tensors
    pg.run_chunk(4, eng.model, buf, cand_pos, cand_rank, None, method="F", n_iters=4,
                 thinning=0, record=True, want_blocks=False, debug=False)
    buf.n_records += 5
    pg.restore_buffers(buf)
    assert int(buf.n_records) == int(before.n_records) + 5


def test_overflow_replay_matches_eager_engine():
    """Exact: a recording chunk that overflows a small capacity is replayed
    at a grown one after its buffers are restored in place; the engine ends
    with the bytes of the engine driven by gibbs_phase (which rebinds the
    snapshot instead)."""
    data = synth_segments(20000, 2, seglen=250)[0]
    engines = []
    for eager in (False, True):
        eng = runner.make_engine(data, seed=4, capacity=128, device="cpu")
        if eager:
            eager_engine(eng)
        eng.run("M", 4, 0)
        eng._resize_capacity_for_phase = lambda: None  # keep the small capacity
        eng.capacity = 128
        counts = eng.buffers.counts
        eng.run("F", 8, 2)
        assert eng.capacity > 128
        engines.append((eng, counts))
    (g, g_counts), (e, _) = engines
    assert g.buffers.counts is g_counts  # restored in place, never rebound
    assert g.phase_graphs.chunks > 2  # the overflowed chunks ran again
    assert_same_buffers(g.buffers, e.buffers)
    for a, b in zip(g.model, e.model):
        assert_same(a, b)
    assert set(g.marginal_counts.sum(axis=0).tolist()) == {4}


@pytest.mark.parametrize("scheme", ["M 12 0 S F 24 3 D F 10 1", "M 10 2 F 16 4 P M 6 0 F 8 0"])
def test_cli_all_streams_match_eager_engine(tmp_path, scheme, monkeypatch):
    """Exact: cli.main with all seven outputs writes the same bytes whether
    the engine's chunks run through PhaseGraphs or gibbs_phase (static and
    dynamic thresholds, thinning 0 to 4, a prior redraw mid-scheme)."""
    np.savetxt(tmp_path / "d.csv", synth_segments(8000, 6, seglen=200)[0])
    make = cli.make_engine
    out = {}
    for tag in ("graph", "eager"):
        if tag == "eager":
            monkeypatch.setattr(cli, "make_engine", lambda *a, **k: eager_engine(make(*a, **k)))
        argv = ["-f", str(tmp_path / "d.csv"), "-s", "3", "-a", "-R", "5", "-i", *scheme.split(),
                "-O", *STREAMS, "-o", str(tmp_path / f"{tag}-"), ".csv", "-w"]
        assert cli.main(argv) == 0
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}
    assert out["graph"] == out["eager"]
    assert out["graph"]["sequences"].count(b"\n") > 5


def test_graph_key():
    """The cache key: a quiet sweep carries no want_blocks, every other
    field tells kinds apart; the chunk's counter and the static threshold's
    value are not part of it."""
    key = phase_graph.graph_key
    assert key(128, "F", False, True, False, True) == key(128, "F", False, False, False, True)
    assert key(128, "F", True, True, False, True) != key(128, "F", True, False, False, True)
    keys = {key(c, m, r, w, d, y) for c in (128, 256) for m in "FM" for r in (False, True)
            for w in (False, True) for d in (False, True) for y in (False, True)}
    assert len(keys) == 2 * 2 * 2 * 2 * 3
    assert key(128, "F", 1, 1, 0, 1) == phase_graph.GraphKey(128, "F", True, True, False, True)


def test_cache_keeps_one_capacity(base):
    """Chunks at one capacity reuse its captured sweeps whatever their
    counter or static threshold; another capacity drops them all (and its
    own set of slots replaces the old one)."""
    eng = base
    pg = phase_graphs(eng)
    buf = eng.buffers.clone()
    kw = dict(method="F", n_iters=4, want_blocks=True, debug=False)
    thr = float(eng.model.threshold(eng.T))

    def chunk(capacity, counter, static, thinning):
        pos, rank = tb.bucket_candidates(eng.ing.ranked, capacity)
        if capacity == 1024:
            pos, rank = cands
        pg.run_chunk(counter, eng.model, buf, pos, rank, static, thinning=thinning, record=True, **kw)
        return pg.cached_keys()

    cands = tb.bucket_candidates(eng.ing.ranked, 1024)
    first = chunk(1024, 1, None, 2)
    assert sorted(k.record for k in first) == [False, True]
    slots = pg._set.slots
    assert chunk(1024, 2, None, 2) == first and pg._set.slots is slots
    assert chunk(1024, 3, None, 0) == first  # a quiet chunk reuses the quiet sweep
    with_static = chunk(1024, 4, thr, 2)
    assert chunk(1024, 5, thr * 1.01, 2) == with_static and len(with_static) == 4
    other = chunk(1280, 6, None, 2)
    assert {k.capacity for k in other} == {1280} and len(other) == 2
    assert pg._set.slots is not slots


@pytest.mark.parametrize("record", [False, True])
def test_warm_up_scratch_is_separate_and_starts_at_row_zero(base, record):
    """A capture's warm-up (on a card, before each capture) writes copies:
    no slot tensor is shared but the buffers of a quiet sweep (which it
    never writes), a recording one gets the snapshot buffers, and the row
    is 0 whatever row the last chunk ended on (the stacks have only as many
    rows as a chunk records)."""
    eng = base
    cand_pos, cand_rank = eng._candidates()
    pg = phase_graphs(eng)
    buf = eng.buffers.clone()
    pg.run_chunk(1, eng.model, buf, cand_pos, cand_rank, None, method="F", n_iters=8,
                 thinning=2, record=True, want_blocks=True, debug=False)
    slots = pg._set.slots
    assert int(slots.row) == 4 == slots.nbs.shape[0]
    scratch = pg._scratch(slots, record)
    assert int(scratch.row) == 0
    assert (scratch.buffers is slots.buffers) == (not record)
    if record:
        assert scratch.buffers.counts is pg._snapshot.counts
    mine = [scratch.row, scratch.diag, scratch.nbs, scratch.means, scratch.varis, scratch.threshold,
            scratch.blk_states, scratch.blk_bounds, *scratch.model]
    theirs = [slots.row, slots.diag, slots.nbs, slots.means, slots.varis, slots.threshold,
              slots.blk_states, slots.blk_bounds, *slots.model]
    assert not {t.data_ptr() for t in mine} & {t.data_ptr() for t in theirs}
    sweep.sweep_step(torch.Generator().manual_seed(1), scratch, eng.priors, eng.ing.ranked,
                     cand_pos, cand_rank, eng.ing.prefix, method="F", nr_params=3,
                     mapping=eng._mapping, use_self_transitions=True, cell_bits=eng.ing.cell_bits,
                     dynamic=True, record=record, write_row=record, debug=False)
    assert int(scratch.row) == int(record) and int(slots.row) == 4


def test_checkpoint_restores_into_the_engines_buffers(tmp_path):
    """Exact: restore_checkpoint copies the saved buffers into the engine's
    own tensors (its graphs write there) and the resumed run equals the
    uninterrupted one."""
    data = synth_segments(10000, 9)[0]

    def build():
        return runner.make_engine(data, seed=3, device="cpu")

    whole = build()
    whole.run("M", 8, 0)
    whole.run("F", 16, 4)
    cut = build()
    cut.run("M", 8, 0)
    save_checkpoint(cut, str(tmp_path / "c.npz"))
    resumed = build()
    resumed.run("M", 2, 0)  # its slots and buffers exist before the restore
    tensors = (resumed.buffers.counts, resumed.buffers.ever_boundary)
    restore_checkpoint(resumed, str(tmp_path / "c.npz"))
    assert (resumed.buffers.counts, resumed.buffers.ever_boundary) == tensors
    resumed.run("F", 16, 4)
    assert_same_buffers(resumed.buffers, whole.buffers)
    for a, b in zip(resumed.model, whole.model):
        assert_same(a, b)


@pytest.mark.parametrize("method", ["F", "M"])
def test_chunk_vs_jax_gibbs_phase(method):
    """Against the JAX package's jitted gibbs_phase on the same numpy
    inputs (data, model, priors, candidates, a static threshold).

    Exact: every sweep's block count (the recorded rows and diag), and the
    block sufficient statistics of that structure. Statistical (the random
    streams differ, threefry against Philox): each emission mean averaged
    over the recorded sweeps within 6 standard errors of the difference of
    the two averages + 0.01, the MAP state of the recorded marginals equal
    on >= 99 % of the positions, and the mean total-variation distance of
    the per-position state frequencies <= 0.03."""
    T, K, cap, n, thin = 6000, 3, 1024, 64, 2
    data = synth_segments(T, 5, seglen=300)[0]
    jing, ting = jrun.ingest(data), runner.ingest(data, device="cpu")
    jpos, jrank = jb.bucket_candidates(jing.ranked, cap)
    tpos, trank = convert.candidates(jpos, jrank)
    model = dict(theta_mean=np.array([0.0, 2.0, -2.0], np.float32),
                 theta_var=np.ones(K, np.float32),
                 A=np.full((K, K), 0.02, np.float32) + np.eye(K, dtype=np.float32) * 0.94,
                 pi=np.full(K, 1 / K, np.float32))
    nig = np.tile(np.array([2.0, 2.0, 0.0, 0.1], np.float32), (K, 1))
    thr = np.float32(2.5)
    want = jsw.gibbs_phase(
        jax.random.PRNGKey(1), JHMMState(**{k: jnp.asarray(v) for k, v in model.items()}),
        JHMMPriors.create(nig, K), jing.ranked, jpos, jrank, jing.prefix,
        jsw.RecordBuffers.create(T, K), np.int32(1), np.bool_(False), thr,
        method=method, capacity=cap, spec_nr_params=K, mapping_tuple=((0,), (1,), (2,)),
        use_self_transitions=True, n_iters=n, thinning=thin, cell_bits=jing.cell_bits,
        record=True, want_blocks=True, debug=False,
    )
    priors = HMMPriors.create(nig, K)
    pg = phase_graph.PhaseGraphs(phase_graph.OneDeviceSweep(
        1, priors, ting.ranked, ting.prefix, torch.arange(K).reshape(K, 1), nr_params=K,
        use_self_transitions=True, cell_bits=ting.cell_bits))
    buf = sweep.RecordBuffers.create(T, K)
    got = pg.run_chunk(1, convert.hmm_state(SimpleNamespace(**model)), buf, tpos, trank,
                       float(thr), method=method, n_iters=n, thinning=thin, record=True,
                       want_blocks=True, debug=False)
    # exact: the block structure every sweep cut, and its statistics
    nb = int(np.asarray(want[4])[0])
    np.testing.assert_array_equal(to_np(got[1]), np.full(n // thin, nb))
    np.testing.assert_array_equal(np.asarray(want[4]), np.full(n // thin, nb))
    assert to_np(got[0])[:2].tolist() == np.asarray(want[3])[:2].tolist() == [nb, nb]
    want_stats = jb.block_sufficient_stats_t(
        jing.prefix, jb.make_blocks_bucketed(jpos, jrank, jing.ranked, jnp.float32(thr)),
        jing.cell_bits)
    got_stats = tb.block_sufficient_stats_t(
        ting.prefix, tb.make_blocks_bucketed(tpos, trank, ting.ranked, torch.tensor(thr)),
        ting.cell_bits)
    np.testing.assert_array_equal(to_np(got_stats).view(np.int32), np.asarray(want_stats).view(np.int32))
    # statistical
    R = n // thin
    m_t, m_j = to_np(got[2]), np.asarray(want[5])
    se = np.sqrt((m_t.var(axis=0) + m_j.var(axis=0)) / R)
    assert np.all(np.abs(m_t.mean(axis=0) - m_j.mean(axis=0)) <= 6 * se + 0.01), (m_t.mean(0), m_j.mean(0))
    freq = [np.cumsum(to_np(c).astype(np.int64).reshape(K, T), axis=1) / R
            for c in (buf.counts, want[1].counts)]
    assert int(buf.n_records) == int(want[1].n_records) == R
    assert (freq[0].argmax(axis=0) == freq[1].argmax(axis=0)).mean() >= 0.99
    assert 0.5 * np.abs(freq[0] - freq[1]).sum(axis=0).mean() <= 0.03
