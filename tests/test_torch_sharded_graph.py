"""The sharded engine's phase chunks on fixed storage
(parallel/sharded.ShardedSweep through samplers/phase_graph.PhaseGraphs).

On a card each run of local pieces of the sweep is a CUDA graph and the
collectives run eagerly between the replays; on the CPU the same pieces run
eagerly on the same slots, the collectives writing into the same fixed
tensors. Here that path is held against the plain sharded_phase (the eager
chunk, which builds its slots anew each chunk) byte for byte: at W = 1 with
P = 1, 2 and 4 shards, and at W = 2 and 4 ranks played by threads of this
process (_torch_helpers.ThreadRanks); for M and F, quiet and recording
chunks, block stacks, the debug bitmask and a static threshold; through an
overflow replay whose buffers are restored in place, and a checkpoint
resume. The card's side is tests/test_torch_cuda.py. Every tolerance here
is bitwise."""

import pytest
import torch

from _torch_helpers import (  # noqa: F401
    ThreadRanks,
    cpu_requested,
    eager_sharded_engine,
    synth_segments,
    to_np,
)
from hammlet_tpu_torch.checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.parallel import sharded as tsh
from hammlet_tpu_torch.parallel.mesh import PositionMesh
from hammlet_tpu_torch.samplers.phase_graph import graph_key, runs_and_collectives

torch.set_num_threads(1)

CPU = torch.device("cpu")
STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "segments")


def assert_same(got, want) -> None:
    """Same dtype, shape and bytes (float32 bit patterns included)."""
    g, w = to_np(got), to_np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes()


def assert_same_buffers(a, b) -> None:
    for name in ("counts", "everb", "n_rec", "n_bound"):
        assert_same(getattr(a, name), getattr(b, name))


def engine(data, P, seed, world=1, ranks=None, **kw) -> tsh.ShardedEngine:
    """P shards on the CPU; over ``world`` thread ranks when ``ranks``."""
    mesh = PositionMesh(P, CPU, group=ranks) if world > 1 else PositionMesh(P, CPU)
    return tsh.make_sharded_engine(data, mesh=mesh, nr_params=3, seed=seed, **kw)


def on_ranks(world, monkeypatch, fn) -> list:
    """``fn(ranks, rank)`` in ``world`` thread ranks (world 1: this thread,
    no group); the results in rank order."""
    if world == 1:
        return [fn(None, 0)]
    ranks = ThreadRanks(world)
    ranks.install(monkeypatch)
    return ranks.run(lambda r: fn(ranks, r))


def chunk_pair(eng, counter, model_g, model_e, mine, theirs, **kw):
    """One chunk through the engine's fixed storage (``_run_chunk``'s
    PhaseGraphs, the error bits ORed over the processes after it) and one
    through the plain sharded_phase, from the given models and buffers."""
    pos, rank = eng._shard_candidates()
    static = kw.pop("static")
    got = eng.phase_graphs.run_chunk(counter, model_g, mine, pos, rank, static, **kw)
    if kw["debug"]:
        got[0][2] = tsh._or_over_processes(eng.mesh, got[0][2])
    want = tsh.sharded_phase(
        eng.mesh, eng.seed, counter, model_e, eng.priors, eng.negw, pos, rank, eng.r_t,
        eng.q2_hi, eng.q2_lo, theirs, static, method=kw["method"], T=eng.T, T_local=eng.T_local,
        cell_bits=eng.cell_bits, mapping=eng._mapping, nr_params=3, use_self_transitions=True,
        n_iters=kw["n_iters"], thinning=kw["thinning"], record=kw["record"],
        want_blocks=kw["want_blocks"], debug=kw["debug"],
    )
    return got, want


def compare_chunks(eng, method, thinning, variant) -> int:
    """Two chunks in a row (the slots carry over): diag, recorded rows,
    block stacks, model and buffers equal byte for byte; a chunk that does
    not record returns no rows. Returns the recorded sweeps."""
    static = float(eng.model.threshold(eng.T)) if variant == "static" else None
    kw = dict(method=method, n_iters=8, thinning=thinning, record=True,
              want_blocks=variant == "blocks", debug=variant == "debug", static=static)
    mine, theirs = eng.buffers.clone(), eng.buffers.clone()
    model_g = model_e = eng.model
    for counter in (7, 8):
        got, want = chunk_pair(eng, counter, model_g, model_e, mine, theirs, **dict(kw))
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
        model_g, model_e = eng.phase_graphs.model_copy(), want[0]
        for g, w in zip(model_g, model_e):
            assert_same(g, w)
        assert_same_buffers(mine, theirs)
    if variant == "debug":
        assert int(got[0][2]) == 0
    return int(mine.n_rec) - int(eng.buffers.n_rec)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def base(request):
    """P shards in one process after a short burn-in (its state is only
    read)."""
    eng = engine(synth_segments(6000, 3, seglen=300)[0], request.param, seed=2)
    eng.run("M", 4, 0)
    return eng


@pytest.mark.parametrize("variant", ["plain", "blocks", "debug", "static"])
@pytest.mark.parametrize("thinning", [0, 2])
@pytest.mark.parametrize("method", ["F", "M"])
def test_chunk_bytes_vs_sharded_phase(base, method, thinning, variant):
    """W = 1, P = 1, 2, 4: the engine's pieces on its fixed storage write
    the plain sharded_phase's bytes."""
    assert compare_chunks(base, method, thinning, variant) == (8 if thinning else 0)


@pytest.mark.parametrize("variant", ["plain", "blocks", "debug", "static"])
@pytest.mark.parametrize("method", ["F", "M"])
@pytest.mark.parametrize("world", [2, 4])
def test_thread_ranks_chunk_bytes_vs_sharded_phase(monkeypatch, world, method, variant):
    """W = 2 and 4 thread ranks, P = 4: on every rank the pieces on fixed
    storage, their collectives writing into fixed tensors, write the bytes
    of the plain sharded_phase, quiet chunks and recording ones."""
    data = synth_segments(6000, 4, seglen=300)[0]

    def rank_fn(ranks, r):
        eng = engine(data, 4, 5, world, ranks)
        eng.run("M", 4, 0)
        return [compare_chunks(eng, method, thinning, variant) for thinning in (0, 2)]

    assert on_ranks(world, monkeypatch, rank_fn) == [[0, 8]] * world


@pytest.mark.parametrize("world", [1, 2, 4])
def test_engine_writes_the_eager_engines_bytes(tmp_path, monkeypatch, world):
    """The whole engine, all six streams, static and dynamic thresholds,
    thinning 0 to 3, a prior redraw: the graphed path (here, its pieces on
    fixed storage) writes the bytes of the engine whose chunks run the
    plain sharded_phase, and over W ranks the bytes of one process (the
    segments stream counts the boundaries summed over the processes)."""
    data = synth_segments(8000, 6, seglen=200)[0]
    scheme = "M 12 0 S F 24 3 D F 10 1 P M 6 0 F 8 2".split()
    out = {}
    for tag, w in (("graph", world), ("eager", world), ("one", 1)):
        if tag == "one" and world == 1:
            continue

        def rank_fn(ranks, r, tag=tag, w=w):
            rec = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", 3, outputs=set(STREAMS),
                          overwrite=True, write=r == 0)
            eng = engine(data, 4, 7, w, ranks, records=rec)
            if tag == "eager":
                eager_sharded_engine(eng)
            eng.run_scheme(scheme)
            eng.finalize()
            return eng.phase_graphs.chunks

        chunks = on_ranks(w, monkeypatch, rank_fn)
        assert (min(chunks) > 4) == (tag != "eager")
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}
    assert out["graph"] == out["eager"] == out.get("one", out["graph"])
    assert out["graph"]["sequences"].count(b"\n") == 8 + 10 + 4


def test_restore_buffers_copies_the_snapshot_back(base):
    """After a recording chunk, restore_buffers puts the pre-chunk contents
    back into the same sharded buffers (an overflow replay); after a chunk
    that does not record it changes nothing."""
    eng = base
    pos, rank = eng._shard_candidates()
    pg = eng.phase_graphs
    buf = eng.buffers.clone()
    before = buf.clone()
    tensors = (buf.counts, buf.everb, buf.n_rec, buf.n_bound)
    kw = dict(method="F", n_iters=4, want_blocks=False, debug=False)
    pg.run_chunk(3, eng.model, buf, pos, rank, None, thinning=2, record=True, **kw)
    assert int(buf.n_rec) == int(before.n_rec) + 2 and int(buf.n_bound) > int(before.n_bound)
    pg.restore_buffers(buf)
    assert_same_buffers(buf, before)
    assert (buf.counts, buf.everb, buf.n_rec, buf.n_bound) == tensors
    pg.run_chunk(4, eng.model, buf, pos, rank, None, thinning=0, record=True, **kw)
    buf.n_rec += 5
    pg.restore_buffers(buf)
    assert int(buf.n_rec) == int(before.n_rec) + 5


@pytest.mark.parametrize("world", [1, 2])
def test_overflow_replay_restores_in_place(monkeypatch, world):
    """A recording chunk that overflows a small capacity is replayed at a
    grown one after its buffers are restored in place (the graphs keep
    their addresses); the engine ends with the bytes of the engine driven
    by sharded_phase, which rebinds its snapshot instead."""
    data = synth_segments(20000, 2, seglen=50, scale=2.0)[0]  # ~200 blocks per shard

    def rank_fn(ranks, r):
        engines = []
        for eager in (False, True):
            eng = engine(data, 2, 4, world, ranks, cap_local=128)
            if eager:
                eager_sharded_engine(eng)
            eng.run("M", 4, 0)
            eng._resize_capacity_for_phase = lambda: None  # keep the small capacity
            eng.cap_local = 128
            counts = eng.buffers.counts
            eng.run("F", 8, 2)
            assert eng.cap_local > 128
            engines.append((eng, counts))
        (g, g_counts), (e, _) = engines
        assert g.buffers.counts is g_counts  # restored in place, never rebound
        assert g.phase_graphs.chunks > 2  # the overflowed chunks ran again
        assert_same_buffers(g.buffers, e.buffers)
        for a, b in zip(g.model, e.model):
            assert_same(a, b)
        return set(g.marginal_counts.sum(axis=0).tolist())

    assert on_ranks(world, monkeypatch, rank_fn) == [{4}] * world


@pytest.mark.parametrize("world", [1, 2])
def test_checkpoint_restores_into_the_engines_buffers(tmp_path, monkeypatch, world):
    """restore_sharded_checkpoint copies the saved buffers into the engine's
    own tensors (its graphs write there), and the resumed run equals the
    uninterrupted run of the eager engine."""
    data = synth_segments(6000, 9, seglen=200)[0]
    ck = str(tmp_path / "c.npz")

    def rank_fn(ranks, r):
        whole = eager_sharded_engine(engine(data, 2, 3, world, ranks))
        whole.run("M", 8, 0)
        whole.run("F", 16, 4)
        cut = engine(data, 2, 3, world, ranks)
        cut.run("M", 8, 0)
        save_sharded_checkpoint(cut, ck)
        if ranks is not None:
            ranks.barrier.wait()  # the primary has written the file
        resumed = engine(data, 2, 3, world, ranks)
        resumed.run("M", 2, 0)  # its slots and buffers exist before the restore
        tensors = tuple(getattr(resumed.buffers, n) for n in ("counts", "everb", "n_rec", "n_bound"))
        restore_sharded_checkpoint(resumed, ck)
        assert tuple(getattr(resumed.buffers, n) for n in ("counts", "everb", "n_rec", "n_bound")) == tensors
        resumed.run("F", 16, 4)
        assert_same_buffers(resumed.buffers, whole.buffers)
        for a, b in zip(resumed.model, whole.model):
            assert_same(a, b)
        return int(resumed.buffers.n_rec)

    assert on_ranks(world, monkeypatch, rank_fn) == [4] * world


@pytest.mark.parametrize("world", [1, 2])
def test_sweep_splits_at_its_collectives(monkeypatch, world):
    """Without a process group every collective is a local piece (the
    identity) and the sweep is one graph, drawing from every generator.
    With one, an F sweep is local runs around the three first gathers, the
    gathers of the forward totals, the backward maps, the last states and
    the statistics, and on a recording sweep the boundary sum; the
    generators are registered only with the runs that draw from them, the
    replicated one with two. A gather writes into the same tensor at every
    sweep."""
    data = synth_segments(4000, 8, seglen=200)[0]

    def rank_fn(ranks, r):
        eng = engine(data, 2, 1, world, ranks)
        prog = eng.phase_graphs.program
        pos, rank = eng._shard_candidates()
        shapes = {}
        for method in ("F", "M"):
            for record in (False, True):
                key = graph_key(rank.shape[1], method, record, False, False, True)
                order = runs_and_collectives(prog.pieces(key, pos, rank, write_row=record))
                shapes[method, record] = [
                    [prog.generators.index(g) for g in dict.fromkeys(x for p in run for x in p.draws)]
                    if isinstance(run, list) else type(run).__name__ for run in order
                ]
        pg, buf = eng.phase_graphs, eng.buffers.clone()
        ptrs = []
        for counter in (1, 2):
            pg.run_chunk(counter, eng.model, buf, pos, rank, None, method="F", n_iters=4,
                         thinning=2, record=True, want_blocks=False, debug=False)
            st = pg._set.steps[graph_key(rank.shape[1], "F", True, False, False, True)].args[2]
            ptrs.append([getattr(st, n).data_ptr() for n in ("firsts_all", "tots_all", "stats_all")])
        # a gather's output keeps its address (without a group it is its
        # input, made inside the one graph)
        assert (ptrs[0] == ptrs[1]) == (world > 1)
        return shapes, pg.graphs

    got = on_ranks(world, monkeypatch, rank_fn)
    shapes, graphs = got[0]
    assert graphs == 0  # nothing is captured on the CPU
    if world == 1:
        assert shapes["F", False] == shapes["F", True] == [[0, 1, 2]]
        assert shapes["M", False] == shapes["M", True] == [[1, 2, 0]]
    else:
        G = "_Gather"
        assert shapes["F", False] == [[], G, [], G, [0, 1], G, [], G, [], G, [0]]
        assert shapes["F", True] == [[], G, [], G, [0, 1], G, [], G, [], G, [0], "_Psum", []]
        assert shapes["M", False] == [[], G, [1], G, [], G, [0]]
        assert shapes["M", True] == [[], G, [1], G, [], G, [0], "_Psum", []]
    assert all(s == shapes for s, _ in got)


def test_ranks_that_build_different_sweeps_fail(monkeypatch):
    """Every process must build the same sweep kinds in the same order (on
    a card each warms up its collectives before a capture): two thread
    ranks asking for different capacities both raise."""
    data = synth_segments(4000, 8, seglen=200)[0]

    def rank_fn(ranks, r):
        eng = engine(data, 2, 1, 2, ranks)
        pos, rank = eng._shard_candidates()
        key = graph_key(rank.shape[1] + r, "F", True, False, False, True)
        with pytest.raises(RuntimeError, match="different sweeps"):
            eng.phase_graphs.program.pieces(key, pos, rank, write_row=True)
        return True

    assert on_ranks(2, monkeypatch, rank_fn) == [True, True]
