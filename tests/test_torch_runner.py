"""The port's ingest, scheme interpreter and engine against the JAX package
(hammlet_tpu/runner.py), and the slice end to end."""

import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_bitwise, synth_segments, to_np, cpu_requested  # noqa: F401
from hammlet_tpu import runner as jrun
from hammlet_tpu.golden.parity import read_marginals, tv_aligned
from hammlet_tpu.io.records import Records as JRecords
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import convert
from hammlet_tpu_torch import runner as trun
from hammlet_tpu_torch.io.records import Records as TRecords

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """The port (the post-processing tools included, which import matplotlib
    only where they draw), chip_smoke.py and ``bin/hammlet-torch -h`` run
    with jax and hammlet_tpu made unimportable."""
    code = (
        "import runpy, sys; sys.modules['jax'] = None; sys.modules['hammlet_tpu'] = None\n"
        "import hammlet_tpu_torch.runner, hammlet_tpu_torch.convert\n"
        "import hammlet_tpu_torch.samplers.phase_graph\n"
        "import hammlet_tpu_torch.io.input, hammlet_tpu_torch.debug\n"
        "import hammlet_tpu_torch.cli, hammlet_tpu_torch.checkpoint\n"
        "import hammlet_tpu_torch.manpage, hammlet_tpu_torch.parallel.sharded\n"
        "import hammlet_tpu_torch.parallel.mesh, hammlet_tpu_torch.parallel.distributed\n"
        "import hammlet_tpu_torch.parallel.ingest, hammlet_tpu_torch.parallel.mh_worker\n"
        "import hammlet_tpu_torch.parallel.launch, hammlet_tpu_torch.entry\n"
        "import hammlet_tpu_torch.golden.reference, hammlet_tpu_torch.golden.parity\n"
        "import hammlet_tpu_torch.pyhammlet, hammlet_tpu_torch.pyhammlet.plotting\n"
        "import hammlet_tpu_torch.tools.avg, hammlet_tpu_torch.tools.genome\n"
        "import hammlet_tpu_torch.tools.max_segmentation, hammlet_tpu_torch.tools.sort_states\n"
        "import hammlet_tpu_torch.tools.sam_to_counts, hammlet_tpu_torch.tools.plot_results\n"
        "assert 'matplotlib' not in sys.modules\n"
        "import chip_smoke\n"
        "sys.argv = ['hammlet-torch', '-h']\n"
        "try:\n"
        "    runpy.run_path('bin/hammlet-torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'hammlet_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "hammlet-torch - Fast Bayesian HMM segmentation" in proc.stdout


def test_scheme_helpers_match_jax():
    """parse_scheme, _next_chunk and _round_capacity are the JAX package's."""
    for scheme in ["M 500 0 S P F 200 0 F 300 3", "F 10 2 D M 3 1", ""]:
        assert trun.parse_scheme(scheme.split()) == jrun.parse_scheme(scheme.split())
    for bad in ["F 10", "F 10 2 X"]:
        with pytest.raises(ValueError):
            trun.parse_scheme(bad.split())
    for done in range(0, 9):
        for end in range(done, 20, 3):
            for thin in (0, 1, 2, 3, 7):
                for chunk in (1, 4, 128):
                    assert trun._next_chunk(done, end, thin, chunk) == jrun._next_chunk(
                        done, end, thin, chunk
                    )
    for n in [0, 1, 128, 129, 1000, 12345, 4_000_000]:
        assert trun._round_capacity(n) == jrun._round_capacity(n)


@pytest.mark.parametrize("dim", [1, 3])
def test_ingest_device_matches_jax(dim):
    """Device ingest: weights bitwise and ranking exact; the noise sigma and
    the in-cell prefix sums within rtol 1e-5 (float32 reductions in another
    order)."""
    data = np.random.default_rng(dim).normal(0, 1, size=(20000, dim)).astype(np.float32)
    data[7000:12000] += 2.0
    want = jrun.ingest_device(data)
    got = trun.ingest_device(data, device="cpu")
    assert_bitwise(got.weights, want.weights)
    assert_bitwise(got.ranked.neg_w_sorted, want.ranked.neg_w_sorted)
    np.testing.assert_array_equal(to_np(got.ranked.pos_by_rank), to_np(want.ranked.pos_by_rank))
    np.testing.assert_allclose(got.noise_std, want.noise_std, rtol=1e-5)
    np.testing.assert_allclose(to_np(got.prefix.r_t), np.asarray(want.prefix.r_t), rtol=1e-5, atol=1e-3)
    assert got.cell_bits == want.cell_bits == jb.DEVICE_CELL_BITS
    for thr in [0.5, 2.0, 5.0]:
        assert got.count_boundaries(thr) == want.count_boundaries(thr)


def test_ingest_default_device_is_resolve_device():
    """With no device, both ingests land where ``resolve_device(None)``
    points (the card, or the device HAMMLET_TORCH_DEVICE names: here the
    CPU these tests ask for), as the JAX package's run on its default
    device."""
    from hammlet_tpu_torch.device import resolve_device

    data = np.random.default_rng(5).normal(0, 1, size=3000).astype(np.float32)
    for ing in (trun.ingest_device(data), trun.ingest(data)):
        assert ing.weights.device == resolve_device(None)
        assert ing.ranked.neg_w_sorted.device == resolve_device(None)


def test_host_ingest_matches_jax():
    """Host ingest (native library or the plain port): bitwise."""
    data = np.random.default_rng(4).normal(0, 1, size=5000).astype(np.float32)
    want = jrun.ingest(data)
    got = trun.ingest(data)
    assert_bitwise(got.weights, want.weights)
    assert got.noise_std == want.noise_std
    for f in ("r_t", "q2_hi", "q2_lo"):
        assert_bitwise(getattr(got.prefix, f), getattr(want.prefix, f))


def test_compact_marginals_matches_jax():
    """Tolerance: exact, on the same recorded buffers."""
    T, K, cap = 3000, 3, 256
    w = np.random.default_rng(3).exponential(1.0, size=T).astype(np.float32)
    w[0] = np.inf
    jr = jb.build_ranked_weights(w)
    jpos, jrank = jb.bucket_candidates(jr, cap)
    buf = jsw.RecordBuffers.create(T, K)
    rng = np.random.default_rng(4)
    for thr in [3.0, 2.7, 3.5]:
        blk = jb.make_blocks_bucketed(jpos, jrank, jr, jnp.float32(thr))
        states = jnp.asarray(rng.integers(0, K, size=cap).astype(np.int32))
        buf = jsw.record_sweep(buf, states, blk.starts, blk.n_blocks)
    want_starts, want_counts = jrun.compact_marginals(buf)
    got_starts, got_counts = trun.compact_marginals(convert.record_buffers(buf))
    np.testing.assert_array_equal(got_starts, want_starts)
    np.testing.assert_array_equal(got_counts, want_counts)


def _reassembly_inputs(P, seed, R=5, cap=40, T_local=300):
    """Random per-shard candidates (ascending positions + a permutation of
    ranks, shard 0's first candidate at position 0 with rank 0) and block
    counts / states per recorded sweep."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((P, cap + 1), np.int32)
    rank = np.zeros((P, cap), np.int32)
    for j in range(P):
        pos[j, :cap] = np.sort(rng.choice(np.arange(1, T_local), cap, replace=False))
        rank[j] = rng.permutation(cap)
        pos[j, cap] = T_local
    pos[0, 0] = 0
    rank[0][rank[0] == 0] = rank[0, 0]
    rank[0, 0] = 0
    nbs = rng.integers(0, cap + 1, size=(R, P)).astype(np.int64)
    nbs[:, 0] = np.maximum(nbs[:, 0], 1)  # every sweep has shard 0's first block
    nbs[1] = cap  # a full row
    z = rng.integers(0, 4, size=(R, P * cap)).astype(np.int32)
    return z, nbs, pos, rank, P * T_local, T_local


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("P", [1, 3])
def test_reassemble_block_rows_matches_jax(P, native_lib, monkeypatch):
    """Exact: the port's record-drain reassembly (native library or its
    numpy fallback) equals the JAX package's on random inputs."""
    from hammlet_tpu.parallel.sharded import _reassemble_block_rows as jreasm
    from hammlet_tpu_torch import native
    from hammlet_tpu_torch.parallel.sharded import _reassemble_block_rows as treasm

    if not native_lib:
        monkeypatch.setattr(native, "reassemble_blocks", lambda *a: None)
    for seed in range(3):
        args = _reassembly_inputs(P, seed)
        want = jreasm(*args)
        got = treasm(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "python"])
def test_record_sweeps_batch_bytes_match_jax(tmp_path, native_lib, monkeypatch):
    """Exact: the port's batch stream writer gives the JAX package's bytes
    on tests/test_e2e.py's golden arrays, with its native formatters and
    with its Python fallback."""
    from hammlet_tpu_torch import native

    if not native_lib:
        monkeypatch.setattr(native, "available", lambda: False)
    states = np.array([[0, 0, 1, 2, 2, 0], [1, 1, 1, 1, 1, 0]], np.int32)
    sizes = np.array([[5, 3, 2, 4, 6, 0], [2, 2, 2, 2, 12, 0]], np.int32)
    ns = np.array([5, 5], np.int64)
    n_bounds = np.array([2, 2], np.int64)
    streams = ("sequences", "blocks", "compression", "segments")
    for cls, tag in ((JRecords, "j-"), (TRecords, "t-")):
        rec = cls(20, str(tmp_path / tag), ".csv", 3, outputs=set(streams), overwrite=True)
        rec.record_sweeps_batch(states, sizes, ns, n_bounds)
        rec.close()
    assert (tmp_path / "t-sequences.csv").read_text() == "8:0\t2:1\t10:2\n20:1\n"
    for s in streams:
        assert (tmp_path / f"t-{s}.csv").read_bytes() == (tmp_path / f"j-{s}.csv").read_bytes(), s


def test_sequences_stream_is_the_recorded_states(tmp_path):
    """Exact: the sequences lines of a run, expanded per position and
    counted per state, equal Engine.marginal_counts — the drained states
    are the states the device recorded. The blocks, segments and
    compression lines agree with them line by line."""
    data = synth_segments(4000, 8, seglen=200, scale=0.7)[0]
    streams = {"sequences", "blocks", "segments", "compression"}
    rec = TRecords(len(data), str(tmp_path / "s-"), ".csv", 3, outputs=streams, overwrite=True)
    eng = trun.make_engine(data, seed=3, records=rec, device="cpu")
    eng.run_scheme("M 10 0 F 24 3".split())
    eng.finalize()
    counts = np.zeros((3, len(data)), np.int64)
    read = lambda s: (tmp_path / f"s-{s}.csv").read_text().splitlines()  # noqa: E731
    lines = read("sequences")
    assert len(lines) == int(eng.buffers.n_records) == 8
    for line, blk, comp in zip(lines, read("blocks"), read("compression")):
        toks = [tuple(map(int, t.split(":"))) for t in line.split("\t")]
        sizes = np.array([n for n, _ in toks])
        pos_state = np.repeat([z for _, z in toks], sizes)
        counts[pos_state, np.arange(len(data))] += 1
        blocks = list(map(int, blk.split("\t")))
        assert sum(blocks) == len(data)
        assert comp == f"{len(data) / len(blocks):.6g}"
        # every sequence boundary is a block boundary
        assert set(np.cumsum(sizes)[:-1]) <= set(np.cumsum(blocks)[:-1].tolist())
    np.testing.assert_array_equal(counts, eng.marginal_counts)
    segs = [int(x.split("\t")[0]) for x in read("segments")]
    assert segs[-1] == int(eng.buffers.n_boundaries) + 1 == int(eng.buffers.ever_boundary.sum()) + 1


@pytest.mark.parametrize("K", [3, 9, 27])
def test_overflow_replay_and_ceiling(K):
    """A chunk that overflows the capacity is replayed at a grown capacity
    from the same streams; recording sweeps stay exact (rows sum to the
    recorded sweeps); at the ceiling, after a prior draw, a burn-in chunk
    runs truncated (the block count clamped: its last count is at most
    the ceiling) and a recording chunk raises, in both packages, with the
    JAX package's message (hammlet_tpu/runner.py:742-746) up to the block
    count. K = 3 on one track; K = 9 and 27 on chip_smoke.py's two- and
    three-track data."""
    from chip_smoke import config4_steps, states27_steps

    if K == 3:
        data, dim = synth_segments(20000, 2, seglen=250)[0], 1
    else:
        dim = {9: 2, 27: 3}[K]
        data = (config4_steps if K == 9 else states27_steps)(40000, seed=2)[0]
    eng = trun.make_engine(data, nr_data_dim=dim, seed=4, capacity=128, device="cpu")
    assert eng.spec.nr_states == K
    eng.run("M", 4, 0)
    eng._resize_capacity_for_phase = lambda: None  # keep the small capacity
    eng.capacity = 128
    eng.run("F", 8, 2)
    assert eng.capacity > 128
    assert set(eng.marginal_counts.sum(axis=0).tolist()) == {4}

    eng.max_capacity = eng.capacity = 128
    jeng = jrun.make_engine(data, nr_data_dim=dim, seed=4, capacity=128)
    jeng.max_capacity = 128
    msgs = []
    for e in (jeng, eng):
        e.sample_prior()  # ~T blocks again
        e.run("M", 2, 0)  # truncated at the ceiling: accepted
        assert e.capacity == 128 and e.last_n_blocks <= 128
        with pytest.raises(RuntimeError, match=r"recording sweep needs \d+ blocks but the capacity "
                           r"ceiling is 128 \(HAMMLET_MAX_CAPACITY\)") as exc:
            e.sample_prior()
            e.run("F", 2, 1)
        msgs.append(re.sub(r"needs \d+ blocks", "needs N blocks", str(exc.value)))
    assert msgs[0] == msgs[1], msgs


def _run_engine(pkg_runner, records_cls, data, seed, prefix, **kw):
    rec = records_cls(
        len(data), prefix, ".csv", 3,
        outputs={"marginals", "parameters", "compression"}, overwrite=True,
    )
    eng = pkg_runner.make_engine(data, nr_params=3, seed=seed, records=rec, device_ingest=True, **kw)
    eng.run_scheme("M 20 0 F 60 2".split())
    eng.finalize()
    return eng


def test_slice_end_to_end_vs_jax(tmp_path):
    """The slice end to end: make_engine(device_ingest=True) -> run_scheme
    -> finalize in both packages on the same low-SNR data (segments of 100,
    means {0, 1, -1}: the posterior is uncertain, so seeds disagree).

    Statistical: the random streams differ (threefry vs torch's), so the
    marginals are compared by tv_aligned (golden/parity.py) in the spirit of
    parity_bound: the mean JAX-vs-port distance must stay within the
    seed-to-seed envelope (mean of the JAX pair's and the port pair's
    distances) + max(50% of it, 0.005) + 0.002, and the port's MAP
    accuracy within 0.02 of the JAX runs'. Formats: every written CSV line
    has the JAX package's field layout."""
    data, truth = synth_segments(20000, 3, seglen=100, scale=0.5)
    for s in (1, 2):
        _run_engine(jrun, JRecords, data, s, str(tmp_path / f"jax{s}-"))
        t = _run_engine(trun, TRecords, data, s, str(tmp_path / f"torch{s}-"), device="cpu")
    assert t.capacity <= 20000 and t.buffers.counts.dtype == torch.int32

    mj = [read_marginals(tmp_path / f"jax{s}-marginals.csv") for s in (1, 2)]
    mt = [read_marginals(tmp_path / f"torch{s}-marginals.csv") for s in (1, 2)]
    envelope = (tv_aligned(mj[0], mj[1]) + tv_aligned(mt[0], mt[1])) / 2
    ours = np.mean([tv_aligned(a, b) for a in mj for b in mt])
    assert ours <= envelope + max(0.5 * envelope, 0.005) + 0.002, (ours, envelope)

    def accuracy(m):
        return max(
            float((np.asarray(p)[m.argmax(axis=1)] == truth).mean())
            for p in itertools.permutations(range(3))
        )

    assert min(map(accuracy, mt)) >= min(map(accuracy, mj)) - 0.02

    def layout(line):
        return [
            "f6" if re.fullmatch(r"-?\d+\.\d{6}", f) else "int" if re.fullmatch(r"-?\d+", f)
            else "g" if re.fullmatch(r"[-+.\deE]+", f) else f
            for f in line.split("\t")
        ]

    for stream in ("marginals", "parameters", "compression"):
        jl = (tmp_path / f"jax1-{stream}.csv").read_text().splitlines()
        tl = (tmp_path / f"torch1-{stream}.csv").read_text().splitlines()
        if stream != "marginals":  # one line per recorded sweep
            assert len(tl) == len(jl) == 30
        assert {tuple(layout(x)) for x in tl} <= {tuple(layout(x)) for x in jl}, stream
    rows = [list(map(int, x.split("\t"))) for x in (tmp_path / "torch1-marginals.csv").read_text().splitlines()]
    assert sum(r[0] for r in rows) == 20000
    assert all(sum(r[1:]) == 30 for r in rows)


@pytest.mark.parametrize("call", ["resolve_device", "process_device", "ingest", "ingest_device",
                                  "make_engine", "make_sharded_engine"])
def test_no_card_without_the_cpu_request_raises(monkeypatch, call):
    """Without a card (torch.cuda.is_available() made False) and without
    HAMMLET_TORCH_DEVICE, every way of taking the default device raises
    and names the request; with HAMMLET_TORCH_DEVICE=cpu, or device="cpu"
    passed, it is the CPU. The port never falls back to the CPU on its
    own."""
    from hammlet_tpu_torch.device import DEVICE_VAR, resolve_device
    from hammlet_tpu_torch.parallel import distributed, sharded

    data = np.random.default_rng(6).normal(0, 1, size=2000).astype(np.float32)
    calls = {
        "resolve_device": lambda **k: resolve_device(k.get("device")),
        "process_device": lambda **k: distributed.process_device(),
        "ingest": lambda **k: trun.ingest(data, **k).weights.device,
        "ingest_device": lambda **k: trun.ingest_device(data, **k).weights.device,
        "make_engine": lambda **k: trun.make_engine(data, **k).device,
        "make_sharded_engine": lambda **k: sharded.make_sharded_engine(data, n_devices=2, **k).device,
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(DEVICE_VAR)
    with pytest.raises(RuntimeError, match=f"{DEVICE_VAR}=cpu"):
        calls[call]()
    if call != "process_device":
        assert calls[call](device="cpu") == torch.device("cpu")
    monkeypatch.setenv(DEVICE_VAR, "cpu")
    assert calls[call]() == torch.device("cpu")
