"""The port's position-sharded engine (hammlet_tpu_torch/parallel/) against
the JAX package's (hammlet_tpu/parallel/), in one process: the port holds
P shards on the CPU (a mesh of one process), the JAX package runs on the
conftest's 8-device virtual CPU mesh. Every test names the JAX function it
holds the port against, and the tolerance."""

import os
import subprocess
import sys
from itertools import permutations
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, synth_segments, to_np, cpu_requested  # noqa: F401
from hammlet_tpu import checkpoint as jckpt
from hammlet_tpu import runner as jrun
from hammlet_tpu.io.records import Records as JRecords
from hammlet_tpu.parallel import ingest as jing
from hammlet_tpu.parallel import sharded as jsh
from hammlet_tpu.parallel.mesh import position_mesh as jax_mesh
from hammlet_tpu_torch import cli, convert
from hammlet_tpu_torch.checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.ops.blocks import build_prefix_stats
from hammlet_tpu_torch.parallel import sharded as tsh
from hammlet_tpu_torch.parallel.ingest import sharded_ingest
from hammlet_tpu_torch.parallel.mesh import position_mesh
from hammlet_tpu_torch.samplers.phase_graph import graph_key, run_pieces

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "segments")


def synth(T=3000, seed=0):
    """tests/test_sharded.py's data: segments of 120-400 in states with
    means {0, 5, -5}, unit noise (well separated)."""
    rng = np.random.default_rng(seed)
    means = [0.0, 5.0, -5.0]
    out, states = [], []
    t = 0
    while t < T:
        n = min(int(rng.integers(120, 400)), T - t)
        s = int(rng.integers(0, 3))
        out.append(rng.normal(means[s], 1.0, size=n))
        states.extend([s] * n)
        t += n
    return np.concatenate(out).astype(np.float32), np.array(states)


def _port(data, P, seed, **kw):
    return tsh.make_sharded_engine(data, n_devices=P, nr_params=3, seed=seed, device=CPU, **kw)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jax_mesh(8)


# ---- ingest -----------------------------------------------------------------


def _blocky(T, dim=1, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 4, size=(7, dim))
    out = []
    t = 0
    while t < T:
        n = min(int(rng.integers(30, 200)), T - t)
        out.append(rng.normal(means[rng.integers(0, 7)], 1.0, size=(n, dim)))
        t += n
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize(
    "T,dim,cell_bits,T_local,mult",
    [
        (2777, 1, 5, 384, 1.0),  # odd T, partial last shard
        (3000, 1, 4, 384, 1.0),
        (4096, 1, 6, 512, 1.0),  # exact power of two, full shards
        (2048, 2, 5, 256, 1.0),  # multivariate
        (3000, 3, 5, 512, 1.0),  # three tracks (-s C 3 3, -s C 4 3)
        (2500, 4, 4, 384, 1.0),  # four tracks (-s C 3 4), partial last shard
        (911, 1, 4, 128, 2.5),  # prime T + weight multiplier
        (130, 1, 4, 512, 1.0),  # single active shard, tiny T
    ],
)
def test_sharded_ingest_matches_jax(mesh8, T, dim, cell_bits, T_local, mult):
    """vs hammlet_tpu.parallel.ingest.sharded_ingest on the 8-device mesh
    (tests/test_sharded_ingest.py's grid): negw, rank, r, q2_hi and q2_lo
    bitwise; nb0, noise_std and block_means exactly equal. The provider is
    never asked for more than one shard at a time."""
    data = _blocky(T, dim=dim, seed=T)
    max_slice = 0

    def provider(start, stop):
        nonlocal max_slice
        max_slice = max(max_slice, stop - start)
        return data[start:stop]

    kw = dict(T_local=T_local, cell_bits=cell_bits, weight_multiplier=mult)
    want = jing.sharded_ingest(mesh8, data, **kw)
    got = sharded_ingest(position_mesh(8, CPU), provider, T, dim, **kw)
    assert max_slice <= T_local
    assert_bitwise(got.negw.reshape(-1), want.negw)
    np.testing.assert_array_equal(to_np(got.rank).reshape(-1), np.asarray(want.rank))
    # (dim, 2, P, T_local+1) -> the JAX package's (P*dim*2, T_local+1) rows
    r = got.r_t.permute(2, 0, 1, 3).reshape(8 * dim * 2, T_local + 1)
    assert_bitwise(r, want.r)
    assert_bitwise(got.q2_hi, want.q2_hi)
    assert_bitwise(got.q2_lo, want.q2_lo)
    # and the port's own monolithic float64 prefix build, cut per shard
    T_pad = 8 * T_local
    data_pad = np.zeros((T_pad, dim), np.float32)
    data_pad[:T] = data
    mono = build_prefix_stats(data_pad, cell_bits).r_t.permute(2, 0, 1)[:T_pad].numpy()
    assert_bitwise(r, tsh._local_r_with_edges(mono, 8, T_local, 1 << cell_bits))
    assert got.nb0 == want.nb0
    assert got.noise_std == want.noise_std
    np.testing.assert_array_equal(got.block_means, want.block_means)


# ---- one JAX sharded run shared by several tests -------------------------------

SCHEME = "M 40 0 F 40 0 F 60 3"


@pytest.fixture(scope="module")
def jax_run(mesh8, tmp_path_factory):
    """The JAX sharded engine on test_sharded.py's statistical case, its
    marginals file and a sharded checkpoint of its finished state."""
    tmp = tmp_path_factory.mktemp("jaxrun")
    data, truth = synth(T=3000, seed=7)
    rec = JRecords(len(data), str(tmp / "jax-"), ".csv", 3, overwrite=True)
    je = jsh.make_sharded_engine(data, mesh=mesh8, nr_params=3, seed=5, records=rec)
    je.run_scheme(SCHEME.split())
    je.finalize()
    jckpt.save_sharded_checkpoint(je, str(tmp / "jax.npz"))
    return dict(data=data, truth=truth, engine=je, tmp=tmp)


def _marginals(path, T):
    rows = [list(map(int, line.split("\t"))) for line in open(path).read().splitlines()]
    pos = np.zeros((T, 3))
    t = 0
    for r in rows:
        pos[t : t + r[0], : len(r) - 1] = r[1:]
        t += r[0]
    assert t == T
    return pos / pos.sum(axis=1, keepdims=True)


def test_marginals_match_jax_sharded(jax_run, tmp_path):
    """Statistical, vs the JAX ShardedEngine (test_sharded.py:76's bound):
    the mean absolute marginal difference under the best state permutation
    is below 0.06 (the random streams differ)."""
    data = jax_run["data"]
    T = len(data)
    rec = Records(T, str(tmp_path / "t-"), ".csv", 3, overwrite=True)
    e = _port(data, 8, 5, records=rec)
    e.run_scheme(SCHEME.split())
    e.finalize()
    m1 = _marginals(jax_run["tmp"] / "jax-marginals.csv", T)
    m2 = _marginals(tmp_path / "t-marginals.csv", T)
    best = min(np.abs(m1 - m2[:, list(p)]).mean() for p in permutations(range(3)))
    assert best < 0.06, best


def check_compaction_matches_jax(je, e, P: int, K: int) -> None:
    """Exact, vs hammlet_tpu.parallel.sharded.compact_sharded_marginals on
    the JAX engine ``je``'s recorded buffers, copied into the port's engine
    ``e`` of the same data and P shards: segment starts and (n_seg, K)
    counts, values and dtypes."""
    e.buffers.counts = torch.from_numpy(np.array(je.counts).reshape(P, K * e.T_local))
    e.buffers.everb[:, : e.T_local] = torch.from_numpy(np.array(je.everb).reshape(P, e.T_local))
    want_starts, want_counts = jsh.compact_sharded_marginals(je)
    got_starts, got_counts = tsh.compact_sharded_marginals(e)
    assert got_counts.shape == (len(want_starts), K) and len(want_starts) > 3
    np.testing.assert_array_equal(got_starts, want_starts)
    np.testing.assert_array_equal(got_counts, want_counts)
    assert got_counts.dtype == want_counts.dtype and got_starts.dtype == want_starts.dtype


def test_compaction_matches_jax(jax_run):
    """check_compaction_matches_jax on the JAX run's buffers."""
    check_compaction_matches_jax(jax_run["engine"], _port(jax_run["data"], 8, 5), 8, 3)


# ---- the sweep body given JAX's draws -----------------------------------------


def global_stats(data, z, sizes, nb, mapping, n_params):
    """Sweep statistics of the global chain the per-shard blocks form, in
    float64 on the host (accumulate_sweep_stats' convention, sweep.py:100:
    the first block's previous state is 0; the statistics of each (block,
    track) go to the emission parameter mapping[state, track], mapping of
    shape (K, dim)). Returns the statistics and, per parameter, the sum of
    |x| its signed sums cancel over."""
    K, dim = mapping.shape
    states, lens = [], []
    for j in range(len(nb)):
        states += list(z[j, : int(nb[j])])
        lens += list(sizes[j, : int(nb[j])])
    lens = np.array(lens, np.int64)
    states = np.array(states)
    pos = np.concatenate([[0], np.cumsum(lens)[:-1]])
    x = data.astype(np.float64).reshape(len(data), dim)
    sums = np.array([x[p : p + n].sum(axis=0) for p, n in zip(pos, lens)])  # (B, dim)
    abs_sums = np.array([np.abs(x[p : p + n]).sum(axis=0) for p, n in zip(pos, lens)])
    sumsqs = np.array([(x[p : p + n] ** 2).sum(axis=0) for p, n in zip(pos, lens)])
    trans = np.zeros((K, K))
    prev = 0
    for s, n in zip(states, lens):
        trans[prev, s] += 1
        trans[s, s] += n - 1
        prev = s
    onehot = states[None, :] == np.arange(K)[:, None]
    theta = {name: np.zeros(n_params) for name in ("sums", "sumsqs", "counts", "abs")}
    for d in range(dim):
        route = mapping[states, d][None, :] == np.arange(n_params)[:, None]  # (n_params, B)
        theta["sums"] += route @ sums[:, d]
        theta["sumsqs"] += route @ sumsqs[:, d]
        theta["counts"] += route @ lens
        theta["abs"] += route @ abs_sums[:, d]
    stats = dict(
        theta_sums=theta["sums"], theta_sumsqs=theta["sumsqs"], theta_counts=theta["counts"],
        trans_counts=trans, state_counts=onehot @ lens,
    )
    return stats, theta["abs"]


def check_sweep_given_jax_draws(je, data, e, ckpt: str, P: int, key, method: str) -> None:
    """vs the JAX sharded sweep body (sharded.py:79, through
    ShardedEngine._sweep_fn) on the settled state of the JAX engine ``je``
    (P shards of ``data``, saved to ``ckpt``), with its Gumbels regenerated
    from the same ``key`` (k_z, fold_in(k_local, shard)), run by the port's
    engine ``e`` of the same data and shards restored from ``ckpt``: the
    same per-shard block counts, sizes and states (exact), the same
    recorded counts, boundary union, n_rec and n_bound (exact); the ordered
    sweep statistics (the carried-state correction on the (K, K)
    transitions included) equal the global chain's (global_stats, float64
    on the host): counts exact, sums of squares within rtol 1e-5, and the
    signed sums within 1e-5 of the sum of |x| they cancel over (float32
    block statistics)."""
    K, n_params = je.spec.nr_states, je.spec.nr_params
    je._resize_capacity_for_phase()
    cap = je.cap_local
    jpos, jrank = je._shard_candidates()
    # the sweep donates its buffers: hand it copies
    out = je._sweep_fn(method, True)(
        key, je.model, je.priors, je.negw, jpos, jrank, je.r, je.q2_hi, je.q2_lo,
        jax.numpy.copy(je.counts), jax.numpy.copy(je.everb), je.n_rec, je.n_bound,
        np.bool_(True), np.bool_(True), np.float32(0.0),
    )
    j_counts, j_everb, j_nrec, j_nbound, j_z, j_sizes, j_nb = (np.asarray(x) for x in out[1:8])
    # the port starts from the same state: the JAX run's checkpoint of it
    restore_sharded_checkpoint(e, ckpt)
    e.model = convert.hmm_state(je.model)
    e.cap_local = cap
    pos, rank = e._shard_candidates()
    np.testing.assert_array_equal(to_np(pos).reshape(-1), np.asarray(jpos))
    np.testing.assert_array_equal(to_np(rank).reshape(-1), np.asarray(jrank))

    k_z, _, k_local = jax.random.split(key, 3)
    k_maps = [jax.random.fold_in(k_local, j) for j in range(P)]
    if method == "M":
        noise = torch.from_numpy(np.stack(
            [np.asarray(jax.random.gumbel(k, (K, cap), dtype=jax.numpy.float32)) for k in k_maps],
            axis=1,
        ))
    else:
        noise = (
            torch.from_numpy(np.array(jax.random.gumbel(k_z, (1, K), dtype=jax.numpy.float32))[0]),
            torch.from_numpy(np.stack(
                [np.asarray(jax.random.gumbel(k, (K, K, cap), dtype=jax.numpy.float32)) for k in k_maps],
                axis=2,
            )),
        )
    # one sweep of the port's pieces (those the engine's graphs capture),
    # run eagerly on the engine's buffers
    program = e.phase_graphs.program
    gkey = graph_key(cap, method, True, False, False, True)
    slots = program.create_slots(e.model, e.buffers, 1, rank, False)
    program.seed_sweep(0, 0)  # the model update's stream (not compared)
    got = SimpleNamespace()
    run_pieces(program.pieces(gkey, pos, rank, write_row=False, noise=noise), slots, got)
    np.testing.assert_array_equal(to_np(got.nb_all), j_nb)
    sampled = np.concatenate([j_z.reshape(P, cap)[j, : j_nb[j]] for j in range(P)])
    assert len(sampled) > 10 and len(np.unique(sampled)) >= min(K, 4)
    np.testing.assert_array_equal(to_np(got.sizes), j_sizes.reshape(P, cap))
    np.testing.assert_array_equal(to_np(got.z), j_z.reshape(P, cap))
    np.testing.assert_array_equal(to_np(e.buffers.counts).reshape(-1), j_counts)
    np.testing.assert_array_equal(to_np(e.buffers.everb[:, : e.T_local]).reshape(-1), j_everb)
    assert (int(e.buffers.n_rec), int(e.buffers.n_bound)) == (int(j_nrec), int(j_nbound))
    want, abs_sums = global_stats(data, j_z.reshape(P, cap), j_sizes.reshape(P, cap), j_nb,
                                  je.spec.mapping(), n_params)
    for name in ("theta_counts", "trans_counts", "state_counts"):
        np.testing.assert_array_equal(to_np(getattr(got.stats, name)), want[name], err_msg=name)
    np.testing.assert_allclose(to_np(got.stats.theta_sumsqs), want["theta_sumsqs"], rtol=1e-5)
    assert (np.abs(to_np(got.stats.theta_sums) - want["theta_sums"]) <= 1e-5 * abs_sums).all()


@pytest.mark.parametrize("method", ["F", "M"])
def test_sweep_given_jax_draws(jax_run, method):
    """check_sweep_given_jax_draws at K = 3 on the JAX run's settled state,
    P = 8 shards."""
    check_sweep_given_jax_draws(jax_run["engine"], jax_run["data"], _port(jax_run["data"], 8, 5),
                                str(jax_run["tmp"] / "jax.npz"), 8, jax.random.PRNGKey(123), method)


# ---- partition, invariants, streams --------------------------------------------


@pytest.fixture(scope="module")
def jax_partition(tmp_path_factory):
    """One recorded F sweep of the JAX single-device engine: its model
    before the sweep and its blocks line."""
    tmp = tmp_path_factory.mktemp("jpart")
    data, _ = synth(T=2777, seed=3)
    e1 = jrun.make_engine(data, nr_params=3, seed=11)
    e1.run("F", 1, 0)
    model = e1.model
    rec = JRecords(len(data), str(tmp / "a-"), ".csv", 3, outputs={"blocks"}, overwrite=True)
    e1.records = rec
    e1.run("F", 1, 1)
    rec.close()
    return data, model, (tmp / "a-blocks.csv").read_text()


@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_block_partition_matches_jax_single_device(jax_partition, tmp_path, P):
    """Exact, vs the JAX single-device engine (test_sharded.py:37): under
    one fixed model the port's sharded blocks line equals it for P shards."""
    data, model, want = jax_partition
    rec = Records(len(data), str(tmp_path / "b-"), ".csv", 3, outputs={"blocks"}, overwrite=True)
    e = _port(data, P, 11, records=rec)
    e.model = convert.hmm_state(model)
    e._one_sweep("F", do_record=True)
    rec.close()
    got = (tmp_path / "b-blocks.csv").read_text()
    assert want.count("\t") > 5
    assert [int(x) for x in got.split("\t")] == [int(x) for x in want.split("\t")]


def test_overflow_replay_and_ceiling():
    """ShardedEngine's capacity ladder (sharded.py:1015-1137): a chunk that
    overflows the per-shard capacity is replayed at a grown capacity from
    the same streams, and its recording sweeps stay exact; at the ceiling a
    burn-in chunk runs truncated and a recording chunk raises."""
    data = synth_segments(20000, 2, seglen=50, scale=2.0)[0]  # ~200 blocks per shard
    e = _port(data, 2, 4, cap_local=128)
    e.run("M", 4, 0)
    e._resize_capacity_for_phase = lambda: None  # keep the small capacity
    e.cap_local = 128
    e.run("F", 8, 2)
    assert e.cap_local > 128
    assert set(e.marginal_counts.sum(axis=0).tolist()) == {4}

    e.max_cap_local = e.cap_local = 128
    e.sample_prior()  # ~T blocks again
    e.run("M", 2, 0)  # truncated at the ceiling: accepted
    assert e.cap_local == 128 and e.last_n_blocks > 2 * 128
    with pytest.raises(RuntimeError, match="capacity ceiling"):
        e.sample_prior()
        e.run("F", 2, 1)


def test_count_invariants():
    """test_sharded.py:244's invariants: every position recorded n_rec
    times, and the raw diff buffers sum to n_rec (one unterminated block
    per recorded sweep)."""
    data, _ = synth(T=2048, seed=1)
    e = _port(data, 8, 2)
    e.run_scheme("M 10 0 F 10 1".split())
    assert (e.marginal_counts.sum(axis=0) == 10).all()
    assert int(e.buffers.n_rec) == 10
    assert int(e.buffers.counts.sum()) == 10


def test_all_streams(tmp_path):
    """test_sharded.py:112's stream checks on the port, with mapping too:
    one line per recorded sweep, blocks and sequences cover T, the segments
    count only grows and ends at the marginals rows, rows sum to the
    recorded sweeps."""
    data, _ = synth(T=2500, seed=4)
    T = len(data)
    f = tmp_path / "d.csv"
    np.savetxt(f, data)
    argv = ["-f", str(f), "-o", str(tmp_path / "sc-"), ".csv", "-s", "3", "-a", "-R", "8",
            "-D", "8", "-i", "M", "20", "0", "F", "40", "4", "-O", *STREAMS, "mapping", "-w"]
    assert cli.main(argv) == 0
    read = lambda s: (tmp_path / f"sc-{s}.csv").read_text().splitlines()  # noqa: E731
    seq_lines = read("sequences")
    assert len(seq_lines) == 10
    for line in seq_lines:
        toks = [tok.split(":") for tok in line.split("\t")]
        assert sum(int(n) for n, _ in toks) == T
    blk_lines = read("blocks")
    assert len(blk_lines) == 10
    for line, comp in zip(blk_lines, read("compression")):
        sizes = list(map(int, line.split("\t")))
        assert sum(sizes) == T and comp == f"{T / len(sizes):.6g}"
    nsegs = [int(line.split("\t")[0]) for line in read("segments")]
    assert len(nsegs) == 10 and all(a <= b for a, b in zip(nsegs, nsegs[1:]))
    assert len(read("compression")) == 10 and len(read("parameters")) == 10
    rows = [list(map(int, line.split("\t"))) for line in read("marginals")]
    assert sum(r[0] for r in rows) == T
    assert all(sum(r[1:]) == 10 for r in rows)
    assert nsegs[-1] == len(rows)
    assert read("mapping") == ["0", "1", "2"]


# ---- checkpoints ------------------------------------------------------------------


def check_jax_checkpoint_restores(jck: str, data, make, P: int, K: int, n_rec: int, tmp_path) -> None:
    """A checkpoint ``jck`` of hammlet_tpu.checkpoint.save_sharded_checkpoint
    (P shards of ``data``, K states, n_rec recorded sweeps) restores into
    the port's engine ``make(P, records=...)`` exactly (model, (P, K
    T_local) counts, boundary union, n_rec, n_bound, cursor); the port's
    own file has the same keys and dtypes; the port continues the run, and
    every marginal row (K states) sums to all recorded sweeps; an engine of
    another shard count refuses the file."""
    T = len(data)
    rec = Records(T, str(tmp_path / "r-"), ".csv", K, overwrite=True)
    e = make(P, records=rec)
    restore_sharded_checkpoint(e, jck)
    with np.load(jck) as z:
        for name in ("theta_mean", "theta_var", "A", "pi"):
            np.testing.assert_array_equal(to_np(getattr(e.model, name)), z[name])
        np.testing.assert_array_equal(to_np(e.buffers.counts).reshape(-1), z["counts"])
        np.testing.assert_array_equal(to_np(e.buffers.everb[:, : e.T_local]).reshape(-1), z["everb"])
        assert (int(e.buffers.n_rec), int(e.buffers.n_bound)) == (int(z["n_rec"]), int(z["n_bound"]))
        assert (e.sweep_counter, e.sweeps_completed, e.cap_local) == (
            int(z["sweep_counter"]), int(z["sweeps_completed"]), int(z["cap_local"]))
        assert z["A"].shape == (K, K)
    assert int(e.buffers.n_rec) == n_rec

    tck = str(tmp_path / "port.npz")
    save_sharded_checkpoint(e, tck)
    with np.load(jck) as zj, np.load(tck) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape), k
    e.run("F", 8, 2)
    e.finalize()
    rows = [list(map(int, x.split("\t"))) for x in (tmp_path / "r-marginals.csv").read_text().splitlines()]
    assert all(len(r) == 1 + K for r in rows)
    assert sum(r[0] for r in rows) == T
    assert all(sum(r[1:]) == n_rec + 4 for r in rows)
    with pytest.raises(ValueError, match="shards"):
        restore_sharded_checkpoint(make(P // 2), jck)


def test_jax_sharded_checkpoint_restores_into_port(jax_run, tmp_path):
    """check_jax_checkpoint_restores on the JAX run's checkpoint (K = 3, P =
    8, 20 recorded sweeps)."""
    check_jax_checkpoint_restores(str(jax_run["tmp"] / "jax.npz"), jax_run["data"],
                                  lambda P, **kw: _port(jax_run["data"], P, 5, **kw), 8, 3, 20,
                                  tmp_path)


def check_resume_bitwise(make, tmp_path, f_iters: int) -> None:
    """Exact: on engines ``make()``, M 16 0 -> save -> new engine -> restore
    -> F f_iters 4 equals the uninterrupted run in the model and every
    buffer."""
    ck = str(tmp_path / "s.npz")
    e1 = make()
    e1.run("M", 16, 0)
    e1.run("F", f_iters, 4)
    e2 = make()
    e2.run("M", 16, 0)
    save_sharded_checkpoint(e2, ck)
    e3 = make()
    restore_sharded_checkpoint(e3, ck)
    e3.run("F", f_iters, 4)
    for a, b in zip(e1.model, e3.model):
        assert torch.equal(a, b)
    for name in ("counts", "everb", "n_rec", "n_bound"):
        assert torch.equal(getattr(e1.buffers, name), getattr(e3.buffers, name)), name
    assert int(e3.buffers.n_rec) == f_iters // 4 and e1.cap_local == e3.cap_local


def test_resume_bitwise_equal(tmp_path):
    """check_resume_bitwise at K = 3, P = 4, F 32 4."""
    data = synth_segments(3000, 3, seglen=200, scale=2.0)[0]
    check_resume_bitwise(lambda: _port(data, 4, 9), tmp_path, 32)


# the child of test_sharded_cli_resume_keeps_stream_lines: the CLI with
# chunks of 8 sweeps, killed at sweep 40 without closing or flushing a file
_KILLED_RUN = """
import os, sys
import torch
torch.set_num_threads(1)
from hammlet_tpu_torch import cli, runner
from hammlet_tpu_torch.parallel import sharded
runner.PHASE_CHUNK = 8
real = sharded.ShardedEngine._maybe_checkpoint
def killed_at_40(self):
    real(self)
    if self.sweeps_completed == 40:  # last checkpoint at 32, 4 records later
        os._exit(9)
sharded.ShardedEngine._maybe_checkpoint = killed_at_40
cli.main(sys.argv[1:])
"""


def test_sharded_cli_resume_keeps_stream_lines(tmp_path, monkeypatch):
    """-D 4 -C: a run killed between two checkpoints and rerun writes the
    bytes of an uninterrupted run in every stream: the resume keeps the
    checkpoint's n_rec lines of each per-sweep stream and appends (the JAX
    CLI reopens them empty, hammlet_tpu/cli.py:334-342 before :400-404)."""
    from hammlet_tpu_torch import runner

    monkeypatch.setattr(runner, "PHASE_CHUNK", 8)
    f = tmp_path / "d.csv"
    np.savetxt(f, synth_segments(1500, 3)[0])

    def argv(tag, ck):
        return ["-f", str(f), "-o", str(tmp_path / f"{tag}-"), ".csv", "-s", "3", "-a",
                "-R", "7", "-D", "4", "-i", "M", "8", "0", "F", "48", "2", "-w",
                "-O", *STREAMS, "-C", str(ck), "16"]

    assert cli.main(argv("whole", tmp_path / "whole.ckpt")) == 0
    ck = tmp_path / "cut.ckpt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _KILLED_RUN, *argv("cut", ck)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 9, proc.stderr
    with np.load(ck) as z:
        assert int(z["sweeps_completed"]) == 32 and int(z["n_rec"]) == 12
    assert cli.main(argv("cut", ck)) == 0
    for s in STREAMS:
        assert (tmp_path / f"cut-{s}.csv").read_bytes() == (tmp_path / f"whole-{s}.csv").read_bytes(), s


def test_multi_chain_sharded_own_checkpoints(tmp_path):
    """-M -C -D 2: every chain checkpoints to its own PATH-<stem> file (the
    JAX CLI hands every chain the same -C PATH, hammlet_tpu/cli.py:286-290)
    and its outputs equal a solo -D 2 run of its file; a rerun resumes each
    chain from its own finished state and changes nothing."""
    files = []
    for i, T in enumerate((800, 1100)):
        f = tmp_path / f"chr{i + 1}.csv"
        np.savetxt(f, synth_segments(T, 10 + i)[0])
        files.append(str(f))
    common = ["-s", "2", "-a", "-R", "3", "-D", "2", "-i", "M", "8", "0", "F", "12", "2",
              "-O", "marginals", "sequences", "parameters", "-w"]
    ck = tmp_path / "run.npz"
    argv = ["-M", "-f", *files, "-o", str(tmp_path / "wgs-"), ".csv", "-C", str(ck), "8", *common]
    assert cli.main(argv) == 0
    assert not ck.exists()
    outputs = {}
    for i in range(2):
        with np.load(tmp_path / f"run-chr{i + 1}.npz") as z:
            assert int(z["n_shards"]) == 2
        assert cli.main(["-f", files[i], "-o", str(tmp_path / f"solo{i}-"), ".csv", *common]) == 0
        for s in ("marginals", "sequences", "parameters"):
            outputs[i, s] = (tmp_path / f"wgs-chr{i + 1}-{s}.csv").read_bytes()
            assert outputs[i, s] == (tmp_path / f"solo{i}-{s}.csv").read_bytes(), (i, s)
    assert cli.main(argv) == 0
    for (i, s), b in outputs.items():
        assert (tmp_path / f"wgs-chr{i + 1}-{s}.csv").read_bytes() == b, (i, s)


def test_nan_model_fails_loudly():
    """tests/test_debug.py:48's check on the sharded engine: with
    HAMMLET_DEBUG=1 (the conftest's default) a NaN emission mean raises at
    the chunk's host sync."""
    assert os.environ.get("HAMMLET_DEBUG") == "1"
    data, _ = synth(T=2000, seed=2)
    e = _port(data, 4, 3)
    e.run("M", 4, 0)
    mean = e.model.theta_mean.clone()
    mean[1] = float("nan")
    e.model = e.model._replace(theta_mean=mean)
    with pytest.raises(FloatingPointError, match="emission mean"):
        e.run("F", 4, 0)


def check_thread_ranks(tmp_path, monkeypatch, data, world: int, K: int, scheme: str,
                       **engine_kw) -> None:
    """Exact: P = 4 shards of ``data`` (K states) over ``world`` ranks,
    played by threads of this process (_torch_helpers.ThreadRanks), write
    the bytes of one process holding all four after ``scheme``: the gathers
    of shard totals, maps and statistics do not depend on the shards per
    process."""
    from _torch_helpers import ThreadRanks
    from hammlet_tpu_torch.parallel.mesh import PositionMesh

    streams = {"marginals", "parameters", "compression"}

    def run(tag, mesh, rank=0):
        rec = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", K, outputs=streams,
                      overwrite=True, write=rank == 0)
        eng = tsh.make_sharded_engine(data, mesh=mesh, seed=8, records=rec, **engine_kw)
        eng.run_scheme(scheme.split())
        eng.finalize()

    run("one", PositionMesh(4, torch.device("cpu")))
    ranks = ThreadRanks(world)
    ranks.install(monkeypatch)
    ranks.run(lambda r: run("ranks", PositionMesh(4, torch.device("cpu"), group=ranks), r))
    for s in sorted(streams):
        assert (tmp_path / f"ranks-{s}.csv").read_bytes() == (tmp_path / f"one-{s}.csv").read_bytes(), s


@pytest.mark.parametrize("world", [2, 4])
def test_thread_ranks_match_one_process(tmp_path, monkeypatch, world):
    """check_thread_ranks at K = 3, T = 100,000, where the per-shard float
    sums are long enough that a summation order that depends on the shards
    per process shows in the parameters."""
    check_thread_ranks(tmp_path, monkeypatch, synth_segments(100_000, 21)[0], world, 3,
                       "M 16 0 F 32 4", nr_params=3)
