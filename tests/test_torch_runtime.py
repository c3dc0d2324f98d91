"""The run-time behaviour of the port's engines against the JAX package
(hammlet_tpu/runner.py, hammlet_tpu/parallel/sharded.py): capacity-scaled
chunk lengths, the HAMMLET_* run switches, metrics(), the record drain that
overlaps the next chunk, the threaded -M path and the thread-safe first-use
build; and the single-sweep and Beta/Geometric APIs."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import synth_segments, to_np, to_torch, toy_problem, cpu_requested  # noqa: F401
from hammlet_tpu import runner as jrun
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.samplers import sweep as jsw
from hammlet_tpu_torch import _build, cli, convert, runner
from hammlet_tpu_torch.models import distributions as td
from hammlet_tpu_torch.ops import blocks as tb
from hammlet_tpu_torch.ops import wavelet_cuda
from hammlet_tpu_torch.parallel import sharded as tsh
from hammlet_tpu_torch.samplers import sweep as tsw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "mapping", "segments")
CAPACITIES = [128, 2**11, 2**11 + 128, 2**13, 2**15, 2**17, 2**17 + 128, 2**23]


# ---- chunk lengths, run switches, metrics ----------------------------------------


@pytest.mark.parametrize("scale", [True, False], ids=["scaled", "fixed"])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_chunk_table_matches_jax(capacity, scale, monkeypatch):
    """Exact: the port's _chunk_for_capacity is the JAX package's table,
    with its scaling turned on (as off a TPU's CPU) and off."""
    monkeypatch.setattr(jrun, "_scale_chunks", lambda: scale)
    assert runner._chunk_for_capacity(capacity, scale) == jrun._chunk_for_capacity(capacity)


def test_scaling_only_on_a_card_without_a_pinned_chunk(monkeypatch):
    """Chunks scale on a cuda device unless HAMMLET_PHASE_CHUNK pins them;
    never on the CPU (the JAX package's rule off a TPU)."""
    monkeypatch.delenv("HAMMLET_PHASE_CHUNK", raising=False)
    assert runner._scale_chunks(torch.device("cuda", 0))
    assert not runner._scale_chunks(torch.device("cpu"))
    monkeypatch.setenv("HAMMLET_PHASE_CHUNK", "64")
    assert not runner._scale_chunks(torch.device("cuda", 0))


def test_env_switches_match_jax():
    """HAMMLET_PHASE_CHUNK and HAMMLET_MAX_CAPACITY set the same module
    constants in both packages, and HAMMLET_SETUP_TRACE prints the same
    stages from make_engine and make_sharded_engine."""
    code = (
        "import numpy as np\n"
        "from hammlet_tpu import runner as j\n"
        "from hammlet_tpu_torch import runner as t\n"
        "from hammlet_tpu_torch.parallel import sharded\n"
        "assert (t.PHASE_CHUNK, t._MAX_CAPACITY) == (j.PHASE_CHUNK, j._MAX_CAPACITY) == (24, 4096)\n"
        "d = np.random.default_rng(0).normal(0, 1, 3000).astype(np.float32)\n"
        "t.make_engine(d, device='cpu')\n"
        "sharded.make_sharded_engine(d, n_devices=2, device='cpu')\n"
    )
    env = dict(os.environ, HAMMLET_PHASE_CHUNK="24", HAMMLET_MAX_CAPACITY="4096",
               HAMMLET_SETUP_TRACE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stages = [line.split("] ", 1)[1].split(" (")[0] for line in proc.stderr.splitlines()
              if line.startswith("[setup +")]
    assert stages == ["ingest done", "autoprior done", "engine init done"] * 2


def test_metrics_have_the_jax_keys():
    """Engine.metrics() and ShardedEngine.metrics() return the JAX
    package's keys, with the rate from phase_log."""
    data = synth_segments(3000, 1)[0]
    je = jrun.make_engine(data, seed=1)
    je.run("M", 4, 0)
    for eng, jkeys in (
        (runner.make_engine(data, seed=1, device="cpu"), je.metrics()),
        (tsh.make_sharded_engine(data, n_devices=2, seed=1, device="cpu"),
         ["sweeps", "sweeps_per_second", "positions_per_second",
          "positions_per_second_per_chip", "n_devices", "block_capacity_per_shard",
          "recorded_sweeps"]),
    ):
        eng.run("M", 4, 0)
        eng.run("F", 6, 2)
        m = eng.metrics()
        assert sorted(m) == sorted(jkeys)
        assert m["sweeps"] == 10 and m["recorded_sweeps"] == 3
        assert m["sweeps_per_second"] == pytest.approx(eng.sweeps_per_second)


def test_profile_switch_writes_one_trace_per_phase(tmp_path, monkeypatch):
    """HAMMLET_PROFILE=<dir>: one torch.profiler trace per phase."""
    monkeypatch.setenv("HAMMLET_PROFILE", str(tmp_path / "prof"))
    eng = runner.make_engine(synth_segments(2000, 2)[0], seed=2, device="cpu")
    eng.run("M", 2, 0)
    eng.run("F", 2, 1)
    traces = list((tmp_path / "prof").iterdir())
    assert len(traces) == 2 and all(t.stat().st_size > 0 for t in traces)


# ---- the overlapped record drain -------------------------------------------------


def _inline(monkeypatch):
    """Make every drain run on the launching thread, at once."""
    monkeypatch.setattr(runner.RecordDrain, "submit", lambda self, fn, *args: fn(*args))


def _argv(data_path, out, extra=()):
    return ["-f", str(data_path), "-o", str(out), ".csv", "-s", "3", "-a", "-R", "4",
            "-i", "M", "8", "0", "F", "48", "2", "-O", *STREAMS, "-w", *extra]


def _read(prefix):
    return {s: Path(f"{prefix}{s}.csv").read_bytes() for s in STREAMS}


@pytest.fixture(scope="module")
def data20k(tmp_path_factory):
    path = tmp_path_factory.mktemp("d") / "d.csv"
    np.savetxt(path, synth_segments(20000, 21, seglen=400)[0])
    return path


@pytest.mark.parametrize("shards", [1, 4], ids=["Engine", "ShardedEngine"])
def test_overlapped_drain_writes_the_inline_bytes(data20k, tmp_path, monkeypatch, shards):
    """Exact: T = 20,000, all seven outputs, an F phase of six 8-sweep
    chunks: the drain on its worker thread writes the bytes of the drain
    made inline, for Engine and for ShardedEngine (-D 4); the worker ran
    every drain, and no drain thread outlives the run."""
    monkeypatch.setattr(runner, "PHASE_CHUNK", 8)
    extra = ("-D", "4") if shards > 1 else ()
    threads = []
    owner = runner.Engine if shards == 1 else tsh.ShardedEngine
    real = owner._write_records

    def spy(self, *args):
        threads.append(threading.current_thread().name)
        return real(self, *args)

    monkeypatch.setattr(owner, "_write_records", spy)
    assert cli.main(_argv(data20k, tmp_path / "over-", extra)) == 0
    assert len(threads) == 6 and all(t.startswith("hammlet-drain") for t in threads)
    assert not any(t.name.startswith("hammlet-drain") for t in threading.enumerate())
    _inline(monkeypatch)
    threads.clear()
    assert cli.main(_argv(data20k, tmp_path / "inline-", extra)) == 0
    assert threads == [threading.current_thread().name] * 6
    over, inline = _read(tmp_path / "over-"), _read(tmp_path / "inline-")
    assert len(over["sequences"].splitlines()) == 24
    assert over == inline


# the killed child of test_killed_and_resumed_run_writes_the_inline_bytes:
# 8-sweep chunks, checkpoints every 16 sweeps, killed at sweep 40 while the
# drain of that chunk may still be writing
_KILLED = """
import os, sys
import torch
torch.set_num_threads(1)
from hammlet_tpu_torch import cli, runner
runner.PHASE_CHUNK = 8
real = runner.Engine._maybe_checkpoint
def killed_at_40(self):
    real(self)
    if self.sweeps_completed == 40:
        os._exit(9)
runner.Engine._maybe_checkpoint = killed_at_40
cli.main(sys.argv[1:])
"""


def test_killed_and_resumed_run_writes_the_inline_bytes(data20k, tmp_path, monkeypatch):
    """Exact: a -C run with the overlapped drain, killed with os._exit
    between two checkpoints and rerun, writes the bytes of an uninterrupted
    run whose drain was made inline: each checkpoint waited for the drain
    and flushed the streams before its save."""
    ck = tmp_path / "cut.ckpt"
    argv = _argv(data20k, tmp_path / "cut-", ("-C", str(ck), "16"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _KILLED, *argv], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 9, proc.stderr
    with np.load(ck) as z:
        assert int(z["sweeps_completed"]) == 32 and int(z["n_records"]) == 12
    monkeypatch.setattr(runner, "PHASE_CHUNK", 8)
    assert cli.main(argv) == 0
    _inline(monkeypatch)
    assert cli.main(_argv(data20k, tmp_path / "whole-", ("-C", str(tmp_path / "w.ckpt"), "16"))) == 0
    assert _read(tmp_path / "cut-") == _read(tmp_path / "whole-")


@pytest.mark.parametrize("fail_at", [1, 3], ids=["mid-phase", "last-chunk"])
def test_failing_drain_fails_the_run(data20k, tmp_path, monkeypatch, capsys, fail_at):
    """A drain that raises on its worker makes the phase raise on the
    launching thread (at the next chunk's hand-off or at the phase end),
    and the CLI exit non-zero; the worker is stopped."""
    monkeypatch.setattr(runner, "PHASE_CHUNK", 16)
    calls = []
    real = runner.Engine._write_records

    def broken(self, *args):
        calls.append(1)
        if len(calls) == fail_at:
            raise OSError("disk full")
        return real(self, *args)

    monkeypatch.setattr(runner.Engine, "_write_records", broken)
    assert cli.main(_argv(data20k, tmp_path / "x-")) == 1
    assert "disk full" in capsys.readouterr().err
    assert not any(t.name.startswith("hammlet-drain") for t in threading.enumerate())
    eng = runner.make_engine(synth_segments(3000, 5)[0], seed=5, device="cpu", records=None)
    eng.records = mock.MagicMock(enabled={"parameters"})
    calls.clear()
    with pytest.raises(OSError, match="disk full"):
        eng.run("F", 48, 2)


# ---- threaded -M ------------------------------------------------------------------


def test_threaded_multi_chain_matches_sequential(tmp_path, monkeypatch):
    """Exact: with _chain_devices giving two (CPU) devices, three -M chains
    run in two threads and write the bytes of the sequential run; both
    threads ran a chain, each with its device passed down."""
    files = []
    for i, T in enumerate((1500, 2200, 1800)):
        f = tmp_path / f"chr{i + 1}.csv"
        np.savetxt(f, synth_segments(T, 30 + i)[0])
        files.append(str(f))

    def argv(prefix):
        return ["-M", "-f", *files, "-o", str(tmp_path / prefix), ".csv", "-s", "3", "-a",
                "-R", "6", "-i", "M", "8", "0", "F", "24", "2", "-O", *STREAMS, "-w"]

    seen, barrier = [], threading.Barrier(2, timeout=60)
    real = cli._run_chain

    def spy(sub, device, turn):
        seen.append((threading.get_ident(), str(device)))
        if len(seen) <= 2:
            barrier.wait()  # the first two chains hold two threads at once
        return real(sub, device, turn)

    monkeypatch.setattr(cli, "_run_chain", spy)
    monkeypatch.setattr(cli, "_chain_devices", lambda: [torch.device("cpu")] * 2)
    assert cli.main(argv("par-")) == 0
    assert len(seen) == 3 and len({t for t, _ in seen}) == 2
    assert threading.get_ident() not in {t for t, _ in seen}
    monkeypatch.setattr(cli, "_chain_devices", lambda: [torch.device("cpu")])
    assert cli.main(argv("seq-")) == 0
    assert len(seen) == 3  # one device: the chains ran one after another
    for i in range(3):
        assert _read(tmp_path / f"par-chr{i + 1}-") == _read(tmp_path / f"seq-chr{i + 1}-"), i


def test_threaded_chains_take_turns_at_phases(tmp_path, monkeypatch):
    """Chains in threads never sample two phases at once (the lock the CLI
    gives their engines), while both chains' threads run; every phase of
    both chains ran."""
    files = []
    for i, T in enumerate((1200, 1600)):
        f = tmp_path / f"c{i}.csv"
        np.savetxt(f, synth_segments(T, 40 + i)[0])
        files.append(str(f))
    active, peak, phases, threads = [0], [0], [], set()
    lock = threading.Lock()
    real = runner.Engine._run_phase

    def spy(self, *args, **kwargs):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            phases.append(args[0])
            threads.add(threading.get_ident())
        try:
            return real(self, *args, **kwargs)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(runner.Engine, "_run_phase", spy)
    monkeypatch.setattr(cli, "_chain_devices", lambda: [torch.device("cpu")] * 2)
    argv = ["-M", "-f", *files, "-o", str(tmp_path / "t-"), ".csv", "-s", "3", "-a", "-R", "2",
            "-i", "M", "6", "0", "F", "12", "2", "-O", "marginals", "-w"]
    assert cli.main(argv) == 0
    assert peak[0] == 1 and sorted(phases) == ["F", "F", "M", "M"] and len(threads) == 2


def test_engines_outside_the_cli_do_not_take_turns(monkeypatch):
    """Two engines a library caller drives from two threads sample their
    phases at the same time: only the CLI's -M chains share a turn."""
    barrier = threading.Barrier(2, timeout=60)
    real = runner.Engine._run_phase

    def spy(self, *args, **kwargs):
        barrier.wait()  # both phases are running at once
        return real(self, *args, **kwargs)

    monkeypatch.setattr(runner.Engine, "_run_phase", spy)
    engines = [runner.make_engine(synth_segments(1500, 50 + i)[0], seed=i, device="cpu")
               for i in range(2)]
    threads = [threading.Thread(target=e.run, args=("F", 4, 0)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not barrier.broken and all(len(e.phase_log) == 1 for e in engines)


def test_last_drain_closes_outside_the_turn(monkeypatch):
    """A phase waits for its last record drain after it has given up its
    turn, so another chain's phase can start meanwhile."""
    eng = runner.make_engine(synth_segments(3000, 5)[0], seed=5, device="cpu")
    eng.records = mock.MagicMock(enabled={"parameters"})
    eng.phase_turn = turn = threading.Lock()
    held = []
    real = runner.RecordDrain.close
    monkeypatch.setattr(runner.RecordDrain, "close",
                        lambda self: held.append(turn.locked()) or real(self))
    eng.run("F", 8, 2)
    assert held == [False] and eng.records.record_theta.call_count == 4


def _fake_chains(monkeypatch, tmp_path, n, fn):
    """-M argv over ``n`` empty files whose chains run ``fn(stem)`` in place
    of the sampler."""
    files = [tmp_path / f"chr{i + 1}.csv" for i in range(n)]
    for f in files:
        f.write_text("0\n")
    real = cli._run

    def run(sub, device=None, turn=None):
        if "-M" in sub:  # the CLI's own call, which splits the chains
            return real(sub, device, turn)
        return fn(Path(sub["-f"][0]).stem)

    monkeypatch.setattr(cli, "_run", run)
    return ["-M", "-f", *map(str, files), "-a"]


@pytest.mark.parametrize("n_devices", [1, 2], ids=["sequential", "threads"])
def test_multi_chain_exit_code_is_the_largest(tmp_path, monkeypatch, n_devices):
    """Both -M paths exit with the largest of the chains' codes."""
    codes = {"chr1": 1, "chr2": 2, "chr3": 0}
    argv = _fake_chains(monkeypatch, tmp_path, 3, codes.__getitem__)
    monkeypatch.setattr(cli, "_chain_devices", lambda: [torch.device("cpu")] * n_devices)
    assert cli.main(argv) == 2


@pytest.mark.parametrize("n_devices", [1, 2], ids=["sequential", "threads"])
def test_failing_chain_stops_the_chains_not_started(tmp_path, monkeypatch, capsys, n_devices):
    """A chain that raises fails -M, and no chain starts after it: the
    sequential loop stops; the threads cancel the chains still queued (the
    running first chain finishes)."""
    started = []

    def chain(stem):
        started.append(stem)
        if stem == "chr2":
            raise OSError("chain 2 failed")
        time.sleep(0.5)
        return 0

    argv = _fake_chains(monkeypatch, tmp_path, 5, chain)
    monkeypatch.setattr(cli, "_chain_devices", lambda: [torch.device("cpu")] * n_devices)
    assert cli.main(argv) == 1
    assert "chain 2 failed" in capsys.readouterr().err
    if n_devices == 1:
        assert started == ["chr1", "chr2"]
    else:  # the thread chain 2 freed may take chain 3 before the others are cancelled
        assert set(started[:2]) == {"chr1", "chr2"} and set(started) <= {"chr1", "chr2", "chr3"}


# ---- thread-safe first-use build --------------------------------------------------


def test_cold_build_from_two_threads_builds_once(tmp_path, monkeypatch):
    """Two threads reaching the kernel library's first use together on a
    cold build directory both succeed, share one library object, and nvcc
    (a stub script on PATH) ran once."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bin_dir / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo run >> {log}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
    )
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(wavelet_cuda, "_lib", None)
    opened = []
    monkeypatch.setattr(wavelet_cuda.ctypes, "CDLL", lambda path: opened.append(path) or mock.MagicMock())
    barrier = threading.Barrier(2, timeout=60)
    libs, errors = [], []

    def first_use():
        barrier.wait()
        try:
            libs.append(wavelet_cuda._library())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(libs) == 2 and libs[0] is libs[1]
    assert log.read_text().splitlines() == ["run"] and len(opened) == 1
    built = list((tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].read_text() == "built\n"  # no .tmp left


def test_two_libraries_build_side_by_side(tmp_path, monkeypatch):
    """Builds of two different libraries from two threads run their nvcc
    at the same time (chip_smoke.py starts them together); each build
    still takes its own library's lock. The stub nvcc (on PATH) notes when
    it starts and ends."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bin_dir / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo start >> {log}\n"
        "sleep 0.5\n"
        f"echo end >> {log}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
    )
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    sources = []
    for name in ("one", "two"):
        src = tmp_path / f"{name}.cu"
        src.write_text(name)
        sources.append(src)
    threads = [threading.Thread(target=_build.build, args=(src.stem, [src])) for src in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert log.read_text().splitlines() == ["start", "start", "end", "end"]
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "build").iterdir()) == ["libone", "libtwo"]


def test_launch_counter_loses_no_update_across_threads():
    """Stress: 16 threads add 2000 launches each to one wrapper's counter
    (wavelet_cuda._count, as -M chains do) with the switch interval
    shortened; no update is lost."""
    fn = wavelet_cuda.maxlet_transform_cuda
    start, old = fn.launches, sys.getswitchinterval()

    def count():
        for _ in range(2000):
            wavelet_cuda._count(fn)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches - start == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        fn.launches = start


# ---- APIs -------------------------------------------------------------------------


def test_emission_log_weights_match_jax():
    """rtol 1e-5: the untransposed (B, K) layout."""
    p = toy_problem(B=30, seed=4, pad=6)
    args = [p["stats"], p["sizes"], p["theta_mean"], p["theta_var"], p["mapping"]]
    want = jd.emission_log_weights(*map(jnp.asarray, args))
    got = td.emission_log_weights(*[to_torch(a) for a in args[:4]], to_torch(p["mapping"], torch.int64))
    assert got.shape == (36, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_beta_geometric_family_matches_jax():
    """Exact for the update; rtol 1e-6 for the log-weights and the
    threshold statistic; beta_sample given JAX's Gammas rtol 1e-6, and its
    own draws' moments within 6 standard errors of Beta(a, b)'s."""
    rng = np.random.default_rng(3)
    prior = rng.uniform(0.5, 3.0, size=(4, 2)).astype(np.float32)
    sums = rng.uniform(0, 50, size=4).astype(np.float32)
    counts = rng.integers(0, 20, size=4).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(td.beta_update(to_torch(prior), to_torch(sums), to_torch(counts))),
        np.asarray(jd.beta_update(jnp.asarray(prior), jnp.asarray(sums), jnp.asarray(counts))),
    )
    theta = rng.uniform(0.05, 0.95, size=3).astype(np.float32)
    bsums = rng.uniform(0, 30, size=10).astype(np.float32)
    bsizes = rng.integers(1, 9, size=10).astype(np.int32)
    np.testing.assert_allclose(
        to_np(td.geometric_log_weights(to_torch(bsums), to_torch(bsizes), to_torch(theta))),
        np.asarray(jd.geometric_log_weights(jnp.asarray(bsums), jnp.asarray(bsizes), jnp.asarray(theta))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(td.beta_threshold_value(to_torch(theta))),
        float(jd.beta_threshold_value(jnp.asarray(theta))), rtol=1e-6,
    )
    key = jax.random.PRNGKey(8)
    ka, kb = jax.random.split(key)
    ga = jax.random.gamma(ka, jnp.asarray(prior[:, 0]))
    gb = jax.random.gamma(kb, jnp.asarray(prior[:, 1]))
    np.testing.assert_allclose(
        to_np(td.beta_sample(None, to_torch(prior), gammas=(to_torch(ga), to_torch(gb)))),
        np.asarray(jd.beta_sample(key, jnp.asarray(prior))), rtol=1e-6,
    )
    n = 20000
    params = torch.tensor([[2.0, 5.0]]).repeat(n, 1)
    draws = to_np(td.beta_sample(torch.Generator().manual_seed(1), params)).astype(np.float64)
    a, b = 2.0, 5.0
    mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(draws.mean() - mean) < 6 * np.sqrt(var / n)
    assert abs(draws.var() - var) < 6 * var * np.sqrt(2 / n) + 1e-4


@pytest.mark.parametrize("thr", [0.5, 2.0, 4.0])
def test_block_builders_match_jax(thr):
    """Exact: make_blocks at a capacity below and above the count,
    blocks_from_sizes, split_block_sizes (and its guard), PrefixStats.r."""
    T = 3000
    w = np.random.default_rng(7).exponential(1.0, size=T).astype(np.float32)
    w[0] = np.inf
    for cap in (64, 4096):
        want = jb.make_blocks(jnp.asarray(w), jnp.float32(thr), cap)
        got = tb.make_blocks(torch.from_numpy(w), torch.tensor(np.float32(thr)), cap)
        for f in want._fields:
            np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    sizes = [5, 3, 9, 1, 12]
    for cap in (None, 8):
        want, got = jb.blocks_from_sizes(sizes, cap), tb.blocks_from_sizes(sizes, cap)
        for f in want._fields:
            np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert tb.split_block_sizes(sizes, 2, 4) == jb.split_block_sizes(sizes, 2, 4) == [5, 3, 5, 4, 1, 12]
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="Cannot split"):
            mod.split_block_sizes(sizes, 3, 1)
        with pytest.raises(ValueError):
            mod.blocks_from_sizes([2, 0])
    data = np.random.default_rng(1).normal(0, 1, size=(T, 2))
    np.testing.assert_array_equal(
        to_np(tb.build_prefix_stats(data).r), np.asarray(jb.build_prefix_stats(data).r)
    )


@pytest.mark.parametrize("method", ["M", "F"])
def test_gibbs_sweep_given_jax_gumbels(method):
    """Exact: one gibbs_sweep fed the JAX sweep's Gumbels (its key splits,
    sweep.py:261 and forward_backward.py) samples the JAX states, with the
    same sizes, block count and threshold, and records the same buffers;
    position_states expands them to the same per-position states. The
    model update draws from another stream and is not compared."""
    data = synth_segments(4000, 6, seglen=250, scale=1.5)[0]
    je = jrun.make_engine(data, seed=6)
    je.run("M", 6, 0)
    cap = je.ing.T  # every block count fits
    jpos, jrank = jb.bucket_candidates(je.ing.ranked, cap)
    key = jax.random.PRNGKey(17)
    mapping = je.spec.mapping().astype(np.int32)
    model, jbuf, out = jsw.gibbs_sweep(
        key, je.model, je.priors, je.ing.ranked, jpos, jrank, je.ing.prefix,
        jsw.RecordBuffers.create(je.ing.T, 3), jnp.bool_(True), jnp.bool_(True),
        jnp.float32(0.0), method=method, capacity=cap, spec_nr_params=3,
        mapping_tuple=tuple(map(tuple, mapping.tolist())), use_self_transitions=True,
    )
    k_states, _ = jax.random.split(key)
    if method == "M":
        noise = to_torch(jax.random.gumbel(k_states, (3, cap), dtype=jnp.float32))
    else:
        k_last, k_maps = jax.random.split(k_states)
        noise = (to_torch(jax.random.gumbel(k_last, (1, 3), dtype=jnp.float32)),
                 to_torch(jax.random.gumbel(k_maps, (3, 3, cap), dtype=jnp.float32)))
    tpos, trank = convert.candidates(jpos, jrank)
    tbuf = tsw.RecordBuffers.create(je.ing.T, 3)
    _, buf, got = tsw.gibbs_sweep(
        torch.Generator().manual_seed(0), convert.hmm_state(je.model), convert.hmm_priors(je.priors),
        convert.ranked_weights(je.ing.ranked), tpos, trank, convert.prefix_stats(je.ing.prefix),
        tbuf, method=method, nr_params=3, mapping=torch.from_numpy(mapping.astype(np.int64)),
        noise=noise,
    )
    assert buf is tbuf and isinstance(got, tsw.SweepOutputs)
    n = int(out.n_blocks)
    assert int(got.n_blocks) == n and 10 < n <= cap
    np.testing.assert_array_equal(to_np(got.states)[:n], np.asarray(out.states)[:n])
    np.testing.assert_array_equal(to_np(got.sizes), np.asarray(out.sizes))
    assert float(got.threshold) == float(out.threshold)
    np.testing.assert_array_equal(to_np(buf.counts), np.asarray(jbuf.counts))
    np.testing.assert_array_equal(to_np(buf.ever_boundary), np.asarray(jbuf.ever_boundary))
    starts = np.concatenate([[0], np.cumsum(np.asarray(out.sizes))[:-1]])
    starts = np.where(np.asarray(out.sizes) > 0, starts, je.ing.T)
    np.testing.assert_array_equal(
        to_np(tsw.position_states(got.states, torch.from_numpy(starts), got.n_blocks, je.ing.T)),
        np.asarray(jsw.position_states(out.states, jnp.asarray(starts, jnp.int32), out.n_blocks, je.ing.T)),
    )
