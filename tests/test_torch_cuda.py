"""Tests of the port that need an NVIDIA card; they skip without one.

This file imports neither jax nor hammlet_tpu, so it also runs on a
machine that has the card but no JAX (there, without the repo's
conftest.py, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The plain torch versions these tests hold the kernels against are checked
bitwise against the JAX package and the golden model by the CPU tests
(tests/test_torch_wavelet.py).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_helpers import (  # noqa: F401
    VOTE_CASES, assert_bitwise, cuda_device, eager_engine, sweep_like_matrices, synth_segments,
    vote_noise,
)
from hammlet_tpu_torch import cli, runner
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.ops import wavelet, wavelet_cuda

torch.set_num_threads(1)


@pytest.mark.cuda
def test_capture_after_prior_draw_fits_the_card_on_card(cuda_device):
    """On the card, in a process of its own (fbscan_probes.py prior_peak
    81): the first F phase right after a prior draw at K = 81 (-s C 3 4,
    T = 400,000 x 4) runs at capacity ~T; its sweeps' warm-ups leave ~41 GB
    in the allocator's cache, more than the card has free, so the cache
    goes back to the card before each capture: the phase runs, and the
    process reserves at most 1.1x the most it held allocated. (With the
    cache kept, the capture ran out of memory on an NVIDIA H100 80GB HBM3:
    62,506 MiB reserved.) First in this file: the other process needs ~42
    GB of the card, more than later tests' leftovers in this one leave."""
    import gc
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    gc.collect()  # engines of earlier tests, held in reference cycles
    torch.cuda.empty_cache()  # this process's cache is the other process's room
    proc = subprocess.run([sys.executable, str(repo / "fbscan_probes.py"), "prior_peak", "81"],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("PRIOR_PEAK "))
    row = json.loads(line.split(" ", 1)[1])
    assert row["error"] is None, row["error"]
    assert row["capacity"] >= 300_000, row
    assert row["peak_reserved_mib"] <= 1.1 * (row["base_mib"] + row["peak_allocated_mib"]), row


@pytest.mark.cuda
@pytest.mark.parametrize("T", [100, 8192, 8193, 20000, 65536, 100000])
@pytest.mark.parametrize("dim", [1, 3])
def test_kernel_bitwise_on_card(cuda_device, T, dim):
    """Tolerance: bitwise. The transform through the Hopper kernels against
    the plain torch version on the card and on the CPU; each call counts one
    transform."""
    data = np.random.default_rng(T + dim).normal(1, 2, size=(T, dim)).astype(np.float32)
    x = torch.from_numpy(data).to(cuda_device)
    before = wavelet_cuda.maxlet_transform_cuda.launches
    got = wavelet_cuda.maxlet_transform_cuda(x)
    torch.cuda.synchronize()
    assert wavelet_cuda.maxlet_transform_cuda.launches == before + 1
    assert_bitwise(got, wavelet.maxlet_transform(x))
    assert_bitwise(got, wavelet.maxlet_transform(torch.from_numpy(data)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8193, 2**20 + 1])
@pytest.mark.parametrize("dim", [1, 3])
def test_each_kernel_bitwise_vs_its_plain_version(cuda_device, T, dim):
    """Tolerance: bitwise. The chunk kernel against maxlet_chunks_reference
    (coefficients and totals) and the cross kernel against
    maxlet_cross_reference on the same inputs, each plain version run on
    the card and on the CPU; a transform launches each kernel once."""
    data = np.random.default_rng(T * 3 + dim).normal(1, 2, size=(T, dim)).astype(np.float32)
    x = torch.from_numpy(data).to(cuda_device)
    counters = (wavelet_cuda.maxlet_transform_cuda, wavelet_cuda.maxlet_chunks_cuda,
                wavelet_cuda.maxlet_cross_cuda)
    before = [f.launches for f in counters]
    wavelet_cuda.maxlet_transform_cuda(x)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    coeffs, totals = wavelet_cuda.maxlet_chunks_cuda(x)
    crossed = wavelet_cuda.maxlet_cross_cuda(coeffs.clone(), totals)
    torch.cuda.synchronize()
    for inp in (x, torch.from_numpy(data)):
        want_c, want_t = wavelet_cuda.maxlet_chunks_reference(inp)
        assert_bitwise(coeffs, want_c)
        assert_bitwise(totals, want_t)
        assert_bitwise(crossed, wavelet_cuda.maxlet_cross_reference(
            coeffs.to(inp.device, copy=True), totals.to(inp.device)))
    assert_bitwise(crossed, wavelet.maxlet_transform(torch.from_numpy(data)))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 5])
def test_kernel_unaligned_and_wide_rows_on_card(cuda_device, dim):
    """Tolerance: bitwise. Rows that start off a 16-byte boundary, and
    dims without a vector-load instance (2, 5), take the kernel's
    scalar-load instance."""
    T = 3 * 8192 + 77
    data = np.random.default_rng(dim).normal(0, 1, size=(T + 1) * dim).astype(np.float32)
    buf = torch.from_numpy(data).to(cuda_device)
    want = wavelet.maxlet_transform(torch.from_numpy(data[dim:].reshape(T, dim)))
    for x in (buf[dim:].view(T, dim), buf[: T * dim].view(T, dim)):
        assert_bitwise(wavelet_cuda.maxlet_transform_cuda(x),
                       wavelet.maxlet_transform(x.cpu()))
    assert_bitwise(wavelet_cuda.maxlet_transform_cuda(buf[dim:].view(T, dim)), want)


@pytest.mark.cuda
def test_ingest_device_defaults_to_card(cuda_device):
    """With no device, ingest_device runs on the card through both kernels
    (and the host ingest uploads to the card)."""
    data = synth_segments(50000, 13)[0]
    counters = (wavelet_cuda.maxlet_chunks_cuda, wavelet_cuda.maxlet_cross_cuda)
    before = [f.launches for f in counters]
    ing = runner.ingest_device(data)
    assert ing.weights.device.type == "cuda"
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1]
    assert_bitwise(ing.weights, runner.ingest_device(data, device="cpu").weights)
    assert runner.ingest(data).weights.device.type == "cuda"


@pytest.mark.cuda
def test_kernel_propagates_nan_on_card(cuda_device):
    """Same NaN positions as the plain version, bitwise elsewhere."""
    data = np.random.default_rng(1).normal(0, 1, size=(30000, 3)).astype(np.float32)
    data[[5, 8191, 8192, 20000], [2, 0, 1, 2]] = np.nan
    x = torch.from_numpy(data).to(cuda_device)
    got = wavelet_cuda.maxlet_transform_cuda(x).cpu().numpy()
    want = wavelet.maxlet_transform(x).cpu().numpy()
    nan = np.isnan(want)
    assert nan.sum() > 20
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert_bitwise(got[~nan], want[~nan])


@pytest.mark.cuda
def test_main_path_on_card(cuda_device, tmp_path):
    """On the card, device ingest runs one transform through the Hopper
    kernels and the slice records every sweep it should."""
    data = synth_segments(50000, 5)[0]
    rec = Records(
        len(data), str(tmp_path / "cuda-"), ".csv", 3,
        outputs={"marginals", "parameters", "compression"}, overwrite=True,
    )
    wavelet_cuda.maxlet_transform_cuda.launches = 0
    eng = runner.make_engine(data, seed=1, records=rec, device_ingest=True, device=cuda_device)
    eng.run_scheme("M 20 0 F 60 2".split())
    eng.finalize()
    assert wavelet_cuda.maxlet_transform_cuda.launches == 1
    assert eng.device.type == "cuda"
    assert set(eng.marginal_counts.sum(axis=0).tolist()) == {30}
    assert len((tmp_path / "cuda-parameters.csv").read_text().splitlines()) == 30


@pytest.mark.cuda
def test_phase_chunk_never_syncs(cuda_device):
    """A whole recording chunk of sweeps queues its work with no host sync
    (torch's sync debug mode raises on any): the engine's single sync per
    chunk is on ``diag``."""
    from hammlet_tpu_torch.samplers import sweep

    data = synth_segments(50000, 6)[0]
    eng = runner.make_engine(data, seed=2, device_ingest=True, device=cuda_device)
    eng.run("M", 10, 0)
    eng.capacity = eng.ing.T  # no overflow: every recording sweep records
    cand_pos, cand_rank = eng._candidates()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for method in ("M", "F"):
            out = sweep.gibbs_phase(
                eng.seed, 99, eng.model, eng.priors, eng.ing.ranked, cand_pos,
                cand_rank, eng.ing.prefix, eng.buffers, None, method=method,
                nr_params=3, mapping=eng._mapping, use_self_transitions=True,
                n_iters=8, thinning=2, cell_bits=eng.ing.cell_bits, record=True,
            )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[3][0]) <= eng.capacity
    assert int(eng.buffers.n_records) == 8


@pytest.mark.cuda
def test_cli_all_streams_on_card(cuda_device, tmp_path):
    """The port's CLI on the card with all seven outputs: every per-sweep
    stream has one line per recorded sweep, blocks and sequences cover T,
    the last segments line counts the marginals rows."""
    from hammlet_tpu_torch import cli

    T = 20000
    np.savetxt(tmp_path / "d.csv", synth_segments(T, 7)[0])
    streams = ["marginals", "sequences", "parameters", "blocks", "compression", "mapping", "segments"]
    argv = ["-f", str(tmp_path / "d.csv"), "-s", "3", "-a", "-R", "2",
            "-i", "M", "20", "0", "F", "40", "2", "-O", *streams, "-w",
            "-C", str(tmp_path / "ck.npz"), "16"]
    assert cli.main(argv) == 0
    read = lambda s: (tmp_path / f"d-{s}.csv").read_text().splitlines()  # noqa: E731
    for s in ("sequences", "parameters", "blocks", "compression", "segments"):
        assert len(read(s)) == 20, s
    for line in read("blocks"):
        assert sum(map(int, line.split("\t"))) == T
    for line in read("sequences"):
        assert sum(int(t.split(":")[0]) for t in line.split("\t")) == T
    rows = [list(map(int, x.split("\t"))) for x in read("marginals")]
    assert all(sum(r[1:]) == 20 for r in rows) and sum(r[0] for r in rows) == T
    assert int(read("segments")[-1].split("\t")[0]) == len(rows)
    before = {s: read(s) for s in streams}
    assert cli.main(argv) == 0  # finished checkpoint: a no-op
    assert {s: read(s) for s in streams} == before


@pytest.mark.cuda
def test_resume_bitwise_on_card(cuda_device, tmp_path):
    """Exact on the card: save -> restore -> continue equals the
    uninterrupted run in the marginal counts and the model."""
    from hammlet_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    data = synth_segments(50000, 9)[0]

    def build():
        return runner.make_engine(data, seed=3, device=cuda_device)

    e1 = build()
    e1.run("M", 16, 0)
    e1.run("F", 32, 4)
    e2 = build()
    e2.run("M", 16, 0)
    save_checkpoint(e2, str(tmp_path / "c.npz"))
    e3 = build()
    restore_checkpoint(e3, str(tmp_path / "c.npz"))
    e3.run("F", 32, 4)
    assert torch.equal(e1.buffers.counts, e3.buffers.counts)
    assert torch.equal(e1.model.theta_mean, e3.model.theta_mean)
    assert int(e3.buffers.n_records) == 8


@pytest.mark.cuda
def test_sharded_chunk_on_card(cuda_device, tmp_path):
    """The sharded engine, 4 shards on the card: a recording F chunk queues
    its work with no host sync, and the finished run's marginal rows sum to
    the recorded sweeps."""
    from hammlet_tpu_torch.parallel import sharded

    data = synth_segments(50000, 11)[0]
    rec = Records(len(data), str(tmp_path / "sh-"), ".csv", 3, overwrite=True)
    eng = sharded.make_sharded_engine(data, n_devices=4, seed=4, records=rec, device=cuda_device)
    eng.run("M", 10, 0)
    eng.run("F", 20, 0)
    candpos, candrank = eng._shard_candidates()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sharded.sharded_phase(
            eng.mesh, eng.seed, 99, eng.model, eng.priors, eng.negw, candpos, candrank,
            eng.r_t, eng.q2_hi, eng.q2_lo, eng.buffers, None, method="F", T=eng.T,
            T_local=eng.T_local, cell_bits=eng.cell_bits, mapping=eng._mapping,
            nr_params=3, use_self_transitions=True, n_iters=8, thinning=2,
        )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if int(out[3][0]) <= eng.cap_local:  # no overflow: every recording sweep recorded
        assert int(eng.buffers.n_rec) == 4
    eng.model = out[0]
    eng.run("F", 16, 2)
    eng.finalize()
    rows = [list(map(int, x.split("\t"))) for x in (tmp_path / "sh-marginals.csv").read_text().splitlines()]
    assert sum(r[0] for r in rows) == len(data)
    assert all(sum(r[1:]) == int(eng.buffers.n_rec) for r in rows)
    assert eng.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 3])
def test_sharded_partition_on_card(cuda_device, tmp_path, P):
    """Exact on the card: under one fixed model one sweep of the sharded
    engine cuts the same blocks as the single-device engine."""
    from hammlet_tpu_torch.parallel import sharded

    data = synth_segments(60000, 12)[0]
    one = runner.make_engine(data, seed=5, device=cuda_device)
    one.run("M", 10, 0)
    one.run("F", 10, 0)
    eng = sharded.make_sharded_engine(data, n_devices=P, seed=5, device=cuda_device)
    eng.model = one.model._replace(**{k: v.clone() for k, v in one.model._asdict().items()})
    for tag, e in (("one", one), ("sh", eng)):
        e.records = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", 3, outputs={"blocks"}, overwrite=True)
    one.run("F", 1, 1)
    eng._one_sweep("F", do_record=True)
    for e in (one, eng):
        e.records.close()
    want = (tmp_path / "one-blocks.csv").read_text()
    assert want.count("\t") > 10
    assert (tmp_path / "sh-blocks.csv").read_text() == want


@pytest.mark.cuda
def test_cold_build_from_two_threads_on_card(cuda_device, tmp_path, monkeypatch):
    """Two threads reaching the kernel's first use on a fresh build
    directory: nvcc runs once, one library is bound, both transforms are
    bitwise equal to the plain version and no temporary file is left."""
    import threading

    from hammlet_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(wavelet_cuda, "_lib", None)
    data = np.random.default_rng(3).normal(0, 1, size=(50000, 1)).astype(np.float32)
    x = torch.from_numpy(data).to(cuda_device)
    barrier = threading.Barrier(2, timeout=120)
    out, errors = [], []

    def first_use():
        barrier.wait()
        try:
            out.append(wavelet_cuda.maxlet_transform_cuda(x))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    torch.cuda.synchronize()
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]
    for got in out:
        assert_bitwise(got, wavelet.maxlet_transform(torch.from_numpy(data)))


@pytest.mark.cuda
def test_engine_on_named_card_driven_from_a_thread(cuda_device):
    """An engine built and run from a worker thread on an explicit cuda:0
    carries the indexed device: its generators and syncs name that card."""
    import threading

    from hammlet_tpu_torch.device import resolve_device

    assert resolve_device("cuda").index == torch.cuda.current_device()
    res = {}

    def drive():
        eng = runner.make_engine(synth_segments(50000, 14)[0], seed=3, device="cuda:0")
        eng.run("M", 8, 0)
        eng.run("F", 8, 2)
        res["device"] = eng.device
        res["generator"] = eng._next_generator().device
        res["recorded"] = int(eng.buffers.n_records)

    t = threading.Thread(target=drive)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    assert res == {"device": torch.device("cuda", 0), "generator": torch.device("cuda", 0),
                   "recorded": 4}


@pytest.mark.cuda
def test_overlapped_drain_one_wait_per_chunk(cuda_device, tmp_path, monkeypatch):
    """A recording phase with every stream, its drain on the worker thread,
    runs under torch's sync debug mode "error" (no synchronizing call) and
    waits on the card exactly once per chunk (one CUDA event)."""
    data = synth_segments(50000, 15)[0]
    eng = runner.make_engine(data, seed=4, device=cuda_device)
    eng.run("M", 16, 0)
    eng.capacity = eng.ing.T  # no overflow: no re-pricing sync
    eng.records = Records(len(data), str(tmp_path / "d-"), ".csv", 3,
                          outputs=set(Records.STREAMS), overwrite=True)
    waits = []
    real_sync = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: waits.append(1) or real_sync(self))
    chunks = eng.phase_graphs.chunks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._draining():
            eng._run_phase("F", 768, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.records.close()
    chunks = eng.phase_graphs.chunks - chunks
    assert chunks >= 2 and len(waits) == chunks
    assert len((tmp_path / "d-sequences.csv").read_text().splitlines()) == 192


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8193, 2**20 + 1])
@pytest.mark.parametrize("dim", [1, 3])
def test_each_kernel_matches_golden_on_card(cuda_device, T, dim):
    """Tolerance: bitwise. The chunk kernel's coefficients off the chunk
    starts (the levels it forms), and the coefficients after the cross-chunk
    kernel everywhere, against the golden model's transform
    (hammlet_tpu_torch.golden.reference, numpy) of the same data."""
    from hammlet_tpu_torch.golden import reference as golden

    data = np.random.default_rng(T * 5 + dim).normal(1, 2, size=(T, dim)).astype(np.float32)
    want = golden.maxlet_transform(data)
    coeffs, totals = wavelet_cuda.maxlet_chunks_cuda(torch.from_numpy(data).to(cuda_device))
    crossed = wavelet_cuda.maxlet_cross_cuda(coeffs.clone(), totals)
    off = np.arange(T) % (1 << wavelet_cuda.CHUNK_BITS) != 0
    assert_bitwise(coeffs.cpu().numpy()[off], want[off])
    assert_bitwise(crossed, want)


@pytest.mark.cuda
def test_cli_shards_span_two_cards(cuda_device, tmp_path, monkeypatch, capsys):
    """On a host with two or more cards, bin/hammlet-torch -D 2 (cli.main)
    runs two processes, one per card, over NCCL, and writes the bytes of
    one process with -D 2 on one card; skipped with fewer cards."""
    from hammlet_tpu_torch import cli
    from hammlet_tpu_torch.parallel import distributed, launch

    if distributed.card_count() < 2:
        pytest.skip("needs two cards")
    for name in ("HAMMLET_NUM_PROCESSES", "HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID",
                 "HAMMLET_LOCAL_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    np.savetxt(tmp_path / "d.csv", synth_segments(50000, 16)[0])
    started = []
    real = launch.subprocess.Popen
    monkeypatch.setattr(launch.subprocess, "Popen",
                        lambda *a, **k: started.append(real(*a, **k)) or started[-1])
    argv = ["-f", str(tmp_path / "d.csv"), "-a", "-R", "4", "-D", "2", "-w", "-v",
            "-O", "marginals", "parameters", "compression", "-i", "M", "16", "0", "F", "32", "2"]
    assert cli.main(argv + ["-o", str(tmp_path / "two-"), ".csv"]) == 0
    assert "2 processes, one per card" in capsys.readouterr().out
    assert len(started) == 2 and all(p.poll() == 0 for p in started)
    monkeypatch.setattr(distributed, "card_count", lambda: 1)
    assert cli.main(argv + ["-o", str(tmp_path / "one-"), ".csv"]) == 0
    assert len(started) == 2
    for s in ("marginals", "parameters", "compression"):
        assert (tmp_path / f"two-{s}.csv").read_bytes() == (tmp_path / f"one-{s}.csv").read_bytes()


@pytest.mark.cuda
def test_thread_ranks_match_one_process_on_card(cuda_device, tmp_path, monkeypatch):
    """Exact on the card: P = 4 shards over four ranks played by threads
    (_torch_helpers.ThreadRanks, one shard each) write the bytes of one
    process holding all four, at T = 1,000,000, where the card's batched
    float sums over the local shards gave other parameters before the
    per-shard statistics ran one shard at a time."""
    from _torch_helpers import ThreadRanks
    from hammlet_tpu_torch.parallel import sharded
    from hammlet_tpu_torch.parallel.mesh import PositionMesh

    data = synth_segments(1_000_000, 22)[0]
    streams = {"marginals", "parameters", "compression"}
    device = torch.device("cuda", torch.cuda.current_device())

    def run(tag, mesh, rank=0):
        rec = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", 3, outputs=streams,
                      overwrite=True, write=rank == 0)
        eng = sharded.make_sharded_engine(data, mesh=mesh, nr_params=3, seed=9, records=rec)
        eng.run_scheme("M 16 0 F 64 4".split())
        eng.finalize()

    run("one", PositionMesh(4, device))
    ranks = ThreadRanks(4)
    ranks.install(monkeypatch)
    ranks.run(lambda r: run("ranks", PositionMesh(4, device, group=ranks), r))
    for s in sorted(streams):
        assert (tmp_path / f"ranks-{s}.csv").read_bytes() == (tmp_path / f"one-{s}.csv").read_bytes(), s


def _graphed(eng) -> bool:
    """Every sweep the engine ran on the card in this process was a graph
    replay (an overflowed chunk replays its sweeps again)."""
    pg = eng.phase_graphs
    return eng.device.type == "cuda" and pg.captures >= 1 and pg.replays >= eng.total_sweeps >= 1


STREAMS = ["marginals", "sequences", "parameters", "blocks", "compression", "mapping", "segments"]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [100_000, 4_000_000])
def test_graph_matches_eager_on_card(cuda_device, tmp_path, monkeypatch, T):
    """Exact on the card: cli.main with all seven outputs writes the same
    bytes whether the engine replays its CUDA graphs or runs the eager
    gibbs_phase (marginals, parameters and compression among them); every
    sweep of the graphed run was a replay."""
    np.savetxt(tmp_path / "d.csv", synth_segments(T, 17)[0], fmt="%.6f")
    make = cli.make_engine
    engines, out = [], {}
    for tag in ("graph", "eager"):
        wrap = eager_engine if tag == "eager" else (lambda e: e)
        monkeypatch.setattr(cli, "make_engine", lambda *a, **k: engines.append(wrap(make(*a, **k))) or engines[-1])
        argv = ["-f", str(tmp_path / "d.csv"), "-s", "3", "-a", "-R", "3", "-i", "M", "32", "0",
                "F", "128", "4", "-O", *STREAMS, "-o", str(tmp_path / f"{tag}-"), ".csv", "-w"]
        assert cli.main(argv) == 0
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}
    assert engines[0].device.type == "cuda" and _graphed(engines[0])
    assert engines[1].phase_graphs.replays == 0
    for s in STREAMS:
        assert out["graph"][s] == out["eager"][s], s
    assert out["graph"]["parameters"].count(b"\n") == 32


@pytest.mark.cuda
def test_graph_overflow_replay_on_card(cuda_device):
    """Exact on the card: from a small starting capacity recording chunks
    overflow, are replayed at a grown capacity after their buffers are
    restored in place (new graphs at each capacity), and end with the
    eager engine's bytes."""
    data = synth_segments(200_000, 18, seglen=250)[0]
    engines = []
    for eager in (False, True):
        eng = runner.make_engine(data, seed=4, capacity=128, device=cuda_device)
        if eager:
            eager_engine(eng)
        eng.run("M", 8, 0)
        eng._resize_capacity_for_phase = lambda: None  # keep the small capacity
        eng.capacity = 128
        counts = eng.buffers.counts
        eng.run("F", 16, 2)
        assert eng.capacity > 128
        engines.append((eng, counts))
    (g, counts), (e, _) = engines
    assert g.buffers.counts is counts and _graphed(g)
    assert g.phase_graphs.replays > g.total_sweeps  # the overflowed chunks ran again
    for name in ("counts", "ever_boundary", "n_records", "n_boundaries"):
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))
    assert set(g.marginal_counts.sum(axis=0).tolist()) == {8}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 27])
def test_resume_into_graphed_engine_on_card(cuda_device, tmp_path, K):
    """Exact on the card: a checkpoint restored into an engine that has
    already captured graphs (its buffers keep their addresses) continues
    with the bytes of the uninterrupted eager run; at K = 3 on one track,
    and at K = 27 on three (chip_smoke.states27_steps, -s C 3 3: the wide
    prefix instances)."""
    from chip_smoke import states27_steps
    from hammlet_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    data = synth_segments(300_000, 19)[0] if K == 3 else states27_steps(300_000, seed=19)[0]
    dim = 1 if K == 3 else 3

    def build():
        return runner.make_engine(data, seed=5, nr_data_dim=dim, device=cuda_device)

    whole = eager_engine(build())
    whole.run("M", 16, 0)
    whole.run("F", 64, 4)
    cut = build()
    cut.run("M", 16, 0)
    save_checkpoint(cut, str(tmp_path / "c.npz"))
    resumed = build()
    resumed.run("M", 4, 0)
    tensors = (resumed.buffers.counts, resumed.buffers.ever_boundary)
    restore_checkpoint(resumed, str(tmp_path / "c.npz"))
    assert (resumed.buffers.counts, resumed.buffers.ever_boundary) == tensors
    resumed.run("F", 64, 4)
    assert _graphed(resumed) and int(resumed.buffers.n_records) == 16
    for name in ("counts", "ever_boundary", "n_records", "n_boundaries"):
        assert torch.equal(getattr(whole.buffers, name), getattr(resumed.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(whole.model, resumed.model))


@pytest.mark.cuda
def test_threaded_chains_graphed_on_card(cuda_device, tmp_path, monkeypatch):
    """Exact on the card: two -M chains in two threads on cuda:0, taking
    turns at phases (the CLI's default) and not (captures and replays of
    both chains at once), write the bytes of the two chains one after
    another; every chain's engine replayed graphs."""
    files = []
    for i in range(2):
        f = tmp_path / f"chr{i + 1}.csv"
        np.savetxt(f, synth_segments(150_000, 20 + i)[0], fmt="%.6f")
        files.append(str(f))
    engines, real_make, real_chain = [], cli.make_engine, cli._run_chain
    monkeypatch.setattr(cli, "make_engine", lambda *a, **k: engines.append(real_make(*a, **k)) or engines[-1])
    out = {}
    for tag, devices, turns in (("seq", 1, True), ("turns", 2, True), ("free", 2, False)):
        monkeypatch.setattr(cli, "_chain_devices", lambda n=devices: [cuda_device] * n)
        monkeypatch.setattr(cli, "_run_chain", lambda sub, dev, turn, t=turns: real_chain(sub, dev, turn if t else None))
        argv = ["-M", "-f", *files, "-o", str(tmp_path / f"{tag}-"), ".csv", "-s", "3", "-a", "-R", "7",
                "-i", "M", "16", "0", "F", "64", "2", "-O", "marginals", "parameters", "compression", "-w"]
        assert cli.main(argv) == 0
        out[tag] = {(i, s): (tmp_path / f"{tag}-chr{i + 1}-{s}.csv").read_bytes()
                    for i in range(2) for s in ("marginals", "parameters", "compression")}
    assert len(engines) == 6 and all(_graphed(e) for e in engines)
    assert out["turns"] == out["seq"] and out["free"] == out["seq"]


@pytest.mark.cuda
def test_graphed_chunk_never_syncs(cuda_device):
    """A graphed recording phase, its captures at a new capacity included,
    queues its work with no synchronizing call (torch's sync debug mode
    "error" raises on any) and replays one graph per sweep."""
    eng = runner.make_engine(synth_segments(50000, 6)[0], seed=2, device=cuda_device)
    eng.run("M", 10, 0)
    eng._resize_capacity_for_phase = lambda: None
    eng.capacity = eng.ing.T  # no overflow: no re-pricing sync; a capacity never captured
    before = (eng.phase_graphs.captures, eng.phase_graphs.replays)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._draining():
            eng._run_phase("F", 16, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.phase_graphs.captures == before[0] + 2
    assert eng.phase_graphs.replays == before[1] + 16
    assert int(eng.buffers.n_records) == 4


@pytest.mark.cuda
def test_synchronize_leaves_another_threads_capture_alone(cuda_device):
    """device.synchronize (what an engine calls at the end of each phase)
    waits for the calling thread's stream only: a thread that calls it
    without pause while another thread's engine captures a new graph at
    every phase does not invalidate those captures."""
    import threading

    from hammlet_tpu_torch.device import synchronize

    eng = runner.make_engine(synth_segments(100_000, 23)[0], seed=6, device=cuda_device)
    eng._resize_capacity_for_phase = lambda: None
    done, errors = threading.Event(), []

    def hammer():
        while not done.is_set():
            synchronize(eng.device)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for capacity in (4096, 5120, 6144, 7168):
            eng.capacity = capacity  # a new capacity: new captures
            eng.run("M", 2, 0)
    except Exception as exc:  # reported below, after the thread stops
        errors.append(exc)
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive() and errors == []
    assert eng.phase_graphs.captures >= 4 and _graphed(eng)


def _sharded(data, device, seed, mesh=None, P=4, **kw):
    """The sharded engine with P shards on ``device`` (or on ``mesh``)."""
    from hammlet_tpu_torch.parallel import sharded

    return sharded.make_sharded_engine(data, mesh=mesh, n_devices=None if mesh else P, nr_params=3,
                                       seed=seed, device=None if mesh else device, **kw)


@pytest.mark.cuda
def test_sharded_graph_matches_eager_on_card(cuda_device, tmp_path, monkeypatch):
    """Exact on the card: cli.main -D 4 (four shards in one process) with
    all seven outputs, static and dynamic thresholds, writes the same bytes
    whether the sharded engine replays one graph per sweep kind or runs its
    chunks through the eager sharded_phase; every sweep of the graphed run
    was a replay, and the eager engine replayed none."""
    from _torch_helpers import eager_sharded_engine

    np.savetxt(tmp_path / "d.csv", synth_segments(100_000, 24)[0], fmt="%.6f")
    make = cli.make_sharded_engine
    engines, out = [], {}
    for tag in ("graph", "eager"):
        wrap = eager_sharded_engine if tag == "eager" else (lambda e: e)
        monkeypatch.setattr(cli, "make_sharded_engine",
                            lambda *a, **k: engines.append(wrap(make(*a, **k))) or engines[-1])
        argv = ["-f", str(tmp_path / "d.csv"), "-s", "3", "-a", "-R", "6", "-D", "4", "-i",
                *"M 16 0 S F 32 4 D F 32 2".split(), "-O", *STREAMS, "-o",
                str(tmp_path / f"{tag}-"), ".csv", "-w"]
        assert cli.main(argv) == 0
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}
    g, e = engines
    assert g.device.type == "cuda" and _graphed(g) and g.phase_graphs.graphs == g.phase_graphs.captures
    assert e.phase_graphs.replays == 0
    for s in STREAMS:
        assert out["graph"][s] == out["eager"][s], s
    assert out["graph"]["parameters"].count(b"\n") == 8 + 16


@pytest.mark.cuda
def test_sharded_graph_overflow_replay_on_card(cuda_device):
    """Exact on the card: from a small per-shard capacity recording chunks
    overflow and are replayed at a grown capacity after their buffers are
    restored in place (new graphs at each capacity), ending with the eager
    engine's bytes."""
    from _torch_helpers import eager_sharded_engine

    data = synth_segments(200_000, 25, seglen=100)[0]
    engines = []
    for eager in (False, True):
        eng = _sharded(data, cuda_device, 4, cap_local=128)
        if eager:
            eager_sharded_engine(eng)
        eng.run("M", 8, 0)
        eng._resize_capacity_for_phase = lambda: None  # keep the small capacity
        eng.cap_local = 128
        counts = eng.buffers.counts
        eng.run("F", 16, 2)
        assert eng.cap_local > 128
        engines.append((eng, counts))
    (g, counts), (e, _) = engines
    assert g.buffers.counts is counts and _graphed(g)
    assert g.phase_graphs.replays > g.total_sweeps  # the overflowed chunks ran again
    for name in ("counts", "everb", "n_rec", "n_bound"):
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))
    assert set(g.marginal_counts.sum(axis=0).tolist()) == {8}


@pytest.mark.cuda
def test_resume_into_graphed_sharded_engine_on_card(cuda_device, tmp_path):
    """Exact on the card: a sharded checkpoint restored into an engine that
    has captured graphs (its buffers keep their addresses) continues with
    the bytes of the uninterrupted eager run."""
    from _torch_helpers import eager_sharded_engine
    from hammlet_tpu_torch.checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint

    data = synth_segments(300_000, 26)[0]
    whole = eager_sharded_engine(_sharded(data, cuda_device, 5))
    whole.run("M", 16, 0)
    whole.run("F", 64, 4)
    cut = _sharded(data, cuda_device, 5)
    cut.run("M", 16, 0)
    save_sharded_checkpoint(cut, str(tmp_path / "c.npz"))
    resumed = _sharded(data, cuda_device, 5)
    resumed.run("M", 4, 0)
    tensors = (resumed.buffers.counts, resumed.buffers.everb)
    restore_sharded_checkpoint(resumed, str(tmp_path / "c.npz"))
    assert (resumed.buffers.counts, resumed.buffers.everb) == tensors
    resumed.run("F", 64, 4)
    assert _graphed(resumed) and int(resumed.buffers.n_rec) == 16
    for name in ("counts", "everb", "n_rec", "n_bound"):
        assert torch.equal(getattr(whole.buffers, name), getattr(resumed.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(whole.model, resumed.model))


@pytest.mark.cuda
def test_sharded_graphed_chunk_never_syncs_and_counts(cuda_device):
    """A graphed recording phase of the sharded engine at a capacity never
    captured queues its work with no synchronizing call; the captures,
    graphs and replays counters move by one sweep kind each (quiet and
    recording), one graph each, and one replay per sweep."""
    eng = _sharded(synth_segments(100_000, 27)[0], cuda_device, 2)
    eng.run("M", 10, 0)
    eng._resize_capacity_for_phase = lambda: None
    eng.cap_local = eng.T_local  # no overflow: no re-pricing sync
    pg = eng.phase_graphs
    before = (pg.captures, pg.graphs, pg.replays)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._draining():
            eng._run_phase("F", 16, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (pg.captures, pg.graphs, pg.replays) == (before[0] + 2, before[1] + 2, before[2] + 16)
    assert int(eng.buffers.n_rec) == 4


@pytest.mark.cuda
def test_sharded_capture_failure_raises_on_card(cuda_device):
    """A capture that fails (here: a piece that waits for the host inside
    it) raises out of the phase; the engine does not run the eager loop
    instead, and replays nothing."""
    from hammlet_tpu_torch.samplers.phase_graph import Local

    eng = _sharded(synth_segments(50_000, 28)[0], cuda_device, 3)
    program = eng.phase_graphs.program
    real = program.pieces

    def pieces(*args, **kwargs):
        return real(*args, **kwargs) + [Local(lambda slots, st: slots.diag.sum().item())]

    program.pieces = pieces
    model = eng.model
    with pytest.raises(RuntimeError):
        eng.run("M", 4, 0)
    assert eng.phase_graphs.replays == 0 and eng.phase_graphs.captures == 0
    assert eng.model is model and int(eng.buffers.n_rec) == 0


@pytest.mark.cuda
def test_segment_graphs_in_nccl_group_of_one_on_card(cuda_device, tmp_path):
    """Exact on the card: inside a one-process NCCL group every collective
    of the sweep runs through NCCL, so each sweep kind is captured as
    several graphs (its local runs) with the collectives issued eagerly
    between their replays; the run writes the bytes of the same run
    without a group (one graph per kind)."""
    import socket

    import torch.distributed as dist
    from hammlet_tpu_torch.parallel.mesh import PositionMesh

    data = synth_segments(300_000, 29)[0]
    streams = {"marginals", "parameters", "compression", "sequences"}
    engines, out = {}, {}

    def run(tag, mesh):
        rec = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", 3, outputs=streams,
                      overwrite=True)
        eng = _sharded(data, cuda_device, 8, mesh=mesh, records=rec)
        eng.run_scheme("M 16 0 F 64 4".split())
        eng.finalize()
        engines[tag] = eng
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in streams}

    device = torch.device("cuda", torch.cuda.current_device())
    run("alone", PositionMesh(4, device))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=device)
    try:
        run("group", PositionMesh(4, device, dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    assert out["group"] == out["alone"]
    a, g = engines["alone"].phase_graphs, engines["group"].phase_graphs
    assert _graphed(engines["group"]) and a.graphs == a.captures
    assert g.graphs >= 4 * g.captures  # M sweeps: 4 runs; F: 6, recording F: 7


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_graph_inputs_outlive_the_capture_on_card(cuda_device, P):
    """Exact on the card: memory allocated between the replays (here, small
    tensors of every size to 4 KiB filled with -7, made and dropped before
    every sweep) is never memory that a captured graph reads, such as a
    constant the sweep's pieces made before the capture; the graphed
    sharded engine still writes the eager engine's bytes."""
    from _torch_helpers import eager_sharded_engine

    data = synth_segments(200_000, 30)[0]
    engines, junk = [], []
    for eager in (False, True):
        eng = _sharded(data, cuda_device, 7, P=P)
        if eager:
            eager_sharded_engine(eng)
        program = eng.phase_graphs.program
        real = program.seed_sweep

        def seed_sweep(counter, i, real=real):
            real(counter, i)
            junk.clear()
            junk.extend(torch.full((n,), -7, dtype=torch.int64, device=cuda_device)
                        for n in range(1, 513, 3))

        program.seed_sweep = seed_sweep
        eng.run("M", 8, 0)
        eng.run("F", 32, 2)
        engines.append(eng)
    g, e = engines
    assert _graphed(g)
    for name in ("counts", "everb", "n_rec", "n_bound"):
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))


def _fb_inputs(B, K, R, seed, device):
    """(K, K, R, B) float32 matrices in [0.05, 1) and (K, R, B) int64 maps,
    from numpy; the last of R > 1 rows is all identities (padding)."""
    rng = np.random.default_rng(seed)
    M = rng.uniform(0.05, 1.0, size=(K, K, R, B)).astype(np.float32)
    maps = rng.integers(0, K, size=(K, R, B))
    if R > 1:
        M[:, :, -1] = np.eye(K, dtype=np.float32)[:, :, None]
        maps[:, -1] = np.arange(K)[:, None]
    return torch.from_numpy(M).to(device), torch.from_numpy(maps).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 130, 256, 384, 29_696])
@pytest.mark.parametrize("K", [1, 3, 9, 10, 12, 16, 17, 27, 32])
@pytest.mark.parametrize("R", [1, 4])
def test_fbscan_kernels_match_plain_on_card(cuda_device, B, K, R):
    """The FB scan kernels (csrc/fbscan.cu) against their plain versions on
    the card and on the CPU. Tolerance: prefix rtol 1e-6, atol 1e-30 (the
    kernel repeats the plain version's arithmetic in its order; bitwise on
    the H100 at every shape chip_smoke.py checks), and bitwise for the team
    and wide instances (K = 9-32); suffix exact. Each call counts one
    launch of its wrapper."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M, maps = _fb_inputs(B, K, R, B * 10 + K + R, cuda_device)
    before = (fb_cuda.prefix_matmul_scan_cuda.launches, fb_cuda.suffix_compose_scan_cuda.launches)
    got = fb.prefix_matmul_scan_t(M)
    sgot = fb.suffix_compose_scan_t(maps)
    torch.cuda.synchronize()
    assert (fb_cuda.prefix_matmul_scan_cuda.launches, fb_cuda.suffix_compose_scan_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for dev in (cuda_device, torch.device("cpu")):
        want = fb.prefix_matmul_scan_reference(M.to(dev))
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-6, atol=1e-30)
        if K > 8:
            assert_bitwise(got, want)
        assert torch.equal(sgot.cpu(), fb.suffix_compose_scan_reference(maps.to(dev)).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [100_000, 433_920])
@pytest.mark.parametrize("K", [3, 9, 10, 12, 16, 27])
def test_fbscan_grid_wide_rows_scan_on_card(cuda_device, B, K):
    """The rows scan too long for one CTA's shared memory runs over the
    whole card (a cooperative launch): a flat B (100,000, not a multiple of
    128) and the group totals of B = 433,920 (3,390 of them, the T = 250M
    per-shard capacity), against the plain versions on the card, also when
    the call is captured into a CUDA graph and replayed. Tolerance as
    above (bitwise for K = 9-32, which take the team rows kernel; at K = 27
    and B = 433,920 the wide group and combine kernels around it)."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M, maps = _fb_inputs(B, K, 1, B + K, cuda_device)
    want = fb.prefix_matmul_scan_reference(M)
    swant = fb.suffix_compose_scan_reference(maps)
    torch.testing.assert_close(fb_cuda.prefix_matmul_scan_cuda(M), want, rtol=1e-6, atol=1e-30)
    assert torch.equal(fb_cuda.suffix_compose_scan_cuda(maps), swant)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fb_cuda.prefix_matmul_scan_cuda(M)
        sgot = fb_cuda.suffix_compose_scan_cuda(maps)
    got.zero_()
    sgot.zero_()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-30)
    if K > 8:
        assert_bitwise(got, want)
    assert torch.equal(sgot, swant)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [130, 29_696])
def test_fbscan_rows_independent_on_card(cuda_device, B):
    """Exact on the card: four rows in one kernel call equal four one-row
    calls, bit for bit, and a permuted / transposed view (the sharded
    engine's cross-shard calls) equals its contiguous copy."""
    from hammlet_tpu_torch.samplers import fb_cuda

    M, maps = _fb_inputs(B, 3, 4, B, cuda_device)
    got = fb_cuda.prefix_matmul_scan_cuda(M)
    sgot = fb_cuda.suffix_compose_scan_cuda(maps)
    for r in range(4):
        assert_bitwise(got[:, :, r], fb_cuda.prefix_matmul_scan_cuda(M[:, :, r:r + 1].contiguous())[:, :, 0])
        assert torch.equal(sgot[:, r], fb_cuda.suffix_compose_scan_cuda(maps[:, r:r + 1].contiguous())[:, 0])
    view = M[:, :, :, 0].permute(2, 0, 1).contiguous().permute(1, 2, 0)  # (K, K, R), not contiguous
    assert not view.is_contiguous()
    assert_bitwise(fb_cuda.prefix_matmul_scan_cuda(view), fb_cuda.prefix_matmul_scan_cuda(view.contiguous()))
    tview = maps[:, :, 0].T.contiguous().T
    assert torch.equal(fb_cuda.suffix_compose_scan_cuda(tview), fb_cuda.suffix_compose_scan_cuda(tview.contiguous()))


def _scan_kernels(fn):
    """Names (mangled) of the CUDA kernels one call of ``fn`` launches: the
    kernel nodes of one call captured into a CUDA graph (chip_smoke.
    scan_kernels). Not torch.profiler: late in one long pytest run of this file
    it dropped one kernel of four traced calls of the statistics kernel at
    every retry, while the same tests passed alone."""
    from chip_smoke import scan_kernels

    return [name for name, _ in scan_kernels(fn)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 4])
def test_fbscan_one_kernel_per_call_on_card(cuda_device, R):
    """At the main path's shape (B = 29,696, K = 3; R = 1 at P = 1, four
    local rows at P = 4 on one card) each scan call is one CUDA kernel,
    the cooperative one-launch form (the kernel nodes of a captured call)."""
    from hammlet_tpu_torch.samplers import fb_cuda

    M, maps = _fb_inputs(29_696, 3, R, 7 + R, cuda_device)
    prefix = _scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))
    suffix = _scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))
    assert len(prefix) == 1 and "fbscan_prefix_one_kernel" in prefix[0], prefix
    assert len(suffix) == 1 and "fbscan_suffix_one_kernel" in suffix[0], suffix


@pytest.mark.cuda
@pytest.mark.parametrize("B, R", [(29_696, 1), (29_696, 4), (9_600, 4), (433_920, 1)])
def test_fbscan_sweep_like_subnormals_bitwise_on_card(cuda_device, B, R):
    """Exact on the card: on matrices shaped like the sweep's (half zeros,
    ~1 % subnormal) the prefix kernels equal their plain version bit for
    bit, in the one-launch form (B = 29,696 and 9,600 per row) and beyond
    one resident wave (B = 433,920, 3,390 groups: three launches); the
    suffix kernels equal theirs on maps of the same shape."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M = torch.from_numpy(sweep_like_matrices(3, R, B, B + R)).to(cuda_device)
    maps = _fb_inputs(B, 3, R, B, cuda_device)[1]
    assert_bitwise(fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M))
    assert torch.equal(fb_cuda.suffix_compose_scan_cuda(maps), fb.suffix_compose_scan_reference(maps))


@pytest.mark.cuda
@pytest.mark.parametrize("R, K, B", [(1, 3, 29_696), (4, 3, 29_696), (1, 9, 29_696),
                                     (1, 10, 29_696), (1, 16, 16_384)])
def test_fbscan_one_launch_in_cuda_graph_on_card(cuda_device, R, K, B):
    """Exact on the card: the one-launch scans (on the sweep-like
    matrices; K = 9, 10 and 16 the team instances, at 232 groups for K = 9
    and 10 and at 128 for K = 16, which takes a whole SM per group) are one
    CUDA kernel per call (the kernel nodes of a captured call), equal their
    plain versions bit for bit, and captured into a CUDA graph and replayed
    twice give the bits of the eager calls."""
    from chip_smoke import scan_kernels
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M = torch.from_numpy(sweep_like_matrices(K, R, B, 5 + R)).to(cuda_device)
    maps = _fb_inputs(B, K, R, 3 + R, cuda_device)[1]
    want = fb_cuda.prefix_matmul_scan_cuda(M)
    swant = fb_cuda.suffix_compose_scan_cuda(maps)
    assert_bitwise(want, fb.prefix_matmul_scan_reference(M))
    assert torch.equal(swant, fb.suffix_compose_scan_reference(maps))
    prefix = scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))
    suffix = scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))
    team = "fbscan_prefix_team_one_kernel" if K > 8 else "fbscan_prefix_one_kernel"
    assert len(prefix) == 1 and team in prefix[0][0], prefix
    assert len(suffix) == 1 and "fbscan_suffix_one_kernel" in suffix[0][0], suffix
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fb_cuda.prefix_matmul_scan_cuda(M)
        sgot = fb_cuda.suffix_compose_scan_cuda(maps)
    for _ in range(2):
        got.zero_()
        sgot.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert_bitwise(got, want)
        assert torch.equal(sgot, swant)


@pytest.mark.cuda
@pytest.mark.parametrize("R, K, B", [(1, 17, 29_696), (1, 27, 29_696), (4, 27, 9_600),
                                     (1, 32, 29_696)])
def test_fbscan_wide_instances_in_cuda_graph_on_card(cuda_device, R, K, B):
    """Exact on the card: at K = 17-32 the prefix (on the sweep-like
    matrices) is the three wide kernels per call (the group kernel over a
    thread block cluster per group, the totals' rows kernel, the combine)
    and the suffix one kernel (the kernel nodes of a captured call); both
    equal their plain versions bit for bit, and captured into a CUDA graph
    and replayed twice give the bits of the eager calls."""
    from chip_smoke import FB_WIDE, scan_kernels
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M = torch.from_numpy(sweep_like_matrices(K, R, B, 9 + K)).to(cuda_device)
    maps = _fb_inputs(B, K, R, 4 + K, cuda_device)[1]
    want = fb_cuda.prefix_matmul_scan_cuda(M)
    swant = fb_cuda.suffix_compose_scan_cuda(maps)
    assert_bitwise(want, fb.prefix_matmul_scan_reference(M))
    assert torch.equal(swant, fb.suffix_compose_scan_reference(maps))
    prefix = [name for name, _ in scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))]
    suffix = scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))
    assert len(prefix) == 3 and all(w in n for w, n in zip(FB_WIDE, prefix)), prefix
    assert len(suffix) == 1 and "fbscan_suffix_one_kernel" in suffix[0][0], suffix
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fb_cuda.prefix_matmul_scan_cuda(M)
        sgot = fb_cuda.suffix_compose_scan_cuda(maps)
    for _ in range(2):
        got.zero_()
        sgot.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert_bitwise(got, want)
        assert torch.equal(sgot, swant)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "zeros, -0 and subnormals", "NaN"])
@pytest.mark.parametrize("B", [130, 384, 29_696])
@pytest.mark.parametrize("K", [33, 48, 64])
@pytest.mark.parametrize("R", [1, 4])
def test_fbscan_deep_instances_match_plain_on_card(cuda_device, R, K, B, case):
    """Exact on the card: at K = 33-64 the prefix (the tiled products, one
    cooperative launch per call, flat at B = 130 and grouped above) equals
    its plain version bit for bit on uniform matrices, on matrices with 40 %
    zeros, 1 % -0 and 5 % subnormal entries, and with one NaN; the suffix
    (one launch where the call's groups fit the card, else three) equals
    its plain version. On uniform inputs each prefix call is one
    fbscan_prefix_deep_kernel and counts one launch of its wrapper, and
    captured into a CUDA graph and replayed it gives the eager bits."""
    from chip_smoke import FB_DEEP, scan_kernels
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M, maps = _fb_inputs(B, K, R, B + K + R, cuda_device)
    if case == "zeros, -0 and subnormals":
        u = torch.rand(M.shape, generator=torch.Generator(device=cuda_device).manual_seed(B),
                       device=cuda_device)
        M = torch.where(u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
        M = torch.where(u > 0.99, -0.0, M)
    elif case == "NaN":
        M[1, 2, 0, B // 3] = float("nan")
    before = fb_cuda.prefix_matmul_scan_cuda.launches
    got = fb_cuda.prefix_matmul_scan_cuda(M)
    assert fb_cuda.prefix_matmul_scan_cuda.launches == before + 1
    assert_bitwise(got, fb.prefix_matmul_scan_reference(M))
    assert torch.equal(fb_cuda.suffix_compose_scan_cuda(maps), fb.suffix_compose_scan_reference(maps))
    if case != "uniform":
        return
    prefix = [name for name, _ in scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))]
    assert len(prefix) == 1 and FB_DEEP[0] in prefix[0], prefix
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        again = fb_cuda.prefix_matmul_scan_cuda(M)
    again.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert_bitwise(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "zeros, -0 and subnormals", "NaN"])
@pytest.mark.parametrize("B", [130, 384])
@pytest.mark.parametrize("K", [65, 81, 128, 129, 243])
@pytest.mark.parametrize("R", [1, 4])
def test_fbscan_tiled_instances_match_plain_on_card(cuda_device, R, K, B, case):
    """Exact on the card: above K = 64 the prefix (the tiled products with j
    streamed, one cooperative launch per call, flat at B = 130 and grouped
    at 384; one tile a side up to K = 128, two above, whose division takes
    a pass of its own) equals its plain version bit for bit on uniform
    matrices, on matrices with 40 % zeros, 1 % -0 and 5 % subnormal entries,
    and with one NaN; the suffix (grouped: the group kernel with the maps in
    shared memory, the totals' rows scan, the combine) equals its plain
    version. On uniform inputs each prefix call is one
    fbscan_prefix_tiled_kernel and counts one launch of its wrapper, each
    grouped suffix call the three suffix kernels, and the prefix captured
    into a CUDA graph and replayed gives the eager bits."""
    from chip_smoke import FB_SUFFIX_GROUPED, FB_TILED, scan_kernels
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    M, maps = _fb_inputs(B, K, R, B + K + R, cuda_device)
    if case == "zeros, -0 and subnormals":
        u = torch.rand(M.shape, generator=torch.Generator(device=cuda_device).manual_seed(B),
                       device=cuda_device)
        M = torch.where(u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
        M = torch.where(u > 0.99, -0.0, M)
    elif case == "NaN":
        M[1, 2, 0, B // 3] = float("nan")
    before = fb_cuda.prefix_matmul_scan_cuda.launches
    got = fb_cuda.prefix_matmul_scan_cuda(M)
    assert fb_cuda.prefix_matmul_scan_cuda.launches == before + 1
    assert_bitwise(got, fb.prefix_matmul_scan_reference(M))
    assert torch.equal(fb_cuda.suffix_compose_scan_cuda(maps), fb.suffix_compose_scan_reference(maps))
    if case != "uniform":
        return
    prefix = [name for name, _ in scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))]
    assert len(prefix) == 1 and FB_TILED[0] in prefix[0], prefix
    suffix = [name for name, _ in scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))]
    if B > 256:
        assert len(suffix) == 3 and all(k in n for k, n in zip(FB_SUFFIX_GROUPED, suffix)), suffix
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        again = fb_cuda.prefix_matmul_scan_cuda(M)
    again.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert_bitwise(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [512, 513, 625, 729, 1024])
def test_fbscan_tiled_prefix_above_512_on_card(cuda_device, K):
    """Above K = 512 the tiled kernel's transposes take each row of 32
    matrices in pieces (at K = 512 still whole rows): flat (B = 4, in one
    and in four rows) and grouped (B = 384), the prefix call is one CUDA
    kernel, counts one launch and equals its plain version bit for bit, and
    the suffix equals its plain version. Nothing is refused and nothing
    falls back to a plain version."""
    from chip_smoke import FB_TILED, scan_kernels
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    for B, R in ((4, 1), (4, 4), (384, 1)):
        M, maps = _fb_inputs(B, K, R, B + K + R, cuda_device)
        before = fb_cuda.prefix_matmul_scan_cuda.launches
        got = fb_cuda.prefix_matmul_scan_cuda(M)
        assert fb_cuda.prefix_matmul_scan_cuda.launches == before + 1
        assert_bitwise(got, fb.prefix_matmul_scan_reference(M))
        assert torch.equal(fb_cuda.suffix_compose_scan_cuda(maps),
                           fb.suffix_compose_scan_reference(maps))
        prefix = [name for name, _ in scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))]
        assert len(prefix) == 1 and FB_TILED[0] in prefix[0], prefix
        del M, maps, got
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [6001, 6016])
def test_fbscan_tiled_prefix_past_int32_entries_on_card(cuda_device, B):
    """At K = 625 a call of 6,001 (flat) or 6,016 (grouped) matrices holds
    K^2 B > 2^31 entries, so every offset into its tensors must be 64-bit:
    on random permutation matrices, whose products are exact in any order,
    the prefix call counts one launch and gives their composition bit for
    bit (chip_smoke.prefix_permutations)."""
    import gc

    from chip_smoke import prefix_permutations

    gc.collect()  # tensors of earlier tests, held in reference cycles
    try:
        assert prefix_permutations(625, B, B)["entries"] > 2**31
    finally:
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_fbscan_refused_argument_raises_on_card(cuda_device):
    """A call whose arguments the library refuses (here 65,536 rows of one
    block at K = 64, beyond the 65,535 a row index may take) raises with the
    CUDA error and counts no launch: nothing falls back to the plain
    version."""
    from hammlet_tpu_torch.samplers import fb_cuda

    M = torch.ones((64, 64, 65_536, 1), device=cuda_device)
    maps = torch.zeros((64, 65_536, 1), dtype=torch.int64, device=cuda_device)
    before = (fb_cuda.prefix_matmul_scan_cuda.launches, fb_cuda.suffix_compose_scan_cuda.launches)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fb_cuda.prefix_matmul_scan_cuda(M)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fb_cuda.suffix_compose_scan_cuda(maps)
    assert (fb_cuda.prefix_matmul_scan_cuda.launches,
            fb_cuda.suffix_compose_scan_cuda.launches) == before


@pytest.mark.cuda
def test_fbscan_deep_launch_refused_by_shared_memory_raises_on_card(cuda_device, monkeypatch):
    """A tiled-product launch whose shared memory the card cannot give
    raises: a copy of fbscan.cu built with K >= 33 only, its deep kernels
    asking for four times their operands' shared memory, launches K = 33
    (110 KiB, within the card's opt-in 227 KiB) bit for bit as the plain
    version, and refuses K = 64 (272 KiB) in allow_smem, before any launch,
    with the CUDA error: no launch counted, no fallback to the plain
    version or the generic kernels."""
    import ctypes

    from hammlet_tpu_torch import _build
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    src = fb_cuda.SOURCES[0].read_text()
    for old, new in (("prefix_at<1>(K,", "prefix_at<33>(K,"), ("suffix_at<1>(K,", "suffix_at<33>(K,"),
                     ("SMEM_FLOATS = OPERANDS +", "SMEM_FLOATS = 4 * OPERANDS +")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    path = _build.BUILD_DIR / "test" / "fbscan_smem_refused.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = fb_cuda._bind(ctypes.CDLL(str(_build.build("fbscan_smem_refused", [path]).path)))
    monkeypatch.setattr(fb_cuda, "_lib", lib)
    M, _ = _fb_inputs(29_696, 33, 1, 33, cuda_device)
    before = fb_cuda.prefix_matmul_scan_cuda.launches
    assert_bitwise(fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M))
    assert fb_cuda.prefix_matmul_scan_cuda.launches == before + 1
    M, _ = _fb_inputs(29_696, 64, 1, 64, cuda_device)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fb_cuda.prefix_matmul_scan_cuda(M)
    torch.cuda.synchronize()
    assert fb_cuda.prefix_matmul_scan_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_graphed_engines_through_fbscan_kernels_on_card(cuda_device, P):
    """Exact on the card at T = 100,000: a graphed Engine (P = 1) and a
    graphed sharded engine (P = 4 shards) write the bytes of the same
    engine run through its eager plain version; both run their scans
    through the FB kernels (the wrappers count the eager sweeps' calls and
    the captures')."""
    from _torch_helpers import eager_sharded_engine
    from hammlet_tpu_torch.samplers import fb_cuda

    data = synth_segments(100_000, 41)[0]
    engines = []
    for eager in (False, True):
        before = fb_cuda.prefix_matmul_scan_cuda.launches, fb_cuda.suffix_compose_scan_cuda.launches
        if P == 1:
            eng = runner.make_engine(data, nr_params=3, seed=5, device=cuda_device)
            if eager:
                eager_engine(eng)
        else:
            eng = _sharded(data, cuda_device, 5, P=P)
            if eager:
                eager_sharded_engine(eng)
        eng.run("M", 8, 0)
        eng.run("F", 32, 2)
        torch.cuda.synchronize()
        assert fb_cuda.prefix_matmul_scan_cuda.launches > before[0]
        assert fb_cuda.suffix_compose_scan_cuda.launches > before[1]
        engines.append(eng)
    g, e = engines
    assert _graphed(g) and e.phase_graphs.replays == 0
    names = [n for n in ("counts", "ever_boundary", "n_records", "everb", "n_rec")
             if hasattr(g.buffers, n)]
    assert len(names) == 3
    for name in names:
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))


@pytest.mark.cuda
def test_graphed_states9_engine_matches_eager_on_card(cuda_device):
    """Exact on the card: configuration 4 (two tracks, K = 9; chip_smoke.
    config4_steps) at T = 100,000 x 2, M 16 0 F 64 4 with marginals and
    parameters, through a graphed engine and through its eager plain
    version: the same bytes; the graphed sweeps are replays and both run
    their scans through the K = 9 kernels (the wrappers count them)."""
    from chip_smoke import config4_steps
    from hammlet_tpu_torch.samplers import fb_cuda

    data = config4_steps(100_000)[0]
    outs = []
    for eager in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "s9-")
            rec = Records(100_000, prefix, ".csv", 9, outputs={"marginals", "parameters"},
                          overwrite=True)
            before = fb_cuda.prefix_matmul_scan_cuda.launches
            eng = runner.make_engine(data, nr_params=3, nr_data_dim=2, seed=0, records=rec,
                                     device=cuda_device)
            if eager:
                eager_engine(eng)
            eng.run_scheme("M 16 0 F 64 4".split())
            eng.finalize()
            torch.cuda.synchronize()
            assert eng.spec.nr_states == 9
            assert fb_cuda.prefix_matmul_scan_cuda.launches > before
            assert _graphed(eng) != eager and (eng.phase_graphs.replays == 0) == eager
            outs.append({name: open(prefix + name + ".csv", "rb").read()
                         for name in ("marginals", "parameters")})
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_graphed_states27_engine_matches_eager_on_card(cuda_device):
    """Exact on the card: three tracks, K = 27 (-s C 3 3; chip_smoke.
    states27_steps) at T = 100,000 x 3, M 16 0 F 64 4 with marginals and
    parameters, through a graphed engine and through its eager plain
    version: the same bytes; the graphed sweeps are replays and both run
    their scans through the K = 27 kernels (the wrappers count them)."""
    from chip_smoke import states27_steps
    from hammlet_tpu_torch.samplers import fb_cuda

    data = states27_steps(100_000)[0]
    outs = []
    for eager in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "s27-")
            rec = Records(100_000, prefix, ".csv", 27, outputs={"marginals", "parameters"},
                          overwrite=True)
            before = fb_cuda.prefix_matmul_scan_cuda.launches
            eng = runner.make_engine(data, nr_params=3, nr_data_dim=3, seed=0, records=rec,
                                     device=cuda_device)
            if eager:
                eager_engine(eng)
            eng.run_scheme("M 16 0 F 64 4".split())
            eng.finalize()
            torch.cuda.synchronize()
            assert eng.spec.nr_states == 27
            assert fb_cuda.prefix_matmul_scan_cuda.launches > before
            assert _graphed(eng) != eager and (eng.phase_graphs.replays == 0) == eager
            outs.append({name: open(prefix + name + ".csv", "rb").read()
                         for name in ("marginals", "parameters")})
    assert outs[0] == outs[1]


def _stats_inputs(R, B, K, dim, seed, device, tail="full"):
    """One statistics call's inputs from numpy: (R, B) states and sizes,
    (R,) block counts (B; a masked tail of about half; or B + 1, an
    overflowing sweep's count before the clamp), (dim, 2, R, B) signed
    block statistics and a (K, dim) mapping into P = K or 2 parameters."""
    rng = np.random.default_rng(seed)
    P = K if dim == 1 else 2
    states = rng.integers(0, K, size=(R, B))
    sizes = rng.integers(1, 400, size=(R, B))
    nb = {"full": np.full(R, B), "masked": B // 2 + 3 * np.arange(R) + 1,
          "overflow": np.full(R, B + 1)}[tail]
    bstats = rng.normal(0, 30, size=(dim, 2, R, B)).astype(np.float32)
    bstats[:, 1] = np.abs(bstats[:, 1])
    mapping = rng.integers(0, P, size=(K, dim))
    host = tuple(map(torch.from_numpy, (states, sizes, nb, bstats, mapping)))
    return tuple(t.to(device) for t in host), host, P


def _same_bits(got, want) -> bool:
    """Equal float32 bits, NaN where the other has NaN."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("R, B, K, dim", [(1, 30, 3, 1), (1, 29_696, 3, 1), (1, 29_696, 10, 3),
                                          (1, 29_696, 27, 3), (4, 9_600, 3, 1), (4, 433_920, 3, 1)])
@pytest.mark.parametrize("tail", ["full", "masked", "overflow"])
def test_sweep_stats_kernels_match_plain_on_card(cuda_device, R, B, K, dim, tail):
    """Exact on the card: the statistics kernels equal their plain version
    (sweep.sweep_stats_reference) bit for bit, on the card and on the CPU,
    with every block valid, a masked tail and an overflowing count; each
    row of a 4-row call equals its one-row call."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep

    args, host, P = _stats_inputs(R, B, K, dim, B + K + dim, cuda_device, tail)
    before = model_cuda.sweep_stats_cuda.launches
    got = model_cuda.sweep_stats_cuda(*args, P)
    torch.cuda.synchronize()
    assert model_cuda.sweep_stats_cuda.launches == before + 1
    assert got.shape == (R, 3 * P + K * K + K)
    assert _same_bits(got, sweep.sweep_stats_reference(*args, P))
    assert _same_bits(got, sweep.sweep_stats_reference(*host, P))
    states, sizes, nb, bstats, mapping = args
    for r in range(R if R > 1 else 0):
        one = model_cuda.sweep_stats_cuda(states[r:r + 1], sizes[r:r + 1], nb[r:r + 1],
                                          bstats[:, :, r:r + 1].contiguous(), mapping, P)
        assert torch.equal(got[r].view(torch.int32), one[0].view(torch.int32)), r


@pytest.mark.cuda
@pytest.mark.parametrize("B", [29_696, 262_144, 4_000_000])
def test_sweep_stats_kernel_at_k64_on_card(cuda_device, B):
    """At K = 64, dim 3 (-s C 4 3: 4,260 summed terms) the statistics kernel
    launches at every capacity the path takes, the M burn-in's B = 4M
    included (its run stacks in shared memory hold the run's levels, not
    the row's); up to B = 262,144 it equals its plain version bit for bit
    on the card, and at 4M (where the plain version's one-hot pairs would
    take 67 GB) its state counts equal the exact integer sums of the sizes
    per state."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep

    args, _, P = _stats_inputs(1, B, 64, 3, B + 64, cuda_device)
    got = model_cuda.sweep_stats_cuda(*args, P)
    torch.cuda.synchronize()
    if B <= 262_144:
        assert _same_bits(got, sweep.sweep_stats_reference(*args, P))
    states, sizes = args[0][0], args[1][0]
    exact = torch.zeros(64, dtype=torch.float64, device=cuda_device).index_add_(
        0, states, sizes.double())
    assert torch.equal(got[0, -64:].double(), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("R, B, K, dim, P", [(1, 4_000_000, 81, 4, 3), (1, 262_144, 81, 4, 3),
                                             (1, 29_696, 128, 7, 2), (1, 29_696, 243, 5, 3),
                                             (4, 1_048_576, 81, 4, 3), (4, 1_048_576, 64, 3, 4),
                                             (1, 4096, 625, 4, 5), (1, 2048, 729, 6, 3),
                                             (1, 4096, 512, 9, 2), (2, 512, 1024, 10, 2)])
def test_sweep_stats_kernel_above_k64_on_card(cuda_device, R, B, K, dim, P):
    """Exact on the card above K = 64, where a CTA's shared memory cannot
    hold every term's run stack and the pair histogram (-s C 3 4 at the M
    burn-in's B = 4M, -s C 2 7, -s C 3 5, -s C 5 4, -s C 3 6: the terms in
    slices; -s C 2 9 and -s C 2 10, dim 9 and 10: the block statistics
    read unstaged), and at the
    sharded M burn-in's four rows of 1,048,576 blocks (T = 4M over P = 4
    shards; -s C 3 4 and -s C 4 3): the statistics call is one CUDA kernel,
    counts one launch, and equals its plain version bit for bit (above B =
    262,144, where the plain version's leaves would take up to 108 GB, the
    plain version's sums taken in chunks,
    chip_smoke.stats_reference_in_chunks)."""
    from chip_smoke import stats_reference_in_chunks
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep

    rng = np.random.default_rng(B + K)
    mapping = torch.from_numpy(rng.integers(0, P, size=(K, dim))).to(cuda_device)
    args = _stats_inputs(R, B, K, dim, B + K + dim, cuda_device)[0][:4] + (mapping,)
    before = model_cuda.sweep_stats_cuda.launches
    got = model_cuda.sweep_stats_cuda(*args, P)
    torch.cuda.synchronize()
    assert model_cuda.sweep_stats_cuda.launches == before + 1
    want = (stats_reference_in_chunks(*args, P) if B > 262_144
            else sweep.sweep_stats_reference(*args, P))
    assert _same_bits(got, want)
    names = _scan_kernels(lambda: model_cuda.sweep_stats_cuda(*args, P))
    assert len(names) == 1 and "modelupdate_stats_kernel" in names[0], names


@pytest.mark.cuda
def test_sweep_stats_refused_beyond_shared_memory_raises_on_card(cuda_device):
    """A statistics call whose least slice of terms cannot fit a CTA's
    shared memory beside the mapping (K = 1,000, dim 30: a 240 KB mapping)
    raises with the CUDA error and counts no launch: nothing falls back to
    the plain version."""
    from hammlet_tpu_torch.models import model_cuda

    args, _, _ = _stats_inputs(1, 30, 1000, 30, 3, cuda_device)
    before = model_cuda.sweep_stats_cuda.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        model_cuda.sweep_stats_cuda(*args, 2)
    torch.cuda.synchronize()
    assert model_cuda.sweep_stats_cuda.launches == before


@pytest.mark.cuda
def test_sweep_stats_nan_on_card(cuda_device):
    """Exact on the card: a NaN block statistic (valid or masked) turns
    every theta sum of its dimension NaN, as the plain version's mask *
    value does, and the kernels' NaNs sit where the plain version's do."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep

    args, _, P = _stats_inputs(2, 29_696, 3, 1, 17, cuda_device, "masked")
    args[3][0, 0, 0, 100] = float("nan")
    args[3][0, 1, 1, 29_000] = float("nan")  # past row 1's blocks
    got = model_cuda.sweep_stats_cuda(*args, P)
    want = sweep.sweep_stats_reference(*args, P)
    assert bool(torch.isnan(got).any()) and _same_bits(got, want)


def _resample_inputs(K, seed, device, nan=False):
    """Priors, statistics whose Gamma shapes run from 0.5 to 1e7 and noise
    drawn on the card, as the resample draws it."""
    from hammlet_tpu_torch.models.hmm import HMMPriors, SweepStats

    rng = np.random.default_rng(seed)
    P = K
    spread = np.array([0.0, 1.0, 7.0, 120.0, 5e4, 1e7], np.float32)
    counts = rng.choice(spread, size=P).astype(np.float32)
    sums = (rng.normal(0.3, 1.0, size=P) * counts).astype(np.float32)
    if nan:
        counts[0], sums[0] = 40.0, np.nan
    stats = SweepStats(*(torch.from_numpy(a).to(device) for a in (
        sums, (counts * 1.7 + np.nan_to_num(sums) ** 2 / np.maximum(counts, 1)).astype(np.float32),
        counts, rng.choice(spread, size=(K, K)).astype(np.float32),
        rng.choice(spread, size=K).astype(np.float32))))
    priors = HMMPriors.create(np.tile(np.array([2.0, 0.4, 0.1, 0.3], np.float32), (P, 1)), K,
                              device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = P + K * K + K
    noise = (torch.randn((8, n), generator=gen, device=device),
             torch.rand((8, n), generator=gen, device=device),
             torch.rand((n,), generator=gen, device=device),
             torch.randn((P,), generator=gen, device=device))
    return priors, stats, noise


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 10, 27])
@pytest.mark.parametrize("nan", [False, True])
def test_resample_kernel_matches_plain_on_card(cuda_device, K, nan):
    """Exact on the card: the resample kernel equals its plain version
    (hmm.resample_model_reference) bit for bit at Gamma shapes from 0.5 to
    1e7, over many draws, and with a NaN theta sum (NaN where the plain
    version has it)."""
    from hammlet_tpu_torch.models import hmm, model_cuda

    for seed in range(20):
        priors, stats, noise = _resample_inputs(K, seed + 100 * nan, cuda_device, nan)
        got = model_cuda.resample_model_cuda(priors, stats, noise)
        want = hmm.resample_model_reference(priors, stats, noise)
        for name, a, b in zip(hmm.HMMState._fields, got, want):
            assert _same_bits(a, b), (seed, name)
        assert bool(torch.isnan(got[0]).any()) == nan


@pytest.mark.cuda
@pytest.mark.parametrize("K", [128, 243, 625, 1024])
def test_resample_kernel_above_k64_on_card(cuda_device, K):
    """Exact on the card at K = 128, 243, 625 and 1024 (243 parameters:
    59,535 Gamma shapes, more than the card's shared memory holds, so the
    kernel draws them in passes of whole rows; 1024: 1,050,624 shapes): the
    resample kernel equals its plain version bit for bit, counts one launch
    and is one CUDA kernel per call."""
    from hammlet_tpu_torch.models import hmm, model_cuda

    for seed in range(3):
        priors, stats, noise = _resample_inputs(K, seed, cuda_device)
        before = model_cuda.resample_model_cuda.launches
        got = model_cuda.resample_model_cuda(priors, stats, noise)
        assert model_cuda.resample_model_cuda.launches == before + 1
        want = hmm.resample_model_reference(priors, stats, noise)
        for name, a, b in zip(hmm.HMMState._fields, got, want):
            assert _same_bits(a, b), (seed, name)
    names = _scan_kernels(lambda: model_cuda.resample_model_cuda(priors, stats, noise))
    assert len(names) == 1 and "modelupdate_resample_kernel" in names[0], names


@pytest.mark.cuda
def test_model_update_kernels_per_call_on_card(cuda_device):
    """One CUDA kernel per resample call and one per statistics call (the
    cooperative modelupdate_stats_kernel), at the main path's shape (B =
    29,696, K = 3; one row, and four rows at P = 4) (the kernel nodes of a
    captured call)."""
    from hammlet_tpu_torch.models import model_cuda

    for R in (1, 4):
        args, _, P = _stats_inputs(R, 29_696, 3, 1, 5, cuda_device)
        names = _scan_kernels(lambda: model_cuda.sweep_stats_cuda(*args, P))
        assert len(names) == 1 and "modelupdate_stats_kernel" in names[0], names
    priors, stats, noise = _resample_inputs(3, 1, cuda_device)
    names = _scan_kernels(lambda: model_cuda.resample_model_cuda(priors, stats, noise))
    assert len(names) == 1 and "modelupdate_resample_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("R, B", [(1, 4_000_000), (4, 433_920), (4, 1_000_000), (1, 100_003)])
def test_sweep_stats_one_kernel_at_large_b_on_card(cuda_device, R, B):
    """Exact on the card at the large shapes (T = 4M's burn-in capacity,
    T = 250M's four local rows, and beyond): the statistics call is one
    CUDA kernel (the kernel nodes of a captured call) and equals its plain
    version bit for bit,
    each row of a many-row call its one-row call."""
    from hammlet_tpu_torch.models import model_cuda
    from hammlet_tpu_torch.samplers import sweep

    args, _, P = _stats_inputs(R, B, 3, 1, B + R, cuda_device, "masked")
    names = _scan_kernels(lambda: model_cuda.sweep_stats_cuda(*args, P))
    assert len(names) == 1 and "modelupdate_stats_kernel" in names[0], names
    got = model_cuda.sweep_stats_cuda(*args, P)
    assert _same_bits(got, sweep.sweep_stats_reference(*args, P))
    states, sizes, nb, bstats, mapping = args
    for r in range(R if R > 1 else 0):
        one = model_cuda.sweep_stats_cuda(states[r:r + 1], sizes[r:r + 1], nb[r:r + 1],
                                          bstats[:, :, r:r + 1].contiguous(), mapping, P)
        assert torch.equal(got[r].view(torch.int32), one[0].view(torch.int32)), r


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 4])
def test_sweep_stats_after_100_graph_replays_on_card(cuda_device, R):
    """Exact on the card: the cooperative statistics kernel captured into
    one CUDA graph gives the eager call's bits on every one of 100 replays
    (B = 29,696 per row, a masked tail)."""
    from hammlet_tpu_torch.models import model_cuda

    args, _, P = _stats_inputs(R, 29_696, 3, 1, 40 + R, cuda_device, "masked")
    want = model_cuda.sweep_stats_cuda(*args, P)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model_cuda.sweep_stats_cuda(*args, P)
    for _ in range(100):
        got.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_sweep_stats_from_two_threads_on_card(cuda_device):
    """Exact on the card: two threads calling the statistics kernel at once
    on one card, each on its own stream and inputs (as engines driven from
    threads do), each get the bits of their calls made alone."""
    import threading

    from hammlet_tpu_torch.models import model_cuda

    cases = [_stats_inputs(R, B, 3, 1, 60 + R, cuda_device, "masked")
             for R, B in ((1, 29_696), (4, 433_920))]
    want = [model_cuda.sweep_stats_cuda(*args, P) for args, _, P in cases]
    torch.cuda.synchronize()
    got: list = [[], []]
    errors: list = []

    def run(i):
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream):
                args, _, P = cases[i]
                for _ in range(20):
                    got[i].append(model_cuda.sweep_stats_cuda(*args, P))
            stream.synchronize()
        except Exception as exc:  # noqa: BLE001 - handed to the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(2):
        assert len(got[i]) == 20
        for out in got[i]:
            assert torch.equal(out.view(torch.int32), want[i].view(torch.int32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 10])
@pytest.mark.parametrize("case", VOTE_CASES)
def test_resample_kernel_vote_cases_on_card(cuda_device, K, case):
    """Exact on the card: on noise built so that no try is accepted (the
    mode), only try 7 is, all are, or a NaN sits in a try
    (_torch_helpers.vote_noise), the resample kernel's first-accepted-try
    vote gives the bits of its plain version."""
    from hammlet_tpu_torch.models import hmm, model_cuda

    priors, stats, _ = _resample_inputs(K, 5, cuda_device)
    noise = tuple(torch.from_numpy(a).to(cuda_device)
                  for a in vote_noise(case, K, 2 * K + K * K, 20 + K))
    got = model_cuda.resample_model_cuda(priors, stats, noise)
    want = hmm.resample_model_reference(priors, stats, noise)
    for name, a, b in zip(hmm.HMMState._fields, got, want):
        assert _same_bits(a, b), name


@pytest.mark.cuda
def test_model_update_in_cuda_graph_on_card(cuda_device):
    """Exact on the card: both kernels captured into a CUDA graph and
    replayed twice give the bits of the eager calls."""
    from hammlet_tpu_torch.models import model_cuda

    args, _, P = _stats_inputs(4, 9_600, 3, 1, 8, cuda_device, "masked")
    priors, stats, noise = _resample_inputs(3, 2, cuda_device)
    want = model_cuda.sweep_stats_cuda(*args, P)
    rwant = model_cuda.resample_model_cuda(priors, stats, noise)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model_cuda.sweep_stats_cuda(*args, P)
        rgot = model_cuda.resample_model_cuda(priors, stats, noise)
    for _ in range(2):
        got.zero_()
        for t in rgot:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(rgot, rwant))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_graphed_engines_through_model_kernels_on_card(cuda_device, P):
    """Exact on the card at T = 100,000: a graphed Engine (P = 1) and a
    graphed sharded engine (P = 4 shards) write the model and buffers of
    the same engine run eagerly, and both run their sweep statistics and
    resample through the model-update kernels (the wrappers count the eager
    sweeps' calls and the captures')."""
    from _torch_helpers import eager_sharded_engine
    from hammlet_tpu_torch.models import model_cuda

    data = synth_segments(100_000, 43)[0]
    engines = []
    for eager in (False, True):
        before = model_cuda.sweep_stats_cuda.launches, model_cuda.resample_model_cuda.launches
        if P == 1:
            eng = runner.make_engine(data, nr_params=3, seed=6, device=cuda_device)
            if eager:
                eager_engine(eng)
        else:
            eng = _sharded(data, cuda_device, 6, P=P)
            if eager:
                eager_sharded_engine(eng)
        eng.run("M", 8, 0)
        eng.run("F", 32, 2)
        torch.cuda.synchronize()
        assert model_cuda.sweep_stats_cuda.launches > before[0]
        assert model_cuda.resample_model_cuda.launches > before[1]
        engines.append(eng)
    g, e = engines
    assert _graphed(g) and e.phase_graphs.replays == 0
    names = [n for n in ("counts", "ever_boundary", "n_records", "everb", "n_rec")
             if hasattr(g.buffers, n)]
    for name in names:
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 3, 4])
@pytest.mark.parametrize("K", [9, 27, 64, 81])
def test_fbscan_cross_shard_calls_match_plain_on_card(cuda_device, K, B):
    """Exact on the card: the sharded sweep's cross-shard scans at P = B
    shards (parallel/sharded.py: the (K, K, P) view of the P gathered shard
    totals, the (K, P) view of their maps), as those views and as
    contiguous copies, at K = 9-81: each call counts one launch of its
    wrapper and gives its plain version's bits; at K > 32 each prefix call
    is one tiled-product kernel."""
    from chip_smoke import FB_DEEP, FB_TILED
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    rng = np.random.default_rng(100 * B + K)
    tots = torch.from_numpy(rng.uniform(0.05, 1.0, size=(B, K, K)).astype(np.float32)).to(cuda_device)
    tmaps = torch.from_numpy(rng.integers(0, K, size=(B, K))).to(cuda_device)
    views = (tots.permute(1, 2, 0), tmaps.T)
    for M, maps in (views, tuple(v.contiguous() for v in views)):
        before = (fb_cuda.prefix_matmul_scan_cuda.launches, fb_cuda.suffix_compose_scan_cuda.launches)
        got, sgot = fb.prefix_matmul_scan_t(M), fb.suffix_compose_scan_t(maps)
        torch.cuda.synchronize()
        assert (fb_cuda.prefix_matmul_scan_cuda.launches,
                fb_cuda.suffix_compose_scan_cuda.launches) == (before[0] + 1, before[1] + 1)
        assert_bitwise(got, fb.prefix_matmul_scan_reference(M.contiguous()))
        assert torch.equal(sgot, fb.suffix_compose_scan_reference(maps.contiguous()))
    if K > 32:
        names = _scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))
        assert len(names) == 1 and (FB_DEEP if K <= 64 else FB_TILED)[0] in names[0], names


@pytest.mark.cuda
def test_sharded_tracks_graph_matches_eager_on_card(cuda_device, tmp_path):
    """Exact on the card: the sharded engine with P = 4 shards of three
    tracks at K = 27 (chip_smoke.states27_steps, -s C 3 3), whose sweep
    takes the wide prefix instances in four rows, the team kernels over the
    (27, 27, 4) shard totals and the one-launch suffix, writes the same
    bytes whether it replays graphs or runs its chunks through the eager
    sharded_phase; every sweep of the graphed run was a replay, the eager
    engine replayed none, and the marginal rows have 27 columns and count
    the recorded sweeps."""
    from _torch_helpers import eager_sharded_engine
    from chip_smoke import states27_steps
    from hammlet_tpu_torch.parallel import sharded

    data = states27_steps(200_000)[0]
    streams = ("marginals", "parameters", "compression")
    engines, out = [], {}
    for tag in ("graph", "eager"):
        rec = Records(len(data), str(tmp_path / f"{tag}-"), ".csv", 27, outputs=set(streams),
                      overwrite=True)
        eng = sharded.make_sharded_engine(data, n_devices=4, nr_params=3, nr_data_dim=3, seed=3,
                                          records=rec, device=cuda_device)
        if tag == "eager":
            eager_sharded_engine(eng)
        eng.run_scheme("M 16 0 F 32 4".split())
        eng.finalize()
        engines.append(eng)
        out[tag] = {s_: (tmp_path / f"{tag}-{s_}.csv").read_bytes() for s_ in streams}
    g, e = engines
    assert g.device.type == "cuda" and g.spec.nr_states == 27 and _graphed(g)
    assert e.phase_graphs.replays == 0
    for s_ in streams:
        assert out["graph"][s_] == out["eager"][s_], s_
    rows = [list(map(int, line.split("\t"))) for line in out["graph"]["marginals"].decode().splitlines()]
    assert all(len(r) == 28 and sum(r[1:]) == 8 for r in rows)
    assert sum(r[0] for r in rows) == len(data)


@pytest.mark.cuda
def test_cli_tracks_graph_matches_eager_on_card(cuda_device, tmp_path, monkeypatch):
    """Exact on the card: cli.main at -s C 3 3 (three tracks, K = 27) with
    the default scheme's ops in order (M · 0 S P F · 0 F · t, its sweeps
    cut) and all seven outputs writes the same bytes whether the engine
    replays its CUDA graphs or runs the eager gibbs_phase; every sweep of
    the graphed run was a replay; 27 mapping rows, one line per recorded
    sweep in every per-sweep stream."""
    from chip_smoke import states27_steps

    np.savetxt(tmp_path / "d.csv", states27_steps(200_000, seed=21)[0], fmt="%.5f")
    make = cli.make_engine
    engines, out = [], {}
    for tag in ("graph", "eager"):
        wrap = eager_engine if tag == "eager" else (lambda e: e)
        monkeypatch.setattr(cli, "make_engine", lambda *a, **k: engines.append(wrap(make(*a, **k))) or engines[-1])
        argv = ["-f", str(tmp_path / "d.csv"), "-s", "C", "3", "3", "-a", "-R", "3", "-i",
                *"M 16 0 S P F 16 0 F 64 4".split(), "-O", *STREAMS,
                "-o", str(tmp_path / f"{tag}-"), ".csv", "-w"]
        assert cli.main(argv) == 0
        out[tag] = {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}
    assert engines[0].device.type == "cuda" and engines[0].spec.nr_states == 27
    assert _graphed(engines[0]) and engines[1].phase_graphs.replays == 0
    for s in STREAMS:
        assert out["graph"][s] == out["eager"][s], s
    assert out["graph"]["mapping"].count(b"\n") == 27
    for s in ("sequences", "parameters", "blocks", "compression", "segments"):
        assert out["graph"][s].count(b"\n") == 16, s


@pytest.mark.cuda
def test_ceiling_truncates_burn_in_at_k64_on_card(cuda_device, monkeypatch):
    """Exact on the card, K = 64 (chip_smoke.states64_steps, -s C 4 3: the
    tiled-product prefix) under a ceiling of 16,384 blocks (runner.
    _MAX_CAPACITY, what HAMMLET_MAX_CAPACITY sets) well below the first
    sweeps' block count after a prior draw: the F burn-in's first chunk
    runs at the ceiling, truncated (its sweeps needed more blocks), the
    recording phase is exact (its rows sum to the recorded sweeps, no
    recording chunk truncated), and the graphed engine ends with the eager
    engine's counts and model."""
    from chip_smoke import log_chunks, states64_steps

    data = states64_steps(200_000, seed=22)[0]
    monkeypatch.setattr(runner, "_MAX_CAPACITY", 16_384)
    engines = []
    for eager in (False, True):
        eng = runner.make_engine(data, nr_params=4, nr_data_dim=3, seed=6, device=cuda_device)
        if eager:
            eager_engine(eng)
        log = []
        log_chunks(eng, log)
        eng.run_scheme("F 16 0 F 32 4".split())
        assert eng.max_capacity == 16_384
        assert log[0]["capacity"] == 16_384 and log[0]["truncated"], log[0]
        assert not any(r["truncated"] for r in log if r["record"])
        engines.append(eng)
    g, e = engines
    assert _graphed(g)
    assert set(g.marginal_counts.sum(axis=0).tolist()) == {8}
    for name in ("counts", "ever_boundary", "n_records", "n_boundaries"):
        assert torch.equal(getattr(g.buffers, name), getattr(e.buffers, name)), name
    assert all(torch.equal(a, b) for a, b in zip(g.model, e.model))
