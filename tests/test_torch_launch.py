"""The local launcher (hammlet_tpu_torch/parallel/launch.py) on the CPU:
``cli.main`` with ``-D 4`` handed to two worker processes over gloo, as it
is on a host with cards (``distributed.card_count`` is replaced by a host
with two cards). Every run holds 4 shards of the T = 3,000 data of
tests/test_torch_multiprocess.py."""

import gzip
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_helpers import cpu_requested  # noqa: F401

from hammlet_tpu_torch import cli
from hammlet_tpu_torch.parallel import distributed, launch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SCHEME = "M 10 0 F 10 0 F 20 2".split()
STREAMS = ("marginals", "parameters", "compression")
BOUND_S = 90  # a failed run ends within this (the collectives' timeout is 30 min)


@pytest.fixture
def data(tmp_path):
    from hammlet_tpu_torch.parallel.mh_worker import synth

    values = "\n".join(f"{v:.6f}" for v in synth(3000)) + "\n"
    with gzip.open(tmp_path / "data.csv.gz", "wt") as fh:
        fh.write(values)
    return tmp_path / "data.csv.gz", values


@pytest.fixture
def procs(monkeypatch):
    """Two cards, no process group in the environment, and every process
    the launcher starts."""
    monkeypatch.setattr(distributed, "card_count", lambda: 2)
    for name in ("HAMMLET_NUM_PROCESSES", "HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID",
                 "HAMMLET_LOCAL_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    started = []
    real = subprocess.Popen

    def spy(*args, **kwargs):
        started.append(real(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(launch.subprocess, "Popen", spy)
    return started


def _argv(*extra):
    return ["-s", "3", "-a", "-R", "5", "-D", "4", "-O", *STREAMS, "-i", *SCHEME, *extra]


def _read(prefix):
    return {s: open(f"{prefix}{s}.csv", "rb").read() for s in STREAMS}


def test_launch_matches_one_process(data, procs, tmp_path, capsys):
    """Exact: -D 4 through the launcher (2 processes x 2 shards) writes the
    bytes of one process with -D 4, prints rank 0's lines once, and leaves
    no process running."""
    f = str(data[0])
    assert cli.main(_argv("-f", f, "-o", str(tmp_path / "L-"), ".csv", "-v", "-w")) == 0
    out = capsys.readouterr().out
    assert len(procs) == 2 and all(p.poll() == 0 for p in procs)
    assert "Cards: 2; -D 4: 2 processes, one per card, shards per process: 2" in out
    assert out.count("Processes: 2, shards per process: 2") == 1
    assert out.count("Exit HaMMLET") == 1
    with pytest.MonkeyPatch.context() as m:
        m.setattr(distributed, "card_count", lambda: 1)  # one card: one process
        assert cli.main(_argv("-f", f, "-o", str(tmp_path / "one-"), ".csv", "-w")) == 0
    assert len(procs) == 2
    assert _read(tmp_path / "L-") == _read(tmp_path / "one-")


def test_stdin_spool_keeps_stdin_names(data, procs, tmp_path, monkeypatch):
    """Exact: a stdin run through the launcher writes hammlet-*.csv, the
    names and bytes of a one-process stdin run, and removes its spool."""
    spool = tmp_path / "spool"
    spool.mkdir()
    monkeypatch.setattr(launch.tempfile, "tempdir", str(spool))
    outs = {}
    for tag, cards in (("launch", 2), ("one", 1)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.setattr(distributed, "card_count", lambda cards=cards: cards)
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data[1].encode())))
        assert cli.main(_argv("-w")) == 0
        outs[tag] = sorted(p.name for p in d.iterdir()), _read(d / "hammlet-")
    assert len(procs) == 2
    assert outs["launch"] == outs["one"]
    assert outs["one"][0] == sorted(f"hammlet-{s}.csv" for s in STREAMS)
    assert list(spool.iterdir()) == []


def test_failing_primary_stops_the_group(data, procs, tmp_path, capsys):
    """An existing output without -w fails rank 0 before the ingest, while
    rank 1 goes on into the ingest's first collective and waits there: the
    launcher ends the run non-zero within BOUND_S with the [ERROR] line
    once, the file untouched and no process running."""
    (tmp_path / "x-marginals.csv").write_text("keep\n")
    t0 = time.monotonic()
    rc = cli.main(_argv("-f", str(data[0]), "-o", str(tmp_path / "x-"), ".csv"))
    elapsed = time.monotonic() - t0
    err = capsys.readouterr().err
    assert rc == 1 and elapsed < BOUND_S, (rc, elapsed)
    assert err.count("[ERROR]") == 1 and "already exists" in err, err
    assert (tmp_path / "x-marginals.csv").read_text() == "keep\n"
    assert len(procs) == 2 and all(p.poll() is not None for p in procs)


def test_multi_chain_without_files_fails_in_the_workers(procs, tmp_path, monkeypatch, capsys):
    """-M -D 4 with no -f: standard input is not spooled into a chain; every
    worker stops with the one-process error, shown once, and no file is
    made."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"1\n2\n")))
    assert cli.main(_argv("-M")) == 1
    err = capsys.readouterr().err
    assert err.count("[ERROR]") == 1 and "-M requires at least one -f input file" in err, err
    assert len(procs) == 2 and list(tmp_path.iterdir()) == []


def test_failing_worker_ends_run_on_cards(procs, monkeypatch, capsys):
    """A plain function whose last process raises while the other waits in
    a barrier: run_on_cards returns non-zero within BOUND_S, shows the
    error, and leaves no process running."""
    monkeypatch.setenv("PYTHONPATH", HERE)
    t0 = time.monotonic()
    rc, value = launch.run_on_cards("_torch_helpers:fail_on_last_rank", 2)
    assert rc == 1 and value is None and time.monotonic() - t0 < BOUND_S
    assert "failed on purpose" in capsys.readouterr().err
    assert len(procs) == 2 and all(p.poll() is not None for p in procs)


@pytest.mark.parametrize("n,cards,world", [(4, 4, 4), (8, 4, 4), (6, 4, 3), (3, 4, 3), (4, 1, 1)])
def test_pick_world(n, cards, world):
    """W is the largest divisor of N that is at most the cards."""
    assert launch.pick_world(n, cards) == world


@pytest.mark.parametrize("argv,env,cards,span", [
    (["-D", "4"], {}, 4, (4, 4)),
    (["-D", "8"], {}, 4, (8, 4)),
    (["-D", "4"], {}, 1, None),  # one card: one process
    (["-D", "1"], {}, 4, None),
    (["-D", "7"], {}, 4, None),  # no divisor above 1 fits: one process
    (["-D", "x"], {}, 4, None),  # fails in the run itself
    (["-D", "4", "-h"], {}, 4, None),
    (["-D", "4"], {"HAMMLET_NUM_PROCESSES": "2"}, 4, None),  # a launch by hand
    (["-a"], {}, 4, None),
])
def test_cards_to_span(argv, env, cards, span, monkeypatch):
    """The CLI hands a run to the launcher only for -D > 1 on several cards
    with no process group in the environment."""
    monkeypatch.delenv("HAMMLET_NUM_PROCESSES", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "card_count", lambda: cards)
    assert cli._cards_to_span(cli.parse_args(argv)) == span


@pytest.mark.parametrize("visible,n,want", [
    (None, 4, 4), ("", 4, 0), ("0", 4, 1), ("2,3", 4, 2), ("0,7,1", 4, 1),
    ("1,-1,2", 4, 1), ("GPU-5ab1,GPU-77c2", 4, 2), ("0,1,2,3,4", 2, 2),
])
def test_visible_cards(visible, n, want):
    """CUDA_VISIBLE_DEVICES as CUDA reads it: up to the first invalid entry."""
    assert distributed._visible_cards(n, visible) == want


def test_card_count_without_cuda():
    """A torch without CUDA has no card (and starts no probe)."""
    if torch.backends.cuda.is_built():
        pytest.skip("this torch is built with CUDA")
    assert distributed.card_count() == 0


def test_gathers_dtypes_without_wire_type():
    """A dtype no backend sends (int16) travels as bytes and comes back
    equal; a 0-d integer psum keeps its shape (one process: identities)."""
    from hammlet_tpu_torch.parallel.mesh import PositionMesh

    x = torch.tensor([[1, -2, 300], [4, 5, -32768]], dtype=torch.int16)
    gathered = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(PositionMesh, "world_size", property(lambda self: 1))
        m.setattr("hammlet_tpu_torch.parallel.mesh._all_gather",
                  lambda out, inp, group=None: (gathered.append(inp.dtype), out.copy_(inp)))
        got = PositionMesh(2, torch.device("cpu"), object()).all_gather(x)  # a group stand-in
    assert gathered == [torch.uint8] and got.dtype == torch.int16 and torch.equal(got, x)
    assert np.asarray(PositionMesh(2, torch.device("cpu")).psum(torch.tensor(3))).shape == ()
