"""The port's multi-process runtime on the CPU: real two-process gloo runs of
the port's CLI front door, counterparts of tests/test_multihost.py.

Every run holds 4 shards of T = 3,000 positions, as 2 processes x 2 shards
(``python -m hammlet_tpu_torch.parallel.mh_worker``) or 1 process x 4
(``bin/hammlet-torch -D 4``), with the scheme ``M 10 0 F 10 0 F 20 2`` in
chunks of 4 sweeps and a shared checkpoint every 8. Each process prints a
digest of the replicated model after every chunk and every output file it
opens for writing."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_helpers import cpu_requested  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEME = "M 10 0 F 10 0 F 20 2".split()
STREAMS = ("marginals", "parameters", "compression")
TIMEOUT = 120  # seconds per process

# each process of a run: chunks of 4 sweeps, a model digest after every
# chunk, every file opened for writing under OUT, and an optional kill
# (os._exit: unflushed stream buffers are lost, as under SIGKILL)
_LAUNCH = """
import builtins, hashlib, os, runpy, sys
import torch
torch.set_num_threads(1)
from hammlet_tpu_torch import runner
from hammlet_tpu_torch.parallel import mh_worker, sharded
runner.PHASE_CHUNK = 4
out_dir = os.environ["OUT"]
real_open = builtins.open
def logged_open(file, mode="r", *a, **k):
    if str(file).startswith(out_dir) and any(c in mode for c in "wax+"):
        print("OPEN", file, flush=True)
    return real_open(file, mode, *a, **k)
builtins.open = logged_open
real_ckpt = sharded.ShardedEngine._maybe_checkpoint
kill_at = int(os.environ.get("KILL_AT", "-1"))
def hooked(self):
    real_ckpt(self)
    digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in self.model))
    print("MODEL", self.sweeps_completed, digest.hexdigest(), flush=True)
    if self.sweeps_completed == kill_at:
        os._exit(9)
sharded.ShardedEngine._maybe_checkpoint = hooked
if sys.argv[1] == "worker":
    mh_worker.main(sys.argv[2:])
else:
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, prefix, ck, kill_at=-1, n_proc=2):
    """Start one run; returns its processes."""
    env = {**os.environ, "PYTHONPATH": REPO, "OUT": str(tmp), "KILL_AT": str(kill_at),
           "HAMMLET_MH_EXTRA": f"-w -C {ck} 8"}
    for name in ("HAMMLET_NUM_PROCESSES", "HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID"):
        env.pop(name, None)
    data = str(tmp / "data.csv.gz")
    if n_proc == 1:
        argv = [[os.path.join(REPO, "bin", "hammlet-torch"), "-f", data, "-s", "3", "-a",
                 "-R", "5", "-D", "4", "-o", str(tmp / prefix), ".csv", "-O", *STREAMS,
                 "-i", *SCHEME, "-w", "-C", str(ck), "8"]]
    else:
        port = str(_free_port())
        argv = [["worker", str(pid), "2", port, data, str(tmp / prefix), "2", *SCHEME]
                for pid in range(2)]
    return [
        subprocess.Popen([sys.executable, "-c", _LAUNCH, *a], env=env, cwd=str(tmp),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in argv
    ]


def _wait(procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return logs


def _lines(log, tag):
    return [line.split()[1:] for line in log.splitlines() if line.startswith(tag + " ")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted two-process run and a one-process run of the same
    command."""
    from hammlet_tpu_torch.parallel.mh_worker import synth

    tmp = tmp_path_factory.mktemp("mp")
    with gzip.open(tmp / "data.csv.gz", "wt") as fh:
        fh.write("\n".join(f"{v:.6f}" for v in synth(3000)))
    two = _launch(tmp, "mh-", tmp / "mh.ckpt")
    one = _launch(tmp, "sp-", tmp / "sp.ckpt", n_proc=1)
    logs = _wait(two + one)
    for p, log in zip(two + one, logs):
        assert p.returncode == 0, log[-3000:]
    return tmp, logs


def test_two_processes_match_one_process(runs):
    """2 gloo processes x 2 shards write byte-identical outputs to 1 process
    x 4 shards (bin/hammlet-torch -D 4); the replicated model is bitwise
    equal on both processes after every chunk, and equal to the
    one-process run's."""
    tmp, logs = runs
    assert "primary=True" in logs[0] and "primary=False" in logs[1]
    for s in STREAMS:
        assert (tmp / f"mh-{s}.csv").read_bytes() == (tmp / f"sp-{s}.csv").read_bytes(), s
    digests = [_lines(log, "MODEL") for log in logs]
    assert len(digests[0]) == 11  # chunks of 4: 3 + 3 + 5
    assert digests[0] == digests[1] == digests[2]


def test_non_primary_opens_no_file(runs, tmp_path):
    """In the two-process run only process 0 opens output or checkpoint
    files; Records(write=False) itself opens none, whatever it is fed."""
    from hammlet_tpu_torch.io.records import Records

    _, logs = runs
    opened = [{path for (path,) in _lines(log, "OPEN")} for log in logs[:2]]
    assert not opened[1]
    assert {os.path.basename(p) for p in opened[0]} >= {f"mh-{s}.csv" for s in STREAMS}
    rec = Records(
        100, str(tmp_path / "np-"), ".csv", 3,
        outputs={"marginals", "sequences", "blocks", "parameters", "compression", "segments"},
        write=False, resume_records=3,
    )
    rec.record_sweeps_batch(np.zeros((1, 4), np.int32), np.full((1, 4), 25, np.int32),
                            np.array([4]), np.array([0]))
    rec.record_theta(np.zeros(3), np.ones(3))
    rec.save_marginals_from_segments(np.array([0, 50]), np.array([[5, 0, 0], [0, 5, 0]]))
    rec.flush()
    rec.close()
    assert list(tmp_path.iterdir()) == []


def test_two_process_kill_and_resume(runs):
    """A two-process run killed after sweep 32 (its last checkpoint at 28,
    two recorded sweeps later) and rerun with the same command writes the
    bytes of the uninterrupted two-process run: both processes restore the
    shared checkpoint, and the streams keep the checkpoint's lines."""
    tmp, _ = runs
    ck = tmp / "kr.ckpt"
    procs = _launch(tmp, "kr-", ck, kill_at=32)
    logs = _wait(procs)
    assert [p.returncode for p in procs] == [9, 9], logs[0][-3000:]
    with np.load(ck) as z:
        assert int(z["sweeps_completed"]) == 28 and int(z["n_rec"]) == 4
    procs = _launch(tmp, "kr-", ck)
    logs = _wait(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert _lines(logs[0], "MODEL")[0][0] == "32"  # resumed after sweep 28
    for s in STREAMS:
        assert (tmp / f"kr-{s}.csv").read_bytes() == (tmp / f"mh-{s}.csv").read_bytes(), s
