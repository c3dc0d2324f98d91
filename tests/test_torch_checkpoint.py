"""Checkpoint/resume of the port (hammlet_tpu_torch/checkpoint.py): a
resumed run continues the exact chain, mismatches are rejected, the .npz has
the JAX package's keys and dtypes, and a checkpoint written by the JAX
package (hammlet_tpu/checkpoint.py) restores into the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import synth_segments, cpu_requested  # noqa: F401
from hammlet_tpu import checkpoint as jckpt
from hammlet_tpu import runner as jrun
from hammlet_tpu_torch import cli, runner
from hammlet_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from hammlet_tpu_torch.io.records import Records, _open_resumed

torch.set_num_threads(1)

DATA = synth_segments(1500, 3)[0]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(seed=9, data=DATA, **kw):
    return runner.make_engine(data, nr_params=3, seed=seed, device="cpu", **kw)


def _state(eng):
    m, b = eng.model, eng.buffers
    return {
        "theta_mean": m.theta_mean, "theta_var": m.theta_var, "A": m.A, "pi": m.pi,
        "counts": b.counts, "ever_boundary": b.ever_boundary,
        "n_records": b.n_records, "n_boundaries": b.n_boundaries,
    }


def _assert_same_state(a, b):
    for key, x in _state(a).items():
        y = _state(b)[key]
        assert x.dtype == y.dtype and torch.equal(x, y), key
    assert (a.sweep_counter, a.capacity) == (b.sweep_counter, b.capacity)


def test_resume_bitwise_equal(tmp_path):
    """Exact: M 32 0 -> save -> new engine -> restore -> F 64 4 equals the
    uninterrupted run in every model and buffer tensor, bit for bit."""
    ck = str(tmp_path / "state.npz")
    e1 = _engine()
    e1.run("M", 32, 0)
    e1.run("F", 64, 4)

    e2 = _engine()
    e2.run("M", 32, 0)
    save_checkpoint(e2, ck)
    e3 = _engine()
    restore_checkpoint(e3, ck)
    assert e3.sweeps_completed == 32
    e3.run("F", 64, 4)
    _assert_same_state(e1, e3)
    assert int(e3.buffers.n_records) == 16


def test_rejects_mismatch(tmp_path):
    """Another seed, other data, or another -i scheme than the one the
    cursor indexes is rejected."""
    ck = str(tmp_path / "c.npz")
    e = _engine(seed=1)
    e.ckpt_scheme_tokens = ["M", "8", "0", "F", "16", "2"]
    e.scheme_op_index, e.scheme_op_done = 2, 4  # mid-scheme cursor
    save_checkpoint(e, ck)
    with pytest.raises(ValueError, match="seed"):
        restore_checkpoint(_engine(seed=2), ck)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(_engine(seed=1, data=DATA[:1000]), ck)
    e2 = _engine(seed=1)
    restore_checkpoint(e2, ck)
    with pytest.raises(ValueError, match="scheme"):
        e2.run_scheme(["F", "32", "4"])


def test_jax_checkpoint_restores_into_port(tmp_path):
    """A checkpoint written by the JAX package has the port's keys and
    dtypes; restored into the port it gives the same counts and model
    tensors; the port's run continues from it, and every marginal row sums
    to all recorded sweeps (the JAX ones plus the port's)."""
    jck, tck = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    je = jrun.make_engine(DATA, nr_params=3, seed=5)
    je.run("M", 8, 0)
    je.run("F", 8, 2)
    jckpt.save_checkpoint(je, jck)

    te = _engine(seed=5)
    save_checkpoint(te, tck)
    with np.load(jck) as zj, np.load(tck) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert (zj[key].dtype, zj[key].shape) == (zt[key].dtype, zt[key].shape), key

    rec = Records(len(DATA), str(tmp_path / "resumed-"), ".csv", 3, overwrite=True)
    te = _engine(seed=5, records=rec)
    restore_checkpoint(te, jck)
    want = {
        "theta_mean": je.model.theta_mean, "theta_var": je.model.theta_var,
        "A": je.model.A, "pi": je.model.pi, "counts": je.buffers.counts,
        "ever_boundary": je.buffers.ever_boundary,
        "n_records": je.buffers.n_records, "n_boundaries": je.buffers.n_boundaries,
    }
    for key, t in _state(te).items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]), err_msg=key)
    assert (te.sweep_counter, te.sweeps_completed, te.capacity) == (
        je.sweep_counter, je.sweeps_completed, je.capacity
    )
    te.run("F", 16, 2)
    te.finalize()
    rows = [list(map(int, x.split("\t"))) for x in (tmp_path / "resumed-marginals.csv").read_text().splitlines()]
    assert sum(r[0] for r in rows) == len(DATA)
    assert all(sum(r[1:]) == 4 + 8 for r in rows)


def _cli_args(tmp_path, tag, ck, every, scheme="M 8 0 F 48 2"):
    f = tmp_path / "d.csv"
    if not f.exists():
        np.savetxt(f, DATA)
    return [
        "-f", str(f), "-o", str(tmp_path / f"{tag}-"), ".csv", "-s", "3", "-a",
        "-R", "7", "-i", *scheme.split(), "-w",
        "-O", "marginals", "sequences", "parameters", "blocks", "compression", "segments",
        "-C", str(ck), str(every),
    ]


STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "segments")


def _outputs(tmp_path, tag):
    return {s: (tmp_path / f"{tag}-{s}.csv").read_bytes() for s in STREAMS}


def test_cli_periodic_checkpoint_and_finished_rerun(tmp_path, capsys):
    """-C PATH 32 writes the file during the run; a rerun on the finished
    checkpoint samples nothing and leaves every output byte-identical."""
    ck = tmp_path / "run.ckpt"
    argv = _cli_args(tmp_path, "p", ck, 32)
    assert cli.main(argv) == 0
    assert ck.exists()
    with np.load(ck) as z:
        assert int(z["sweeps_completed"]) == 56 and int(z["n_records"]) == 24
    first = _outputs(tmp_path, "p")
    assert len(first["sequences"].splitlines()) == 24
    capsys.readouterr()
    assert cli.main(argv + ["-v"]) == 0
    assert "Sampled 0 sweeps" in capsys.readouterr().out
    assert _outputs(tmp_path, "p") == first


# the child process of test_cli_resume_after_interruption: the CLI with
# chunks of 8 sweeps, killed at sweep 40 without closing or flushing a file
_KILLED_RUN = """
import os, sys
import torch
torch.set_num_threads(1)
from hammlet_tpu_torch import cli, runner
runner.PHASE_CHUNK = 8
real = runner.Engine._maybe_checkpoint
def killed_at_40(self):
    real(self)
    if self.sweeps_completed == 40:  # last checkpoint at 32, 4 records later
        os._exit(9)
runner.Engine._maybe_checkpoint = killed_at_40
cli.main(sys.argv[1:])
"""


def test_cli_resume_after_interruption(tmp_path, monkeypatch):
    """A run killed between two checkpoints (os._exit: the streams' buffers
    are lost, as under SIGKILL) and rerun with the same arguments writes
    exactly the bytes of an uninterrupted run: every per-sweep stream keeps
    the lines of the sweeps the checkpoint holds, which were flushed before
    the save, drops the later ones (the resumed run redoes those sweeps) and
    continues. (The JAX package's CLI reopens the streams empty on resume,
    losing every line written before the interruption.)"""
    monkeypatch.setattr(runner, "PHASE_CHUNK", 8)
    assert cli.main(_cli_args(tmp_path, "whole", tmp_path / "whole.ckpt", 16)) == 0

    ck = tmp_path / "cut.ckpt"
    argv = _cli_args(tmp_path, "cut", ck, 16)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _KILLED_RUN, *argv], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 9, proc.stderr
    with np.load(ck) as z:
        assert int(z["sweeps_completed"]) == 32 and int(z["n_records"]) == 12
    assert len((tmp_path / "cut-parameters.csv").read_text().splitlines()) >= 12
    assert cli.main(argv) == 0
    assert _outputs(tmp_path, "cut") == _outputs(tmp_path, "whole")


def test_resumed_stream_drops_cut_off_line(tmp_path):
    """Exact: a stream whose last line was cut off mid-write keeps only its
    complete lines up to the checkpoint's count; one with fewer complete
    lines than the checkpoint counts is refused and left as it was."""
    path = tmp_path / "s.csv"
    path.write_bytes(b"1\t2\n3\t4\n5\t")
    with pytest.raises(ValueError, match="holds 2 lines"):
        _open_resumed(str(path), 3)
    assert path.read_bytes() == b"1\t2\n3\t4\n5\t"
    with _open_resumed(str(path), 2) as fh:
        fh.write("7\t8\n")
    assert path.read_bytes() == b"1\t2\n3\t4\n7\t8\n"
    with _open_resumed(str(path), 1) as fh:
        fh.write("9\n")
    assert path.read_bytes() == b"1\t2\n9\n"
    with _open_resumed(str(tmp_path / "new.csv"), 0) as fh:
        fh.write("0\n")
    assert (tmp_path / "new.csv").read_bytes() == b"0\n"
