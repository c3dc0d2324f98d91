"""The port's command line (hammlet_tpu_torch/cli.py) against the JAX
package's (hammlet_tpu/cli.py): the same parse, the same error texts, the
same -g dump, the same streams end to end, and -M chains."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import synth_segments, cpu_requested  # noqa: F401
from hammlet_tpu import cli as jcli
from hammlet_tpu.golden.parity import read_marginals, tv_aligned
from hammlet_tpu_torch import cli as tcli

torch.set_num_threads(1)

ARGVS = [
    ["-f", "a.csv", "b.csv", "-s", "3", "-a", "-R", "4", "-w"],
    ["-input-file", "x", "-random-seed", "11", "-auto-priors", "-overwrite"],
    ["-t", "-0.5", "-m", "-2", "-I", "-.25", "-e", "normal", "0.3", "0.8"],
    ["-states", "C", "2", "2", "-transitions", "1", "2", "-no-self-transitions"],
    ["-O", "M", "S", "P", "B", "C", "D", "G", "-o", "out-", ".tsv", "-v", "-g"],
    ["-output-data", "marginals", "-output-pattern", "p", "s", "-verbose"],
    ["-i", "M", "5", "0", "S", "P", "F", "10", "2", "-iterations-x"],
    ["-C", "ck.npz", "50", "-D", "1", "-M", "-f", "c1.csv", "c2.csv"],
    ["-checkpoint", "ck", "-devices", "2", "-multi", "-help", "--help"],
    ["-weight-multiplier", "1.5", "-initial-dist", "0.1", "-arguments"],
    ["-h"],
    [],
    ["data.csv"],
    ["-s", "3", "-s", "4"],
    ["-s", "3", "-states", "4"],
    ["-f", "x", "-q"],
]


def _parse(parse, argv):
    try:
        return parse(argv)
    except SystemExit as e:
        return ("SystemExit", str(e))


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40] or "empty")
def test_parse_args_matches_jax(argv):
    """Exact: the same dict (or the same error) for long and short aliases
    and negative numbers."""
    assert _parse(tcli.parse_args, argv) == _parse(jcli.parse_args, argv)


ERROR_ARGVS = [
    ["-f", "x", "-q"],  # unknown flag
    ["-s", "3", "-s", "4"],  # duplicate
    ["data.csv"],  # positional first
    ["-R", "eleven", "-a"],  # conversion
    ["-a", "-e", "normal", "0.2"],  # missing argument
    ["-a", "-t", "x"],
    ["-a", "-s", "X", "2"],
    ["-a", "-s", "I", "2"],
    ["-a", "-e", "gamma", "1", "1"],
    ["-s", "3", "-R", "1"],  # no -a
    ["-a", "-R", "1", "-i", "F", "10"],  # malformed scheme
    ["-a", "-R", "1", "-i", "F", "10", "2", "X"],
    ["-a", "-R", "1", "-M"],  # -M without -f
]


@pytest.mark.parametrize("argv", ERROR_ARGVS, ids=lambda a: " ".join(a))
def test_error_texts_match_jax(argv, capsys, tmp_path, monkeypatch):
    """Exact: the same exit code and standard error, and no file made."""
    monkeypatch.chdir(tmp_path)
    rc_j = jcli.main(list(argv))
    err_j = capsys.readouterr()
    rc_t = tcli.main(list(argv))
    err_t = capsys.readouterr()
    assert (rc_t, err_t.err, err_t.out) == (rc_j, err_j.err, err_j.out) and rc_t == 1
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [
    ["-g", "-a", "-R", "4", "-i", "F", "10"],
    ["-arguments", "-f", "d.csv", "-O", "C", "G", "-s", "C", "2", "2", "-t", "-1", "-i", "F", "2", "0", "X"],
])
def test_argument_dump_byte_identical(argv, capsys, tmp_path, monkeypatch):
    """Exact: the -g dump (printed before the scheme check fails) is the
    JAX package's, byte for byte."""
    monkeypatch.chdir(tmp_path)
    assert jcli.main(list(argv)) == 1
    want = capsys.readouterr()
    assert tcli.main(list(argv)) == 1
    got = capsys.readouterr()
    assert got.out == want.out and got.out.count("\n") == len(tcli._REGISTERED)
    assert got.err == want.err


def _data_file(tmp_path, T=1200, seed=3):
    f = tmp_path / "d.csv"
    np.savetxt(f, synth_segments(T, seed)[0])
    return str(f)


def test_fails_before_any_output(tmp_path, capsys, monkeypatch):
    """Omitting -a, a malformed -i, -D 0 and a -D that is not the processes
    times HAMMLET_LOCAL_DEVICES fail before any output file exists; without
    -w an existing output stops the run before the next stream's file is
    made."""
    f = _data_file(tmp_path)
    base = ["-f", f, "-o", str(tmp_path / "o-"), ".csv", "-R", "1", "-O", "M", "S"]
    for extra, text in [
        ([], "use -a"),
        (["-a", "-i", "F", "10"], "multiples of 3"),
        (["-a", "-D", "0"], "at least one shard"),
        (["-a", "-devices", "3", "-M"], "HAMMLET_LOCAL_DEVICES=2"),
    ]:
        if "-M" in extra:
            monkeypatch.setenv("HAMMLET_LOCAL_DEVICES", "2")
        assert tcli.main(base + extra) == 1
        err = capsys.readouterr().err
        assert "[ERROR]" in err and text in err, (extra, err)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["d.csv"], extra

    monkeypatch.delenv("HAMMLET_LOCAL_DEVICES")
    (tmp_path / "o-marginals.csv").write_text("keep\n")
    assert tcli.main(base + ["-a"]) == 1
    assert "already exists" in capsys.readouterr().err
    assert (tmp_path / "o-marginals.csv").read_text() == "keep\n"
    assert not (tmp_path / "o-sequences.csv").exists()


@pytest.mark.parametrize("how", ["main", "bin"])
def test_no_card_without_the_cpu_request_fails(tmp_path, capsys, monkeypatch, how):
    """Without a card and without HAMMLET_TORCH_DEVICE the CLI (cli.main
    with torch.cuda.is_available() made False; bin/hammlet-torch in a
    process that sees no card) prints one [ERROR] that names the request,
    exits 1 and makes no file. With HAMMLET_TORCH_DEVICE=cpu the same
    command runs, on the CPU."""
    import os
    import subprocess
    import sys

    from hammlet_tpu_torch.device import DEVICE_VAR

    f = _data_file(tmp_path, T=600)
    argv = ["-f", f, "-o", str(tmp_path / "o-"), ".csv", "-a", "-R", "1", "-i", "M", "4", "0",
            "F", "4", "2", "-O", "M", "-v"]
    monkeypatch.delenv(DEVICE_VAR)
    if how == "main":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

        def run(env):
            for name, value in env.items():
                monkeypatch.setenv(name, value)
            rc = tcli.main(argv)
            got = capsys.readouterr()
            return rc, got.out, got.err
    else:
        exe = str(Path(__file__).resolve().parents[1] / "bin" / "hammlet-torch")

        def run(env):
            proc = subprocess.run([sys.executable, exe, *argv], capture_output=True, text=True,
                                  timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **env})
            return proc.returncode, proc.stdout, proc.stderr

    rc, out, err = run({})
    assert rc == 1 and err.count("[ERROR]") == 1 and f"{DEVICE_VAR}=cpu" in err, (rc, err)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["d.csv"]
    rc, out, err = run({DEVICE_VAR: "cpu"})
    assert rc == 0 and "Device: cpu" in out, (rc, err)
    assert (tmp_path / "o-marginals.csv").exists()


@pytest.mark.parametrize("value", ["2", "auto"])
def test_multi_host_env_refused(tmp_path, capsys, monkeypatch, value):
    """A multi-process environment that does not say how to reach the other
    processes (no HAMMLET_COORDINATOR and HAMMLET_PROCESS_ID; for auto, no
    torchrun variables) stops with an [ERROR] before any file is made."""
    for name in ("HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID", "WORLD_SIZE", "RANK",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HAMMLET_NUM_PROCESSES", value)
    f = _data_file(tmp_path)
    assert tcli.main(["-f", f, "-a", "-R", "1", "-w", "-D", "2"]) == 1
    err = capsys.readouterr().err
    assert "[ERROR]" in err and ("HAMMLET_COORDINATOR" if value == "2" else "WORLD_SIZE") in err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["d.csv"]


def test_shards_not_a_multiple_of_processes_refused(tmp_path, capsys, monkeypatch):
    """In a group of 2 processes, -D 3 stops with an [ERROR] before any file
    is made (every process must hold the same number of shards)."""
    monkeypatch.setattr(tcli.distributed, "world_size", lambda: 2)
    f = _data_file(tmp_path)
    assert tcli.main(["-f", f, "-a", "-R", "1", "-w", "-D", "3"]) == 1
    err = capsys.readouterr().err
    assert "[ERROR]" in err and "not a multiple of the 2 processes" in err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["d.csv"]


# ---- end to end -------------------------------------------------------------

T_E2E = 3000
N_REC = 30  # F 60 2
STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "mapping", "segments")


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both CLIs, two seeds each, all seven outputs, on low-SNR data
    (segments of 100, means {0, 1, -1}: the posterior is uncertain, so the
    seeds disagree and the envelope is wide enough to mean something)."""
    tmp = tmp_path_factory.mktemp("e2e")
    data, truth = synth_segments(T_E2E, 7, seglen=100, scale=0.5)
    np.savetxt(tmp / "d.csv", data)
    for (who, main), seed in itertools.product((("jax", jcli.main), ("torch", tcli.main)), (1, 2)):
        argv = [
            "-f", str(tmp / "d.csv"), "-o", str(tmp / f"{who}{seed}-"), ".csv",
            "-s", "3", "-a", "-R", str(seed), "-i", "M", "20", "0", "F", "60", "2",
            "-O", *STREAMS, "-w",
        ]
        assert main(argv) == 0, who
    return tmp, truth


@pytest.mark.parametrize("who", ["jax", "torch"])
def test_cli_streams_structure(e2e, who):
    """Every stream of both CLIs passes tests/test_e2e.py's structural
    checks; the last segments line counts the marginals rows, and the
    mapping is the combinations mapping."""
    tmp, _ = e2e
    T = T_E2E

    def read(s, seed=1):
        return (tmp / f"{who}{seed}-{s}.csv").read_text().splitlines()

    seq_re = re.compile(r"^\d+:\d+(\t\d+:\d+)*$")
    seq_bounds = []
    seq_lines = read("sequences")
    assert len(seq_lines) == N_REC
    for line in seq_lines:
        assert seq_re.match(line), line[:80]
        toks = [tuple(map(int, t.split(":"))) for t in line.split("\t")]
        assert sum(n for n, _ in toks) == T
        assert all(a[1] != b[1] for a, b in zip(toks, toks[1:]))
        seq_bounds.append(np.cumsum([n for n, _ in toks])[:-1])

    blk_lines, comp_lines = read("blocks"), read("compression")
    assert len(blk_lines) == len(comp_lines) == N_REC
    for bl, cl in zip(blk_lines, comp_lines):
        sizes = list(map(int, bl.split("\t")))
        assert sum(sizes) == T and all(s > 0 for s in sizes)
        assert cl == f"{T / len(sizes):.6g}"

    par_lines = read("parameters")
    assert len(par_lines) == N_REC
    for line in par_lines:
        fields = line.split("\t")
        assert len(fields) == 6 and all(re.match(r"^-?\d+\.\d{6}$", f) for f in fields)

    segs = [tuple(map(int, x.split("\t"))) for x in read("segments")]
    assert len(segs) == N_REC
    assert all(0 < n <= T and internal == n * 4 for n, internal in segs)
    assert [n for n, _ in segs] == sorted(n for n, _ in segs)  # the union only grows

    rows = [list(map(int, x.split("\t"))) for x in read("marginals")]
    assert sum(r[0] for r in rows) == T
    assert all(sum(r[1:]) == N_REC for r in rows)
    assert segs[-1][0] == len(rows)
    marg_bounds = set(np.cumsum([r[0] for r in rows])[:-1].tolist())
    for bounds in seq_bounds:
        assert not set(bounds.tolist()) - marg_bounds

    assert read("mapping") == ["0", "1", "2"]


def test_cli_marginals_within_seed_envelope(e2e):
    """Statistical (the random streams differ): the mean JAX-vs-port
    marginal distance stays within the seed-to-seed envelope, as in
    test_torch_runner.py::test_slice_end_to_end_vs_jax, and the port's MAP
    accuracy within 0.02 of the JAX runs'."""
    tmp, truth = e2e
    mj = [read_marginals(tmp / f"jax{s}-marginals.csv") for s in (1, 2)]
    mt = [read_marginals(tmp / f"torch{s}-marginals.csv") for s in (1, 2)]
    envelope = (tv_aligned(mj[0], mj[1]) + tv_aligned(mt[0], mt[1])) / 2
    ours = np.mean([tv_aligned(a, b) for a in mj for b in mt])
    assert ours <= envelope + max(0.5 * envelope, 0.005) + 0.002, (ours, envelope)

    def accuracy(m):
        return max(
            float((np.asarray(p)[m.argmax(axis=1)] == truth).mean())
            for p in itertools.permutations(range(3))
        )

    assert min(map(accuracy, mt)) >= min(map(accuracy, mj)) - 0.02


# ---- -M ---------------------------------------------------------------------


@pytest.mark.parametrize("states", [["2"], ["C", "3", "2"]], ids=["s2", "sC32"])
def test_multi_chain_matches_solo_runs(tmp_path, states):
    """Exact: every -M chain's outputs are byte-identical to a solo run of
    its file with the same seed; with -C each chain checkpoints to its own
    file, and a rerun resumes each chain from its own state. At -s 2 on one
    track, and at -s C 3 2 on two tracks (K = 9, chip_smoke.py's
    configuration 4 data)."""
    from chip_smoke import config4_steps

    files = []
    for i, T in enumerate((800, 800, 1100)):
        f = tmp_path / f"chr{i + 1}.csv"
        np.savetxt(f, synth_segments(T, 10 + i)[0] if states == ["2"]
                   else config4_steps(2 * T, seed=10 + i)[0])
        files.append(str(f))
    common = ["-s", *states, "-a", "-R", "3", "-i", "M", "8", "0", "F", "12", "2",
              "-O", "marginals", "sequences", "parameters", "-w"]
    ck = tmp_path / "run.npz"
    argv = ["-M", "-f", *files, "-o", str(tmp_path / "wgs-"), ".csv", "-C", str(ck), "8", *common]
    assert tcli.main(argv) == 0
    assert not ck.exists()
    for i in range(3):
        assert (tmp_path / f"run-chr{i + 1}.npz").exists()
        assert tcli.main(["-f", files[i], "-o", str(tmp_path / f"solo{i}-"), ".csv", *common]) == 0
    outputs = {}
    for i, s in itertools.product(range(3), ("marginals", "sequences", "parameters")):
        outputs[i, s] = (tmp_path / f"wgs-chr{i + 1}-{s}.csv").read_bytes()
        assert outputs[i, s] == (tmp_path / f"solo{i}-{s}.csv").read_bytes(), (i, s)
    assert tcli.main(argv) == 0  # every chain's checkpoint is finished
    for (i, s), b in outputs.items():
        assert (tmp_path / f"wgs-chr{i + 1}-{s}.csv").read_bytes() == b, (i, s)


@pytest.mark.parametrize("names", [("a/chr1.txt", "b/chr1.txt", "chr2.txt"),
                                   ("chr1.txt", "chr2.txt", "chr1.csv.gz")],
                         ids=["directories", "extensions"])
@pytest.mark.parametrize("n_devices", [1, 2], ids=["sequential", "threads"])
def test_multi_chain_refuses_shared_stems(tmp_path, capsys, monkeypatch, names, n_devices):
    """-M with two files of one stem (their chains would write the same
    outputs and checkpoint) stops with an [ERROR] before any chain runs and
    any file is made, on the sequential path and the threaded one (two CPU
    devices standing in for two cards)."""
    import gzip

    files = []
    for name in names:
        path = tmp_path / "in" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        values = "\n".join(map(str, synth_segments(600, 1)[0])) + "\n"
        if name.endswith(".gz"):
            with gzip.open(path, "wt") as fh:
                fh.write(values)
        else:
            path.write_text(values)
        files.append(str(path))
    before = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    monkeypatch.setattr(tcli, "_chain_devices", lambda: [torch.device("cpu")] * n_devices)
    out = tmp_path / "out"
    out.mkdir()
    argv = ["-M", "-f", *files, "-o", str(out / "w-"), ".csv", "-a", "-R", "1", "-w",
            "-C", str(out / "ck.npz"), "8", "-i", "M", "4", "0", "F", "4", "2"]
    assert tcli.main(argv) == 1
    err = capsys.readouterr().err
    assert "[ERROR]" in err and "chr1 appears more than once" in err, err
    assert list(out.iterdir()) == []
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before + [Path("out")]


def test_help_describes_the_port_as_it_runs():
    """bin/hammlet-torch -h prints the manual as the code behaves: -D N
    shards (and spans the local cards), -M runs a chain per card, a missing
    card is an error unless the CPU is named; no passage from before the
    sharded engines and the card requirement."""
    import subprocess
    import sys

    exe = str(Path(__file__).resolve().parents[1] / "bin" / "hammlet-torch")
    proc = subprocess.run([sys.executable, exe, "-h"], capture_output=True, text=True, timeout=120)
    text = proc.stdout
    assert proc.returncode == 0 and "SYNOPSIS" in text, (proc.returncode, proc.stderr[-2000:])
    for stale in ("not ported", "[-D 1]", "else on the CPU", "N > 1 is an error",
                  "one after another on the one device"):
        assert stale not in text, stale
    assert "[-D N]" in text and "-D, -devices N" in text and "NCCL" in text
    assert "one chain runs per\n        card" in text and "HAMMLET_TORCH_DEVICE=cpu" in text
