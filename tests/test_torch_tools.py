"""The port's post-processing tools (hammlet_tpu_torch/tools/, pyhammlet/)
against the JAX package's (hammlet_tpu/tools/, pyhammlet/) on the inputs of
tests/test_tools.py and tests/test_tools_tail.py: byte-equal outputs
(gzip members compared decompressed: their headers carry the write time),
equal reader structures; and the bin/hammlet-torch-* wrappers with jax,
hammlet_tpu and matplotlib blocked."""

import gzip
import io
import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

from _torch_helpers import cpu_requested  # noqa: F401

from hammlet_tpu import pyhammlet as jph
from hammlet_tpu.tools import avg as javg
from hammlet_tpu.tools import genome as jgen
from hammlet_tpu.tools import max_segmentation as jmax
from hammlet_tpu.tools import plot_results as jplot
from hammlet_tpu.tools import sam_to_counts as jsam
from hammlet_tpu.tools import sort_states as jsort
from hammlet_tpu_torch import pyhammlet as tph
from hammlet_tpu_torch.tools import avg as tavg
from hammlet_tpu_torch.tools import genome as tgen
from hammlet_tpu_torch.tools import max_segmentation as tmax
from hammlet_tpu_torch.tools import plot_results as tplot
from hammlet_tpu_torch.tools import sam_to_counts as tsam
from hammlet_tpu_torch.tools import sort_states as tsort

REPO = Path(__file__).resolve().parents[1]
SAM = "\n".join([
    "@HD\tVN:1.6",
    "r1\t0\tchr1\t100\t60\t50M\t*\t0\t0\tA\tF",
    "r2\t0\tchr1\t100\t60\t50M\t*\t0\t0\tA\tF",
    "r2b\t0\tchr1\t100\t60\t50M\t*\t0\t0\tA\tF",
    "r3\t4\tchr1\t200\t0\t*\t*\t0\t0\tA\tF",
    "r4\t0\tchr2\t50\t60\t50M\t*\t0\t0\tA\tF",
    "r4\t256\tchr2\t60\t60\t50M\t*\t0\t0\tA\tF",
    "r5\t0\tchr1\t300\t60\t50M\t*\t0\t0\tA\tF",
]) + "\n"


def _files(d: Path) -> dict:
    """Every file under d by name, gzip members decompressed."""
    return {p.name: (gzip.open(p).read() if p.suffix == ".gz" else p.read_bytes())
            for p in sorted(d.iterdir())}


def _both(tmp_path, fn):
    """Run fn(out_dir, tools_pkg) in a fresh directory per package; return
    both directories' files."""
    out = []
    for tag, pkg in (("jax", "j"), ("torch", "t")):
        d = tmp_path / tag
        d.mkdir()
        fn(d, pkg)
        out.append(_files(d))
    return out


def _marginals_text(seed, rows=50, K=4):
    rng = np.random.default_rng(seed)
    return "".join(
        f"{rng.integers(1, 20)}\t" + "\t".join(str(rng.integers(0, 30)) for _ in range(K)) + "\n"
        for _ in range(rows)
    )


@pytest.mark.parametrize("text", [
    "10\t5\t1\t0\n5\t4\t2\t0\n7\t0\t9\t1\n3\t0\t1\t8\n", _marginals_text(0), _marginals_text(1, K=2),
])
def test_max_segmentation_bytes(text):
    outs = []
    for mod in (jmax, tmax):
        out = io.StringIO()
        mod.run(io.StringIO(text), out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("window,values", [(3, "1 2 3 4 5 6 7"), (4, " ".join(map(str, range(-9, 30))))])
def test_avg_bytes(window, values):
    outs = []
    for mod in (javg, tavg):
        out = io.StringIO()
        mod.run(window, io.StringIO(values), out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


def test_sort_states_bytes(tmp_path):
    path = tmp_path / "p.csv"
    path.write_text("0.1\t1.0\t2.0\t1.0\t-1.5\t1.0\n\n3.25\t0.5\t-2.0\t0.5\t0.0\t0.7\n")
    outs = []
    for mod in (jsort, tsort):
        out = io.StringIO()
        mod.run(str(path), out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] == "#state\tmean\n0\t3.25\n2\t0\n1\t-2\n"


def test_readers_and_rle_match(tmp_path):
    """pyhammlet's readers and RLE helpers build the same structures."""
    (tmp_path / "m.csv").write_text("5\t10\t0\n3\t2\t8\n")
    (tmp_path / "s.csv").write_text("# c\n5:0\t3:1\n\n2:1\t6:0\n")
    (tmp_path / "b.csv").write_text("4\t4\n2\t6\n")
    (tmp_path / "map.csv").write_text("0\t1\n1\t0\n")
    from hammlet_tpu.pyhammlet import io as jio
    from hammlet_tpu_torch.pyhammlet import io as tio

    def same(a, b):
        np.testing.assert_array_equal(a.ends, b.ends)
        np.testing.assert_array_equal(a.values(), b.values())
        np.testing.assert_array_equal(a.decompress(), b.decompress())
        assert str(a) == str(b) and a.shape == b.shape

    same(tph.readMarginals(tmp_path / "m.csv"), jph.readMarginals(tmp_path / "m.csv"))
    same(tph.readMarginals(tmp_path / "m.csv").argmax(), jph.readMarginals(tmp_path / "m.csv").argmax())
    for a, b in zip(tph.readCompressedStateSequences(tmp_path / "s.csv"),
                    jph.readCompressedStateSequences(tmp_path / "s.csv"), strict=True):
        same(a, b)
    same(tph.readBlockSizes(tmp_path / "b.csv"), jph.readBlockSizes(tmp_path / "b.csv"))
    np.testing.assert_array_equal(tio.readMapping(tmp_path / "map.csv"), jio.readMapping(tmp_path / "map.csv"))
    got, want = (
        pkg.shatter(pkg.RunLengthArray(sizes=[4, 4], array=np.array([1, 2])),
                    pkg.RunLengthArray(sizes=[2, 6], array=np.array([9, 8])))
        for pkg in (tph, jph)
    )
    for g, w in zip(got, want, strict=True):
        same(g, w)
    same(tph.RunLengthArray(sizes=[3, 2, 4], array=np.array([5, 5, 5])).compress(),
         jph.RunLengthArray(sizes=[3, 2, 4], array=np.array([5, 5, 5])).compress())


def _count_sets(d, seed):
    """Two refseqs' count sets "a" and "b" (tests/test_tools_tail.py)."""
    for prefix, s in (("a", seed), ("b", seed + 1)):
        rng = np.random.default_rng(s)
        data = OrderedDict()
        for name in ("chr1", "chr2"):
            n = int(rng.integers(20, 60))
            data[name] = (np.sort(rng.choice(np.arange(1, 200), size=n, replace=False)),
                          rng.integers(1, 9, size=n))
        jgen.write_count_set(str(d / prefix), data)


@pytest.mark.parametrize("ops", [["+", "a", "b"], ["+", "a", "a", "-", "a"], ["-", "b"]])
def test_combine_counts_bytes(tmp_path, monkeypatch, ops):
    src = tmp_path / "src"
    src.mkdir()
    _count_sets(src, 1)

    def run(d, pkg):
        monkeypatch.chdir(d)
        mod = jgen if pkg == "j" else tgen
        argv = ["-i", *[o if o in "+-" else str(src / o) for o in ops], "-o", "out"]
        assert mod.combine_counts_main(argv) == 0

    jax_files, torch_files = _both(tmp_path, run)
    assert jax_files == torch_files and len(jax_files) == 3


@pytest.mark.parametrize("extra", [[], ["-r"], ["-c"], ["-r", "-c"]])
def test_map_lines_to_genome_bytes(tmp_path, monkeypatch, extra):
    rng = np.random.default_rng(9)
    data = OrderedDict()
    for name in ("chr1", "chr2"):
        n = int(rng.integers(10, 30))
        data[name] = (np.sort(rng.choice(np.arange(1, 500), size=n, replace=False)),
                      rng.integers(1, 5, size=n))
    jgen.write_count_set(str(tmp_path / "g"), data)
    total = sum(len(p) for p, _ in data.values())
    (tmp_path / "in.txt").write_text("".join(f"v{i}\n" for i in range(total)))

    def run(d, pkg):
        monkeypatch.chdir(d)
        mod = jgen if pkg == "j" else tgen
        argv = ["-g", str(tmp_path / "g"), "-i", str(tmp_path / "in.txt"), "-o", "out.txt", *extra]
        assert mod.map_lines_to_genome_main(argv) == 0

    jax_files, torch_files = _both(tmp_path, run)
    assert jax_files == torch_files and jax_files["out.txt"]


def test_genome_readers_and_sort_multiply(tmp_path):
    _count_sets(tmp_path, 3)
    for a, b in zip(tgen.read_count_set(str(tmp_path / "a")).items(),
                    jgen.read_count_set(str(tmp_path / "a")).items(), strict=True):
        assert a[0] == b[0]
        for x, y in zip(a[1], b[1], strict=True):
            np.testing.assert_array_equal(x, y)
    seen = []
    for mod in (tgen, jgen):
        gg = mod.GenomeGetter(str(tmp_path / "a"))
        walk = []
        while gg.next():
            walk.append((gg.refseq, gg.pos))
        seen.append(walk)
    assert seen[0] == seen[1] and len(seen[0]) > 40
    pos = np.array([7, 3, 7, 3, 9, 3])
    val = np.array([2.0, 0.5, 3.0, 4.0, 5.0, 2.0])
    for x, y in zip(tgen.sort_multiply_and_compress(pos, val), jgen.sort_multiply_and_compress(pos, val)):
        np.testing.assert_array_equal(x, y)


def test_sam_to_counts_bytes(tmp_path):
    (tmp_path / "in.sam").write_text(SAM)

    def run(d, pkg):
        (jsam if pkg == "j" else tsam).sam_to_counts(str(tmp_path / "in.sam"), str(d / "cov"))

    jax_files, torch_files = _both(tmp_path, run)
    assert jax_files == torch_files and len(jax_files) == 3


def test_plot_results_bytes(tmp_path, monkeypatch):
    """The port's plot-results draws the JAX tool's PNG bytes on the record
    streams of a port CLI run (tests/test_tools_tail.py's panels)."""
    from hammlet_tpu_torch import cli

    rng = np.random.default_rng(2)
    f = tmp_path / "d.csv"
    np.savetxt(f, np.concatenate([rng.normal(0, 1, 300), rng.normal(5, 1, 300)]))
    assert cli.main(["-f", str(f), "-s", "2", "-a", "-R", "1", "-i", "M", "5", "0", "F", "6", "2",
                     "-O", "marginals", "sequences", "blocks", "-w"]) == 0
    runs = [
        ["-s", "Ym", "Msp", "S", "B", "-y", "Data", "Marginals", "Sequences", "Blocks",
         "-r", "50", "-d", "6", "6"],
        ["-s", "Mfc", "-S", "250", "-R", "0", "500", "-r", "40"],
    ]
    pngs = {}
    for tag, mod in (("j", jplot), ("t", tplot)):
        for i, extra in enumerate(runs):
            assert mod.main(["-f", str(f), *extra, "-o", str(tmp_path / f"{tag}{i}-"), ".png"]) == 0
        pngs[tag] = {p.name[1:]: p.read_bytes() for p in tmp_path.glob(f"{tag}[01]-*.png")}
    assert sorted(pngs["t"]) == ["0-0-599.png", "1-0-249.png", "1-250-499.png"]
    assert pngs["t"] == pngs["j"]
    for bad in (["-s", "ym"], ["-s", "M"]):
        with pytest.raises(SystemExit):
            tplot.main(["-f", str(f), *bad])


def test_matrix_quantile_plot_bytes(tmp_path):
    from hammlet_tpu.pyhammlet import plotting as jplg
    from hammlet_tpu_torch.pyhammlet import plotting as tplg

    data = np.random.default_rng(0).normal(0, 1, size=(200, 50)) + np.linspace(0, 3, 50)
    out = {}
    for tag, mod in (("j", jplg), ("t", tplg)):
        plt = tplg._pyplot()
        plt.figure()
        ax = mod.matrixQuantilePlot(data, ylabel="F-measure (quantiles)")
        plt.savefig(tmp_path / f"{tag}.png", dpi=40)
        plt.close()
        assert ax.get_ylabel() == "F-measure (quantiles)"
        out[tag] = (tmp_path / f"{tag}.png").read_bytes()
    assert out["t"] == out["j"]


def test_wrappers_run_without_jax_or_matplotlib(tmp_path):
    """Every bin/hammlet-torch-* wrapper runs with jax, hammlet_tpu,
    matplotlib and torch made unimportable (plot-results as far as its -h),
    as on a machine with the card and without JAX: the tools are numpy."""
    (tmp_path / "in.sam").write_text(SAM)
    (tmp_path / "m.csv").write_text("10\t5\t1\t0\n5\t4\t2\t0\n7\t0\t9\t1\n")
    (tmp_path / "p.csv").write_text("0.1\t1.0\t2.0\t1.0\n")
    runs = [
        ("avg", ["3"], "1 2 3 4 5 6 7\n"),
        ("max-segmentation", ["-i", "m.csv"], ""),
        ("sort-states", ["p.csv"], ""),
        ("sam-to-counts", ["in.sam", "cov"], ""),
        ("combine-counts", ["-i", "+", "cov", "cov", "-o", "twice"], ""),
        ("map-lines-to-genome", ["-g", "cov", "-i", "m.csv", "-o", "mapped.txt"], ""),
        ("plot-results", ["-h"], ""),
    ]
    code = (
        "import io, runpy, sys\n"
        "for m in ('jax', 'hammlet_tpu', 'matplotlib', 'torch'):\n"
        "    sys.modules[m] = None\n"
        "name, stdin = sys.argv[1], sys.argv[2]\n"
        "sys.argv = [name] + sys.argv[3:]\n"
        "sys.stdin = io.StringIO(stdin)\n"
        "try:\n"
        "    runpy.run_path(name, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert not any(m.split('.')[0] in ('jax', 'hammlet_tpu', 'matplotlib', 'torch')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    for tool, args, stdin in runs:
        wrapper = str(REPO / "bin" / f"hammlet-torch-{tool}")
        proc = subprocess.run([sys.executable, "-c", code, wrapper, stdin, *args], cwd=tmp_path,
                              capture_output=True, text=True, timeout=120,
                              env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert proc.returncode == 0, (tool, proc.stderr[-2000:])
        if tool == "avg":
            assert proc.stdout == "2\n5\n7\n"
        if tool == "max-segmentation":
            assert proc.stdout == "15\t0\n7\t1\n"
    assert (tmp_path / "twice-size.csv").exists() and (tmp_path / "mapped.txt").read_text()
