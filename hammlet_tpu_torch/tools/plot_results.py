"""Plot the results from a HaMMLET run (bin/plotResults parity).

Reproduces the reference tool's CLI grammar (bin/plotResults:12-119):

  -f/--data-file PATH         emissions processed by HaMMLET
  -i/--input-pattern P S      record files are P{marginals,sequences,
                              blocks}S (default derived from -f)
  -o/--output-pattern P S     output files P<start>-<end>S (default: -i
                              pattern with the extension replaced by .png)
  -R/--range START END        positions to plot, [START, END)
  -D/--dimensionality N       data dimensions
  -d/--dimensions W H         figure size in inches
  -r/--resolution DPI
  -s/--subfigures DESC...     subfigure descriptors, each with EXACTLY one
                              capital letter (default: Ym Msp):
                                Y  data  (+m: colored by max-marginal state)
                                M  marginals (+s state-sorted | +f by
                                   frequency; +p probabilities | +c counts)
                                S  sampled state sequences heat map
                                B  block-size heat map
  -S/--split N                one output file per N positions
  -x/--xlabel STR, -y/--ylabels STR...
  -p/--palette PATH           one #RRGGBB per line; missing states black
  -c/--chunksize N            x-axis stretch for pre-averaged input

The implementation is structured as three independent stages rather than
the reference's single script body: descriptor strings parse into typed
``PanelSpec``s up front (all grammar errors fire before any file is read),
a ``RunArtifacts`` loader pulls exactly the record streams the panel set
needs while cross-checking T/K/I consistency, and a generic per-window
renderer draws each panel kind from a dispatch table.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Plot the results from a HaMMLET run.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--data-file", dest="datafile", default="sample.csv")
    p.add_argument("-i", "--input-pattern", dest="inPattern", nargs=2,
                   metavar=("PREFIX", "SUFFIX"), default=None)
    p.add_argument("-o", "--output-pattern", dest="outPattern", nargs=2,
                   metavar=("PREFIX", "SUFFIX"), default=None)
    p.add_argument("-R", "--range", dest="range", nargs=2, type=int,
                   default=[0, None], metavar=("START", "END"))
    p.add_argument("-D", "--dimensionality", dest="dimensionality",
                   type=int, default=1)
    p.add_argument("-d", "--dimensions", dest="dimensions", nargs=2,
                   type=float, default=(10, 10), metavar=("WIDTH", "HEIGHT"))
    p.add_argument("-r", "--resolution", dest="resolution", type=int,
                   default=300)
    p.add_argument("-s", "--subfigures", dest="subfigures", nargs="+",
                   default=["Ym", "Msp"])
    p.add_argument("-S", "--split", dest="splitsize", type=int, default=None)
    p.add_argument("-x", "--xlabel", dest="xlabel", default="Position")
    p.add_argument("-y", "--ylabels", dest="ylabels", nargs="+",
                   default=["Data", "Marginal probabilities"])
    p.add_argument("-p", "--palette", dest="palette", default=None)
    p.add_argument("-c", "--chunksize", dest="chunksize", type=int, default=1)
    return p


# ---- stage 1: descriptor grammar -> typed panel specs ----------------------

@dataclass(frozen=True)
class PanelSpec:
    kind: str  # data | marginals | sequences | blocks
    ylabel: str | None
    color_by_state: bool = False  # data: 'm' modifier
    sort_states: bool = False  # marginals: 's' (vs 'f' frequency order)
    normalize: bool = False  # marginals: 'p' probabilities (vs 'c' counts)


_KIND_BY_CAPITAL = {
    "Y": "data", "M": "marginals", "S": "sequences", "B": "blocks",
}


def parse_descriptor(desc: str, ylabel: str | None) -> PanelSpec:
    """One reference descriptor -> PanelSpec, or SystemExit on bad grammar
    (reference semantics: exactly one capital; marginals additionally need
    one of s/f and one of p/c)."""
    capitals = [c for c in desc if c.isupper()]
    if len(capitals) != 1:
        raise SystemExit(
            f'Invalid subfigure descriptor "{desc}", must contain exactly '
            "one capital letter!"
        )
    kind = _KIND_BY_CAPITAL.get(capitals[0])
    if kind is None:
        raise SystemExit(f"Invalid subfigure descriptor: {desc}")
    mods = set(desc) - set(capitals)
    if kind == "data":
        return PanelSpec(kind, ylabel, color_by_state="m" in mods)
    if kind == "marginals":
        if "s" in mods:
            ordered = True
        elif "f" in mods:
            ordered = False
        else:
            raise SystemExit(f"Unknown plotting type for marginals: {desc}!")
        if "p" in mods:
            prob = True
        elif "c" in mods:
            prob = False
        else:
            raise SystemExit(f"Unknown y-scaling for marginals: {desc}!")
        return PanelSpec(kind, ylabel, sort_states=ordered, normalize=prob)
    return PanelSpec(kind, ylabel)


# ---- stage 2: lazy record-stream loading with consistency checks -----------

class RunArtifacts:
    """Loads exactly the streams a panel set needs; every load cross-checks
    the run dimensions (T positions, K states, I iterations) against what
    other streams implied."""

    def __init__(self, datafile: str, in_prefix: str, in_suffix: str,
                 nr_dim: int):
        self.datafile = datafile
        self.in_prefix = in_prefix
        self.in_suffix = in_suffix
        self.nr_dim = nr_dim
        self.data = None
        self.marginals = None
        self.sequences = None
        self.blocks = None
        self._dims: dict[str, int] = {}

    def _note(self, key: str, val: int, what: str) -> None:
        old = self._dims.get(key)
        if old is not None and old != val:
            raise SystemExit(f"Conflicting {what} detected: {old}, {val}!")
        self._dims[key] = val

    def _stream_path(self, name: str) -> str:
        return f"{self.in_prefix}{name}{self.in_suffix}"

    def require(self, kind: str) -> None:
        import numpy as np

        from hammlet_tpu_torch.pyhammlet import io as pio

        if kind == "data" and self.data is None:
            self.data = np.loadtxt(self.datafile).reshape(-1, self.nr_dim)
            self._note("T", len(self.data), "data sizes")
        elif kind == "marginals" and self.marginals is None:
            self.marginals = pio.readMarginals(self._stream_path("marginals"))
            self._note("T", len(self.marginals), "data sizes")
            self._note("K", self.marginals.shape[1], "number of states")
            self._note(
                "I", int(self.marginals.values()[0].sum()),
                "number of iterations",
            )
        elif kind == "sequences" and self.sequences is None:
            self.sequences = pio.readCompressedStateSequences(
                self._stream_path("sequences")
            )
            self._note("I", len(self.sequences), "number of iterations")
            if "K" not in self._dims and self.sequences:
                self._dims["K"] = 1 + max(
                    int(np.max(s.values())) for s in self.sequences
                )
        elif kind == "blocks" and self.blocks is None:
            self.blocks = pio.readBlockSizes(self._stream_path("blocks"))
            self._note("T", len(self.blocks), "data sizes")
            self._note("I", self.blocks.shape[1], "number of iterations")

    def dim(self, key: str) -> int | None:
        return self._dims.get(key)

    def max_marginal_states(self):
        """Per-position most-likely state, from marginals if loaded, else
        by majority vote over the sampled sequences."""
        import numpy as np

        if self.marginals is not None:
            return self.marginals.argmax().decompress()
        if self.sequences is not None:
            mats = np.stack([s.decompress() for s in self.sequences])
            return np.apply_along_axis(
                lambda col: np.bincount(col).argmax(), 0, mats
            )
        raise SystemExit(
            "Need at least one of marginals and sequences to determine "
            "most common states."
        )


# ---- stage 3: generic per-window rendering ----------------------------------

def _draw_data(ax_group, spec, art, window, style):
    import matplotlib.pyplot as plt

    start, end = window
    colored = style["max_states"] if spec.color_by_state else None
    for d, ax in enumerate(ax_group):
        plt.sca(ax)
        style["plg"].plotData(
            art.data[:, d], states=colored, start=start, end=end,
            cmap=style["cmap"] if colored is not None else None,
            norm=style["norm"] if colored is not None else None,
            ylabel=spec.ylabel,
        )


def _draw_marginals(ax_group, spec, art, window, style):
    import matplotlib.pyplot as plt

    plt.sca(ax_group[0])
    style["plg"].plotMarginals(
        art.marginals, start=window[0], end=window[1],
        cmap=style["cmap"], norm=style["norm"],
        normalize=spec.normalize, sort_states=spec.sort_states,
        ylabel=spec.ylabel,
    )


def _draw_sequences(ax_group, spec, art, window, style):
    import matplotlib.pyplot as plt

    plt.sca(ax_group[0])
    style["plg"].plotSequences(
        art.sequences, start=window[0], end=window[1],
        nrStates=art.dim("K"), cmap=style["cmap"], norm=style["norm"],
        ylabel=spec.ylabel,
    )


def _draw_blocks(ax_group, spec, art, window, style):
    import matplotlib.pyplot as plt
    from matplotlib.cm import Greys_r
    from matplotlib.colors import LogNorm

    plt.sca(ax_group[0])
    cm = Greys_r
    for setter in (cm.set_bad, cm.set_under, cm.set_over):
        setter("k")
    style["plg"].plotBlockSizes(
        art.blocks, start=window[0], end=window[1],
        chunkSize=style["chunksize"], ylabel=spec.ylabel,
        cmap=cm, norm=LogNorm(vmin=1),
    )


_DRAW = {
    "data": _draw_data,
    "marginals": _draw_marginals,
    "sequences": _draw_sequences,
    "blocks": _draw_blocks,
}


def render_window(panels, art, window, style, args) -> str:
    """Draw every panel for one [start, end) window into one figure file
    named PREFIX<start>-<end-1>SUFFIX (the reference's naming)."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    n_rows = sum(
        art.nr_dim if p.kind == "data" else 1 for p in panels
    )
    fig, axes = plt.subplots(
        n_rows, figsize=tuple(args.dimensions), dpi=args.resolution,
        sharex=True, sharey=False, squeeze=False,
    )
    row = 0
    for spec in panels:
        span = art.nr_dim if spec.kind == "data" else 1
        _DRAW[spec.kind](axes[row : row + span, 0], spec, art, window, style)
        row += span
    plt.xlabel(args.xlabel)
    for ax in axes.reshape(-1):
        # modern matplotlib chokes on nbins=0 from hidden shared axes
        nbins = max(len(ax.get_xticklabels()), 3)
        ax.yaxis.set_major_locator(MaxNLocator(nbins=nbins, prune="both"))
    fig.subplots_adjust(hspace=0)
    out = f"{args.outPattern[0]}{window[0]}-{window[1] - 1}{args.outPattern[1]}"
    plt.savefig(out, bbox_inches="tight", dpi=args.resolution)
    plt.close()
    return out


def main(argv=None) -> int:
    from hammlet_tpu_torch.pyhammlet import plotting as plg

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    plg._pyplot()  # the Agg backend before any figure
    if args.inPattern is None:
        pref, suff = os.path.splitext(args.datafile)
        args.inPattern = (pref + "-", suff)
    if args.outPattern is None:
        base = args.inPattern[1].rsplit(".", 1)[0]
        args.outPattern = [args.inPattern[0], base + ".png"]

    # parse ALL descriptors before touching any file
    panels = [
        parse_descriptor(
            desc, args.ylabels[i] if i < len(args.ylabels) else None
        )
        for i, desc in enumerate(args.subfigures)
    ]

    art = RunArtifacts(
        args.datafile, args.inPattern[0], args.inPattern[1],
        args.dimensionality,
    )
    for spec in panels:
        art.require(spec.kind)
    T = art.dim("T")
    if T is None:
        raise SystemExit("Could not determine data size, input is incomplete!")

    cmap, norm = plg.load_palette(args.palette)
    style = {
        "plg": plg,
        "cmap": cmap,
        "norm": norm,
        "chunksize": args.chunksize,
        "max_states": None,
    }
    if any(p.kind == "data" and p.color_by_state for p in panels):
        style["max_states"] = art.max_marginal_states()

    # [start, end) windows: the requested range cut into split-sized pieces
    r0, r1 = args.range
    lo, hi = max(0, r0), min(T if r1 is None else r1, T)
    split = args.splitsize or T
    windows = [(s, min(s + split, hi)) for s in range(lo, hi, split)]

    for w in windows:
        print(render_window(panels, art, w, style, args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
