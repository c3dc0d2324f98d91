"""Output record streams with reference-compatible CSV formats.

Replaces src/Records.hpp and src/StateMarginals.hpp. The reference maintains
a run-length-compressed marginal count store updated serially per recorded
segment; here the marginal counts accumulate on device ((T, K) int32, sharded
with the position axis) together with the union of segment boundaries, and
RLE compression happens once at save time — producing the identical
marginals CSV (rows are the refinement of all recorded segmentations:
``segsize\\tcount_s0\\tcount_s1...``, StateMarginals.hpp:268-310).

File naming and formats (Records.hpp:52-144, verified against the compiled
reference binary — SURVEY.md §7):
- ``{prefix}marginals{suffix}``:   ``segsize\\tc0\\tc1...`` per segment row
- ``{prefix}sequences{suffix}``:   per recorded sweep, tab-separated
                                   ``SIZE:STATE`` run-length tokens
- ``{prefix}blocks{suffix}``:      per recorded sweep, tab-separated block sizes
- ``{prefix}compression{suffix}``: per recorded sweep, T / #blocks
- ``{prefix}parameters{suffix}``:  per recorded sweep, tab-separated
                                   ``mean\\tvar`` per emission parameter
- ``{prefix}segments{suffix}``:    per recorded sweep, #segments and internal
                                   marginal-store size
"""

from __future__ import annotations

import os
from typing import IO

import numpy as np


def _fmt(x: float) -> str:
    """std::to_string-compatible float formatting (6 fixed decimals)."""
    return f"{x:.6f}"


def _fmt_g(x: float) -> str:
    """Default ostream<<double formatting (6 significant digits)."""
    return f"{x:.6g}"


class Records:
    """Host-side output hub. Device work stays in RecordBuffers; this class
    only turns fetched arrays into the reference CSV streams."""

    STREAMS = ("marginals", "sequences", "blocks", "compression", "parameters", "segments")
    #: the streams that get one line per recorded sweep
    PER_SWEEP = ("sequences", "blocks", "compression", "parameters", "segments")

    def __init__(
        self,
        T: int,
        prefix: str,
        suffix: str,
        nr_states: int,
        outputs: set[str] | None = None,
        overwrite: bool = False,
        write: bool = True,
        resume_records: int | None = None,
    ):
        """``write=False`` makes this a non-writing participant: it keeps
        the ``enabled`` set (so every rank of a multi-host run takes the
        same record-fetching code paths) but opens no files and every
        record call is a no-op. The reference has a single writer by
        construction (Records.hpp:52-70).

        ``resume_records`` continues a run resumed from a checkpoint that
        had recorded that many sweeps: each per-sweep stream keeps its
        first ``resume_records`` lines (the sweeps the checkpoint holds;
        later lines belong to sweeps the resumed run redoes) and appends
        after them, instead of starting empty."""
        self.T = T
        self.nr_states = nr_states
        self.prefix = prefix
        self.suffix = suffix
        outputs = {"marginals"} if outputs is None else set(outputs)
        unknown = outputs - set(self.STREAMS) - {"mapping"}
        if unknown:
            raise ValueError(f"unknown output streams: {sorted(unknown)}")
        self.enabled = outputs
        self._files: dict[str, IO[str]] = {}
        if not write:
            return
        for name in self.STREAMS + ("mapping",):
            if name in self.enabled:
                path = prefix + name + suffix
                if os.path.exists(path) and not overwrite:
                    raise FileExistsError(
                        f"File {path} already exists! Use -w to allow overwrite!"
                    )
                if resume_records is not None and name in self.PER_SWEEP:
                    self._files[name] = _open_resumed(path, resume_records)
                else:
                    self._files[name] = open(path, "w")

    # -- per-sweep records ------------------------------------------------

    def record_sweeps_batch(
        self,
        states: np.ndarray,
        sizes: np.ndarray,
        n_blocks: np.ndarray,
        n_bounds: np.ndarray | None = None,
    ) -> None:
        """Record a whole chunk of recorded sweeps at once (reference
        Records::record(state, N), Records.hpp:155-235): (R, cap) block
        states/sizes + per-sweep block counts. Formatting ~capacity integers
        per sweep in Python is slow, so the CSV bytes come from the native
        batch formatters when the C++ library is built, and from the
        byte-identical Python loops below otherwise."""
        if not (
            {"sequences", "blocks", "segments", "compression"} & set(self._files)
        ):
            return
        from hammlet_tpu_torch import native

        ns = np.asarray(n_blocks, dtype=np.int64)
        R = len(ns)
        if "blocks" in self._files:
            out = native.format_int_lines(sizes, ns) if native.available() else None
            if out is None:
                for j in range(R):
                    self._files["blocks"].write(
                        "\t".join(str(int(x)) for x in sizes[j][: ns[j]]) + "\n"
                    )
            else:
                self._files["blocks"].write(out.decode("ascii"))
        self.record_compressions(ns)
        if "sequences" in self._files or "segments" in self._files:
            res = (
                native.format_rle_lines(states, sizes, ns)
                if native.available()
                else None
            )
            if res is not None:
                lines, nsegs = res
                if "sequences" in self._files:
                    self._files["sequences"].write(lines.decode("ascii"))
                if "segments" in self._files:
                    segs = n_bounds + 1 if n_bounds is not None else nsegs
                    self._files["segments"].write(
                        "".join(
                            f"{int(s)}\t{int(s) * (self.nr_states + 1)}\n"
                            for s in segs
                        )
                    )
            else:
                for j in range(R):
                    seg_sizes, seg_states = _merge_runs(
                        np.asarray(states[j][: ns[j]]),
                        np.asarray(sizes[j][: ns[j]]),
                    )
                    if "sequences" in self._files:
                        self._files["sequences"].write(
                            "\t".join(
                                f"{int(n)}:{int(s)}"
                                for n, s in zip(seg_sizes, seg_states)
                            )
                            + "\n"
                        )
                    if "segments" in self._files:
                        nseg = (
                            int(n_bounds[j]) + 1
                            if n_bounds is not None
                            else len(seg_sizes)
                        )
                        self._files["segments"].write(
                            f"{nseg}\t{nseg * (self.nr_states + 1)}\n"
                        )

    def record_compressions(self, n_blocks: np.ndarray) -> None:
        """One compression line, T / #blocks, per recorded sweep."""
        if "compression" in self._files:
            self._files["compression"].write(
                "".join(_fmt_g(self.T / max(1, int(n))) + "\n" for n in n_blocks)
            )

    def record_theta(self, theta_mean: np.ndarray, theta_var: np.ndarray) -> None:
        """Records.hpp:146-153 / Theta::str (mean, var per parameter)."""
        if "parameters" in self._files:
            self._files["parameters"].write(
                "\t".join(
                    _fmt(m) + "\t" + _fmt(v)
                    for m, v in zip(theta_mean.tolist(), theta_var.tolist())
                )
                + "\n"
            )

    def save_mapping(self, mapping: np.ndarray) -> None:
        """Write the state -> emission-parameter mapping, one row per state,
        one tab-separated parameter index per data dimension.

        The reference registers -O D/mapping "output the emission mappings
        for each state" (main.cpp:244) but its handler body is an empty TODO
        (main.cpp:249-252); this implements the documented intent.
        """
        if "mapping" not in self._files:
            return
        f = self._files["mapping"]
        for row in np.asarray(mapping):
            f.write("\t".join(str(int(p)) for p in row) + "\n")

    # -- final marginals --------------------------------------------------

    def save_marginals(self, counts: np.ndarray, ever_boundary: np.ndarray) -> None:
        """Write the RLE marginals CSV from on-device accumulators.

        counts: (T, K) recorded per-position state counts
        ever_boundary: (T,) union of recorded segment starts (t >= 1)
        """
        if "marginals" not in self._files:
            return
        f = self._files["marginals"]
        starts = np.flatnonzero(np.concatenate([[True], ever_boundary[1:]]))
        ends = np.concatenate([starts[1:], [self.T]])
        # the reference only emits columns up to the highest state ever
        # recorded (StateMarginals.hpp:272 note)
        nonzero_states = np.flatnonzero(counts.sum(axis=0) > 0)
        n_cols = int(nonzero_states[-1]) + 1 if len(nonzero_states) else 1
        seg_counts = counts[starts, :n_cols]
        lines = []
        for (s, e), row in zip(zip(starts, ends), seg_counts):
            lines.append(
                str(int(e - s)) + "\t" + "\t".join(str(int(c)) for c in row)
            )
        f.write("\n".join(lines) + "\n")

    def save_marginals_from_segments(
        self, starts: np.ndarray, seg_counts: np.ndarray
    ) -> None:
        """Write the marginals CSV from pre-compacted per-segment rows
        (device-side RLE; avoids downloading the full (T, K) counts)."""
        if "marginals" not in self._files:
            return
        f = self._files["marginals"]
        ends = np.concatenate([starts[1:], [self.T]])
        nonzero_states = np.flatnonzero(seg_counts.sum(axis=0) > 0)
        n_cols = int(nonzero_states[-1]) + 1 if len(nonzero_states) else 1
        lines = []
        for s_, e_, row in zip(starts, ends, seg_counts[:, :n_cols]):
            lines.append(
                str(int(e_ - s_)) + "\t" + "\t".join(str(int(c)) for c in row)
            )
        f.write("\n".join(lines) + "\n")

    def flush(self) -> None:
        """Push every open stream to the disk (the file's buffer, then the
        OS cache), so that a checkpoint saved next counts no line that a
        killed process could still lose."""
        for fh in self._files.values():
            fh.flush()
            os.fsync(fh.fileno())

    def close(self) -> None:
        for fh in self._files.values():
            fh.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_resumed(path: str, n_lines: int) -> IO[str]:
    """Open a per-sweep stream for appending after its first ``n_lines``
    complete lines, dropping the rest (a cut-off last line included)."""
    kept = end = 0
    if os.path.exists(path):
        with open(path, "rb") as fh:
            while kept < n_lines:
                line = fh.readline()
                if not line.endswith(b"\n"):
                    break
                kept += 1
                end += len(line)
    if kept < n_lines:
        raise ValueError(
            f"{path} holds {kept} lines but the checkpoint recorded "
            f"{n_lines} sweeps; cannot resume this stream"
        )
    fh = open(path, "a")
    fh.truncate(end)
    return fh


def _merge_runs(states: np.ndarray, sizes: np.ndarray):
    """Merge adjacent equal-state blocks into segments (Records.hpp:167-188)."""
    if len(states) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    change = np.concatenate([[True], states[1:] != states[:-1]])
    seg_idx = np.cumsum(change) - 1
    seg_sizes = np.bincount(seg_idx, weights=sizes).astype(np.int64)
    seg_states = states[change]
    return seg_sizes, seg_states


def output_paths(prefix: str, suffix: str) -> dict[str, str]:
    return {name: prefix + name + suffix for name in Records.STREAMS}
