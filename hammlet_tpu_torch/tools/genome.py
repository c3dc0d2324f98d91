"""Genome count-file utilities (reference: src/tools/{GenomeGetter.hpp,
MappedValues.hpp, combineCounts.cpp, mapLinesToGenome.cpp}).

File convention (bin/samToCounts): a genome count set PREFIX consists of
- ``PREFIX-size.csv``:      rows ``refseq\\tn_entries\\tcumulative``
- ``PREFIX-pos.csv.gz``:    one position per line, grouped by refseq
- ``PREFIX-count.csv.gz``:  one count per line, aligned with pos
"""

from __future__ import annotations

import gzip
import sys
from collections import OrderedDict

import numpy as np


def _open(path: str, mode: str = "rt"):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


class GenomeGetter:
    """Iterator over (refseq, position) pairs of a genome count set."""

    def __init__(self, prefix: str, pos_suffix="-pos.csv.gz", size_suffix="-size.csv"):
        self._sizes = []
        with open(prefix + size_suffix) as fh:
            for line in fh:
                parts = line.split()
                if parts:
                    self._sizes.append((parts[0], int(parts[1])))
        self._pos_fh = _open(prefix + pos_suffix)
        self._chunk_idx = -1
        self._in_chunk = 0
        self.refseq = ""
        self.prev_refseq = ""
        self.pos = 0
        self.prev_pos = 0
        self.refseq_changed = False

    def next(self) -> bool:
        self.refseq_changed = False
        while self._chunk_idx < 0 or self._in_chunk >= self._sizes[self._chunk_idx][1]:
            self._chunk_idx += 1
            if self._chunk_idx >= len(self._sizes):
                return False
            self.prev_refseq = self.refseq
            self.refseq = self._sizes[self._chunk_idx][0]
            self._in_chunk = 0
            self.refseq_changed = True
        line = self._pos_fh.readline()
        if not line:
            raise RuntimeError("Not enough entries in position file!")
        self.prev_pos = self.pos
        self.pos = int(line)
        self._in_chunk += 1
        return True


def sort_add_and_compress(pos: np.ndarray, cnt: np.ndarray):
    """Sort by position and sum counts of duplicate positions
    (MappedValues::sortAddAndCompress, src/tools/MappedValues.hpp:66-83)."""
    order = np.argsort(pos, kind="stable")
    pos, cnt = pos[order], cnt[order]
    upos, inv = np.unique(pos, return_inverse=True)
    ucnt = np.bincount(inv, weights=cnt).astype(np.int64)
    return upos, ucnt


def sort_multiply_and_compress(pos: np.ndarray, val: np.ndarray):
    """Sort by position and MULTIPLY values of duplicate positions
    (MappedValues::sortMultiplyAndCompress, src/tools/MappedValues.hpp:85-102
    — e.g. combining per-position probabilities/weights)."""
    order = np.argsort(pos, kind="stable")
    pos, val = pos[order], np.asarray(val)[order]
    upos, starts = np.unique(pos, return_index=True)
    uval = np.multiply.reduceat(val, starts)
    return upos, uval


def read_count_set(prefix, pos_suffix="-pos.csv.gz", count_suffix="-count.csv.gz",
                   size_suffix="-size.csv"):
    """-> OrderedDict refseq -> (pos array, count array)."""
    out = OrderedDict()
    with open(prefix + size_suffix) as fh:
        sizes = [(p[0], int(p[1])) for p in (l.split() for l in fh) if p]
    with _open(prefix + pos_suffix) as pf, _open(prefix + count_suffix) as cf:
        for refseq, n in sizes:
            pos = np.array([int(pf.readline()) for _ in range(n)], dtype=np.int64)
            cnt = np.array([int(cf.readline()) for _ in range(n)], dtype=np.int64)
            if refseq in out:
                pos = np.concatenate([out[refseq][0], pos])
                cnt = np.concatenate([out[refseq][1], cnt])
            out[refseq] = (pos, cnt)
    return out


def write_count_set(prefix, data: OrderedDict, pos_suffix="-pos.csv.gz",
                    count_suffix="-count.csv.gz", size_suffix="-size.csv"):
    total = 0
    with open(prefix + size_suffix, "w") as sf, _open(
        prefix + pos_suffix, "wt"
    ) as pf, _open(prefix + count_suffix, "wt") as cf:
        for refseq, (pos, cnt) in data.items():
            total += len(pos)
            sf.write(f"{refseq}\t{len(pos)}\t{total}\n")
            pf.write("\n".join(str(int(p)) for p in pos))
            cf.write("\n".join(str(int(c)) for c in cnt))
            if len(pos):
                pf.write("\n")
                cf.write("\n")


def combine_counts_main(argv=None) -> int:
    """CLI: add/subtract count sets (reference combineCounts).

    hammlet-torch-combine-counts -i + A B - C -o OUT [-p POS_SUF -c CNT_SUF -s SIZE_SUF]
    """
    argv = sys.argv[1:] if argv is None else argv
    opts = {"-p": "-pos.csv.gz", "-c": "-count.csv.gz", "-s": "-size.csv"}
    prefices: list[str] = []
    out_prefix = None
    i = 0
    cur = None
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "-help", "--help"):
            print(combine_counts_main.__doc__)
            return 0
        if a in ("-i", "-input-prefices"):
            cur = "i"
        elif a in ("-o", "-out-prefix"):
            cur = "o"
        elif a in ("-p", "-pos-suffix", "-c", "-count-suffix", "-s", "-size-suffix"):
            opts[a[:2]] = argv[i + 1]
            i += 2
            continue
        else:
            if cur == "i":
                prefices.append(a)
            elif cur == "o":
                out_prefix = a
        i += 1
    if not prefices or prefices[0] not in ("+", "-"):
        print("First token of -i must be + or -!", file=sys.stderr)
        return 1
    if out_prefix is None:
        print("missing -o OUT_PREFIX", file=sys.stderr)
        return 1

    acc: OrderedDict = OrderedDict()
    sign = 1
    for p in prefices:
        if p == "+":
            sign = 1
            continue
        if p == "-":
            sign = -1
            continue
        print(("Adding" if sign > 0 else "Subtracting") + f" counts for {p}*")
        for refseq, (pos, cnt) in read_count_set(
            p, opts["-p"], opts["-c"], opts["-s"]
        ).items():
            cnt = sign * cnt
            if refseq in acc:
                pos = np.concatenate([acc[refseq][0], pos])
                cnt = np.concatenate([acc[refseq][1], cnt])
            acc[refseq] = sort_add_and_compress(pos, cnt)
    print(f"Writing output to {out_prefix}*")
    write_count_set(out_prefix, acc, opts["-p"], opts["-c"], opts["-s"])
    return 0


def map_lines_to_genome_main(argv=None) -> int:
    """CLI: prepend genomic coordinates to output lines (reference
    mapLinesToGenome).

    hammlet-torch-map-lines-to-genome -g PREFIX [-c] [-w N] [-b] [-r [MAXDIST]]
                                [-i IN] [-o OUT]
    """
    argv = sys.argv[1:] if argv is None else argv
    genome_prefix = ""
    window = 1
    rle = False
    ranges = False
    max_merge = float("inf")
    infile = outfile = None
    coords = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "-help", "--help"):
            print(map_lines_to_genome_main.__doc__)
            return 0
        if a in ("-g", "-genome-prefix"):
            genome_prefix = argv[i + 1]
            i += 2
            continue
        if a in ("-w", "-window-size"):
            window = int(argv[i + 1])
            i += 2
            continue
        if a in ("-b", "-blocks"):
            rle = True
        elif a in ("-c", "-coordinates"):
            coords = True
        elif a in ("-r", "-range"):
            ranges = True
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                max_merge = int(argv[i + 1])
                i += 1
        elif a in ("-i", "-infile"):
            infile = argv[i + 1]
            i += 1
        elif a in ("-o", "-outfile"):
            outfile = argv[i + 1]
            i += 1
        i += 1

    ins = open(infile) if infile else sys.stdin
    outs = open(outfile, "w") if outfile else sys.stdout
    sep1, sep2 = (":", "-") if coords else ("\t", "\t")
    gg = GenomeGetter(genome_prefix)
    try:
        for line in ins:
            line = line.rstrip("\n")
            seg = 1
            if rle:
                first, _, rest = line.partition("\t")
                seg = int(first)
                if seg == 0:
                    raise RuntimeError("Segment size must be positive!")
                line = rest
            n = window * seg
            if ranges:
                if not gg.next():
                    raise RuntimeError("Genome ended before all data was processed!")
                refseq, start, end = gg.refseq, gg.pos, gg.pos
                n -= 1
                while n > 0:
                    if not gg.next():
                        break
                    if gg.refseq_changed or gg.pos - end > max_merge:
                        outs.write(f"{refseq}{sep1}{start}{sep2}{end}\t{line}\n")
                        refseq, start = gg.refseq, gg.pos
                    end = gg.pos
                    n -= 1
                outs.write(f"{refseq}{sep1}{start}{sep2}{end}\t{line}\n")
            else:
                while n > 0:
                    if not gg.next():
                        break
                    outs.write(f"{gg.refseq}{sep1}{gg.pos}\t{line}\n")
                    n -= 1
            if n >= window:
                raise RuntimeError("Data too long for genome!")
        if gg.next():
            raise RuntimeError("Data ended before genome!")
    finally:
        if infile:
            ins.close()
        if outfile:
            outs.close()
    return 0
