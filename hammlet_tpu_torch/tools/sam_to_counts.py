"""SAM/BAM -> read-start count files (reference: bin/samToCounts).

Produces the genome count-set convention:
- PREFIX-count.csv.gz : per-position read-start counts
- PREFIX-pos.csv.gz   : corresponding positions per refseq
- PREFIX-size.csv     : refseq \\t n_entries \\t cumulative

Reads with any of the filter bits set (default 3844: unmapped, secondary,
QC-fail, duplicate, supplementary) are skipped; duplicate (qname, refseq,
pos) alignments count once. SAM text is parsed natively; BAM requires a
``samtools`` binary on PATH.

Usage: hammlet-torch-sam-to-counts SAMFILE OUT_PREFIX [FILTERBITS]
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from collections import OrderedDict

from hammlet_tpu_torch.tools.genome import _open, write_count_set

import numpy as np


def _sam_lines(path: str):
    if path.endswith(".bam"):
        samtools = shutil.which("samtools")
        if not samtools:
            raise RuntimeError("BAM input requires samtools on PATH")
        proc = subprocess.Popen(
            [samtools, "view", path], stdout=subprocess.PIPE, text=True
        )
        yield from proc.stdout
        proc.wait()
    else:
        opener = _open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            yield from fh


def sam_to_counts(path: str, out_prefix: str, filter_bits: int = 3844) -> None:
    per_refseq: dict[str, set] = OrderedDict()
    for line in _sam_lines(path):
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        if len(f) < 4:
            continue
        qname, flag, refseq, pos = f[0], int(f[1]), f[2], int(f[3])
        if flag & filter_bits or refseq == "*":
            continue
        per_refseq.setdefault(refseq, set()).add((pos, qname))

    data = OrderedDict()
    for refseq in sorted(per_refseq):
        starts = np.array([p for p, _ in per_refseq[refseq]], dtype=np.int64)
        upos, counts = np.unique(starts, return_counts=True)
        data[refseq] = (upos, counts.astype(np.int64))
    write_count_set(out_prefix, data)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    bits = int(argv[2]) if len(argv) > 2 else 3844
    sam_to_counts(argv[0], argv[1], bits)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
