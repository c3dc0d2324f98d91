"""Maximum-posterior segmentation from a marginals file
(reference: src/tools/maxSegmentation.cpp).

Reads marginals rows ``segsize\\tc0\\tc1...`` from -i/-infile or stdin and
prints ``size\\tstate`` rows of the argmax segmentation, merging adjacent
segments with equal argmax. Matches the reference's exact output sequence,
including its leading zero-length segment when the first state is nonzero.
"""

import sys


def run(instream, outstream) -> None:
    total_rle = 0
    prev_index = 0
    max_index = 0
    for line in instream:
        parts = line.split()
        if not parts:
            continue
        rle = int(parts[0])
        counts = [int(x) for x in parts[1:]]
        max_index = 0
        max_col = 0
        for i, c in enumerate(counts):
            if c > max_col:  # strict: first maximum wins
                max_col = c
                max_index = i
        if max_index == prev_index:
            total_rle += rle
        else:
            outstream.write(f"{total_rle}\t{prev_index}\n")
            total_rle = rle
            prev_index = max_index
    outstream.write(f"{total_rle}\t{max_index}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    infile = None
    if argv and argv[0] in ("-h", "-help", "--help"):
        print(__doc__)
        return 0
    if argv and argv[0] in ("-i", "-infile"):
        infile = argv[1]
    if infile:
        with open(infile) as fh:
            run(fh, sys.stdout)
    else:
        run(sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
