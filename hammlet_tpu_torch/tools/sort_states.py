"""Sort states by their last-iteration emission means
(reference: bin/sortStates bash pipeline).

Usage: hammlet-torch-sort-states PARAMETERS_FILE
Prints ``#state\\tmean`` then one ``state\\tmean`` row per state, ordered by
descending mean (the reference sorts on the absolute-value-with-sign trick;
the effective order is by signed mean descending).
"""

import sys


def run(path: str, outstream=sys.stdout) -> None:
    with open(path) as fh:
        last = [l for l in fh.read().splitlines() if l.strip()][-1]
    vals = last.split("\t")
    means = [(i // 2, float(vals[i])) for i in range(0, len(vals), 2)]
    means.sort(key=lambda t: t[1], reverse=True)
    outstream.write("#state\tmean\n")
    for s, m in means:
        outstream.write(f"{s}\t{m:g}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: hammlet-torch-sort-states PARAMETERS_FILE", file=sys.stderr)
        return 1
    run(argv[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
