"""Embedded user manual, printed by ``hammlet-torch -h``.

Port of hammlet_tpu/manpage.py (the reference embeds its manpage in the
binary, src/hammlet-manpage.hpp, shown at main.cpp's -h branch): the same
flag grammar, sampling-scheme DSL and output formats, with the extensions as
the PyTorch/CUDA port implements them.
"""

MANPAGE = r"""
HAMMLET(1)                        User Commands                       HAMMLET(1)

NAME
    hammlet-torch - Fast Bayesian HMM segmentation of very long 1-D data
    using forward-backward Gibbs sampling over dynamically compressed
    wavelet blocks (PyTorch/CUDA port of hammlet, for NVIDIA GPUs).

SYNOPSIS
    hammlet-torch [-f FILE...] [-s [C] P [D]] [-e normal VAR P] -a
            [-i SCHEME...] [-t A [D]] [-I A] [-S] [-R SEED] [-m X]
            [-o PREFIX SUFFIX] [-O STREAM...] [-w] [-v] [-g] [-h]
            [-C PATH [EVERY]] [-D 1] [-M]

DESCRIPTION
    hammlet draws posterior samples of a hidden state sequence under a
    Bayesian hidden Markov model with Normal emissions, conjugate
    Normal-Inverse-Gamma emission priors and Dirichlet transition/initial
    priors. Each Gibbs sweep first re-compresses the data into blocks whose
    internal variation lies below the current noise estimate (a Haar-wavelet
    "universal threshold"), then samples states per block from the exact
    forward-backward posterior, then redraws model parameters from their
    conjugate posteriors. Per-sweep cost is proportional to the number of
    blocks, not the number of data points, so inputs with millions to
    billions of positions are practical. The posterior state distribution
    per position is recorded as a run-length-encoded marginals file.

    This is the PyTorch/CUDA port. It runs on one CUDA device when one is
    present, else on the CPU, and writes the same files in the same
    formats as hammlet.

INPUT
    Data is whitespace/newline-separated decimal text read from the file(s)
    given by -f, or from standard input when -f is absent. For D-dimensional
    models (-s C P D) consecutive values are interleaved by dimension: the
    first D values form position 0, the next D position 1, and so on. The
    number of positions T is the number of values divided by D.

OPTIONS
  General
    -h, -help
        Print this manual and exit.
    -v, -verbose
        Progress messages on standard output.
    -g, -arguments
        Dump every flag with its effective (set or default) tokens. Set
        flags are marked [*], defaulted ones [ ].
    -w, -overwrite
        Allow existing output files to be overwritten. Without it, an
        existing output file is a fatal error before anything runs.

  Input/output
    -f, -input-file FILE...
        Input file(s), concatenated in order. Default: standard input.
    -o, -output-pattern PREFIX SUFFIX
        Output files are named PREFIX<stream>SUFFIX. Default: "hammlet-"
        and ".csv"; if -f is given and -o is not, the first input filename
        (with its extension stripped) is used as PREFIX and its extension
        as SUFFIX.
    -O, -output-data STREAM...
        Which record streams to write. Long or one-letter forms:
          M marginals    per-position posterior state counts, RLE rows
                         "segsize<TAB>count_s0<TAB>count_s1..." (default)
          S sequences    one line per recorded sweep of "SIZE:STATE" tokens
                         (the sampled state sequence, run-length encoded)
          P parameters   one line per recorded sweep: tab-separated
                         (mean, variance) per emission parameter
          B blocks       one line per recorded sweep: block sizes
          C compression  one float per recorded sweep: T / #blocks
          G segments     per recorded sweep: number of marginal segments
                         and the marginal store size (diagnostics)
          D mapping      the state-to-emission-parameter mapping, one row
                         per state, one parameter index per data dimension
                         (written once; the mapping is static)

  Model
    -s, -states [C] P [D]
        Number of emission distributions P, or "C P D" for a multivariate
        model over D data dimensions whose state space is every combination
        of P emission parameters per dimension (K = P^D states).
        Default: 3.
    -e, -emissions normal VAR P
        Emission family and automatic-prior tuning: the Normal-Inverse-
        Gamma hyperparameters are chosen so that a priori a fraction P of
        probability mass lies within variance VAR (see -a).
        Default: normal 0.2 0.9.
    -a, -auto-priors
        Derive emission hyperparameters from the data (required; manual
        theta priors are not implemented, matching the reference).
    -t, -transitions A [D]
        Dirichlet prior pseudocounts for transition matrix rows: A for
        off-diagonal entries, D for the diagonal (default: A). Default:
        0.5 0.5.
    -I, -initial-dist A
        Dirichlet prior pseudocount for the initial state distribution.
        Default: 0.5.
    -S, -no-self-transitions
        Ignore within-block self-transition terms ((N-1)*log A[s,s]) when
        weighting block emissions.
    -R, -random-seed N
        Random seed. Default: current epoch time. Every sweep's torch
        generator is seeded from (seed, chunk counter, sweep index), so a
        seed reproduces a run on the same device type; equal seeds give
        statistically equivalent, not bitwise-equal, output to the
        reference's mt19937 and to hammlet's threefry keys.
    -m, -weight-multiplier X
        Multiply breakpoint weights by X (> 1 biases toward more, smaller
        blocks; guards against overcompression). Default: 1.

  Sampling scheme
    -i, -iterations TOKEN...
        A small program of sampling phases, executed left to right:
          P          redraw theta, pi and A from their priors
          S          freeze the block structure at the current threshold
                     (static compression)
          D          dynamic compression: re-create blocks every sweep
          F N T      N forward-backward Gibbs sweeps, recording every T-th
          M N T      N mixture sweeps (states drawn independently per
                     block from emission weights only; fast burn-in),
                     recording every T-th
        T = 0 records nothing. An implicit P precedes the program.
        Default: M 500 0 S P F 200 0 F 300 3.

  Extensions (not in the reference)
    -C, -checkpoint PATH [EVERY]
        Write a resumable checkpoint (RNG counter, model iterate, marginal
        counts, scheme cursor) to PATH every EVERY sweeps (default 100).
        If PATH exists at startup the run resumes from it, continuing the
        chain and the -i scheme exactly where they stopped.
        Checkpoints of hammlet (the JAX package) load here too.
    -D, -devices N
        Number of devices to shard the position axis over. The port runs
        on one device: N = 1 is accepted, N > 1 is an error (the sharded
        and multi-host engines are not ported yet, see ROADMAP.md).
    -M, -multi
        Treat every -f file as an independent chain with its own priors,
        random stream and outputs PREFIX<file stem>-<stream>SUFFIX. The
        chains run one after another on the one device.

EXIT STATUS
    0 on success, 1 on any error (message on standard error).

EXAMPLES
    Segment a coverage track into 3 states with default scheme:
        hammlet-torch -f depth.csv -s 3 -a -R 0
    5-state, record everything, fixed seed, overwrite:
        hammlet-torch -f acgh.csv -s 5 -a -R 17 -O M S P B C G -w
    Two-dimensional data, 2 parameters per dimension (4 states):
        hammlet-torch -f pairs.csv -s C 2 2 -a
    Long run with periodic checkpoints, resumable after interruption:
        hammlet-torch -f wgs.csv -s 3 -a -R 1 -i M 500 0 F 1000 10 -C run.ckpt 100
    One chain per chromosome file:
        hammlet-torch -f chr1.csv chr2.csv -M -s 3 -a -R 1

FILES
    PREFIX{marginals,sequences,parameters,blocks,compression,segments,mapping}SUFFIX

SEE ALSO
    hammlet(1) (the JAX package this port is held against),
    hammlet-avg(1), hammlet-max-segmentation(1), hammlet-combine-counts(1),
    hammlet-map-lines-to-genome(1), hammlet-sam-to-counts(1),
    hammlet-sort-states(1), hammlet-plot-results(1).

    Wiedenhoeft, Brugel, Schliep: "Fast Bayesian Inference of Copy Number
    Variants using Hidden Markov Models with Wavelet Compression", PLOS
    Computational Biology 12(5):e1004871, 2016.
"""


def print_manpage() -> None:
    print(MANPAGE.strip("\n"))
