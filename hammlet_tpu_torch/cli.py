"""Command-line front end of the PyTorch/CUDA port, flag-compatible with the
reference binary and with hammlet_tpu/cli.py (its own copy: the JAX
package's module imports jax).

Flag grammar per src/main.cpp:33-65 and doc/hammlet-manpage.md:33-176:

  -v/-verbose          progress output
  -g/-arguments        dump parsed arguments
  -h/-help             help text
  -f/-input-file F...  input file(s) (default: stdin)
  -o/-output-pattern PREFIX SUFFIX   (default derived from -f)
  -O/-output-data  [marginals sequences parameters blocks compression
                    mapping segments] (long or one-letter forms)
  -w/-overwrite        allow overwriting outputs
  -s/-states [C] P [D] number of emission distributions / mapping spec
  -e/-emissions normal s2 p   emission type + autoprior parameters
  -a/-auto-priors      automatic hyperparameters (required, as in reference)
  -t/-transitions a [d]  transition Dirichlet alphas (off-diag, diag)
  -S/-no-self-transitions
  -I/-initial-dist a   initial-distribution Dirichlet alpha
  -R/-random-seed N    RNG seed (default: time)
  -i/-iterations SCHEME  sampling scheme DSL (P, S, D, {F,M} iter thin)
  -m/-weight-multiplier X
  -C/-checkpoint PATH [EVERY]  periodic checkpointing (resumes from PATH
                               when it exists)
  -D/-devices N        shards of the position axis (parallel/sharded.py): N
                       > 1 runs the sharded engine, N / W shards on each of
                       W processes. On a host with C > 1 cards and no
                       HAMMLET_NUM_PROCESSES, the CLI starts W processes
                       itself, one per card over NCCL, W the largest
                       divisor of N that is at most C (parallel/launch.py),
                       as the JAX CLI spans its local chips; the outputs
                       are the bytes of one process. With one card, or
                       under HAMMLET_NUM_PROCESSES (by hand or torchrun,
                       parallel/distributed.py), the CLI runs in the
                       processes it is given; N must be a multiple of W
  -M/-multi            every -f file is an INDEPENDENT chain with its own
                       priors/RNG/outputs; the file names must differ in
                       their stems (each chain writes {prefix}{stem}-*).
                       One chain per local card in threads when there are
                       several cards, no -D and one process; else one
                       after another (each sharded over -D N shards, in
                       the processes -D N spans)
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

import numpy as np
import torch

from hammlet_tpu_torch.io.input import ValueStream, read_values
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.parallel import distributed
from hammlet_tpu_torch.parallel.sharded import make_sharded_engine
from hammlet_tpu_torch.runner import make_engine

_FLAG_ALIASES = {
    "-verbose": "-v",
    "-arguments": "-g",
    "-help": "-h",
    "--help": "-h",
    "-input-file": "-f",
    "-output-pattern": "-o",
    "-output-data": "-O",
    "-overwrite": "-w",
    "-states": "-s",
    "-emissions": "-e",
    "-auto-priors": "-a",
    "-transitions": "-t",
    "-no-self-transitions": "-S",
    "-initial-dist": "-I",
    "-random-seed": "-R",
    "-iterations": "-i",
    "-weight-multiplier": "-m",
    "-checkpoint": "-C",
    "-devices": "-D",
    "-multi": "-M",
}

_DEFAULTS = {
    "-o": ["hammlet-", ".csv"],
    "-O": ["marginals"],
    "-s": ["3"],
    "-e": ["normal", "0.2", "0.9"],
    "-t": ["0.5", "0.5"],
    "-I": ["0.5"],
    "-i": ["M", "500", "0", "S", "P", "F", "200", "0", "F", "300", "3"],
    "-m": ["1"],
}

_OUTPUT_ALIASES = {
    "M": "marginals",
    "S": "sequences",
    "P": "parameters",
    "B": "blocks",
    "C": "compression",
    "D": "mapping",
    "G": "segments",
}


_REGISTERED = set(_DEFAULTS) | {
    "-v", "-g", "-h", "-w", "-a", "-S", "-f", "-R", "-C", "-D", "-M",
}


def _looks_numeric(tok: str) -> bool:
    """A '-'-prefixed token that is a negative number, not a flag typo."""
    return len(tok) > 1 and (tok[1].isdigit() or tok[1] == ".")


def parse_args(argv: list[str]) -> dict[str, list[str]]:
    """Registered-flag tokenizer (src/Parser.hpp:142-193): every token after
    a registered flag and before the next one belongs to that flag.
    Duplicate and positional-first errors mirror the reference; unregistered
    '-x' tokens are rejected up front (the reference's parser swallows them
    as parameters and fails later with a conversion error; PARITY.md)."""
    out: dict[str, list[str]] = {}
    cur: str | None = None
    for tok in argv:
        canon = _FLAG_ALIASES.get(tok, tok)
        if canon in _REGISTERED:
            if canon in out:
                raise SystemExit(f"Duplicate flag {tok}!")
            cur = canon
            out[cur] = []
        elif tok.startswith("-") and not _looks_numeric(tok):
            raise SystemExit(f"Unknown flag {tok}!")
        else:
            if cur is None:
                raise SystemExit(
                    f"First input token ({tok}) is not a registered flag; "
                    "parser does not support positional arguments!"
                )
            out[cur].append(tok)
    return out


def _conv(conv, s: str):
    """Typed token conversion with the reference's error text
    (Parser.hpp:46-54)."""
    try:
        return conv(s)
    except (TypeError, ValueError):
        raise ValueError(f'Conversion failed for string "{s}"!')


def _parse_at(tokens: list[str], index: int, conv, flag: str):
    """parse<T>(flag, index) with the reference's bounds error
    (Parser.hpp:196-208)."""
    if index >= len(tokens):
        raise ValueError(f"Not enough arguments for flag {flag}!")
    return _conv(conv, tokens[index])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        args = parse_args(argv)
    except SystemExit as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1

    try:
        span = _cards_to_span(args)
        if span is not None:
            # one process per card: the workers run this CLI in a group
            from hammlet_tpu_torch.parallel import launch

            return launch.run_cli(args, *span)
        return _run(args)
    except Exception as e:  # mirror the reference's fatal handler
        print(f"\n[ERROR] {e}", file=sys.stderr)
        print("Terminating HaMMLET. The rest is silence.", file=sys.stderr)
        return 1
    finally:
        distributed.shutdown()


def _cards_to_span(args: dict[str, list[str]]) -> tuple[int, int] | None:
    """(N, C) when ``-D N`` is to span C local cards in processes of their
    own (parallel/launch.py): N > 1, no -h, no HAMMLET_NUM_PROCESSES, more
    than one card, and a divisor of N above 1 that fits them. Else None:
    the run stays in this process (a -D that is no integer fails there)."""
    if "-h" in args or "HAMMLET_NUM_PROCESSES" in os.environ or not args.get("-D"):
        return None
    try:
        n = int(args["-D"][0])
    except ValueError:
        return None
    if n < 2:
        return None
    cards = distributed.card_count()
    if cards < 2:
        return None
    from hammlet_tpu_torch.parallel.launch import pick_world

    return (n, cards) if pick_world(n, cards) > 1 else None


def _check_shards(n_devices: int) -> None:
    """-D against the process layout, before any file is made: P >= 1, a
    multiple of the W processes, and W times HAMMLET_LOCAL_DEVICES when
    that is set."""
    world = distributed.world_size()
    if n_devices < 1:
        raise ValueError(f"-D {n_devices}: need at least one shard")
    if n_devices % world:
        raise ValueError(
            f"-D {n_devices} is not a multiple of the {world} processes "
            "(HAMMLET_NUM_PROCESSES); every process holds the same number "
            "of shards"
        )
    local = distributed.local_shards_from_env()
    if local is not None and local * world != n_devices:
        raise ValueError(
            f"-D {n_devices} != {world} processes x HAMMLET_LOCAL_DEVICES={local}"
        )


def _chain_stem(path: str) -> str:
    """The name an -M chain's outputs carry: the file name without its
    directory, ``.gz`` and last extension."""
    stem = os.path.basename(path)
    if stem.endswith(".gz"):
        stem = stem[:-3]
    return stem.rsplit(".", 1)[0]


def _chain_devices() -> list[torch.device]:
    """The devices ``-M`` spreads its chains over: every local card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _run_chain(sub: dict[str, list[str]], device: torch.device, turn: threading.Lock) -> int:
    """One ``-M`` chain on its own device, from its own thread: the thread's
    current card is the chain's (the counterpart of the JAX package's
    ``jax.default_device``), and its engine samples a phase only while it
    holds ``turn``, the lock all the chains share."""
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        return _run(sub, device, turn)


def _run_chains(subs: list[dict[str, list[str]]], devices: list[torch.device]) -> int:
    """Run the ``-M`` chains: one per device in threads when there are
    several of both, else one after another. Either way the exit code is
    the largest of the chains', and a chain that raises stops every chain
    that has not started; threads that are running finish first."""
    if len(subs) < 2 or len(devices) < 2:
        return max(_run(sub) for sub in subs)
    turn = threading.Lock()
    with ThreadPoolExecutor(max_workers=len(devices)) as ex:
        futures = [
            ex.submit(_run_chain, sub, devices[i % len(devices)], turn)
            for i, sub in enumerate(subs)
        ]
        wait(futures, return_when=FIRST_EXCEPTION)
        ex.shutdown(cancel_futures=True)
        return max(f.result() for f in futures)


def _run(
    args: dict[str, list[str]],
    device: torch.device | None = None,
    turn: threading.Lock | None = None,
) -> int:
    """One run of the parsed flags. ``device`` (an -M chain's card) replaces
    the device the engine would take; ``turn`` becomes the engine's
    ``phase_turn``."""
    # multi-process runtime: HAMMLET_NUM_PROCESSES & friends start the
    # torch.distributed group before anything else; -D then shards the
    # position axis over every process
    distributed.initialize_from_env()

    def get(flag: str) -> list[str]:
        v = args.get(flag)
        return v if v else _DEFAULTS.get(flag, [])

    if "-h" in args:
        from hammlet_tpu_torch.manpage import print_manpage

        print_manpage()
        return 0

    verbose = "-v" in args
    overwrite = "-w" in args

    if "-g" in args:
        # reference dump format (Parser.hpp:242-269): one line per flag
        # group listing every alias, set-marker, then effective tokens
        groups: dict[str, list[str]] = {c: [c] for c in sorted(_REGISTERED)}
        for alias, canon in _FLAG_ALIASES.items():
            groups[canon].append(alias)
        for canon, aliases in groups.items():
            mark = "*" if canon in args else " "
            print(f"[{mark}] {' '.join(aliases)} : {' '.join(get(canon))}")

    # output prefix/suffix (main.cpp:92-100)
    if "-o" not in args and "-f" in args and args["-f"]:
        fname = args["-f"][0]
        dot = fname.rfind(".")
        if dot < 0:
            opref, osuff = fname + "-", ""
        else:
            opref, osuff = fname[:dot] + "-", fname[dot:]
    else:
        o = get("-o")
        opref = o[0] if len(o) > 0 else "hammlet-"
        osuff = o[1] if len(o) > 1 else ".csv"

    seed = (
        _parse_at(args["-R"], 0, int, "-R")
        if args.get("-R")
        else int(time.time())
    )

    # state / mapping spec (main.cpp:117-137)
    s_tokens = get("-s")
    if len(s_tokens) == 1:
        nr_params, nr_dim = _parse_at(s_tokens, 0, int, "-s"), 1
    else:
        if s_tokens[0] in ("I", "independent"):
            # accepted by the reference's parser but unimplemented there too
            # (Mapping.hpp:110-111)
            raise ValueError('Mapping type "independent" not implemented yet!')
        if s_tokens[0] not in ("C", "combinations"):
            raise ValueError(f"Unknown mapping type {s_tokens[0]}!")
        nr_params = _parse_at(s_tokens, 1, int, "-s")
        nr_dim = _parse_at(s_tokens, 2, int, "-s") if len(s_tokens) >= 3 else 1

    t_tokens = get("-t")
    trans = _parse_at(t_tokens, 0, float, "-t")
    self_trans = (
        _parse_at(t_tokens, 1, float, "-t") if len(t_tokens) > 1 else trans
    )
    initial_alpha = _parse_at(get("-I"), 0, float, "-I")
    weight_multiplier = _parse_at(get("-m"), 0, float, "-m")
    use_self = "-S" not in args

    e_tokens = get("-e")
    if e_tokens[0] != "normal":
        raise ValueError(f"Emission type {e_tokens[0]} unknown or not implemented yet!")
    if "-a" not in args:
        raise ValueError("Manual theta priors not implemented, use -a!")
    s2 = _parse_at(e_tokens, 1, float, "-e")
    p = _parse_at(e_tokens, 2, float, "-e")

    outputs = {_OUTPUT_ALIASES.get(t, t) for t in get("-O")}

    n_devices = _parse_at(args["-D"], 0, int, "-D") if args.get("-D") else 1
    _check_shards(n_devices)
    sharded = n_devices > 1

    # the device the engine will take (make_engine's own choice, or the
    # process's device in a process group)
    from hammlet_tpu_torch.device import resolve_device

    if device is None:
        device = distributed.process_device() if distributed.world_size() > 1 else resolve_device(None)

    if verbose:
        K = nr_params**nr_dim
        print(f"Data dimensions: {nr_dim}")
        print(f"Emission distributions: {nr_params}")
        print(f"States: {K}")
        print(f"Sampling scheme: {' '.join(get('-i'))}")
        print(f"Random seed: {seed}")
        print(f"Device: {device}")
        if distributed.world_size() > 1:
            print(f"Processes: {distributed.world_size()}, "
                  f"shards per process: {n_devices // distributed.world_size()}")
        if "-f" in args:
            for f in args["-f"]:
                print(f"Reading {f}")
        else:
            print("Reading from standard input")

    # validate the sampling scheme before any file is created or data read
    # (the reference checks -i tokens up front, main.cpp:367-377)
    from hammlet_tpu_torch.runner import parse_scheme

    parse_scheme(get("-i"))

    # -M: every -f file is an INDEPENDENT chain (the reference's WGS
    # workflow runs one process per chromosome, bin/samToCounts:5-7), each
    # with its own auto-priors, RNG stream, and output files
    # {prefix}{filestem}-*{suffix}. With several local cards, no -D and one
    # process, the chains run one per card in threads (hammlet_tpu/cli.py:
    # 292-305); every engine draws from its own generators, so the outputs
    # are the bytes of a sequential run. Otherwise they run one after
    # another, each sharded over -D N shards. Each chain checkpoints to its
    # own file, PATH with "-{filestem}" before the extension (one shared file
    # would hand one chain's state to the next).
    if "-M" in args:
        files = args.get("-f") or []
        if len(files) < 1:
            raise ValueError("-M requires at least one -f input file")
        stems = [_chain_stem(f) for f in files]
        shared = sorted({s for s in stems if stems.count(s) > 1})
        if shared:
            # the chains' outputs and checkpoints are named by the stem alone
            raise ValueError(
                "-M chains need input files whose names differ without their "
                f"directory and extension; {', '.join(shared)} appears more "
                "than once, and those chains would write the same output files"
            )
        subs = []
        for fpath, stem in zip(files, stems):
            sub = {k: list(v) for k, v in args.items()}
            del sub["-M"]
            sub["-f"] = [fpath]
            sub["-o"] = [f"{opref}{stem}-", osuff]
            if sub.get("-C"):
                base, ext = os.path.splitext(sub["-C"][0])
                sub["-C"][0] = f"{base}-{stem}{ext}"
            subs.append(sub)
        one_process = "-D" not in args and distributed.world_size() == 1
        return _run_chains(subs, _chain_devices() if one_process else [])

    # sharded runs stream the input: the provider hands the ingest one
    # token range at a time (each process reads only its own shards' ranges),
    # so a multi-Gbp file never materializes on any host — the reference's
    # one-pass istream ingest property (wavelet.hpp:98-188)
    stream = None
    if sharded and args.get("-f"):
        stream = ValueStream(args["-f"], nr_dim)
        data, T = stream, stream.T
    else:
        data = read_values(args.get("-f"), nr_dim)
        T = data.shape[0]
    if verbose:
        print(f"Output will be written to {opref}*{osuff}")
        print(f"Number of data points: {T}")
        print("Calculating Haar breakpoint weights")

    ckpt_path = args["-C"][0] if args.get("-C") else None
    ckpt_every = (
        _parse_at(args["-C"], 1, int, "-C") if ckpt_path and len(args["-C"]) > 1 else 100
    )
    resume = ckpt_path is not None and os.path.exists(ckpt_path)
    resume_records = None
    if resume:
        # the per-sweep streams keep the lines of the sweeps the checkpoint
        # holds and continue after them
        with np.load(ckpt_path) as z:
            resume_records = int(z["n_rec" if sharded else "n_records"])
    # single writer: in a multi-process run only the primary process opens
    # output files (Records.hpp:52-70 has one writer by construction); every
    # other process takes part in the collectives with an inert hub
    records = Records(
        T,
        opref,
        osuff,
        nr_params**nr_dim,
        outputs=outputs,
        overwrite=overwrite,
        write=distributed.is_primary(),
        resume_records=resume_records,
    )
    if "mapping" in outputs:
        # -O D/mapping: the state -> emission-parameter assignment is static
        # (combinations scheme), so it is written once up front. Upstream
        # registers the flag but leaves the handler an empty TODO
        # (main.cpp:249-252); this writes the documented content.
        from hammlet_tpu_torch.models.mapping import combinations_mapping

        records.save_mapping(combinations_mapping(nr_dim, nr_params))
    common = dict(
        nr_params=nr_params,
        nr_data_dim=nr_dim,
        seed=seed,
        s2=s2,
        p=p,
        trans=trans,
        self_trans=self_trans,
        initial_alpha=initial_alpha,
        weight_multiplier=weight_multiplier,
        use_self_transitions=use_self,
        records=records,
        device=device,
    )
    if sharded:
        engine = make_sharded_engine(data, n_devices=n_devices, T=T, dim=nr_dim, **common)
        if stream is not None:
            stream.close()
    else:
        engine = make_engine(data, **common)
    if turn is not None:
        engine.phase_turn = turn
    if ckpt_path is not None:
        from hammlet_tpu_torch.checkpoint import (
            restore_checkpoint,
            restore_sharded_checkpoint,
        )

        engine.checkpoint_path = ckpt_path
        engine.checkpoint_every = ckpt_every
        if resume:
            restore = restore_sharded_checkpoint if sharded else restore_checkpoint
            restore(engine, engine.checkpoint_path)
            if verbose:
                print(
                    f"Resumed from {engine.checkpoint_path} at sweep "
                    f"{engine.sweeps_completed}"
                )
    engine.run_scheme(get("-i"))
    engine.finalize()
    if verbose:
        print(
            f"Sampled {engine.total_sweeps:.0f} sweeps at "
            f"{engine.sweeps_per_second:.2f} sweeps/s"
        )
        print("Exit HaMMLET")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
