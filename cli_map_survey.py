#!/usr/bin/env python3
"""MAP agreement of the CLI over engine seeds on chip_smoke.py's
[cli_tracks] data (the data of [states9]-[states81]) under one -i scheme:
how often a short chain stays in a local mode.

    python3 cli_map_survey.py DEVICE KS T SEEDS SCHEME

DEVICE is ``cuda``: the port's CLI (cli.main in this process) on the card;
or ``cpu``: per seed three runs, the JAX package's CLI (bin/hammlet, in a
process of its own on JAX's CPU backend), the port's CLI in this process,
and the port's CLI again with the CPU flushing subnormals to zero
(torch.set_flush_denormal), as XLA's CPU backend runs the JAX package. KS
(of 9, 27, 64, 81) and SEEDS are comma-separated, T is the positions per
track. Prints one line "MAP_SURVEY <json>" per run: K, T, seed, package,
exit code, seconds, the MAP agreement (chip_smoke.map_agreement) and the
last parameters line. For example:

    python3 cli_map_survey.py cuda 9,27,64,81 400000 0,1,2,3 "M 32 0 S P F 32 0 F 128 4"
    python3 cli_map_survey.py cpu 64 24000 0,1,2,3 "M 32 0 S P F 32 0 F 64 4"

This process imports no JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from hammlet_tpu_torch import cli

REPO = os.path.dirname(os.path.abspath(__file__))


def run_port(argv: list[str], flush: bool) -> int:
    torch.set_flush_denormal(flush)
    try:
        return cli.main(argv)
    finally:
        torch.set_flush_denormal(False)


def run_jax(argv: list[str]) -> int:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, os.path.join(REPO, "bin", "hammlet"), *argv],
                          env=env, stdout=subprocess.DEVNULL).returncode


def main(argv: list[str]) -> int:
    if len(argv) != 5 or argv[0] not in ("cuda", "cpu"):
        print(__doc__, file=sys.stderr)
        return 2
    device, ks, T, seeds, scheme = argv
    if device == "cuda" and not torch.cuda.is_available():
        print("cli_map_survey: cuda asked for, no card", file=sys.stderr)
        return 1
    if device == "cpu":
        os.environ["HAMMLET_TORCH_DEVICE"] = "cpu"
        torch.set_num_threads(1)
        if not torch.set_flush_denormal(True):
            print("cli_map_survey: this CPU cannot flush subnormals", file=sys.stderr)
            return 1
        torch.set_flush_denormal(False)
        runners = {"jax": run_jax, "torch": lambda a: run_port(a, False),
                   "torch-ftz": lambda a: run_port(a, True)}
    else:
        runners = {"torch": cli.main}
    cases = cs.cli_tracks_cases()
    with tempfile.TemporaryDirectory() as tmp:
        for K in map(int, ks.split(",")):
            tag, steps, states = cases[K]
            data, truth = steps(int(T))
            path = os.path.join(tmp, f"{tag}.csv")
            np.savetxt(path, data, fmt="%.5f")
            for seed in map(int, seeds.split(",")):
                for package, run in runners.items():
                    prefix = os.path.join(tmp, f"{tag}-{seed}-{package}-")
                    t0 = time.perf_counter()
                    rc = run(["-f", path, "-s", *states, "-a", "-R", str(seed), "-i",
                              *scheme.split(), "-O", "marginals", "parameters",
                              "-o", prefix, ".csv", "-w"])
                    seconds = time.perf_counter() - t0
                    sizes, counts = cs.read_marginals(prefix + "marginals.csv")
                    with open(prefix + "parameters.csv") as fh:
                        last = fh.read().splitlines()[-1]
                    print("MAP_SURVEY", json.dumps({
                        "K": K, "T": int(T), "scheme": scheme, "seed": seed, "package": package,
                        "rc": rc, "seconds": round(seconds, 3),
                        "map_agreement": cs.map_agreement(sizes, counts, truth),
                        "parameters": last}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
