"""One process of a multi-process sharded run (test and validation entry
point). Port of hammlet_tpu/parallel/mh_worker.py.

Usage:
    python -m hammlet_tpu_torch.parallel.mh_worker <process_id> \\
        <num_processes> <port> <datafile> <outprefix> [local_shards] [scheme...]

Every process joins the torch.distributed group (gloo on the CPU, NCCL on
cards) at localhost:<port> and then runs the REAL CLI front door
(``hammlet_tpu_torch.cli.main``) on the same input file with the same SHARED
output prefix: ingest reads only the process-local shards' token ranges, and
only the primary process opens and writes the output files
(``Records(write=is_primary())``). tests/test_torch_multiprocess.py compares
the shared outputs byte for byte with a one-process CLI run of the same
command. ``HAMMLET_MH_EXTRA`` adds CLI tokens; ``{rank}`` in them expands to
the process id.
"""

from __future__ import annotations

import os
import sys


def synth(T: int, seed: int = 7):
    import numpy as np

    rng = np.random.default_rng(seed)
    means = [0.0, 5.0, -5.0]
    out = []
    t = 0
    while t < T:
        n = min(int(rng.integers(120, 400)), T - t)
        s = int(rng.integers(0, 3))
        out.append(rng.normal(means[s], 1.0, size=n))
        t += n
    return np.concatenate(out).astype(np.float32)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    pid, nproc, port = int(argv[0]), int(argv[1]), int(argv[2])
    datafile, outprefix = argv[3], argv[4]
    local = int(argv[5]) if len(argv) > 5 else 2
    scheme = argv[6:] or "M 10 0 F 10 0 F 20 2".split()

    os.environ["HAMMLET_COORDINATOR"] = f"localhost:{port}"
    os.environ["HAMMLET_NUM_PROCESSES"] = str(nproc)
    os.environ["HAMMLET_PROCESS_ID"] = str(pid)
    os.environ["HAMMLET_LOCAL_DEVICES"] = str(local)
    extra = os.environ.get("HAMMLET_MH_EXTRA", "").format(rank=pid).split()

    from hammlet_tpu_torch.cli import main as cli_main

    rc = cli_main(
        ["-f", datafile, "-s", "3", "-a", "-R", "5", "-D", str(local * nproc),
         "-o", outprefix, ".csv",
         "-O", "marginals", "parameters", "compression", "-i", *scheme,
         *extra]
    )
    if rc != 0:
        raise SystemExit(rc)
    print(f"rank {pid}: ok, primary={pid == 0}", flush=True)


if __name__ == "__main__":
    main()
