"""The local launcher: ``-D N`` over the cards of one host, one process per
card, as the JAX CLI spans its local chips (hammlet_tpu/cli.py:351-356).

``hammlet-torch -D N`` on a host with C > 1 cards and no
HAMMLET_NUM_PROCESSES runs W worker processes, W the largest divisor of N
that is at most C (``pick_world``), each holding N / W shards on its own
card (``distributed._card_index``: LOCAL_RANK). Every worker runs the port's
CLI with the user's flags under HAMMLET_NUM_PROCESSES=W,
HAMMLET_PROCESS_ID=r, HAMMLET_COORDINATOR=127.0.0.1:<free port>,
HAMMLET_LOCAL_DEVICES=N/W and LOCAL_RANK=r, and the group forms over NCCL
(gloo on the CPU). The outputs are the bytes of one process with -D N:
the cross-shard float sums do not depend on W (all_gathered and summed in
shard order, parallel/sharded.py) and only rank 0 writes.

The workers are new interpreters (not forks): this process never touches
CUDA (``distributed.card_count`` reads NVML). Each dies with this process
(PR_SET_PDEATHSIG). The launcher forwards rank 0's standard output and
error, and the ``[ERROR]`` lines of the rank that failed first (not those of
the peers that then lose it), each line once; it waits for every worker and returns the largest
exit code. As soon as one worker exits non-zero, or prints ``[ERROR]`` and
does not exit within GRACE_S, the others are terminated (then killed after
GRACE_S): a rank left inside a collective would otherwise wait for the
peer that is gone. There is no fallback to one process.

With no ``-f`` the workers cannot share standard input: it is spooled to a
temporary file (removed at the end) that every worker reads with ``-f``,
under an explicit ``-o`` so the outputs keep the names of a stdin run.

``run_on_cards(target, n)`` runs a plain function, "module:function", in n
processes of one card each (entry.dryrun_multichip, chip_smoke.py
``--sharded-cards``) and returns rank 0's JSON-able result.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

from hammlet_tpu_torch.parallel import distributed

#: seconds a worker that printed [ERROR] has to exit on its own, and that
#: terminated workers have before they are killed
GRACE_S = 10.0

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BOOT = "from hammlet_tpu_torch.parallel import launch; launch._worker_main()"


def pick_world(n_shards: int, cards: int) -> int:
    """W: the largest divisor of ``n_shards`` that is at most ``cards`` (1
    without a card)."""
    return max(w for w in range(1, max(min(n_shards, cards), 1) + 1) if n_shards % w == 0)


def free_port() -> int:
    """A loopback TCP port that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(rank: int, world: int, port: int, local_shards: int) -> dict[str, str]:
    env = dict(os.environ)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    env.update(
        HAMMLET_NUM_PROCESSES=str(world),
        HAMMLET_PROCESS_ID=str(rank),
        HAMMLET_COORDINATOR=f"127.0.0.1:{port}",
        HAMMLET_LOCAL_DEVICES=str(local_shards),
        LOCAL_RANK=str(rank),
        HAMMLET_LAUNCHER_PID=str(os.getpid()),
        PYTHONUNBUFFERED="1",
        PYTHONPATH=os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p),
    )
    return env


class _Group:
    """W running workers, their output forwarded and their failures
    watched."""

    def __init__(self, world: int, local_shards: int, worker_argv: list[str]):
        port = free_port()
        self.lock = threading.Lock()
        self.printed_errors: set[str] = set()
        self.error_at: float | None = None  # first [ERROR] line of any rank
        self.first_error: int | None = None  # the rank that printed it
        self.errored: set[int] = set()  # ranks that printed an [ERROR] line
        self.tails = [deque(maxlen=20) for _ in range(world)]  # standard error
        self.procs: list[subprocess.Popen] = []
        self.threads: list[threading.Thread] = []
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _BOOT, *worker_argv],
                    env=_worker_env(r, world, port, local_shards), stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, errors="replace", bufsize=1,
                ))
                for stream, out in ((self.procs[r].stdout, sys.stdout),
                                    (self.procs[r].stderr, sys.stderr)):
                    t = threading.Thread(
                        target=self._forward, args=(r, stream, out, out is sys.stderr), daemon=True
                    )
                    t.start()
                    self.threads.append(t)
        except BaseException:
            self.stop()
            raise

    def _forward(self, rank: int, stream, out, is_err: bool) -> None:
        """Rank 0's lines, and the [ERROR] lines of the rank that failed
        first (not those of the peers that lost it), each once."""
        for line in stream:
            with self.lock:
                is_error = "[ERROR]" in line
                if is_err:
                    self.tails[rank].append(line)
                if is_error:
                    self.errored.add(rank)
                    if self.error_at is None:
                        self.error_at, self.first_error = time.monotonic(), rank
                    if line.strip() in self.printed_errors or rank not in (0, self.first_error):
                        continue
                    self.printed_errors.add(line.strip())
                elif rank != 0:
                    continue
                out.write(line)
                out.flush()

    def wait(self) -> int:
        """Wait for every worker; stop the rest after a failure. Returns the
        largest exit code of the workers that ended on their own (128 + the
        signal of one that a signal ended), at least 1 after a failure."""
        stopped_at = None
        stopped: set[int] = set()
        while any(p.poll() is None for p in self.procs):
            now = time.monotonic()
            failed = any(p.returncode not in (None, 0) for p in self.procs)
            with self.lock:
                hung = self.error_at is not None and now - self.error_at > GRACE_S
            if (failed or hung) and stopped_at is None:
                for r, p in enumerate(self.procs):
                    if p.poll() is None:
                        p.terminate()
                        stopped.add(r)
                stopped_at = now
            elif stopped_at is not None and now - stopped_at > GRACE_S:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
        for t in self.threads:
            t.join(timeout=GRACE_S)
        codes = [
            p.returncode if p.returncode >= 0 else 128 - p.returncode
            for r, p in enumerate(self.procs) if r not in stopped
        ]
        rc = max(codes, default=0)
        if rc == 0 and (stopped or self.error_at is not None):
            rc = 1
        for r, p in enumerate(self.procs):
            if p.returncode != 0 and r not in stopped and r not in self.errored:
                # rank 0's standard error is already shown in full
                tail = "".join(self.tails[r]) if r else ""
                sys.stderr.write(f"[ERROR] process {r} of {len(self.procs)} exited with "
                                 f"code {p.returncode}\n{tail}")
        sys.stderr.flush()
        return rc

    def stop(self) -> None:
        """Kill every worker still running (after an exception here)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def _run_group(world: int, local_shards: int, worker_argv: list[str]) -> int:
    group = _Group(world, local_shards, worker_argv)
    try:
        return group.wait()
    finally:
        group.stop()


def run_cli(args: dict[str, list[str]], n_shards: int, cards: int) -> int:
    """The CLI's parsed flags ``args`` with ``-D n_shards`` over W of the
    ``cards`` local cards; returns the exit code."""
    world = pick_world(n_shards, cards)
    args = {k: list(v) for k, v in args.items()}
    spool = None
    try:
        if not args.get("-f") and "-M" not in args:  # -M without -f fails in the workers
            fd, spool = tempfile.mkstemp(prefix="hammlet-stdin-", suffix=".txt")
            with os.fdopen(fd, "wb") as fh:
                shutil.copyfileobj(sys.stdin.buffer, fh)
            args["-f"] = [spool]
            if not args.get("-o"):
                args["-o"] = ["hammlet-", ".csv"]
        if "-v" in args:
            print(f"Cards: {cards}; -D {n_shards}: {world} processes, one per card, "
                  f"shards per process: {n_shards // world}", flush=True)
        argv = ["--cli"] + [tok for flag, vals in args.items() for tok in (flag, *vals)]
        return _run_group(world, n_shards // world, argv)
    finally:
        if spool is not None:
            os.unlink(spool)


def run_on_cards(target: str, n: int, args: tuple = ()) -> tuple[int, object]:
    """Call ``target`` ("module:function") with the JSON-able ``args`` in
    n processes of one shard and one card each, joined in a process group
    before the call. Returns (the largest exit code, rank 0's return
    value, None if it failed)."""
    fd, result = tempfile.mkstemp(prefix="hammlet-result-", suffix=".json")
    os.close(fd)
    try:
        rc = _run_group(n, 1, ["--call", target, result, json.dumps(list(args))])
        with open(result) as fh:
            text = fh.read()
        return rc, (json.loads(text) if rc == 0 and text else None)
    finally:
        os.unlink(result)


def _bind_to_parent() -> None:
    """Die with the launcher: PR_SET_PDEATHSIG, then check that the
    launcher did not end before it was set."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if str(os.getppid()) != os.environ.get("HAMMLET_LAUNCHER_PID"):
        os._exit(1)


def _worker_main() -> None:
    """A worker: ``--cli ARGS...`` runs the CLI; ``--call TARGET RESULT
    ARGS_JSON`` joins the group, calls TARGET and writes rank 0's result."""
    _bind_to_parent()
    argv = sys.argv[1:]
    if argv[0] == "--cli":
        from hammlet_tpu_torch.cli import main

        raise SystemExit(main(argv[1:]))
    target, result, fn_args = argv[1], argv[2], json.loads(argv[3])
    try:
        distributed.initialize_from_env()
        module, name = target.split(":")
        value = getattr(importlib.import_module(module), name)(*fn_args)
        if distributed.is_primary():
            with open(result, "w") as fh:
                json.dump(value, fh)
    except Exception as e:
        print(f"[ERROR] {target}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    finally:
        distributed.shutdown()
