"""Multi-process runtime on torch.distributed.

Port of hammlet_tpu/parallel/distributed.py. One process per device joins a
torch.distributed process group; ``position_mesh()`` then spans every
process, each holding P / W consecutive shards on its own device. CUDA
processes talk over NCCL, CPU processes over gloo. Nothing else changes: the
sharded engine, ingest and outputs are written against the mesh.

On a host with C > 1 cards, ``hammlet-torch -D N`` with no
HAMMLET_NUM_PROCESSES starts the group itself (parallel/launch.py): W
processes, one per card, W the largest divisor of N that is at most C, each
with N / W shards, as the JAX CLI spans N local chips. The counterpart of
launching them by hand (W processes, e.g. one per GPU, or several hosts):

    export HAMMLET_COORDINATOR=host0:8476     # host:port of process 0
    export HAMMLET_NUM_PROCESSES=W
    export HAMMLET_PROCESS_ID=<0..W-1>
    hammlet-torch -f counts.csv -D <P, a multiple of W> ...

``HAMMLET_NUM_PROCESSES=auto`` takes torchrun's WORLD_SIZE, RANK,
MASTER_ADDR and MASTER_PORT instead (``torchrun --nproc-per-node=4
bin/hammlet-torch -D 4 ...``). ``HAMMLET_LOCAL_DEVICES`` states the shards
per process; the CLI then checks that -D is W times it. A CUDA process uses
``cuda:(LOCAL_RANK or rank) % device_count``, so two processes never share
a card on a host with enough of them (NCCL refuses two ranks on one GPU).
A collective that waits longer than COLLECTIVE_TIMEOUT for a process fails
the run. A process runs on the CPU, over gloo, only when
HAMMLET_TORCH_DEVICE=cpu asks for it; tests/test_torch_multiprocess.py and
tests/test_torch_launch.py run two such processes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from hammlet_tpu_torch.device import DEVICE_VAR, resolve_device

#: how long a collective (and the group's rendezvous) waits for the other
#: processes before the run fails: longer than any gap between two
#: collectives of a healthy run (a genome-scale ingest or checkpoint write)
COLLECTIVE_TIMEOUT = timedelta(minutes=30)


def _env_int(name: str) -> int:
    value = os.environ[name]
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


def _require(names: tuple[str, ...], why: str) -> None:
    missing = [n for n in names if n not in os.environ]
    if missing:
        raise ValueError(f"{why} needs {', '.join(missing)} in the environment")


def _card_index(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def process_device(rank: int | None = None) -> torch.device:
    """This process's device (``rank`` None: its rank in the group, 0
    without one): the device HAMMLET_TORCH_DEVICE names (``cpu`` asks for
    the CPU), else the process's own card. Raises when it is to be a card
    and there is none (device.resolve_device)."""
    dev = torch.device(os.environ.get(DEVICE_VAR) or "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(dev)  # raises without a card
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _card_index(rank))


def initialize_from_env() -> bool:
    """Start the torch.distributed process group if the environment asks for
    it. Must run before any other process-group use (the CLI calls it first
    thing); a second call is a no-op. Returns True iff more than one process
    takes part.

    ``HAMMLET_NUM_PROCESSES=1`` with a coordinator starts a group of one
    (every collective then runs through the backend); without one it starts
    nothing."""
    num = os.environ.get("HAMMLET_NUM_PROCESSES")
    if num is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num == "auto":
        _require(("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"),
                 "HAMMLET_NUM_PROCESSES=auto (torchrun's discovery)")
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        coord = os.environ.get(
            "HAMMLET_COORDINATOR",
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        )
    else:
        world = _env_int("HAMMLET_NUM_PROCESSES")
        if world < 1:
            raise ValueError(f"HAMMLET_NUM_PROCESSES={world} must be >= 1")
        coord = os.environ.get("HAMMLET_COORDINATOR")
        if coord is None:
            if world == 1:
                return False
            _require(("HAMMLET_COORDINATOR",), f"HAMMLET_NUM_PROCESSES={world}")
        if world > 1:
            _require(("HAMMLET_PROCESS_ID",), f"HAMMLET_NUM_PROCESSES={world}")
        rank = _env_int("HAMMLET_PROCESS_ID") if world > 1 else 0
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside 0..{world - 1}")
    kwargs = {}
    dev = process_device(rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # NCCL binds the process's card and builds its communicator now,
        # not at the first collective
        backend, kwargs["device_id"] = "nccl", dev
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=world, rank=rank,
        timeout=COLLECTIVE_TIMEOUT, **kwargs,
    )
    return world > 1


def card_count() -> int:
    """The cards this process could use, counted without initialising CUDA
    (NVML, then CUDA_VISIBLE_DEVICES), so that a launcher can still start
    its workers cleanly. Falls back to torch.cuda.device_count() in a child
    process when NVML cannot be loaded; 0 without a CUDA build of torch."""
    if not torch.backends.cuda.is_built():
        return 0
    n = _nvml_count()
    if n is None:
        probe = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=300,
        )
        return int(probe.stdout.strip() or 0) if probe.returncode == 0 else 0
    return _visible_cards(n, os.environ.get("CUDA_VISIBLE_DEVICES"))


def _nvml_count() -> int | None:
    """The cards NVML sees (None when the library or the driver is
    missing)."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        n = ctypes.c_uint(0)
        return n.value if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) == 0 else None
    finally:
        nvml.nvmlShutdown()


def _visible_cards(n: int, visible: str | None) -> int:
    """How many of ``n`` cards CUDA_VISIBLE_DEVICES leaves, read as CUDA
    reads it: entries up to the first invalid index (UUIDs count)."""
    if visible is None:
        return n
    count = 0
    for tok in visible.split(","):
        tok = tok.strip()
        if not tok or (tok.lstrip("-").isdigit() and not 0 <= int(tok) < n):
            break
        count += 1
    return min(count, n)


def local_shards_from_env() -> int | None:
    """HAMMLET_LOCAL_DEVICES: the shards each process holds, if stated."""
    return _env_int("HAMMLET_LOCAL_DEVICES") if "HAMMLET_LOCAL_DEVICES" in os.environ else None


def world_size() -> int:
    """W: the processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes the output files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (every process calls it at the same point)."""
    if dist.is_initialized():
        dist.destroy_process_group()
