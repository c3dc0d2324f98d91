"""The position mesh: P shards of the position axis over W processes.

Port of hammlet_tpu/parallel/mesh.py. The JAX package maps each shard to
one device of a 1-D mesh and runs the sweep under shard_map. Here every
process drives ONE device and holds P / W consecutive shards on it, as a
leading local-shard axis on every per-shard tensor; the collectives go
through torch.distributed (NCCL for CUDA tensors, gloo for CPU tensors).
One process with W = 1 and P = 4 is the counterpart of the JAX package's
virtual CPU mesh, and is how one card runs the sharded path; ``-D N`` on a
host with several cards runs one process per card (parallel/launch.py), the
counterpart of the JAX package's mesh over the local chips.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from hammlet_tpu_torch.device import resolve_device

# torch >= 2.13 renames all_gather_into_tensor (the name older releases,
# such as 2.11, only have); both take (output, input, group=...)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

#: dtypes every backend gathers as they are (NCCL sends bool as uint8 and
#: has no 16-bit integers); any other dtype travels as its bytes
_WIRE_DTYPES = {
    torch.bool, torch.int8, torch.uint8, torch.int32, torch.int64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
}


@dataclass(frozen=True)
class PositionMesh:
    """P shards of the position axis, W processes, one device per process.

    Rank r holds the global shards [r * S, (r + 1) * S), S = P / W, on
    ``device``. ``group`` is None in a single process without
    torch.distributed; every collective is then the identity."""

    n_shards: int
    device: torch.device
    group: object | None = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"-D {self.n_shards}: need at least one shard")
        if self.n_shards % self.world_size:
            raise ValueError(
                f"-D {self.n_shards} is not a multiple of the {self.world_size} "
                "processes (every process holds the same number of shards)"
            )

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> int:
        """S: the shards this process holds."""
        return self.n_shards // self.world_size

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local_shards

    @property
    def local_ids(self) -> range:
        return range(self.first_shard, self.first_shard + self.local_shards)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate ``x`` along axis 0 over the processes in rank order:
        (S, ...) per-shard rows become the (P, ...) rows of every shard.
        The identity without a process group. ``x`` has at least one axis."""
        if self.group is None:
            return x
        out = torch.empty(
            (self.world_size * x.shape[0],) + tuple(x.shape[1:]),
            dtype=x.dtype, device=x.device,
        )
        self.all_gather_into(out, x)
        return out

    def all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """``all_gather`` into ``out``, a contiguous (W * S, ...) tensor of
        ``x``'s dtype that the caller keeps (a CUDA graph reads it at a
        fixed address). A dtype outside _WIRE_DTYPES (the int16 state
        stacks of K > 127 states) is gathered as bytes."""
        x = x.contiguous()
        if x.dtype not in _WIRE_DTYPES:
            out, x = out.view(torch.uint8), x.view(torch.uint8)
        _all_gather(out, x, group=self.group)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Integer sum over the processes (exact in any order)."""
        if self.group is None:
            if x.is_floating_point():
                raise TypeError("psum is for integers; a float sum over shards is an all_gather "
                                "and one sum in shard order")
            return x
        y = torch.empty((x.numel(),), dtype=x.dtype, device=x.device)
        self.psum_into(y, x)
        return y.reshape(x.shape)

    def psum_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """``psum`` of ``x`` into ``out``, a 1-D tensor of its dtype and
        size that the caller keeps."""
        if x.is_floating_point():
            raise TypeError("psum is for integers; a float sum over shards is an all_gather "
                            "and one sum in shard order")
        out.copy_(x.reshape(-1))
        dist.all_reduce(out, group=self.group)


def position_mesh(n_shards: int, device: str | torch.device | None = None) -> PositionMesh:
    """A mesh of ``n_shards`` shards over the processes of the default
    torch.distributed group (started by parallel.distributed), or over this
    process alone. ``device`` None takes the process's device."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if device is None and group is not None:
        from hammlet_tpu_torch.parallel.distributed import process_device

        device = process_device()
    return PositionMesh(n_shards, resolve_device(device), group)
