"""Device choice and the float32 numerics policy of the port.

Every computation of the port runs in float32 (plus a few float64 host
reductions, as in the JAX package). TF32 would keep ~3 decimal digits in
matmuls and convolutions, so it is turned off once here; nothing in the port
enables autocast.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: how a process names its device when a caller passes none: ``cpu`` is the
#: one way to run the port on the CPU without passing ``device="cpu"``
#: (the counterpart of the JAX package's ``JAX_PLATFORMS=cpu``)
DEVICE_VAR = "HAMMLET_TORCH_DEVICE"


def apply_float32_policy() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


apply_float32_policy()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` takes the device that HAMMLET_TORCH_DEVICE names, else the
    card. A cuda device without a card raises: the port runs on the CPU
    only when asked for it by name (``device="cpu"`` or
    HAMMLET_TORCH_DEVICE=cpu), never because no card was found. A cuda
    device always comes back with its index (the calling thread's current
    card when none is named), so that an engine driven from another thread
    still syncs, seeds and launches on its own card."""
    dev = torch.device(device if device is not None else os.environ.get(DEVICE_VAR) or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev}: torch.cuda.is_available() is False; to run on the CPU, "
                f"pass device='cpu' or set {DEVICE_VAR}=cpu"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work the calling thread queued on ``device`` (its
    current stream there; no-op on the CPU). Not the whole device: another
    thread may be capturing a CUDA graph (samplers/phase_graph.py), and a
    device-wide synchronization invalidates a capture in progress."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def to_host(device: torch.device, tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Host copies of ``tensors`` (all on ``device``) with one wait.

    On a card every copy is queued without blocking into pinned memory on
    the device's current stream, and one CUDA event recorded after them is
    waited on: the chunk's single host sync. (torch's sync debug mode does
    not count an event wait, so a test can run a whole chunk under it and
    count the waits itself.) On the CPU the arrays are copies, never views
    of tensors that the next chunk overwrites."""
    if device.type != "cuda":
        return {k: t.cpu().numpy().copy() for k, t in tensors.items()}
    host = {}
    for k, t in tensors.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    done.synchronize()
    return {k: h.numpy() for k, h in host.items()}
