"""Device choice and the float32 numerics policy of the port.

Every computation of the port runs in float32 (plus a few float64 host
reductions, as in the JAX package). TF32 would keep ~3 decimal digits in
matmuls and convolutions, so it is turned off once here; nothing in the port
enables autocast.
"""

from __future__ import annotations

import torch


def apply_float32_policy() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


apply_float32_policy()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` picks cuda when a card is present, else cpu. An explicit
    cuda request without a card raises instead of falling back to the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
