"""Device resolution."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for a user-given name or device.

    "cuda" requires a visible card: there is no silent CPU fallback, so a
    run that asked for the card either gets it or stops here.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested, but "
            "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
