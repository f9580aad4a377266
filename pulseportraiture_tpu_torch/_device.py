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


def require_f32_matmul(name, device):
    """Raise when float32 matmuls on `device` would run in TF32.

    The brute phase grids ((Ns, nh) @ (nh, rows)), the Newton steps and
    the covariance need float32-class products: TF32 keeps ~3 decimal
    digits.
    """
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def as_tensor(x, device=None, dtype=None):
    """x as a floating tensor.  A tensor keeps its device unless `device`
    is given; host data (numbers, numpy) go to `device`, the card when it
    is None.  dtype: the float type (default: a tensor's own, float64
    for host data)."""
    if torch.is_tensor(x):
        if dtype is None:
            dtype = x.dtype if x.dtype.is_floating_point else torch.float64
        return x.to(device=x.device if device is None else
                    resolve_device(device), dtype=dtype)
    import numpy as np
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           dtype=dtype or torch.float64,
                           device=resolve_device("cuda" if device is None
                                                 else device))
