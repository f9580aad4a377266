"""Per-channel portrait normalization.

Port of pulseportraiture_tpu.ops.normalize.  Methods: 'mean', 'max',
'prof' (the scale of a phase fit against the weighted mean profile),
'rms' (noise to 1) and 'abs' (unit vector norm).  Channels that are all
zero are left as they are and report norm 1.  Reference:
pplib.py:2462-2507.
"""

from __future__ import annotations

import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles

_METHODS = ("mean", "max", "prof", "rms", "abs")


def normalize_portrait(port, method="rms", weights=None, return_norms=False,
                       device=None):
    """port (nchan, nbin) divided by a per-channel norm, on its device
    (host data: `device`, the card by default); with return_norms also
    the norms (nchan,)."""
    port = as_tensor(port, device)
    active = torch.any(port != 0.0, dim=-1)
    if method == "mean":
        norms = port.mean(dim=-1)
    elif method == "max":
        norms = port.amax(dim=-1)
    elif method == "rms":
        norms = noise_PS_profiles(port)
    elif method == "abs":
        norms = torch.sqrt((port ** 2).sum(dim=-1))
    elif method == "prof":
        from pulseportraiture_tpu_torch.fitters.phase_shift import \
            fit_phase_shift_batch
        good = (port.sum(dim=-1) != 0.0).to(port.dtype)
        w = good if weights is None else \
            as_tensor(weights, port.device, port.dtype) * good
        mean_prof = (port * w[:, None]).sum(dim=0) / w.sum()
        norms = fit_phase_shift_batch(
            port, mean_prof.expand(port.shape).contiguous()).scale
    else:
        raise ValueError(f"Unknown normalize_portrait method {method!r}")
    safe = torch.where(active & (norms != 0.0), norms,
                       torch.ones_like(norms))
    out = torch.where(active[:, None], port / safe[:, None], port)
    norms = torch.where(active, safe, torch.ones_like(safe))
    if return_norms:
        return out, norms
    return out
