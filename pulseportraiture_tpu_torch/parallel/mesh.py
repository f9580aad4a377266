"""Mesh construction and batch- and channel-sharded wideband fits.

Port of pulseportraiture_tpu.parallel.mesh.  The workload has two
parallel axes: *batch*, the subints, whose fits are independent, and
*chan*: the per-channel sufficient statistics are sums over each
channel's harmonics, so the channels shard like a sequence axis.

One process drives every device, as in the JAX package (not
torch.distributed): a Mesh is an (n_batch, n_chan) grid of torch devices.
fit_portrait_full_sharded cuts the batch into n_batch shards, each fitted
by a host thread of its own on its row of the grid (so one shard's "all
done" sync each Newton iteration does not hold the others back), and
each shard's channels into n_chan slabs, one per device of the row:

  * the fused setup (ops.setup_dft.fused_setup, the hand kernel on a
    card) runs on each slab's device against that device's copy of the
    template; the data power and the brute seed's band sums go to the
    row's lead device (its first), the sums added in slab order;
  * Gr, Gi and M2 stay on their slabs (fitters.stats.ChanSlabs): each
    Newton iteration sends each slab its channels' phases (and taus) and
    takes back 3 (or 9) moments per channel and item
    (fitters.stats._per_slab), (B, nchan)-sized operands, never a
    spectrum;
  * the Newton loop, nu_zeros and the covariance run on the lead device
    as on one device.

Per-row results do not depend on the split: with seed_phase=False a
sharded fit is bitwise the single-device fit on the CPU, and for channel
slabs on a card (the per-channel template sums are taken on the lead).
Batch shards on a card differ by rounding: torch's CUDA reductions over
the channels choose their order by the number of items.  The seed's band
sums are added in another order, which moves the start a little, not the
optimum.
An uneven split is fine (the JAX path pads channels and items to the
mesh because GSPMD needs even shards; the port does not).

The JAX package has three entry points: fit_portrait_full_sharded (GSPMD
over the XLA setup and moments), fit_portrait_full_sharded_direct (the
capped DFT-as-matmul setup, plain XLA, so GSPMD partitions it) and
fit_portrait_full_sharded_ct (the Pallas CT setup under shard_map).  They
exist because GSPMD cannot partition a pallas_call.  The port's setup
kernel is channel-local on every route, so all three are the one
function here: a capped or full-band model_ft_ri covers _direct and _ct,
scales the int16 ingest, packed=True the packed result.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import resolve_device
from pulseportraiture_tpu_torch.fitters.portrait import (PortraitFitResult,
                                                         _fit_batch,
                                                         pack_result)
from pulseportraiture_tpu_torch.ops.launches import tally


class Mesh:
    """An (n_batch, n_chan) grid of torch devices.

    devices: n_batch rows of n_chan devices (a row is a channel group,
    its first device the lead); shape: {"batch": n_batch, "chan": n_chan},
    as a JAX mesh's.  launches: {(ib, ic): {kernel wrapper: count}}, the
    kernels each shard launched (reset_launches() clears them).
    """

    def __init__(self, devices):
        rows = [[resolve_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs n_batch >= 1 rows of the same "
                             "n_chan >= 1 devices")
        self.devices = rows
        self.shape = {"batch": len(rows), "chan": len(rows[0])}
        self.reset_launches()

    def reset_launches(self):
        self.launches = {(ib, ic): {} for ib in range(self.shape["batch"])
                         for ic in range(self.shape["chan"])}

    @property
    def device_list(self):
        """The distinct devices of the grid, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self):
        return (f"Mesh(batch={self.shape['batch']}, "
                f"chan={self.shape['chan']}, devices={self.devices})")


def make_mesh(n_batch=None, n_chan=1, devices=None) -> Mesh:
    """A ('batch', 'chan') mesh over the devices.

    devices: default every visible card (torch.cuda.device_count()); with
    none the call raises, there is no CPU fallback.  An explicit list
    (names or torch.devices) may repeat a device: ["cpu"] * 8 or
    ["cuda:0"] * 4 run the sharded logic (the slabs, the threads, what
    crosses between devices) on fewer devices.  That is a way to test the
    logic, not to gain speed.  n_batch: default len(devices) // n_chan.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                               "devices= to lay a mesh over given devices)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    total = len(devices)
    if n_batch is None:
        n_batch = total // n_chan
    if n_batch < 1 or n_chan < 1 or n_batch * n_chan > total:
        raise ValueError(f"mesh {n_batch}x{n_chan} does not fit {total} "
                         "devices")
    return Mesh([devices[i * n_chan:(i + 1) * n_chan]
                 for i in range(n_batch)])


def _rows(v, b0, b1, B):
    """Items b0..b1 of a per-item operand; None, numbers and operands
    shared by every item (no leading B axis) pass through."""
    if v is None or not hasattr(v, "shape") or len(v.shape) == 0 or \
            v.shape[0] != B:
        return v
    return v[b0:b1]


def shard_fit_inputs(mesh, data_ports, model_ft_ri, init_params, Ps, freqs,
                     errs, weights=None, nu_fits=None, scales=None):
    """The batched-fit operands cut along the batch for each row of the
    mesh: a list of (ib, devices, (b0, b1), operands) for every nonempty
    batch shard, items b0..b1 (np.array_split sizes, so uneven splits are
    fine).  operands are fit_portrait_full_batch's, by name; the channel
    cut into slabs is made by the fit itself, on each slab's device.

    model_ft_ri: (mr, mi), each (nchan, nh) shared or (B, nchan, nh) per
    item, or a dict {device: (mr, mi)} with a copy on every device of the
    mesh (what GetTOAs keeps per template).
    """
    B = data_ports.shape[0]
    if torch.is_tensor(freqs) or isinstance(freqs, np.ndarray):
        if len(freqs.shape) == 1:       # one grid for every item
            freqs = freqs[None].expand(B, -1) if torch.is_tensor(freqs) \
                else np.broadcast_to(freqs, (B, len(freqs)))
    bounds = np.cumsum([0] + [len(b) for b in np.array_split(
        np.arange(B), mesh.shape["batch"])])
    def item_rows(pair, b0, b1):
        return tuple(v[b0:b1] if len(v.shape) == 3 else v for v in pair)

    out = []
    for ib, devices in enumerate(mesh.devices):
        b0, b1 = int(bounds[ib]), int(bounds[ib + 1])
        if b1 == b0:
            continue
        model = ({d: item_rows(pair, b0, b1)
                  for d, pair in model_ft_ri.items()}
                 if isinstance(model_ft_ri, dict)
                 else item_rows(model_ft_ri, b0, b1))
        out.append((ib, devices, (b0, b1), dict(
            data_ports=data_ports[b0:b1], model_ft_ri=model,
            init_params=_rows(init_params, b0, b1, B),
            Ps=_rows(Ps, b0, b1, B), freqs=_rows(freqs, b0, b1, B),
            errs=_rows(errs, b0, b1, B),
            weights=_rows(weights, b0, b1, B),
            nu_fits=_rows(nu_fits, b0, b1, B),
            scales=_rows(scales, b0, b1, B))))
    return out


def fit_portrait_full_sharded(mesh, data_ports, model_ft_ri, init_params, Ps,
                              freqs, errs, weights=None, nu_fits=None,
                              fit_flags=(1, 1, 0, 0, 0), log10_tau=True,
                              max_iter=100, scales=None, dtype=None,
                              seed_phase=True, nu_outs=None, scattering=None,
                              packed=False):
    """fitters.portrait.fit_portrait_full_batch over a mesh: the batch cut
    along mesh rows (a host thread each), each row's channels along its
    devices (see the module docstring).

    data_ports (B, nchan, nbin), float or int16 with scales (B, nchan),
    anywhere (host tensors go to each slab's device in int16 when they
    are int16); model_ft_ri as shard_fit_inputs takes it; the other
    arguments as fit_portrait_full_batch's, nu_outs' entries None, a
    number or (B,).  An exception on any shard re-raises here.
    Returns the PortraitFitResult on the first row's lead device, or
    with packed=True pack_result's (B, K) array on the host: each
    shard's result leaves its card in one transfer.
    """
    B = data_ports.shape[0]

    def run(shard):
        ib, devices, (b0, b1), ops = shard
        outs = None if nu_outs is None else tuple(
            _rows(v, b0, b1, B) for v in nu_outs)
        # launches on the row's lead (its one slab when n_chan is 1)
        # count to its first shard; each slab's to its own
        with tally(mesh.launches[(ib, 0)]):
            res = _fit_batch(
                **ops, fit_flags=fit_flags, log10_tau=log10_tau,
                max_iter=max_iter, dtype=dtype, seed_phase=seed_phase,
                nu_outs=outs, scattering=scattering, chan_devices=devices,
                tallies=[mesh.launches[(ib, ic)]
                         for ic in range(len(devices))])[0]
        return pack_result(res).cpu() if packed else res

    shards = shard_fit_inputs(mesh, data_ports, model_ft_ri, init_params,
                              Ps, freqs, errs, weights=weights,
                              nu_fits=nu_fits, scales=scales)
    if len(shards) == 1:
        results = [run(shards[0])]
    else:
        with ThreadPoolExecutor(max_workers=len(shards)) as pool:
            results = list(pool.map(run, shards))
    if packed:
        return torch.cat(results)
    lead = mesh.devices[0][0]
    return PortraitFitResult(*[
        None if results[0][j] is None else
        torch.cat([r[j].to(lead) for r in results])
        for j in range(len(results[0]))])
