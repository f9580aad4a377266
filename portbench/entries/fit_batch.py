"""The batched portrait fit, called as the pipeline's fit_chunk calls it.

Each call is fit_portrait_full_batch_packed on one batch of the pool
(int16 data and scales, one template spectrum shared by the batch,
seed_phase=True) and then unpack_result, which brings the packed result
to the host.  With the mix's "batches_on": "card" the batches sit on the
card already; with "host" each call first does what fit_chunk does with
the subints' host arrays: stacks them on the host and copies the batch
to the card.  The pool's batches are cycled, so every answer of the
window is one of pool x batch distinct fits, and each is held against
the reference fit of its data.
"""

import math
import time

import numpy as np
import torch

from portbench import compare, reference
from portbench.generate import Pool


class Entry:
    def __init__(self, config, mix, seed, device, split):
        t = time.perf_counter()
        from pulseportraiture_tpu_torch import _build
        from pulseportraiture_tpu_torch.fitters import portrait
        self.portrait = portrait
        if device.type == "cuda":
            _build.load_kernels()
        split["library"] = time.perf_counter() - t
        t = time.perf_counter()
        self.config, self.mix, self.device = config, mix, device
        self.pool = pool = Pool(config, mix, seed, device)
        B, C = mix["batch"], config["nchan"]
        P = config["period_s"]
        self.fit_flags = ff = tuple(mix["fit_flags"])
        f32 = dict(dtype=torch.float32, device=device)
        init = torch.zeros((B, 5), **f32)
        if ff[3]:
            tau, nu, alpha = mix["scat_guess"]
            init[:, 3] = math.log10(tau / P * (pool.nu_fit / nu) ** alpha)
            init[:, 4] = alpha
        self.mft = (pool.mr, pool.mi)
        self.ops = (init, torch.full((B,), P, **f32),
                    pool.nu.float().expand(B, C).contiguous(),
                    torch.full((B, C), config["noise"], **f32),
                    torch.full((B, 3), pool.nu_fit, **f32))
        self.kwargs = dict(fit_flags=ff, log10_tau=True, dtype=torch.float32,
                           seed_phase=True)
        self.host = None
        if mix["batches_on"] == "host":
            # one dict a subint, as the pipeline holds it before fit_chunk
            x, sc = pool.x.cpu().numpy(), pool.scales.cpu().numpy()
            pool.x, pool.scales = torch.from_numpy(x), torch.from_numpy(sc)
            ops = [o.double().cpu().numpy() for o in self.ops]
            self.host = [[dict(port=x[j, b], scale=sc[j, b].astype(np.float64),
                               init=ops[0][b], P=ops[1][b], freqs=ops[2][b],
                               errs=ops[3][b], nu_fit=pool.nu_fit)
                          for b in range(B)] for j in range(mix["pool"])]
        self.answers = []
        self.shapes = dict(B=B, nchan=C, nbin=config["nbin"],
                           nh=pool.mr.shape[-1], kseed=2, x_itemsize=2,
                           scaled=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        split["data"] = time.perf_counter() - t

    def call(self, i, span):
        """One timed call on pool batch i mod pool; returns the fits."""
        j = i % self.mix["pool"]
        copy_s = 0.0
        if self.host is None:
            x, scales, ops = self.pool.x[j], self.pool.scales[j], self.ops
        else:
            with span("pb:host_to_card"):
                t = time.perf_counter()
                x, scales, ops = self.to_card(self.host[j])
                copy_s = time.perf_counter() - t
        with span("pb:fit_portrait_full_batch_packed"):
            packed = self.portrait.fit_portrait_full_batch_packed(
                x, self.mft, *ops[:4], scales=scales, nu_fits=ops[4],
                **self.kwargs)
        with span("pb:unpack_result"):
            host = self.portrait.unpack_result(packed, self.shapes["nchan"])
        self._last = (j, host, copy_s)
        return self.mix["batch"]

    def to_card(self, items):
        """A batch's operands from its subints' host arrays, as fit_chunk
        makes them: stacked on the host, then copied to the card."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device)
        x = torch.from_numpy(np.stack([p["port"] for p in items]))
        scales = torch.from_numpy(np.stack([p["scale"] for p in items])
                                  .astype(np.float32))
        ops = (np.stack([p["init"] for p in items]),
               np.array([p["P"] for p in items]),
               np.stack([p["freqs"] for p in items]),
               np.stack([p["errs"] for p in items]),
               np.array([[p["nu_fit"]] * 3 for p in items]))
        return (x.to(self.device), scales.to(self.device),
                tuple(map(dev, ops)))

    def keep(self):
        """Keeps what the comparison and the readers read of the last
        call: its answers, and the seconds it took to bring its batch to
        the card."""
        j, h, copy_s = self._last
        self.answers.append(dict(
            pool=j, params=np.array(h.params), cov=np.array(
                h.covariance_matrix), nu_DM=np.array(h.nu_DM),
            nu_tau=np.array(h.nu_tau), red_chi2=np.array(h.red_chi2),
            niter=np.array(h.niter), copy_s=copy_s))

    def niter_max(self):
        """The slowest item's Newton iterations, a call."""
        return [int(a["niter"].max()) for a in self.answers]

    def release(self):
        """Frees the program's operands; the pool's data stay."""
        self.mft = self.ops = self.kwargs = self.host = self._last = None

    def reference_fit(self, j, precision="float64"):
        """The plain reference's fit of pool batch j."""
        pool, cfg = self.pool, self.config
        return reference.fit(
            pool.x[j].to(self.device), pool.scales[j].to(self.device),
            pool.mr, pool.mi, pool.nu,
            torch.tensor(cfg["noise"], device=self.device),
            cfg["period_s"], pool.nu_fit, pool.truth[j], self.fit_flags,
            cfg["dispersion_constant"], precision=precision)

    def numbers(self, answers, ref):
        """compare.numbers of answers (dicts as keep() stores them) of
        one pool batch, each against the reference's fit of its item."""
        n = len(answers)
        prog = {k: torch.as_tensor(np.concatenate([a[k] for a in answers]))
                for k in ("params", "cov", "nu_DM", "nu_tau", "red_chi2")}
        rep = reference.Fit(**{k: torch.cat([getattr(ref, k).cpu()] * n)
                               for k in ("params", "errs", "cov", "nu_DM",
                                         "nu_tau", "red_chi2")})
        kdm = self.config["dispersion_constant"] / self.config["period_s"]
        return compare.numbers(prog, rep, kdm, self.fit_flags)

    def check(self, limits):
        """(attempted, failed, {number: largest}) over every answer."""
        attempted, failed = 0, 0
        worst = {n: 0.0 for n in limits}
        for j in sorted({a["pool"] for a in self.answers}):
            got = [a for a in self.answers if a["pool"] == j]
            bad, w = compare.judge(self.numbers(got, self.reference_fit(j)),
                                   limits)
            attempted += len(bad)
            failed += int(bad.sum())
            worst = {n: max(worst[n], w[n]) for n in worst}
        return attempted, failed, worst
