"""pptoas on the card: get_TOAs() of a fresh GetTOAs over PSRFITS files.

The pool's archives (archives.Pool: int16, total intensity, stored
dispersed) and the template's .gmodel are written once, at set-up, under
build/portbench/; each call builds a fresh GetTOAs(files, template,
device) over the next archives_per_call archives, as each pptoas run
does, and runs get_TOAs() with pptoas' defaults (fit_DM, bary, the band
cap), so the files are read, decoded and prepared anew on every call and
nothing is carried from one call to the next; a call runs on one host
thread, as a campaign's pptoas workers do.  The call's answers are
its TOA lines, one a subint; each is held against the plain reference's
line for its subint (reference_toa), and a subint without a line fails.
"""

import os
import shutil
import time

import numpy as np
import torch

from portbench import reference_toa
from portbench.archives import Pool

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Entry:
    def __init__(self, config, mix, seed, device, split):
        t = time.perf_counter()
        from pulseportraiture_tpu_torch import _build
        from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
        self.GetTOAs = GetTOAs
        if device.type == "cuda":
            _build.load_kernels()
        split["library"] = time.perf_counter() - t
        t = time.perf_counter()
        self.config, self.mix, self.device = config, mix, device
        self.pool = pool = Pool(config, mix, seed, device)
        self.dir = os.path.join(ROOT, "build", "portbench", "archives",
                                "%s-%d" % (config["name"], os.getpid()))
        shutil.rmtree(self.dir, ignore_errors=True)
        paths, self.gmodel = pool.write(self.dir, config)
        k = mix["archives_per_call"]
        self.files = [paths[j * k:(j + 1) * k] for j in range(mix["pool"])]
        mr, _ = reference_toa.template_spectrum(config, pool.nu, pool.nu_a)
        self.shapes = dict(B=mix["batch"], nchan=config["nchan"],
                           nbin=config["nbin"], nh=mr.shape[-1], kseed=2,
                           x_itemsize=2, scaled=True)
        self.answers, self._refs = [], {}
        split["data"] = time.perf_counter() - t

    def call(self, i, span):
        """One pptoas run over the archives of pool entry i mod pool, on
        one host thread, as one worker of a campaign that runs a pptoas
        a core; returns the TOAs it made.

        The load is serial numpy; torch's intra-op pool, left at the
        host's 8 cores, spun its 7 other threads through the call (~0.55
        s of CPU a call on an H100's host) for a call ~3% faster (a
        median 0.90 s against 0.93 s on one thread), taking the cores
        the main thread shares with the kernel's page-fault handling."""
        j = i % self.mix["pool"]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with span("pb:GetTOAs"):
                gt = self.GetTOAs(self.files[j], self.gmodel,
                                  device=self.device, dtype=torch.float32,
                                  quiet=True)
            with span("pb:get_TOAs"):
                gt.get_TOAs(quiet=True)
        finally:
            torch.set_num_threads(threads)
        self._last = (j, gt)
        return len(gt.TOA_list)

    def keep(self):
        """Keeps the last call's TOA lines, its slowest subint's Newton
        iterations and the program's fit_timing."""
        j, gt = self._last
        k = {f: n for n, f in enumerate(self.files[j])}
        toas = gt.TOA_list
        sec = [t.MJD.secs + t.MJD.frac for t in toas]
        self.answers.append(dict(
            pool=j, timing=dict(gt.fit_timing),
            subint=[(k[t.archive], int(t.flags["subint"])) for t in toas],
            lines=dict(
                day=np.array([t.MJD.days for t in toas], np.float64),
                sec=np.array(sec, np.float64),
                toa_err_us=np.array([t.TOA_error for t in toas], np.float64),
                dm=np.array([t.DM for t in toas], np.float64),
                dm_err=np.array([t.DM_error for t in toas], np.float64),
                gof=np.array([t.flags["gof"] for t in toas], np.float64),
                freq=np.array([t.frequency for t in toas], np.float64)),
            niter=max((int(np.max(n)) - 1 for n in gt.nfevals if len(n)),
                      default=0)))
        self._last = None

    def niter_max(self):
        """The slowest subint's Newton iterations, a call."""
        return [a["niter"] for a in self.answers]

    def release(self):
        """Removes the pool's files; the pool's data stay for the check."""
        self._last = None
        shutil.rmtree(self.dir, ignore_errors=True)

    def reference_lines(self, j, precision="float64"):
        """The plain reference's lines of pool entry j, [archive][field]
        (nsub,) on the host."""
        k = self.mix["archives_per_call"]
        return [reference_toa.lines(self.pool, j * k + a, precision)
                for a in range(k)]

    def numbers(self, answer, ref):
        """reference_toa.numbers of one call's lines (an answer as keep()
        stores it) against the reference lines ref of its pool entry;
        with the (archive, subint) of each line."""
        k = self.mix["archives_per_call"]
        at = answer["subint"]
        rep = {n: torch.stack([ref[a][n][s] for a, s in at])
               for n in ref[0]}
        dop = torch.tensor([float(self.pool.doppler[answer["pool"] * k + a,
                                                    s]) for a, s in at],
                           dtype=torch.float64)
        got = {n: torch.as_tensor(v, dtype=torch.float64)
               for n, v in answer["lines"].items()}
        return reference_toa.numbers(got, rep, dop, self.config)

    def check(self, limits):
        """(attempted, failed, {number: largest}) over every subint of
        every kept call: a subint fails when a number breaks its limit or
        is not finite, or when it has no line (or more than one)."""
        attempted, failed = 0, 0
        worst = {n: 0.0 for n in limits}
        want = self.mix["archives_per_call"] * self.mix["subints"]
        for a in self.answers:
            j = a["pool"]
            if j not in self._refs:
                self._refs[j] = self.reference_lines(j)
            attempted += want
            failed += want - len(set(a["subint"]))
            failed += len(a["subint"]) - len(set(a["subint"]))
            if not a["subint"]:
                continue
            nums = self.numbers(a, self._refs[j])
            bad = torch.zeros(len(a["subint"]), dtype=torch.bool)
            for n in limits:
                v = nums[n]
                bad |= ~(v <= limits[n])
                worst[n] = max(worst[n], float(torch.where(
                    torch.isfinite(v), v, torch.inf).max()))
            failed += int(bad.sum())
        return attempted, min(failed, attempted), worst
