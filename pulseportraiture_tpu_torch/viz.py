"""Diagnostic plots (matplotlib, imported only when a plot is drawn).

Port of the JAX package's viz module: the reference's show_* family
(pplib.py:3505-4045): portrait image + profile/flux side panels, stacked
profiles, data/model/residual panels with per-channel red-chi2, eigen
profiles, and spline-curve projections; and the interactive Gaussian
component selector of ppgauss.  The plots take host arrays (numpy, or
tensors, which are copied to the host).  The package imports without
matplotlib; a plot asked for without it raises an ImportError that
names it.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """a as a host numpy array (a tensor anywhere is copied to the host)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("the plots need matplotlib, which is not "
                          "installed") from exc
    if not matplotlib.get_backend().lower().startswith(("qt", "tk", "mac",
                                                        "gtk", "wx")):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def show_portrait(port, phases=None, freqs=None, title=None, prof=True,
                  fluxprof=True, rvrsd=False, colorbar=True, savefig=False,
                  show=True, aspect="auto", interpolation="none",
                  origin="lower", **kwargs):
    """Portrait image with optional mean-profile and flux side panels.

    Reference: pplib.py:3505-3610.
    """
    plt = _plt()
    port = _host(port)
    nchan, nbin = port.shape
    if phases is None:
        phases = (np.arange(nbin) + 0.5) / nbin
    if freqs is None:
        freqs = np.arange(nchan)
    if rvrsd:
        port = port[::-1]
        freqs = freqs[::-1]
    extent = (phases[0], phases[-1], freqs.min(), freqs.max())
    fig = plt.figure(figsize=(8, 7))
    if prof or fluxprof:
        grid = fig.add_gridspec(2, 2, width_ratios=[4, 1],
                                height_ratios=[4, 1], hspace=0.05,
                                wspace=0.05)
        ax = fig.add_subplot(grid[0, 0])
    else:
        ax = fig.add_subplot(111)
    im = ax.imshow(port, aspect=aspect, origin=origin, extent=extent,
                   interpolation=interpolation, **kwargs)
    ax.set_ylabel("Frequency [MHz]")
    if title:
        ax.set_title(title)
    if prof:
        axp = fig.add_subplot(grid[1, 0], sharex=ax)
        axp.plot(phases, port.mean(0), "k-")
        axp.set_xlabel("Phase [rot]")
        axp.set_ylabel("Flux")
    if fluxprof:
        axf = fig.add_subplot(grid[0, 1], sharey=ax)
        axf.plot(port.mean(1), freqs, "k-")
        axf.set_xlabel("Flux")
    if colorbar:
        fig.colorbar(im, ax=ax, fraction=0.046)
    return _finish(plt, fig, savefig, show)


def show_profiles(port, nprofs=8, savefig=False, show=True):
    """A subset of channel profiles.  Reference: pplib.py:3677-3700."""
    plt = _plt()
    port = _host(port)
    idx = np.linspace(0, len(port) - 1, min(nprofs, len(port))).astype(int)
    fig, ax = plt.subplots(figsize=(7, 5))
    for i in idx:
        ax.plot(port[i], label=f"chan {i}")
    ax.set_xlabel("Bin")
    ax.legend(fontsize=7)
    return _finish(plt, fig, savefig, show)


def show_stacked_profiles(port, freqs=None, spacing=None, savefig=False,
                          show=True):
    """Vertically offset channel profiles.  Reference: pplib.py:3612-3675."""
    plt = _plt()
    port = _host(port)
    if spacing is None:
        spacing = 1.5 * np.abs(port).max()
    fig, ax = plt.subplots(figsize=(6, 9))
    for i, prof in enumerate(port):
        ax.plot(prof + i * spacing, "k-", lw=0.5)
    ax.set_xlabel("Bin")
    ax.set_yticks([])
    return _finish(plt, fig, savefig, show)


def show_residual_plot(port, model, phases=None, freqs=None, errs=None,
                       titles=("Data", "Model", "Residuals"), title=None,
                       savefig=False, show=True, **kwargs):
    """Data/model/residual panels + per-channel red-chi2 histogram.

    Reference: pplib.py:3702-3823.  ``title`` is an overall figure title;
    ``titles`` label the three panels.
    """
    plt = _plt()
    port = _host(port)
    model = _host(model)
    resid = port - model
    nchan, nbin = port.shape
    if phases is None:
        phases = (np.arange(nbin) + 0.5) / nbin
    if freqs is None:
        freqs = np.arange(nchan)
    extent = (phases[0], phases[-1], np.min(freqs), np.max(freqs))
    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    for ax, dataset, panel_title in zip(axes.flat[:3],
                                        (port, model, resid), titles):
        ax.imshow(dataset, aspect="auto", origin="lower", extent=extent,
                  **kwargs)
        ax.set_title(panel_title)
        ax.set_xlabel("Phase [rot]")
        ax.set_ylabel("Freq [MHz]")
    if errs is None:
        errs = resid.std(axis=1)
    errs = np.where(errs > 0, errs, 1.0)
    red_chi2 = (resid ** 2).sum(axis=1) / (errs ** 2 * nbin)
    axes.flat[3].hist(red_chi2[red_chi2 > 0], bins=20, color="gray")
    axes.flat[3].set_xlabel("Channel red chi2")
    if title:
        fig.suptitle(title)
    return _finish(plt, fig, savefig, show)


def show_eigenprofiles(eigvec, mean_prof=None, ncomp=None, savefig=False,
                       show=True):
    """Mean profile + eigenprofiles.  Reference: pplib.py:3964-4045."""
    plt = _plt()
    eigvec = _host(eigvec)
    if ncomp is None:
        ncomp = min(4, eigvec.shape[1])
    nrow = ncomp + (1 if mean_prof is not None else 0)
    fig, axes = plt.subplots(max(nrow, 1), 1, figsize=(6, 2 * nrow),
                             sharex=True)
    axes = np.atleast_1d(axes)
    irow = 0
    if mean_prof is not None:
        axes[0].plot(mean_prof, "k-")
        axes[0].set_ylabel("mean")
        irow = 1
    for ic in range(ncomp):
        axes[irow + ic].plot(eigvec[:, ic], "b-")
        axes[irow + ic].set_ylabel(f"e{ic}")
    axes[-1].set_xlabel("Bin")
    return _finish(plt, fig, savefig, show)


def show_spline_curve_projections(proj_port, freqs, tck=None, savefig=False,
                                  show=True):
    """Projected coordinates vs frequency (+ spline curve).

    Reference: pplib.py:3825-3962.
    """
    plt = _plt()
    proj_port = _host(proj_port)
    ncomp = proj_port.shape[1]
    fig, axes = plt.subplots(max(ncomp, 1), 1, figsize=(6, 2 * ncomp),
                             sharex=True)
    axes = np.atleast_1d(axes)
    if tck is not None:
        from pulseportraiture_tpu_torch.models.spline import splev_np
        fine = np.linspace(np.min(freqs), np.max(freqs), 400)
        curve = splev_np(fine, tck)
    for ic in range(ncomp):
        axes[ic].plot(freqs, proj_port[:, ic], "k.")
        if tck is not None:
            axes[ic].plot(fine, curve[ic], "r-")
        axes[ic].set_ylabel(f"proj {ic}")
    axes[-1].set_xlabel("Frequency [MHz]")
    return _finish(plt, fig, savefig, show)


def _finish(plt, fig, savefig, show):
    if savefig:
        fig.savefig(savefig if isinstance(savefig, str) else "ppplot.png",
                    dpi=120, bbox_inches="tight")
    if show and not savefig:
        try:
            plt.show()
        except Exception:
            pass
    plt.close(fig)
    return fig


class GaussianSelector:
    """Interactive matplotlib hand-fitter for Gaussian components.

    Feature-parity reimplementation of the reference's selector
    (ppgauss.py:374-655) over the port's Gaussian fitters (host
    tensors, float64):

    - left-click-drag draws a rubber-band box; on release a component
      is added with loc = box center, wid = box width, amp = 1.05 x
      (release-y - DC); the press-y anchors at the DC guess
    - middle click fits all components (+ optional scattering) and
      shows the best fit plus a residual panel
    - right click removes the last component
    - 'q' (or closing the window) finishes; results live in
      fitted_params / fit_errs / chi2 / dof / residuals (and ``fit``)
    - tau seeds the scattering timescale [bin]; fixscat=False fits it
    - auto_gauss != 0 skips interaction: a single component of that
      width is placed by a brute phase fit and fitted immediately
    - profile_fit_flags selects which non-scattering parameters to fit
    """

    def __init__(self, profile, errs, fit_scattering=None, quiet=True,
                 tau=0.0, fixscat=True, auto_gauss=0.0,
                 profile_fit_flags=None, ax=None):
        self.profile = _host(profile).astype(float)
        self.errs = errs
        if fit_scattering is None:
            fit_scattering = not fixscat
        self.fit_scattering = fit_scattering
        # the reference's 0-tau guard: fitting scattering from exactly
        # zero stalls (ppgauss.py:414-416)
        self.tau = float(tau) if (tau or not fit_scattering) else 0.1
        self.profile_fit_flags = profile_fit_flags
        self.quiet = quiet
        self.nbin = len(self.profile)
        self.phases = (np.arange(self.nbin) + 0.5) / self.nbin
        self.components = []  # (loc, wid, amp)
        # DC guess: low-decile level, as the reference (ppgauss.py:419)
        self.dc = float(sorted(self.profile)[self.nbin // 10 + 1])
        self.fit = None
        self.fitted_params = None
        self.fit_errs = None
        self.chi2 = None
        self.dof = None
        self.residuals = None
        self._press = None
        if not quiet and not auto_gauss:
            print("=============================================")
            print("Left mouse drag to draw a Gaussian component")
            print("Middle mouse click to fit components to data")
            print("Right mouse click to remove the last component")
            print("Press 'q' or close window when done fitting")
            print("=============================================")
        plt = _plt()
        if ax is not None:
            self.fig = ax.figure
            self.ax = ax
            self.ax_resid = None
        else:
            self.fig, (self.ax, self.ax_resid) = plt.subplots(
                2, 1, figsize=(10, 7), height_ratios=[2, 1], sharex=True)
        self.ax.plot(self.phases, self.profile, c="k", lw=3, alpha=0.3)
        self.ax.axhline(0.0, color="k", lw=1, alpha=0.3, ls=":")
        if self.ax_resid is not None:
            self.ax_resid.set_xlabel("Pulse Phase")
            self.ax_resid.set_ylabel("Data-Fit Residuals")
        self.ax.set_ylabel("Pulse Amplitude")
        self._comp_lines = []
        self._model_line, = self.ax.plot([], [], "k-", lw=1)
        self._resid_line = None
        from matplotlib.patches import Rectangle
        self._band = Rectangle((0, 0), 0, 0, fill=False, edgecolor="k",
                               alpha=0.5, visible=False)
        self.ax.add_patch(self._band)
        self.fig.canvas.mpl_connect("button_press_event", self._on_press)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_move)
        self.fig.canvas.mpl_connect("button_release_event",
                                    self._on_release)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        if auto_gauss:
            self._auto_fit(float(auto_gauss))
        plt.show()

    # ------------------------------------------------------- events
    def _on_press(self, event):
        if event.inaxes != self.ax:
            return
        if event.button == 1:
            # press-y anchored at the DC guess (ppgauss.py:503-505)
            self._press = (event.xdata, self.dc)
            self._band.set_visible(True)
        elif event.button == 2:
            self._do_fit()
        elif event.button == 3 and self.components:
            self.components.pop()   # last component (ppgauss.py:641-647)
            self._redraw()

    def _on_move(self, event):
        if self._press is None or event.inaxes != self.ax:
            return
        x0, y0 = self._press
        x1, y1 = event.xdata, event.ydata
        self._band.set_x(min(x0, x1))
        self._band.set_y(min(y0, y1))
        self._band.set_width(abs(x1 - x0))
        self._band.set_height(abs(y1 - y0))
        self.fig.canvas.draw_idle()

    def _on_release(self, event):
        if event.inaxes != self.ax or self._press is None or \
                event.button != 1:
            return
        x0, _ = self._press
        self._press = None
        self._band.set_visible(False)
        # loc/wid/amp from the box, as the reference (ppgauss.py:600-607)
        loc = 0.5 * (x0 + event.xdata)
        wid = max(abs(event.xdata - x0), 1.0 / self.nbin)
        amp = abs(1.05 * (event.ydata - self.dc))
        self.components.append((loc, wid, amp))
        self._redraw()

    def _on_key(self, event):
        if event.key == "q":
            _plt().close(self.fig)

    # ------------------------------------------------------- fitting
    def _params(self):
        params = [self.dc, self.tau]
        for loc, wid, amp in self.components:
            params += [loc, wid, amp]
        return params

    def _auto_fit(self, wid):
        from pulseportraiture_tpu_torch.fitters.phase_shift import \
            fit_phase_shift
        from pulseportraiture_tpu_torch.ops.gaussian import gaussian_profile
        amp = float(self.profile.max())
        first = amp * np.asarray(gaussian_profile(self.nbin, 0.5, wid))
        shift = fit_phase_shift(torch.as_tensor(self.profile),
                                torch.as_tensor(first), self.errs)
        loc = 0.5 + float(shift.phase)
        self.components.append((loc, wid, amp))
        if not self.quiet:
            print("Auto-fitting a single Gaussian component...")
        self._do_fit()

    def _do_fit(self):
        if not self.components:
            return
        from pulseportraiture_tpu_torch.models.gaussian import \
            fit_gaussian_profile
        if not self.quiet:
            print("Fitting reference Gaussian profile...")
        self.fit = fit_gaussian_profile(
            torch.as_tensor(self.profile),
            torch.as_tensor(self._params(), dtype=torch.float64),
            self.errs, fit_flags=self.profile_fit_flags,
            fit_scattering=self.fit_scattering, quiet=self.quiet)
        p = list(np.asarray(self.fit.fitted_params))
        self.fitted_params = np.asarray(self.fit.fitted_params)
        self.fit_errs = np.asarray(getattr(self.fit, "fit_errs", []))
        self.chi2 = getattr(self.fit, "chi2", None)
        self.dof = getattr(self.fit, "dof", None)
        self.dc = p[0]
        self.tau = p[1]
        self.components = [(p[i], p[i + 1], p[i + 2])
                           for i in range(2, len(p) - 2, 3)]
        self._redraw(show_fit=True)

    # ------------------------------------------------------- drawing
    def _redraw(self, show_fit=False):
        from pulseportraiture_tpu_torch.models.gaussian import \
            gen_gaussian_profile
        from pulseportraiture_tpu_torch.ops.gaussian import gaussian_profile
        for ln in self._comp_lines:
            ln.remove()
        self._comp_lines = []
        # per-component colored curves (ppgauss.py:584-593)
        colors = ["b", "g", "r", "c", "m", "y"] * 10
        for i, (loc, wid, amp) in enumerate(self.components):
            comp = self.dc + amp * np.asarray(
                gaussian_profile(self.nbin, loc, wid))
            ln, = self.ax.plot(self.phases, comp, colors[i], lw=1)
            self._comp_lines.append(ln)
        model = gen_gaussian_profile(
            torch.as_tensor(self._params(), dtype=torch.float64),
            self.nbin).detach().numpy()
        self._model_line.set_data(self.phases, model)
        if show_fit and self.ax_resid is not None:
            self.residuals = self.profile - model
            if self._resid_line is None:
                self._resid_line, = self.ax_resid.plot(
                    self.phases, self.residuals, "k")
            else:
                self._resid_line.set_data(self.phases, self.residuals)
            self.ax_resid.relim()
            self.ax_resid.autoscale_view()
        self.fig.canvas.draw_idle()


def set_colormap(cmap="viridis"):
    """Set the default matplotlib colormap (reference pplib.py:656-669)."""
    import matplotlib
    matplotlib.rcParams["image.cmap"] = cmap
