"""Gaussian-model (.gmodel) text files.

Port of pulseportraiture_tpu.models.gmodel_io, evaluating with the port's
own generator on the host.  The format is the reference's
(pplib.py:2828-2953): MODEL / CODE / FREQ / DC / TAU / ALPHA lines plus
one COMPnn line per component with six (value, fit-flag) pairs.  TAU is
stored in seconds and converted to bins (tau_bin = tau_sec * nbin / P) on
evaluation.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.models.gaussian import gen_gaussian_portrait


def write_model(filename, name, model_code, nu_ref, model_params, fit_flags,
                alpha, fit_alpha, append=False, quiet=False):
    """Write a .gmodel file.  model_params[1] is the scattering timescale
    in *seconds*.  Reference: pplib.py:2828-2865."""
    with open(filename, "a" if append else "w") as outfile:
        outfile.write("MODEL   %s\n" % name)
        outfile.write("CODE    %s\n" % model_code)
        outfile.write("FREQ    %.5f\n" % nu_ref)
        outfile.write("DC     % .8f %d\n" % (model_params[0], fit_flags[0]))
        outfile.write("TAU    % .8f %d\n" % (model_params[1], fit_flags[1]))
        outfile.write("ALPHA  % .3f      %d\n" % (alpha, fit_alpha))
        for igauss in range((len(model_params) - 2) // 6):
            comp = model_params[2 + igauss * 6: 8 + igauss * 6]
            fit_comp = fit_flags[2 + igauss * 6: 8 + igauss * 6]
            pairs = []
            for v, f in zip(comp, fit_comp):
                pairs.extend([v, f])
            outfile.write(
                "COMP%02d % .8f %d  % .8f %d  % .8f %d  % .8f %d  % .8f %d"
                "  % .8f %d\n" % ((igauss + 1,) + tuple(pairs)))
    if not quiet:
        print("%s written." % filename)


def read_model(modelfile, phases=None, freqs=None, P=None, quiet=True):
    """Read a .gmodel file; optionally evaluate it to a portrait.

    Read-only: returns (name, code, nu_ref, ngauss, params, fit_flags,
    alpha, fit_alpha).  With phases/freqs: returns (name, ngauss, model)
    with TAU converted from seconds to bins.  Reference: pplib.py:2867-2953.
    """
    read_only = phases is None and freqs is None
    ngauss = 0
    comps = []
    modelname = model_code = None
    nu_ref = dc = tau = alpha = 0.0
    fit_dc = fit_tau = fit_alpha = 0
    with open(modelfile) as f:
        for line in f.readlines():
            info = line.split()
            if not info:
                continue
            key = info[0]
            try:
                if key == "MODEL":
                    modelname = info[1]
                elif key == "CODE":
                    model_code = info[1]
                elif key == "FREQ":
                    nu_ref = np.float64(info[1])
                elif key == "DC":
                    dc, fit_dc = np.float64(info[1]), int(info[2])
                elif key == "TAU":
                    tau, fit_tau = np.float64(info[1]), int(info[2])
                elif key == "ALPHA":
                    alpha, fit_alpha = np.float64(info[1]), int(info[2])
                elif key.startswith("COMP"):
                    comps.append(line)
                    ngauss += 1
            except IndexError:
                pass
    params = np.zeros(ngauss * 6 + 2)
    fit_flags = np.zeros(len(params))
    params[0], params[1] = dc, tau
    fit_flags[0], fit_flags[1] = fit_dc, fit_tau
    for igauss in range(ngauss):
        toks = comps[igauss].split()
        params[2 + igauss * 6: 8 + igauss * 6] = \
            [np.float64(v) for v in toks[1::2]]
        fit_flags[2 + igauss * 6: 8 + igauss * 6] = \
            [int(v) for v in toks[2::2]]
    if read_only:
        return (modelname, model_code, nu_ref, ngauss, params, fit_flags,
                alpha, fit_alpha)
    nbin = len(phases)
    if params[1] != 0:
        if P is None:
            raise ValueError("Need period P for non-zero scattering TAU.")
        params = params.copy()
        params[1] *= nbin / P  # seconds -> bins (pplib.py:2936)
    model = gen_gaussian_portrait(model_code, params, alpha, phases,
                                  freqs, nu_ref).numpy()
    if not quiet:
        print("Model %s: %d components, %d bins, %d channels @ %.3f MHz"
              % (modelname, ngauss, nbin, len(freqs), nu_ref))
    return (modelname, ngauss, model)
