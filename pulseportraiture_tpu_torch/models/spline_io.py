"""Spline model (.spl) files: the legacy pickle and the .npz form.

Port of pulseportraiture_tpu.models.spline_io.  The reference pickles
[modelname, source, datafile, mean_prof, eigvec, tck] with protocol 2
(ppspline.py:206-232, pplib.py:2955-3013); the .npz form needs no
unpickling.
"""

from __future__ import annotations

import pickle

import numpy as np


def write_spline_model(modelfile, modelname, source, datafile, mean_prof,
                       eigvec, tck, fmt="pickle", quiet=False):
    """Write a spline model.  fmt: 'pickle' (the reference's layout) or
    'npz'.  Tensors are written as float64 numpy arrays."""
    def host(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.asarray(a)

    t, c, k = tck
    t, c = host(t), host(c)
    mean_prof, eigvec = host(mean_prof), host(eigvec)
    if fmt == "pickle":
        # legacy layout: the tck coefficients as a list per dimension
        with open(modelfile, "wb") as f:
            pickle.dump([modelname, source, datafile, mean_prof, eigvec,
                         [t, [np.asarray(ci) for ci in c], int(k)]], f,
                        protocol=2)
    elif fmt == "npz":
        np.savez(modelfile, modelname=modelname, source=source,
                 datafile=datafile, mean_prof=mean_prof, eigvec=eigvec,
                 knots=t, coefs=c, degree=int(k))
    else:
        raise ValueError(f"Unknown spline model format {fmt!r}")
    if not quiet:
        print("%s written." % modelfile)


def read_spline_model(modelfile, freqs=None, nbin=None, quiet=True):
    """(modelname, source, datafile, mean_prof, eigvec, tck), or with
    freqs (modelname, portrait at freqs).

    The legacy format is a pickle: open only model files you trust (the
    .npz form needs no unpickling).
    """
    if str(modelfile).endswith(".npz"):
        with np.load(modelfile, allow_pickle=False) as z:
            modelname = str(z["modelname"])
            source = str(z["source"])
            datafile = str(z["datafile"])
            mean_prof = z["mean_prof"]
            eigvec = z["eigvec"]
            tck = (z["knots"], z["coefs"], int(z["degree"]))
    else:
        with open(modelfile, "rb") as f:
            modelname, source, datafile, mean_prof, eigvec, tck = \
                pickle.load(f, encoding="latin1")
        t, c, k = tck
        tck = (np.asarray(t), np.asarray(c), int(k))
    if freqs is None:
        return (modelname, source, datafile, mean_prof, eigvec, tck)
    from pulseportraiture_tpu_torch.models.spline import gen_spline_portrait
    return (modelname,
            gen_spline_portrait(mean_prof, freqs, eigvec, tck, nbin,
                                device="cpu").numpy())


def get_spline_model_coords(modelfile, nfreq=1000, lo_freq=None,
                            hi_freq=None):
    """(model_freqs, projections (nfreq, ncomp)) of a spline model's curve
    over a frequency grid, by default its knot span.  Reference:
    pplib.py:2989-3013."""
    from pulseportraiture_tpu_torch.models.spline import splev_np
    tck = read_spline_model(modelfile, quiet=True)[5]
    t = np.asarray(tck[0])
    lo_freq = t.min() if lo_freq is None else lo_freq
    hi_freq = t.max() if hi_freq is None else hi_freq
    model_freqs = np.linspace(lo_freq, hi_freq, nfreq)
    return model_freqs, splev_np(model_freqs, tck).T
