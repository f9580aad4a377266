"""Spline model (.spl) reading: the legacy pickle and the .npz form.

Port of pulseportraiture_tpu.models.spline_io.read_spline_model (whose
module imports the JAX generator).  Reference: pplib.py:2955-2987.
"""

from __future__ import annotations

import pickle

import numpy as np


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
    from pulseportraiture_tpu_torch.models.spline import \
        gen_spline_portrait_np
    return (modelname,
            gen_spline_portrait_np(mean_prof, freqs, eigvec, tck, nbin))
