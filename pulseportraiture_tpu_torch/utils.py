"""Small shared utilities: the DataBunch record, bin centers, weighted
mean and RMS, threshold crossings.

This package's own copy of the helpers it needs from
pulseportraiture_tpu/utils.py (same behaviour; reference pplib.py).
"""

from __future__ import annotations

import numpy as np


class DataBunch(dict):
    """dict with attribute access; universal result/record type.

    Expensive fields may be registered lazily (add_lazy): the thunk runs
    on first attribute access and the result is cached in place, so a
    loader's cost stays proportional to the fields a caller uses.

    Reference: pplib.py:125-136.
    """

    def __init__(self, **kwds):
        super().__init__(**kwds)
        self.__dict__ = self

    def add_lazy(self, name, thunk):
        self.setdefault("_lazy", {})[name] = thunk

    def __getattr__(self, name):
        thunks = dict.get(self, "_lazy")
        if thunks is not None and name in thunks:
            val = thunks.pop(name)()
            self[name] = val
            return val
        raise AttributeError(name)

    def __contains__(self, name):
        if dict.__contains__(self, name):
            return True
        thunks = dict.get(self, "_lazy")
        return bool(thunks) and name in thunks


def get_bin_centers(nbin: int, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Return nbin bin centers with extremities at lo and hi.

    Reference: pplib.py:671-684.
    """
    lo = np.float64(lo)
    hi = np.float64(hi)
    diff = hi - lo
    return np.linspace(lo + diff / (nbin * 2), hi - diff / (nbin * 2), nbin)


def weighted_mean(data, errs=1.0):
    """Weighted mean and its standard error; weights are errs**-2.

    Reference: pplib.py:696-709.
    """
    data = np.asarray(data, dtype=np.float64)
    if np.isscalar(errs) or getattr(errs, "ndim", 0) == 0:
        errs = np.ones(len(data))
    errs = np.asarray(errs, dtype=np.float64)
    ok = errs > 0.0
    w = errs[ok] ** -2.0
    mean = (data[ok] * w).sum() / w.sum()
    return mean, w.sum() ** -0.5


def count_crossings(x, x0):
    """Number of crossings of the 1-D array x across the threshold x0.

    Reference: pplib.py:686-694.
    """
    x = np.asarray(x)
    return int((np.diff(np.sign(x - x0)) != 0).sum() - ((x - x0) == 0).sum())


def get_WRMS(data, errs=1.0):
    """Weighted root-mean-square value.  Reference: pplib.py:711-725."""
    data = np.asarray(data, dtype=np.float64)
    if np.isscalar(errs) or getattr(errs, "ndim", 0) == 0:
        errs = np.ones(len(data))
    errs = np.asarray(errs, dtype=np.float64)
    ok = errs > 0.0
    w_mean = weighted_mean(data, errs)[0]
    w = errs[ok] ** -2.0
    return (((data[ok] - w_mean) ** 2.0 * w).sum() / w.sum()) ** 0.5
