"""Minimal TEMPO-style par (ephemeris) file parser.

Covers the keys the reference's archive writers consume (pplib.py:
3116-3141, 3265-3296): PSR/PSRJ, RAJ, DECJ, F0/P0, F1, PEPOCH, DM.
Values with fit flags/uncertainties keep only the value; FORTRAN 'D'
exponents are handled.  Unknown keys are preserved in .all for round-trip.
"""

from __future__ import annotations


from pulseportraiture_tpu_torch.utils import DataBunch


def _to_float(s):
    return float(s.replace("D", "E").replace("d", "e"))


def parse_par(path_or_lines):
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    out = DataBunch(all={})
    for line in lines:
        toks = line.split()
        if not toks or toks[0].startswith("#") or toks[0] == "C":
            continue
        key = toks[0]
        val = toks[1] if len(toks) > 1 else ""
        out.all[key] = toks[1:]
        if key in ("PSR", "PSRJ"):
            out.PSR = val
        elif key == "RAJ":
            out.RAJ = val
        elif key == "DECJ":
            out.DECJ = val
        elif key == "F0":
            out.F0 = _to_float(val)
        elif key == "P0":
            out.P0 = _to_float(val)
        elif key == "F1":
            out.F1 = _to_float(val)
        elif key == "PEPOCH":
            out.PEPOCH = _to_float(val)
        elif key == "DM":
            out.DM = _to_float(val)
    if not hasattr(out, "P0") and hasattr(out, "F0"):
        out.P0 = 1.0 / out.F0
    if not hasattr(out, "F0") and hasattr(out, "P0"):
        out.F0 = 1.0 / out.P0
    if not hasattr(out, "F1"):
        out.F1 = 0.0
    if not hasattr(out, "DM"):
        out.DM = 0.0
    return out


def period_at(par, mjd_days: float) -> float:
    """Folding period at an epoch from F0/F1 (polyco-free spin model).

    The reference obtains per-subint folding periods from PSRCHIVE
    polycos (pplib.py:2732); a linear spin-down model is equivalent for
    the topocentric-period precision the fits consume.
    """
    dt = (mjd_days - getattr(par, "PEPOCH", mjd_days)) * 86400.0
    f = par.F0 + par.F1 * dt
    return 1.0 / f
