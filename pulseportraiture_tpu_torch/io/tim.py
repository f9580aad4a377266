"""TOA record and .tim writers (IPTA/tempo2 + Princeton formats).

Byte-format parity with the reference writers (pplib.py:3409-3503):
`archive freq MJDint.MJDfrac err code -pp_dm ... -pp_dme ...` plus
arbitrary flags with the reference's per-flag formatting rules
(string / int / _cov -> %.1e / phs -> %.8f / flux -> %.5f / else %.3f).
"""

from __future__ import annotations

import operator

import numpy as np


class TOA:
    """A single TOA measurement (reference pptoas.py:31-73, minus exec)."""

    def __init__(self, archive, frequency, MJD, TOA_error, telescope,
                 telescope_code, DM=None, DM_error=None, flags=None):
        self.archive = archive
        self.frequency = frequency
        self.MJD = MJD
        self.TOA_error = TOA_error
        self.telescope = telescope
        self.telescope_code = telescope_code
        self.DM = DM
        self.DM_error = DM_error
        self.flags = dict(flags or {})

    def __getattr__(self, name):
        flags = object.__getattribute__(self, "__dict__").get("flags", {})
        if name in flags:
            return flags[name]
        raise AttributeError(name)

    def write_TOA(self, inf_is_zero=True, outfile=None):
        write_TOAs(self, inf_is_zero=inf_is_zero, outfile=outfile)

    def __repr__(self):
        return (f"TOA({self.archive}, {self.frequency:.3f} MHz, "
                f"{self.MJD}, +/-{self.TOA_error:.3f} us)")


_OPS = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
        "<=": operator.le, "==": operator.eq, "!=": operator.ne}


def filter_TOAs(TOAs, flag, cutoff, criterion=">=", pass_unflagged=False,
                return_culled=False):
    """Filter TOAs on a flag/attribute (reference pplib.py:3380-3407,
    without the exec)."""
    op = _OPS[criterion]
    new_toas, culled = [], []
    for toa in TOAs:
        try:
            val = getattr(toa, flag)
            (new_toas if op(val, cutoff) else culled).append(toa)
        except AttributeError:
            (new_toas if pass_unflagged else culled).append(toa)
    if return_culled:
        return new_toas, culled
    return new_toas


def write_princeton_TOA(TOA_MJDi, TOA_MJDf, TOA_err, nu_ref, dDM, obs="@",
                        name=" " * 13, outfile=None):
    """Princeton-format TOA line.  Reference: pplib.py:3409-3443."""
    if nu_ref == np.inf:
        nu_ref = 0.0
    toa = "%5d" % int(TOA_MJDi) + ("%.13f" % TOA_MJDf)[1:]
    line = obs + " %13s %8.3f %s %8.3f              %9.5f" % (
        name, nu_ref, toa, TOA_err, dDM)
    if outfile is not None:
        with open(outfile, "a") as f:
            f.write(line + "\n")
    else:
        print(line)
    return line


def _format_flag(flag, value):
    if value is None:
        return ""
    if isinstance(value, str):
        return f" -{flag} {value}"
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        return f" -{flag} {int(value):d}"
    if "_cov" in flag:
        return f" -{flag} {value:.1e}"
    if "phs" in flag:
        return f" -{flag} {value:.8f}"
    if "flux" in flag:
        return f" -{flag} {value:.5f}"
    return f" -{flag} {value:.3f}"


def toa_string(toa, inf_is_zero=True):
    freq = 0.0 if (toa.frequency == np.inf and inf_is_zero) else \
        toa.frequency
    s = "%s %.8f %s   %.3f  %s" % (toa.archive, freq,
                                   toa.MJD.day_fracstr(15),
                                   toa.TOA_error, toa.telescope_code)
    if toa.DM is not None:
        s += " -pp_dm %.7f" % toa.DM
    if toa.DM_error is not None:
        s += " -pp_dme %.7f" % toa.DM_error
    for flag, value in toa.flags.items():
        s += _format_flag(flag, value)
    return s


def write_TOAs(TOAs, inf_is_zero=True, SNR_cutoff=0.0, outfile=None,
               append=True):
    """Write loosely-IPTA-formatted TOAs.  Reference: pplib.py:3445-3503."""
    toas = TOAs if hasattr(TOAs, "__len__") else [TOAs]
    toas = filter_TOAs(toas, "snr", SNR_cutoff, ">=", pass_unflagged=False)
    lines = [toa_string(t, inf_is_zero) for t in toas]
    if outfile is not None:
        with open(outfile, "a" if append else "w") as f:
            for line in lines:
                f.write(line + "\n")
    else:
        for line in lines:
            print(line)
    return lines
