"""The work of the fit's layers, reckoned from the call's shapes alone.

Each function counts what the layer must do, whatever kernel happens to
do it: every input byte read once, every output byte written once, and
the float32 operations of the arithmetic.  The counts follow
chip_smoke.py's setup_bound and scat_bound (the benchmark's own copies,
with nchan an argument).
"""

import math

from portbench.peaks import bound_s

# float32 operations a harmonic: the phase moments (adds and multiplies;
# sincos and round counted as one each) and the scattering moments' closed
# forms (chip_smoke.py PHASE_OPS, SCAT_OPS)
PHASE_OPS, SCAT_OPS = 19, 56


def setup_s(B, nchan, nbin, nh, kseed, x_itemsize, scaled):
    """Least seconds of the fused setup: x read once, the model spectrum
    read once, the seed weights and scales read, Gr/Gi, sd and the kseed
    seed sums written; an FFT's 2.5 nbin log2(nbin) operations a row,
    Parseval's 3 nbin, the cross-spectrum's 6 nh and the seed sums' 4
    kseed nh."""
    rows = B * nchan
    nbytes = (rows * nbin * x_itemsize + nchan * nh * 8 + rows * kseed * 4 +
              (rows * 4 if scaled else 0) + rows * nh * 8 + rows * 4 +
              B * kseed * nh * 8)
    ops = rows * (2.5 * nbin * math.log2(nbin) + 3 * nbin + 6 * nh +
                  4 * kseed * nh)
    return bound_s(nbytes, ops)


def phase_moments_s(B, nchan, nh):
    """Least seconds of one phase-moments pass: Gr, Gi, the shared M2 and
    the phases read once, the three sums written."""
    rows = B * nchan
    return bound_s(rows * nh * 8 + nchan * nh * 4 + rows * 4 + 3 * rows * 4,
                   rows * nh * PHASE_OPS)


def scat_moments_s(B, nchan, nh):
    """Least seconds of one scattering-moments pass: Gr, Gi, the shared M2,
    the phases and taus read once, the nine sums written."""
    rows = B * nchan
    return bound_s(rows * nh * 8 + nchan * nh * 4 + rows * 8 + 9 * rows * 4,
                   rows * nh * SCAT_OPS)
