"""Peaks of one NVIDIA H100 SXM and the least time a piece of work takes.

NVIDIA's data sheet, dense rates, at the full 700 W power limit: HBM3 at
3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.  A card set
below 700 W runs slower under load; each run prints its power limit
beside its shares.
"""

PEAK_BYTES = 3.35e12       # bytes/s
PEAK_F32 = 67e12           # float32 operations/s


def bound_s(nbytes, nops):
    """Least seconds for nbytes of HBM traffic and nops float32
    operations: whichever of the two takes longer at the peaks."""
    return max(nbytes / PEAK_BYTES, nops / PEAK_F32)
