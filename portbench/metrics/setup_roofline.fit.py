"""setup_roofline.fit [%]: the fit setup's least time (work.setup_s from
the call's shapes: the data read once, the template once, Gr/Gi, sd and
the seed sums written; an FFT's operations) over the device time of the
kernels that do it.  Those kernels are the hand setup kernels and any FFT
kernel (a library FFT on the rfft route), by name."""

from portbench import work

KERNELS = r"(?i)setup_|seed_reduce|sd_reduce|fft"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ks = t.matching(KERNELS)
    if not ks:
        return None
    busy = sum(e - s for _, s, e in ks) / 1e6
    return 100.0 * t.calls * work.setup_s(**ctx.entry.shapes) / busy
