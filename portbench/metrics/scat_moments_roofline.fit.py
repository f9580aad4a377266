"""scat_moments_roofline.fit [%]: a scattering-moments pass's least time
(work.scat_moments_s: Gr, Gi, M2, the phases and taus read once, the nine
sums written) over the scattering-moments kernel's device time, a
launch."""

from portbench import work

KERNELS = r"scat_moments_kernel"


def read(ctx):
    t = ctx.trace
    ks = [] if t is None else t.matching(KERNELS)
    if not ks:
        return None
    s = ctx.entry.shapes
    busy = sum(e - b for _, b, e in ks) / 1e6
    return 100.0 * len(ks) * work.scat_moments_s(
        s["B"], s["nchan"], s["nh"]) / busy
