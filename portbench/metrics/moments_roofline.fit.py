"""moments_roofline.fit [%]: a phase-moments pass's least time
(work.phase_moments_s: Gr, Gi, M2 and the phases read once, the three
sums written) over the phase-moments kernel's device time, a launch."""

from portbench import work

KERNELS = r"phase_moments_kernel"


def read(ctx):
    t = ctx.trace
    ks = [] if t is None else t.matching(KERNELS)
    if not ks:
        return None
    s = ctx.entry.shapes
    busy = sum(e - b for _, b, e in ks) / 1e6
    return 100.0 * len(ks) * work.phase_moments_s(
        s["B"], s["nchan"], s["nh"]) / busy
