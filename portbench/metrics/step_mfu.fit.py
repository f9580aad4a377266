"""step_mfu.fit [%]: the whole call's share of the card's peak: the least
time of the call's layer work from its shapes (one setup, and as many
phase- or scattering-moments passes as the traced calls made) over the
unprofiled wall a call.  It bounds the layers' rooflines from above in
time: a kernel taken off the path leaves its roofline silent, not this."""

from portbench import work

PHASE, SCAT = r"phase_moments_kernel", r"scat_moments_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    s = ctx.entry.shapes
    least = (t.calls * work.setup_s(**s) +
             len(t.matching(PHASE)) * work.phase_moments_s(
                 s["B"], s["nchan"], s["nh"]) +
             len(t.matching(SCAT)) * work.scat_moments_s(
                 s["B"], s["nchan"], s["nh"]))
    wall = ctx.window_s / len(ctx.calls)
    return 100.0 * least / (t.calls * wall)
