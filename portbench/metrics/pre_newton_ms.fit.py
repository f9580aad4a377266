"""pre_newton_ms.fit [ms/call]: the host wall of the fit's setup and
seed, the program's "pp:fit.setup" and "pp:fit.seed" ranges, summed over
the traced calls and taken a call.  Profiled walls: the profiler slows
the host."""

from portbench import spans

NAMES = ("pp:fit.setup", "pp:fit.seed")


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    us, n = spans.total_us(t, NAMES)
    return us / 1e3 / t.calls if n else None
