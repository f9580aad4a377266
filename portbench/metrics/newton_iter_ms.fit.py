"""newton_iter_ms.fit [ms/iter]: the mean host wall of one Newton loop
iteration, the program's "pp:newton.iter" range (the loop's "all done?"
sync between iterations left out).  The loop a call takes about this
times newton_iters.fit.  Profiled walls: the profiler slows the host."""

from portbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    us, n = spans.total_us(t, ("pp:newton.iter",))
    return us / 1e3 / n if n else None
