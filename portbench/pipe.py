"""What the pipeline cell's metric readers share: sums of the program's
fit_timing over the window's calls (the entry keeps each call's), and
the ms a call of one of the program's ranges in the traced calls."""

from portbench import spans


def timing_sum(ctx, key):
    """The sum of fit_timing[key] over the window's calls, or None where
    a call's fit_timing has no such key."""
    got = [a.get("timing", {}).get(key)
           for a in ctx.entry.answers[:len(ctx.calls)]]
    if not got or any(v is None for v in got):
        return None
    return sum(got)


def timing_share(ctx, key):
    """100 x the sum of fit_timing[key] [s] over the window's calls'
    walls."""
    v = timing_sum(ctx, key)
    if v is None:
        return None
    return 100.0 * v / sum(e - s for s, e, _ in ctx.calls)


def span_ms(ctx, name):
    """The summed host wall [ms] of the ranges named `name` in the traced
    calls, a call; None without device operations or such ranges."""
    t = spans.traced(ctx)
    if t is None:
        return None
    us, n = spans.total_us(t, (name,))
    return us / 1e3 / t.calls if n else None
