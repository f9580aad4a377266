"""The program's own ranges in a Trace: the port's "pp:" spans
(profiling.annotate, torch.profiler record_function ranges) and the CUDA
runtime's kernel launch records, both host events on the clock of the
trace's device kernels.  A kernel runs after the range that launched it
has ended, so launches are counted from the runtime's records, by the
range in which each starts."""

import bisect
import re

LAUNCH = re.compile(r"(?i)^cu(da)?Launch(Cooperative)?Kernel")


def traced(ctx):
    """The Trace of a --trace 1 run in which the device ran operations,
    else None."""
    t = ctx.trace
    return t if t is not None and t.kernels else None


def ranges(trace, name):
    """[(start_us, end_us)] of the host ranges named `name` inside the
    traced window, by start."""
    return sorted((s, e) for n, s, e in trace.spans
                  if n == name and trace.t0_us <= s and e <= trace.t1_us)


def total_us(trace, names):
    """Summed length [us] of the ranges of every name in `names`, and how
    many there were."""
    rs = [r for n in names for r in ranges(trace, n)]
    return sum(e - s for s, e in rs), len(rs)


def launch_starts(trace):
    """Start times [us] of the runtime's kernel launch records inside the
    traced window, sorted."""
    return sorted(s for n, s, _ in trace.spans
                  if LAUNCH.match(n) and trace.t0_us <= s <= trace.t1_us)


def launches_in(trace, name):
    """(launch records that start inside a range named `name`, number of
    such ranges)."""
    starts = launch_starts(trace)
    rs = ranges(trace, name)
    n = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
            for s, e in rs)
    return n, len(rs)
