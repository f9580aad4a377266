"""idle_share.fit [%]: 1 - device busy a call / wall a call.  Busy: the
union of device operations over the traced calls, a call; wall: the
unprofiled window's length over its calls (the profiler slows the host,
so its own wall would overstate the idle time)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    busy = ctx.trace.busy_s() / ctx.trace.calls
    wall = ctx.window_s / len(ctx.calls)
    return 100.0 * (1.0 - busy / wall)
