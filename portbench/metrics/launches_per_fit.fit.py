"""launches_per_fit.fit: device kernels launched in the traced calls over
the fits they made (memory copies and sets not counted)."""

KERNEL = r"^(?!Memcpy|Memset)"


def read(ctx):
    if ctx.trace is None or not ctx.trace.items:
        return None
    n = len(ctx.trace.matching(KERNEL))
    return n / ctx.trace.items if n else None
