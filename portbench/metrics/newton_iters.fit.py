"""newton_iters.fit: the mean over the window's calls of the slowest
item's Newton iterations (a batch runs until its slowest item stops), as
the program's result reports them (niter)."""


def read(ctx):
    n = ctx.entry.niter_max()
    return sum(n) / len(n) if n else None
