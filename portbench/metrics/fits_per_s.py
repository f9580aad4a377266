"""fits_per_s: fits completed in the window over the window's length, from
the first call to the last result on the host (host clock)."""


def read(ctx):
    return ctx.items / ctx.window_s
