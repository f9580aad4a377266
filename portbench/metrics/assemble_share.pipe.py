"""assemble_share.pipe [%]: the share of the window's call time that
get_TOAs spent assembling TOA lines, the program's
fit_timing["assemble_s"] (_assemble_archive), summed over the window's
calls, over their walls (host clock)."""

from portbench import pipe


def read(ctx):
    return pipe.timing_share(ctx, "assemble_s")
