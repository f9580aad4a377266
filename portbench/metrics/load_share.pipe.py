"""load_share.pipe [%]: the share of the window's call time that
get_TOAs spent loading its archives, the program's fit_timing["load_s"]
(prep_archive: the read, the decode, baseline, noise and S/N, the
template), summed over the window's calls, over their walls (host
clock)."""

from portbench import pipe


def read(ctx):
    return pipe.timing_share(ctx, "load_s")
