"""prep_ms.pipe [ms/call]: the host wall of the program's "pp:load.prep"
ranges (the rest of load_data: baseline, noise, S/N and geometry),
summed over the traced calls and taken a call; nothing where the program
records no such range.  Profiled walls: the profiler slows the host."""

from portbench import pipe


def read(ctx):
    return pipe.span_ms(ctx, "pp:load.prep")
