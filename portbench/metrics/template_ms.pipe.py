"""template_ms.pipe [ms/call]: the host wall of the program's
"pp:load.template" ranges (the template at a cache miss: evaluation,
the DM0 rotation and the band cap), summed over the traced calls and
taken a call; nothing where the program records no such range.
Profiled walls: the profiler slows the host."""

from portbench import pipe


def read(ctx):
    return pipe.span_ms(ctx, "pp:load.template")
