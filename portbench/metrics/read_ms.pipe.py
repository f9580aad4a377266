"""read_ms.pipe [ms/call]: the host wall of the program's "pp:load.read"
ranges (read_psrfits: the file, its columns and the int16 decode),
summed over the traced calls and taken a call; nothing where the program
records no such range.  Profiled walls: the profiler slows the host."""

from portbench import pipe


def read(ctx):
    return pipe.span_ms(ctx, "pp:load.read")
