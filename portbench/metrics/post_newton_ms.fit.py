"""post_newton_ms.fit [ms/call]: the host wall of what follows the
Newton loop, the program's "pp:fit.nu_zeros", "pp:fit.finalize",
"pp:fit.pack" and "pp:fit.unpack" ranges, summed over the traced calls
and taken a call (unpack_result's range holds the device-to-host copy).
Profiled walls: the profiler slows the host."""

from portbench import spans

NAMES = ("pp:fit.nu_zeros", "pp:fit.finalize", "pp:fit.pack",
         "pp:fit.unpack")


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    us, n = spans.total_us(t, NAMES)
    return us / 1e3 / t.calls if n else None
