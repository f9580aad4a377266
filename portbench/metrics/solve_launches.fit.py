"""solve_launches.fit [launches/solve]: kernels launched a trust-region
subproblem solve: the CUDA runtime's launch records that start inside
the program's "pp:newton.solve" ranges, over the number of ranges (two
an iteration: the step and the speculative step)."""

from portbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    n, solves = spans.launches_in(t, "pp:newton.solve")
    return n / solves if solves else None
