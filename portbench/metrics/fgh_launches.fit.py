"""fgh_launches.fit [launches/eval]: kernels launched an objective
evaluation (chi2, gradient and Hessian from the moments): the CUDA
runtime's launch records that start inside the program's
"pp:newton.fgh" ranges, over the number of ranges (one before the loop,
one an iteration)."""

from portbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    n, evals = spans.launches_in(t, "pp:newton.fgh")
    return n / evals if evals else None
