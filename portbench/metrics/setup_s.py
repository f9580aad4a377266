"""setup_s: process start to the first timed call [s] (host clock):
imports, the CUDA context, the kernel library, the data made from the
seed, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
