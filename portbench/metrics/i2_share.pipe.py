"""i2_share.pipe [%]: the share of the window's fitted subints that
reached the fit as int16 samples and scales, the program's
fit_timing["i2_subints"] over fit_timing["fit_subints"]; nothing where
the program keeps no such count."""

from portbench import pipe


def read(ctx):
    i2 = pipe.timing_sum(ctx, "i2_subints")
    fits = pipe.timing_sum(ctx, "fit_subints")
    return 100.0 * i2 / fits if i2 is not None and fits else None
