"""card_prep_share.pipe [%]: the share of the window's fitted subints
whose archive's baseline, noise and S/N came from the card, the
program's fit_timing["card_prep_subints"] over fit_timing["fit_subints"];
nothing where the program keeps no such count."""

from portbench import pipe


def read(ctx):
    card = pipe.timing_sum(ctx, "card_prep_subints")
    fits = pipe.timing_sum(ctx, "fit_subints")
    return 100.0 * card / fits if card is not None and fits else None
