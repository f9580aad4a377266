"""The benchmark's cells at a size a CPU test run holds."""

import time

import torch

from portbench import run

# channels and bins a cell keeps on the CPU; its band, template, noise,
# draws and limits are the cell's own
SIZES = {"lband_fit_phidm": (256, 512), "lband_fit_phidm_host": (256, 512),
         "uwl_fit_scat": (416, 512)}
CPU = torch.device("cpu")


def cell(name):
    c = run.Cell(name)
    nchan, nbin = SIZES[name]
    c.config = dict(c.config, nchan=nchan, nbin=nbin)
    c.mix = dict(c.mix, batch=4, pool=2, trace_calls=2)
    return c


def run_cell(name, trace=0, seed=2**31 + 9, seconds=0.5):
    """One run of the tiny cell on the CPU, past the look for a card."""
    return run.run_cell(cell(name), seed, seconds, trace, CPU,
                        time.perf_counter())
