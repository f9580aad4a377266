"""The batched fit's spans under torch.profiler, on the CPU.

fit_portrait_full_batch_packed and unpack_result record their phases as
sibling ranges (pp:fit.setup, .seed, .newton, .nu_zeros, .finalize,
.pack, .unpack) and the Newton loop one pp:newton.iter a loop iteration,
each with one objective (pp:newton.fgh) and two subproblem solves
(pp:newton.solve), the first objective a range of its own.  Without a
profiler profiling.annotate is one shared null context, and the fit's
answers are the same bits either way.  get_TOAs records pp:toas.load,
pp:toas.fit (holding pp:toas.to_card and the fit's phases) and
pp:toas.assemble where fit_timing times.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pulseportraiture_tpu_torch import profiling
from pulseportraiture_tpu_torch.fitters.portrait import (
    fit_portrait_full_batch_packed, template_spectrum, unpack_result)

from test_torch_pipeline import ws  # noqa: F401
from torch_parity_utils import injected_batch, t64

torch.set_num_threads(2)

PHASES = ["pp:fit.setup", "pp:fit.seed", "pp:fit.newton", "pp:fit.nu_zeros",
          "pp:fit.finalize", "pp:fit.pack", "pp:fit.unpack"]
FITS = {"phi_dm": ((1, 1, 0, 0, 0), 0.0), "scat": ((1, 1, 0, 1, 1), 4e-3)}
B, NCHAN, NBIN = 3, 16, 128


def _call(kind):
    """One fit of a tiny batch, packed, then unpacked on the host."""
    ff, tau = FITS[kind]
    d = injected_batch(B=B, nchan=NCHAN, nbin=NBIN, seed=1, tau=tau)
    init = np.zeros((B, 5))
    if tau:
        init[:, 3], init[:, 4] = np.log10(2e-3), -4.0
    packed = fit_portrait_full_batch_packed(
        torch.from_numpy(d["data"]), template_spectrum(d["model"]),
        t64(init), t64(np.full(B, d["P"])), t64(d["freqs"]), t64(d["errs"]),
        nu_fits=t64(d["nu_fits"]), fit_flags=ff, log10_tau=bool(tau),
        dtype=torch.float64)
    return unpack_result(packed, NCHAN)


def _pp_spans(prof):
    """[(name, start, end)] of a profile's pp: ranges by start, outer
    first."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("pp:")),
                  key=lambda s: (s[1], -s[2]))


@pytest.fixture(scope="module")
def runs():
    """{kind: (plain result, profiled result, its pp: ranges)}."""
    out = {}
    for kind in FITS:
        plain = _call(kind)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = _call(kind)
        out[kind] = (plain, traced, _pp_spans(prof))
    return out


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2] and span != outer


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("kind", sorted(FITS))
def test_phase_spans_once_a_call_in_order(runs, kind):
    spans = runs[kind][2]
    top = [s for s in spans if not any(_inside(s, o) for o in spans)]
    assert [s[0] for s in top] == PHASES
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    for name in PHASES:
        (phase,) = _named(spans, name)
        assert not [o for o in spans if _inside(phase, o)], name


@pytest.mark.parametrize("kind", sorted(FITS))
def test_one_iteration_span_a_newton_iteration(runs, kind):
    _, res, spans = runs[kind]
    (loop,) = _named(spans, "pp:fit.newton")
    iters = _named(spans, "pp:newton.iter")
    assert len(iters) == int(res.niter.max()) >= 1
    assert all(_inside(s, loop) for s in iters)
    assert all(a[2] <= b[1] for a, b in zip(iters, iters[1:]))


@pytest.mark.parametrize("kind", sorted(FITS))
def test_each_iteration_one_objective_two_solves(runs, kind):
    _, res, spans = runs[kind]
    (loop,) = _named(spans, "pp:fit.newton")
    iters = _named(spans, "pp:newton.iter")
    fgh = _named(spans, "pp:newton.fgh")
    solves = _named(spans, "pp:newton.solve")
    for it in iters:
        assert len([s for s in fgh if _inside(s, it)]) == 1
        assert len([s for s in solves if _inside(s, it)]) == 2
    assert len(fgh) == 1 + int(res.niter.max())
    assert len(solves) == 2 * len(iters)
    # the first objective, at the start, before the loop's iterations
    assert _inside(fgh[0], loop) and fgh[0][2] <= iters[0][1]
    assert not any(_inside(fgh[0], it) for it in iters)


def test_annotate_is_one_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("pp:a")
    assert off is profiling.annotate("pp:b")
    assert isinstance(off, contextlib.nullcontext)
    with off:
        with off:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.annotate("pp:on")
        assert on is not off
        with on:
            torch.ones(3).sum()
    assert [e.name for e in prof.events()].count("pp:on") == 1


@pytest.mark.parametrize("kind", sorted(FITS))
def test_profiled_fit_gives_the_same_bits(runs, kind):
    plain, traced, _ = runs[kind]
    for name, a, b in zip(plain._fields, plain, traced):
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=True), name


def test_get_toas_spans_at_the_fit_timing_boundaries(ws):
    """get_TOAs' own ranges: pp:toas.load an archive, pp:toas.fit a
    chunk holding its pp:toas.to_card and the fit's phases, and
    pp:toas.assemble an archive; fit_timing keeps its keys."""
    from pulseportraiture_tpu_torch.pipelines import toas
    gt = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                      dtype=torch.float64, quiet=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.get_TOAs(quiet=True)
    spans = _pp_spans(prof)
    assert set(gt.fit_timing) == {"load_s", "fit_s", "assemble_s",
                                  "wall_s", "batched_chunks", "fit_subints",
                                  "i2_subints", "card_prep_subints"}
    narch = len(ws["files"])
    assert len(_named(spans, "pp:toas.load")) == narch
    assert len(_named(spans, "pp:toas.assemble")) == narch
    fits = _named(spans, "pp:toas.fit")
    assert len(fits) == gt.fit_timing["batched_chunks"] >= 1
    top = [s for s in spans if not any(_inside(s, o) for o in spans)]
    assert {s[0] for s in top} == {"pp:toas.load", "pp:toas.fit",
                                   "pp:toas.assemble"}
    for f in fits:
        inner = [s[0] for s in spans if _inside(s, f)]
        assert inner.count("pp:toas.to_card") == 1
        assert all(inner.count(p) == 1 for p in PHASES), inner
