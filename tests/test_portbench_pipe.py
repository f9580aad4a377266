"""The benchmark's pipeline cell (lband_pipe_phidm) on the CPU, at a tiny
size: 2 archives x 2 subints of 64 channels x 256 bins, int16,
total intensity, written by the benchmark's own PSRFITS writer.

The program's get_TOAs lines against the plain TOA-line reference within
the cell's limits, which the reference in TF32 breaks; planted faults (a
TOA moved by its error, a subint's line dropped) that make `correct`
false; the program's reader returning
the generator's int16 samples and scales bit for bit; the int16 route's
count (every subint of npol = 1 files, none of npol = 4 files); the
card-prep route (the archives' statistics from the raw samples, here by
the kernel's plain twin): its count, its lines against the host route's,
a subint fitted outside the batch; the loader's pp:load.* ranges under
torch.profiler and nowhere without one; and the cell's metric readers on
hand-built inputs.
"""

import contextlib
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import archives, control_toa, run
from portbench.trace import Trace
from pulseportraiture_tpu_torch import profiling
from pulseportraiture_tpu_torch.config import DCONST
from pulseportraiture_tpu_torch.io.psrfits import read_psrfits, write_psrfits
from pulseportraiture_tpu_torch.pipelines import toas

torch.set_num_threads(2)

CELL, CPU = "lband_pipe_phidm", torch.device("cpu")
SEED = 2**31 + 17


def _cell():
    c = run.Cell(CELL)
    c.config = dict(c.config, nchan=64, nbin=256)
    c.mix = dict(c.mix, pool=1, subints=2, batch=4, trace_calls=1)
    return c


def _plain(_):
    return contextlib.nullcontext()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny pool written as npol = 1 files (the benchmark's writer)
    and as npol = 4 files (the program's writer, Stokes I the same
    samples, Q, U, V noise)."""
    c = _cell()
    pool = archives.Pool(c.config, c.mix, SEED, CPU)
    d = tmp_path_factory.mktemp("pipe")
    one, gm = pool.write(str(d / "npol1"), c.config)
    os.makedirs(d / "npol4")
    four = []
    rng = np.random.default_rng(5)
    for ia, path in enumerate(one):
        a = read_psrfits(path)
        i = a.data[:, :1].astype(np.float64)
        a.data = np.concatenate(
            [i, 0.1 * rng.standard_normal((a.nsub, 3) + i.shape[2:])], 1)
        a.state, a.raw_i2, a.raw_scl = "Stokes", None, None
        four.append(str(d / "npol4" / os.path.basename(path)))
        write_psrfits(four[-1], a, dtype="i2")
    return dict(pool=pool, npol1=one, npol4=four, gmodel=gm)


@pytest.mark.parametrize("seed", [SEED, 11])
def test_lines_match_the_reference_within_the_cells_limits(seed):
    c = _cell()
    entry = c.entry().Entry(c.config, c.mix, seed, CPU, {})
    assert entry.call(0, _plain) == 4
    entry.keep()
    entry.release()
    attempted, failed, worst = entry.check(c.limits)
    assert attempted == 4 and failed == 0, worst
    assert entry.niter_max()[0] >= 1
    assert not os.path.exists(entry.dir)


def test_control_is_not_correct():
    """The plain reference in TF32 (the precision below the cell's
    float32) in the program's place breaks a limit of the cell where the
    program's lines keep every one."""
    c = _cell()
    got = control_toa.readings(c, SEED, CPU)
    assert all(got["program"][n] <= c.limits[n] for n in c.limits), got
    assert any(got["control"][n] > c.limits[n] for n in c.limits), got


def _moved(monkeypatch):
    """The first line of each archive moved by its own TOA error."""
    real = toas.GetTOAs._assemble_archive

    def moved(self, job, *a, **kw):
        n = len(self.TOA_list)
        real(self, job, *a, **kw)
        t = self.TOA_list[n]
        t.MJD = t.MJD.add_seconds(t.TOA_error * 1e-6)
    monkeypatch.setattr(toas.GetTOAs, "_assemble_archive", moved)


def _dropped(monkeypatch):
    """The last subint of each archive left without a line."""
    real = toas.GetTOAs._assemble_archive

    def dropped(self, *a, **kw):
        real(self, *a, **kw)
        self.TOA_list.pop()
    monkeypatch.setattr(toas.GetTOAs, "_assemble_archive", dropped)


@pytest.mark.parametrize("fault", [_moved, _dropped])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run.run_cell(_cell(), SEED, 0.3, 0, CPU, time.perf_counter())
    assert out["attempted"] >= 4 and out["attempted"] % 4 == 0
    assert not out["correct"], out["checks"]
    assert out["failed"] >= out["attempted"] // 4


def test_tiny_run_reports_the_cells_metrics():
    out = run.run_cell(_cell(), SEED, 0.3, 1, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    # the readers of device operations and of spans find nothing on the
    # CPU; the program's own counts are there
    assert set(out["metrics"]) == {"newton_iters.fit", "load_share.pipe",
                                   "assemble_share.pipe", "i2_share.pipe",
                                   "card_prep_share.pipe"}
    assert out["metrics"]["i2_share.pipe"]["value"] == 100.0
    # a CPU fit prepares its archives on the host
    assert out["metrics"]["card_prep_share.pipe"]["value"] == 0.0
    assert 0 < out["metrics"]["load_share.pipe"]["value"] < 100


@pytest.mark.parametrize("fails", [False, True])
def test_a_call_runs_on_one_host_thread(fails, monkeypatch):
    """get_TOAs sees one torch thread; the count before the call comes
    back after it, also when the call raises."""
    seen = []

    def get_toas(self, *a, **kw):
        seen.append(torch.get_num_threads())
        if fails:
            raise RuntimeError("planted")
    monkeypatch.setattr(toas.GetTOAs, "get_TOAs", get_toas)
    c = _cell()
    entry = c.entry().Entry(c.config, c.mix, SEED, CPU, {})
    before = torch.get_num_threads()
    try:
        if fails:
            with pytest.raises(RuntimeError, match="planted"):
                entry.call(0, _plain)
        else:
            assert entry.call(0, _plain) == 0
    finally:
        entry.release()
    assert seen == [1]
    assert torch.get_num_threads() == before == 2


def test_reader_returns_the_generators_samples_bit_for_bit(files):
    pool = files["pool"]
    for ia, path in enumerate(files["npol1"]):
        a = read_psrfits(path)
        assert a.raw_i2.dtype == np.int16 and a.npol == 1
        assert np.array_equal(a.raw_i2[:, 0], pool.raw[ia].numpy())
        assert np.array_equal(a.raw_scl[:, 0].view(np.uint32),
                              pool.scl[ia].numpy().view(np.uint32))
        offs = a.data[:, 0] - a.raw_scl[:, 0, :, None] * a.raw_i2[:, 0]
        assert np.allclose(offs, pool.offs[ia].numpy()[..., None],
                           rtol=0, atol=1e-6)
        assert np.array_equal(a.freqs[0], pool.nu.numpy())
        assert np.array_equal(a.doppler_factors, pool.doppler[ia].numpy())
        assert a.DM == 30.0 and not a.dedispersed
        assert np.all(a.Ps == 0.003)
        assert [(e.days, e.secs + e.frac) for e in a.epochs] == \
            [pool.epoch(ia, s) for s in range(pool.nsub)]
        assert a.backend_delay == 2.5e-07 and a.telescope == "GBT"


@pytest.mark.parametrize("npol", [1, 4])
def test_int16_route_counts_the_subints_it_takes(files, npol):
    gt = toas.GetTOAs(files["npol%d" % npol], files["gmodel"], device="cpu",
                      dtype=torch.float32, quiet=True)
    gt.get_TOAs(quiet=True)
    t = gt.fit_timing
    assert t["fit_subints"] == len(gt.TOA_list) == 4
    assert t["i2_subints"] == (4 if npol == 1 else 0)
    assert t["card_prep_subints"] == 0
    ctx = types.SimpleNamespace(calls=[(0.0, 1.0, 4)], entry=types.
                                SimpleNamespace(answers=[dict(timing=t)]))
    assert _reader("i2_share.pipe").read(ctx) == (100.0 if npol == 1
                                                  else 0.0)


def _stats_on(monkeypatch, device=CPU):
    """get_TOAs' float32 fits on the CPU take the card's route for an
    archive's statistics, with the plain twin in the kernel's place."""
    monkeypatch.setattr(toas.load_stats, "stats_device",
                        lambda d, dt: device if dt == torch.float32 else None)


@pytest.mark.parametrize("npol", [1, 4])
def test_card_prep_counts_the_subints_it_prepares(files, npol, monkeypatch):
    host = toas.GetTOAs(files["npol%d" % npol], files["gmodel"],
                        device="cpu", dtype=torch.float32, quiet=True)
    host.get_TOAs(quiet=True)
    _stats_on(monkeypatch)
    gt = toas.GetTOAs(files["npol%d" % npol], files["gmodel"], device="cpu",
                      dtype=torch.float32, quiet=True)
    gt.get_TOAs(quiet=True)
    t = gt.fit_timing
    assert t["fit_subints"] == len(gt.TOA_list) == 4
    assert t["card_prep_subints"] == (4 if npol == 1 else 0)
    ctx = types.SimpleNamespace(calls=[(0.0, 1.0, 4)], entry=types.
                                SimpleNamespace(answers=[dict(timing=t)]))
    assert _reader("card_prep_share.pipe").read(ctx) == (
        100.0 if npol == 1 else 0.0)
    # the same lines within a hair of their errors: only nu_fit's S/N
    # weights move, and with them the frequency a TOA is given at
    for a, b in zip(gt.TOA_list, host.TOA_list):
        assert (a.archive, a.flags["subint"]) == (b.archive,
                                                  b.flags["subint"])
        assert abs(_toa_us(a, b.frequency) - _toa_us(b, b.frequency)) <= \
            1e-3 * b.TOA_error
        assert abs(a.DM - b.DM) <= 1e-3 * b.DM_error
        assert a.TOA_error == pytest.approx(b.TOA_error, rel=1e-3)


def _toa_us(t, nu):
    """TOA t [us from its MJD day's start] moved to nu [MHz] with its DM."""
    return (t.MJD.secs + t.MJD.frac + DCONST * t.DM *
            (nu ** -2.0 - t.frequency ** -2.0)) * 1e6 + \
        t.MJD.days * 86400e6


def test_card_prep_serves_a_subint_outside_the_batch(files, monkeypatch):
    """A subint with one live channel is fitted on its own from the
    baseline-removed cube, which the card's baselines make at that read."""
    real = toas.load_data

    def one_channel(*a, **kw):
        data = real(*a, **kw)
        data.ok_ichans[1] = data.ok_ichans[1][:1]
        data.weights[1, 1:] = 0.0
        return data
    monkeypatch.setattr(toas, "load_data", one_channel)
    runs = []
    for stats in (False, True):
        if stats:
            _stats_on(monkeypatch)
        gt = toas.GetTOAs(files["npol1"][:1], files["gmodel"], device="cpu",
                          dtype=torch.float32, quiet=True)
        gt.get_TOAs(quiet=True)
        runs.append(gt)
    host, card = runs
    assert card.fit_timing["card_prep_subints"] == 2
    assert card.fit_timing["batched_chunks"] == 1
    a, b = card.TOA_list[1], host.TOA_list[1]
    assert a.flags["subint"] == b.flags["subint"] == 1
    assert a.frequency == b.frequency
    assert abs(_toa_us(a, b.frequency) - _toa_us(b, b.frequency)) <= \
        1e-3 * b.TOA_error


def _load_spans(prof):
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(("pp:load.", "pp:toas.load"))),
                  key=lambda s: (s[1], -s[2]))


def test_load_spans_under_the_profiler_and_not_without(files, monkeypatch):
    gt = toas.GetTOAs(files["npol1"], files["gmodel"], device="cpu",
                      dtype=torch.float32, quiet=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.get_TOAs(quiet=True)
    spans = _load_spans(prof)
    loads = [s for s in spans if s[0] == "pp:toas.load"]
    assert len(loads) == 2
    for k, (_, s0, e0) in enumerate(loads):
        inner = [n for n, s, e in spans if s0 <= s and e <= e0 and
                 n != "pp:toas.load"]
        # one template evaluation a call: the second archive's hits
        assert inner == ["pp:load.read", "pp:load.prep"] + \
            (["pp:load.template"] if k == 0 else [])
    # with the statistics from the raw samples: pp:load.stats inside
    # pp:load.prep
    _stats_on(monkeypatch)
    gt = toas.GetTOAs(files["npol1"], files["gmodel"], device="cpu",
                      dtype=torch.float32, quiet=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.get_TOAs(quiet=True)
    spans = _load_spans(prof)
    stats = [s for s in spans if s[0] == "pp:load.stats"]
    preps = [s for s in spans if s[0] == "pp:load.prep"]
    assert len(stats) == len(preps) == 2
    assert all(p[1] <= s[1] and s[2] <= p[2] for s, p in zip(stats, preps))
    recorded = []

    def record(name):
        recorded.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(profiling, "_recorded", record)
    gt = toas.GetTOAs(files["npol1"], files["gmodel"], device="cpu",
                      dtype=torch.float32, quiet=True)
    gt.get_TOAs(quiet=True)
    assert recorded == [] and len(gt.TOA_list) == 4


def _reader(name):
    return run.load_file(os.path.join(run.HERE, "metrics", name + ".py"),
                         "pipe_reader_" + name.replace(".", "_"))


def _traced(spans, kernels=(("k", 1.0, 2.0),), calls=2):
    return types.SimpleNamespace(trace=Trace(list(kernels), spans, 0.0,
                                             5000.0, calls, 16 * calls))


SPANS = {"read_ms.pipe": "pp:load.read", "prep_ms.pipe": "pp:load.prep",
         "template_ms.pipe": "pp:load.template"}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_readers(name):
    # two calls: two reads of 100 us, two preps of 300 us and one
    # template of 250 us each
    spans = []
    for t0 in (0.0, 2000.0):
        spans += [("pp:toas.load", t0, t0 + 650), ("pp:load.read", t0,
                                                    t0 + 100),
                  ("pp:load.prep", t0 + 100, t0 + 400),
                  ("pp:load.template", t0 + 400, t0 + 650),
                  ("pp:toas.load", t0 + 700, t0 + 1100),
                  ("pp:load.read", t0 + 700, t0 + 800),
                  ("pp:load.prep", t0 + 800, t0 + 1100)]
    want = {"read_ms.pipe": 0.2, "prep_ms.pipe": 0.6,
            "template_ms.pipe": 0.25}[name]
    r = _reader(name)
    assert r.read(_traced(spans)) == pytest.approx(want)
    # nothing without device operations, a trace, or the program's range
    assert r.read(_traced(spans, kernels=())) is None
    assert r.read(types.SimpleNamespace(trace=None)) is None
    assert r.read(_traced([s for s in spans if s[0] != SPANS[name]])) is None


# the readers of a share of the fitted subints, and their counts
COUNTS = {"i2_share.pipe": "i2_subints",
          "card_prep_share.pipe": "card_prep_subints"}


@pytest.mark.parametrize("name,key", [("load_share.pipe", "load_s"),
                                      ("assemble_share.pipe", "assemble_s"),
                                      ("i2_share.pipe", None),
                                      ("card_prep_share.pipe", None)])
def test_timing_readers(name, key):
    # three window calls of 2 s, then a traced one the readers leave out
    calls = [(0.0, 2.0, 16), (2.0, 4.0, 16), (4.0, 6.0, 16)]
    timing = dict(load_s=1.5, assemble_s=0.06, fit_subints=16,
                  i2_subints=12, card_prep_subints=4)
    entry = types.SimpleNamespace(answers=[dict(timing=timing)] * 3 + [
        dict(timing=dict(timing, load_s=9.0, i2_subints=0,
                         card_prep_subints=0))])
    ctx = types.SimpleNamespace(calls=calls, entry=entry)
    want = 100.0 * timing[COUNTS[name]] / 16 if key is None else \
        100.0 * timing[key] / 2.0
    assert _reader(name).read(ctx) == pytest.approx(want)
    # a program whose fit_timing lacks the key reports nothing
    bare = {k: v for k, v in timing.items()
            if k != (key or COUNTS[name])}
    entry.answers = [dict(timing=bare)] * 3
    assert _reader(name).read(ctx) is None
