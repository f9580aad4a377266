"""The pipeline's template owner (pipelines/template.py) on the archives of
tests/test_torch_pipeline.py, float64 on the CPU.

- get_TOAs' fluxes against the JAX package's, with and without fit_scat,
  within 1e-6 relative (flux takes the template's channel means: the
  scattering kernel's DC term is 1, so fit_scat needs no scattered model).
- Archives that share a grid give one evaluation and one prepared
  template for the whole run.
- A period differing beyond 6 significant digits gives a second prepared
  template but no second evaluation of a template that does not depend
  on P; a scattered .gmodel at another period is evaluated again.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu_torch.io.archive import load_data  # noqa: E402
from pulseportraiture_tpu_torch.models.gmodel_io import \
    write_model  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import template, toas  # noqa: E402

from test_torch_pipeline import MODEL_PARAMS, ws  # noqa: E402,F401

torch.set_num_threads(2)


def _counting(monkeypatch, cls, name):
    """Count the calls of cls.name."""
    calls = []
    orig = getattr(cls, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)
    monkeypatch.setattr(cls, name, counted)
    return calls


def _fluxes_match_jax(ws, monkeypatch, fit_scat):
    want = JGetTOAs(ws["files"], ws["fits"], quiet=True)
    want.get_TOAs(quiet=True, fit_scat=fit_scat)
    got = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(quiet=True, fit_scat=fit_scat)
    g, w = np.concatenate(got.fluxes), np.concatenate(want.fluxes)
    assert len(g) == len(w) == 6 and np.all(g > 0)
    assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w)), (g, w)


def _shared_grid(ws, monkeypatch, _):
    evals = _counting(monkeypatch, template.ModelSource, "_eval")
    preps = _counting(monkeypatch, template.Templates, "_prepare")
    gt = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                      dtype=torch.float64, quiet=True)
    gt.get_TOAs(quiet=True)
    assert len(gt.TOA_list) == 6
    assert len(evals) == len(preps) == 1


def _archive(ws):
    return load_data(ws["files"][0], dedisperse=False, dededisperse=True,
                     pscrunch=True, rm_baseline=True, quiet=True)


def _period(ws, monkeypatch, _):
    """Within 6 significant digits the template is shared and restore
    takes the mismatch out; beyond them a second one is prepared from
    the same evaluation."""
    data = _archive(ws)
    src = template.ModelSource(ws["fits"])
    evals = _counting(monkeypatch, src, "_eval")
    tm = template.Templates(src, torch.float64)
    P0 = float(data.Ps[0])
    data.Ps[1] = P0 * (1 + 1e-9)
    a, b = tm.get(data, 0, data.DM), tm.get(data, 1, data.DM)
    assert a is b and len(evals) == 1
    phi, DM = a.restore(0.0, 0.0, a.nu_anchor, float(data.Ps[1]))
    assert phi == 0.0 and DM == data.DM * (float(data.Ps[1]) / P0)
    data.Ps[1] = P0 * (1 + 1e-4)
    c = tm.get(data, 1, data.DM)
    assert c is not a and c.P_model == float(data.Ps[1])
    assert len(evals) == 1 and tm.mharms == [0]


def _scattered_gmodel(ws, monkeypatch, _):
    """Only a scattered Gaussian model depends on P, and not when its
    scattering is zeroed for fit_scat."""
    path = str(ws["path"] / "scattered.gmodel")
    params = list(MODEL_PARAMS)
    params[1] = 2e-5                                   # tau [s]
    write_model(path, "TEST", "000", 1500.0, params, [1] * len(params),
                -4.0, 0, quiet=True)
    data = _archive(ws)
    P0 = float(data.Ps[0])
    data.Ps[1] = P0 * (1 + 1e-4)
    for unscat, n_evals in ((False, 2), (True, 1)):
        src = template.ModelSource(path)
        evals = _counting(monkeypatch, src, "_eval")
        tm = template.Templates(src, torch.float64, unscat=unscat)
        assert tm.get(data, 0, data.DM) is not tm.get(data, 1, data.DM)
        assert len(evals) == n_evals, unscat


CASES = {"fluxes": (_fluxes_match_jax, False),
         "fluxes_fit_scat": (_fluxes_match_jax, True),
         "shared_grid": (_shared_grid, None),
         "period_beyond_6_digits": (_period, None),
         "scattered_gmodel_period": (_scattered_gmodel, None)}


@pytest.mark.parametrize("case", list(CASES))
def test_template_owner(ws, monkeypatch, case):
    check, arg = CASES[case]
    check(ws, monkeypatch, arg)
