"""The timed path broken underneath a tiny run on the CPU: `correct` has
to come out false for each fault a fit cell can have.  (One card: there
is no exchange between cards to leave out.)"""

import pytest
import torch

from pulseportraiture_tpu_torch.fitters import newton, portrait
from portbench.tests import tiny

PACKED = portrait.fit_portrait_full_batch_packed


def state_unchanged(monkeypatch):
    """Every Newton step returns its state unchanged: the fit stops at
    its seed."""
    real = newton.trust_region_minimize

    def stuck(fgh, x0, **kw):
        kw["max_iter"] = 0
        return real(fgh, x0, **kw)
    monkeypatch.setattr(newton, "trust_region_minimize", stuck)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean of the rest in its place."""
    def half(x, mft, init, Ps, freqs, errs, scales=None, nu_fits=None,
             **kw):
        h = x.shape[0] // 2
        got = PACKED(x[:h], mft, init[:h], Ps[:h], freqs[:h], errs[:h],
                     scales=scales[:h], nu_fits=nu_fits[:h], **kw)
        return torch.cat([got, got.mean(0, keepdim=True).expand(
            x.shape[0] - h, -1)])
    monkeypatch.setattr(portrait, "fit_portrait_full_batch_packed", half)


def answer_altered(monkeypatch):
    """One answer a call altered where it is produced: the first item's
    phase moved by its own sigma."""
    def altered(*a, **kw):
        out = PACKED(*a, **kw).clone()
        out[0, 0] += out[0, 5]
        return out
    monkeypatch.setattr(portrait, "fit_portrait_full_batch_packed", altered)


@pytest.mark.parametrize("name", sorted(tiny.SIZES))
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run_cell(name)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
