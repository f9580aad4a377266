"""The port's pptoas and ppzap under --x64 against the JAX tools' --x64.

--x64 is the JAX tools' float64 parity mode; the port's tools take it
with --device cpu (the card's kernels take float32 only, so --x64 with
--device cuda stops at argument parsing).  On an archive of
tests/test_torch_pipeline.py (2 subints, 32 channels x 256 bins, int16,
its FITS template) and the noisy archive of tests/test_torch_zap.py:
the TOAs pptoas writes agree with the JAX tool's within the pipeline
parity bounds (1 ns; DM, its error and the TOA error within 1e-6 of the
formal error), the port's float32 run does not, and ppzap gives the JAX
tool's zap list and paz commands.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.cli import ppzap as jppzap  # noqa: E402
from pulseportraiture_tpu.cli import pptoas as jpptoas  # noqa: E402
from pulseportraiture_tpu.io import tim as jtim  # noqa: E402
from pulseportraiture_tpu_torch.cli import ppzap, pptoas  # noqa: E402
from pulseportraiture_tpu_torch.io import tim  # noqa: E402
from pulseportraiture_tpu_torch.io.psrfits import read_psrfits  # noqa: E402

from test_torch_pipeline import ws  # noqa: E402,F401
from test_torch_zap import RFI, noisy  # noqa: E402,F401
from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)


def _written(module, monkeypatch, main, argv):
    """The TOA objects main(argv) hands to module.write_TOAs."""
    seen, orig = [], module.write_TOAs

    def record(toas, *a, **kw):
        seen.extend(toas)
        return orig(toas, *a, **kw)

    monkeypatch.setattr(module, "write_TOAs", record)
    assert main(argv) == 0
    monkeypatch.setattr(module, "write_TOAs", orig)
    return seen


def _worst(got, want):
    """The largest TOA difference [s] and the largest DM, DM error and TOA
    error differences in units of the formal errors; the frequencies
    agree within 1e-6 of theirs."""
    assert [t.archive for t in got] == [t.archive for t in want]
    for a, b in zip(got, want):
        assert abs(a.frequency - b.frequency) < 1e-6 * b.frequency
    return (max(abs(mjd_diff_s(a.MJD, b.MJD)) for a, b in zip(got, want)),
            max(max(abs(a.DM - b.DM), abs(a.DM_error - b.DM_error)) /
                b.DM_error for a, b in zip(got, want)),
            max(abs(a.TOA_error - b.TOA_error) / b.TOA_error
                for a, b in zip(got, want)))


@pytest.fixture(scope="module")
def jax_toas(ws):  # noqa: F811
    """The JAX pptoas --x64 run: (its TOAs, its .tim lines)."""
    out = str(ws["path"] / "x64-jax.tim")
    mp = pytest.MonkeyPatch()
    try:
        toas = _written(jtim, mp, jpptoas.main,
                        ["-d", *ws["files"][:1], "-m", ws["fits"], "-o", out,
                         "--x64", "--quiet"])
    finally:
        mp.undo()
    with open(out) as f:
        return toas, f.read().splitlines()


@pytest.mark.parametrize("x64", [True, False])
def test_pptoas_x64_matches_jax(ws, jax_toas, x64, monkeypatch):  # noqa: F811
    """--x64 writes the JAX tool's TOAs within 1 ns and 1e-6 sigma; the
    float32 run (no --x64) lies outside those bounds."""
    want, jlines = jax_toas
    out = str(ws["path"] / f"x64-port-{x64}.tim")
    got = _written(tim, monkeypatch, pptoas.main,
                   ["-d", *ws["files"][:1], "-m", ws["fits"], "-o", out,
                    "--device", "cpu", "--quiet"] + (["--x64"] if x64 else
                                                      []))
    assert len(got) == len(want) == 2
    with open(out) as f:
        lines = f.read().splitlines()
    assert [ln.split()[0] for ln in lines] == [ln.split()[0]
                                               for ln in jlines]
    dt, ddm, derr = _worst(got, want)
    inside = dt < 1e-9 and ddm <= 1e-6 and derr <= 1e-6
    assert inside == x64, (dt, ddm, derr)


@pytest.mark.parametrize("tool", [pptoas, ppzap])
def test_x64_on_the_card_is_refused(ws, tool, capsys):  # noqa: F811
    """--x64 with --device cuda (the default) stops at argument parsing,
    naming --device cpu, before any file is read or any fit runs."""
    argv = ["-d", ws["files"][0], "-m", ws["fits"], "--x64"]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as e:
            tool.main(argv + extra)
        assert e.value.code != 0
        assert "--device cpu" in capsys.readouterr().err


def test_ppzap_x64_matches_jax(ws, noisy, capsys):  # noqa: F811
    """ppzap -m ... --x64: the JAX tool's zapped weights and paz lines."""
    common = ["-d", noisy, "-m", ws["fits"], "--quiet", "--x64"]
    a = str(ws["path"] / "x64-zap-port.fits")
    b = str(ws["path"] / "x64-zap-jax.fits")
    assert ppzap.main(common + ["-o", a, "--device", "cpu"]) == 0
    assert jppzap.main(common + ["-o", b]) == 0
    wa, wb = read_psrfits(a).weights, read_psrfits(b).weights
    assert np.array_equal(wa, wb)
    assert not wa[:, RFI].any()
    capsys.readouterr()
    assert ppzap.main(common + ["--print_cmds", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert jppzap.main(common + ["--print_cmds"]) == 0
    assert lines == capsys.readouterr().out.splitlines()
    assert len(lines) >= len(RFI)
