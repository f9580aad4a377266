"""The port's profiling hooks on the CPU: a torch.profiler trace written
as a Chrome trace that names an annotate() range, the directory rule
(the argument, then PP_TRACE_DIR, else nothing), and timed()'s results,
with the JAX package's timed() semantics (label, seconds, the printed
line)."""

import glob
import json
import os

import pytest
import torch

from pulseportraiture_tpu_torch import profiling

torch.set_num_threads(2)


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "pp_trace_*.json")))


def test_trace_names_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path)) as where:
        assert where == str(tmp_path)
        with profiling.annotate("pp_test_range"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    (path,) = _traces(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "pp_test_range" in names
    assert any(n and "mm" in n for n in names)


def test_trace_directory_precedence(tmp_path, monkeypatch):
    env, arg = tmp_path / "env", tmp_path / "arg"
    monkeypatch.setenv("PP_TRACE_DIR", str(env))
    with profiling.trace(str(arg)) as where:
        torch.ones(3).sum()
    assert where == str(arg) and len(_traces(arg)) == 1
    assert not env.exists()
    with profiling.trace() as where:
        torch.ones(3).sum()
    assert where == str(env) and len(_traces(env)) == 1


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("PP_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as where:
        torch.ones(3).sum()
    assert where is None
    assert os.listdir(tmp_path) == []


def test_timed_results(capsys):
    from pulseportraiture_tpu.profiling import timed as jtimed
    out = {}
    for name, timed in (("port", profiling.timed), ("jax", jtimed)):
        results = []
        with timed("section", results=results):
            sum(range(1000))
        with timed("quiet", quiet=True, results=results):
            pass
        out[name] = (results, capsys.readouterr().out)
    for results, printed in out.values():
        assert [r[0] for r in results] == ["section", "quiet"]
        assert all(r[1] >= 0.0 for r in results)
        assert printed.startswith("[pp] section: ") and printed.endswith(
            " s\n") and "quiet" not in printed
    with pytest.raises(ZeroDivisionError):
        with profiling.timed("raises", quiet=True, results=[]):
            1 / 0
