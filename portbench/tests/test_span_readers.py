"""The readers of the program's spans (metrics/*.py with source
"program_span") on hand-built traces: each value from known ranges,
launch records and kernels, and nothing where the device ran no
operation (as on the CPU) or the program recorded no range (a program
without the spans)."""

import os
import types

import pytest

from portbench import run
from portbench.trace import Trace

READERS = ("pre_newton_ms.fit", "newton_iter_ms.fit", "solve_launches.fit",
           "fgh_launches.fit", "post_newton_ms.fit")


def reader(name):
    return run.load_file(os.path.join(run.HERE, "metrics", name + ".py"),
                         "span_reader_" + name.replace(".", "_"))


def launches(t0, n, kind="cudaLaunchKernel"):
    """n launch records from t0 [us], one a microsecond."""
    return [(kind, t0 + k, t0 + k + 0.5) for k in range(n)]


def one_call(t0):
    """The host ranges of one fit of two Newton iterations from t0 [us]:
    setup 0-100, seed 100-150, the loop 150-650 (a first objective, then
    two iterations, each an objective between two solves), nu_zeros
    650-700, finalize 700-760, pack 760-770, unpack 780-800; runtime
    launch records inside each; an aten operator around some."""
    r = [("pp:fit.setup", 0, 100), ("pp:fit.seed", 100, 150),
         ("pp:fit.newton", 150, 650), ("pp:newton.fgh", 155, 195)]
    r += launches(160, 10)
    for k in range(2):
        a = 200 + 220 * k
        r += [("pp:newton.iter", a, a + 200),
              ("pp:newton.solve", a, a + 50), ("aten::linalg_eigh", a, a + 9),
              ("pp:newton.fgh", a + 60, a + 100),
              ("pp:newton.solve", a + 110, a + 160)]
        r += launches(a + 1, 30) + launches(a + 111, 28, "cuLaunchKernel") + \
            launches(a + 139, 2, "cudaLaunchKernelExC")
        r += launches(a + 61, 12) + launches(a + 101, 5)
    r += [("pp:fit.nu_zeros", 650, 700), ("pp:fit.finalize", 700, 760),
          ("pp:fit.pack", 760, 770), ("pp:fit.unpack", 780, 800),
          ("cudaMemcpyAsync", 781, 790), ("cudaStreamSynchronize", 790, 799)]
    r += launches(10, 3)
    return [(n, t0 + s, t0 + e) for n, s, e in r]


def ctx(spans, kernels=(("k", 1.0, 2.0),), calls=2):
    t = Trace(list(kernels), spans, 0.0, 2000.0, calls, 4 * calls)
    return types.SimpleNamespace(trace=t)


def test_readers_read_the_spans():
    c = ctx(one_call(0.0) + one_call(1000.0))
    got = {n: reader(n).read(c) for n in READERS}
    assert got == {
        # (100 + 50) us a call
        "pre_newton_ms.fit": pytest.approx(0.15),
        # 4 iterations of 200 us
        "newton_iter_ms.fit": pytest.approx(0.2),
        # (30 + 30) launches a solve pair, half a solve
        "solve_launches.fit": pytest.approx(30.0),
        # 10 + 12 + 12 launches in three objectives a call
        "fgh_launches.fit": pytest.approx(34.0 / 3.0),
        # 50 + 60 + 10 + 20 us a call
        "post_newton_ms.fit": pytest.approx(0.14)}


def test_ranges_outside_the_window_are_left_out():
    c = ctx(one_call(0.0) + one_call(1000.0) + one_call(5000.0))
    assert reader("pre_newton_ms.fit").read(c) == pytest.approx(0.15)
    assert reader("solve_launches.fit").read(c) == pytest.approx(30.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_device_operations(name):
    assert reader(name).read(ctx(one_call(0.0), kernels=())) is None
    assert reader(name).read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_programs_spans(name):
    bare = [s for s in one_call(0.0) if not s[0].startswith("pp:")]
    assert reader(name).read(ctx(bare)) is None
