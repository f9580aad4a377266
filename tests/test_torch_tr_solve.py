"""The Newton loop's trust-region subproblem on the CPU (ops.tr_solve).

CPU tensors take the plain twin, tr_solve_reference, which is the
arithmetic the loop has always had: the same bits through the wrapper
and through newton._tr_solve, and no kernel launch counted.  The
wrapper's checks of what the kernel takes run before any launch, so
they are held here on CPU tensors; the kernel itself is held against
the twin on the card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu_torch.fitters import newton
from pulseportraiture_tpu_torch.ops import tr_solve as trs

from test_torch_kernels import TR_KINDS, _tr_batch


def _inputs(n, dtype, seed=3):
    g, H, r, _, _ = _tr_batch(np.random.default_rng(seed), n, 2 * len(
        TR_KINDS))
    return [torch.as_tensor(a, dtype=dtype) for a in (g, H, r)]


@pytest.mark.parametrize("hard_case", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_wrapper_takes_the_twin_on_the_cpu(n, dtype, hard_case):
    t = _inputs(n, dtype)
    n0 = trs.tr_solve.launches
    p, hit = trs.tr_solve(*t, hard_case=hard_case)
    want, want_hit = trs.tr_solve_reference(*t, hard_case=hard_case)
    assert trs.tr_solve.launches == n0
    assert p.dtype == dtype and torch.equal(p, want)
    assert torch.equal(hit, want_hit)


@pytest.mark.parametrize("hard_case", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_tr_solve_is_the_twin(dtype, hard_case):
    t = _inputs(5, dtype, seed=4)
    p, hit = newton._tr_solve(*t, hard_case=hard_case)
    want, want_hit = trs.tr_solve_reference(*t, hard_case=hard_case)
    assert torch.equal(p, want) and torch.equal(hit, want_hit)


def test_twin_batches_over_leading_axes():
    """Leading axes (2, 3) give the bits of the flat batch of 6."""
    g, H, r = _inputs(5, torch.float64, seed=5)
    g, H, r = g[:6], H[:6], r[:6]
    p, hit = trs.tr_solve(g.view(2, 3, 5), H.view(2, 3, 5, 5), r.view(2, 3))
    want, want_hit = trs.tr_solve(g, H, r)
    assert torch.equal(p.view(6, 5), want)
    assert torch.equal(hit.view(6), want_hit)


def _bad(case):
    g = torch.zeros((4, 5))
    H = torch.zeros((4, 5, 5))
    r = torch.ones(4)
    if case == "n=9":
        return torch.zeros((4, 9)), torch.zeros((4, 9, 9)), r
    if case == "n=0":
        return torch.zeros((4, 0)), torch.zeros((4, 0, 0)), r
    if case == "float16":
        return g.half(), H.half(), r.half()
    if case == "mixed dtypes":
        return g, H.double(), r
    if case == "H shape":
        return g, H[:, :4], r
    if case == "radius shape":
        return g, H, r[:3]
    if case == "axes that are no view":
        return (torch.zeros((2, 4, 5)).transpose(0, 1),
                torch.zeros((4, 2, 5, 5)), torch.ones((4, 2)))
    raise AssertionError(case)


@pytest.mark.parametrize("case,exc", [
    ("n=9", ValueError), ("n=0", ValueError), ("float16", TypeError),
    ("mixed dtypes", TypeError), ("H shape", ValueError),
    ("radius shape", ValueError), ("axes that are no view", ValueError)])
def test_kernel_checks_refuse_before_any_launch(case, exc):
    """The kernel path's checks (ops.tr_solve._launch), run on CPU
    tensors: each refusal comes before the library is loaded or a launch
    counted."""
    n0 = trs.tr_solve.launches
    with pytest.raises(exc):
        trs._launch(*_bad(case), False)
    assert trs.tr_solve.launches == n0
