"""Profiling and tracing hooks.

Port of the JAX package's profiling module.  The reference only stamps
wall-clock durations per fit (pplib.py:2084, pptoaslib.py:1011); every
fitter here records the same `duration` and `nfeval` bookkeeping, and
this module adds the device layer: a torch.profiler trace of the host and
the card (CUPTI records the ctypes-launched hand kernels as it records
torch's own), written as a Chrome/Perfetto trace, plus a section timer.
The batched fit and get_TOAs mark their phases with `annotate` ("pp:"
ranges, README's profiling section), which records only while a
profiler does.

Usage:
    from pulseportraiture_tpu_torch.profiling import annotate, timed, trace

    with trace("/tmp/pp_trace"):          # or PP_TRACE_DIR=/tmp/pp_trace
        with annotate("get_TOAs"):
            gt.get_TOAs(...)

    with timed("model build"):
        dp.make_spline_model()
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir=None, create_perfetto_link=False):
    """torch.profiler trace of the host and the visible cards, written on
    exit as <log_dir>/pp_trace_<pid>_<ms>.json (open it in Perfetto or
    chrome://tracing); yields the directory.  A no-op yielding None when
    no directory is given.  Directory precedence: the argument, then the
    PP_TRACE_DIR environment variable.  create_perfetto_link is accepted
    for the JAX signature and does nothing.
    """
    log_dir = log_dir or os.environ.get("PP_TRACE_DIR")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        _sync_cuda()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"pp_trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def _sync_cuda():
    """Wait for the work queued on every card in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def timed(label, quiet=False, results=None):
    """Wall-clock section timer; appends (label, seconds) to `results`.
    The cards in use are synchronized before the clock is read at both
    ends, so the section's device work is timed, not only its launches."""
    _sync_cuda()
    t0 = time.time()
    try:
        yield
    finally:
        _sync_cuda()
        dt = time.time() - t0
        if results is not None:
            results.append((label, dt))
        if not quiet:
            print(f"[pp] {label}: {dt:.3f} s")


_OFF = contextlib.nullcontext()


def annotate(name):
    """A named range in a trace while a torch profiler records on this
    thread: torch.profiler.record_function, and an NVTX range where a
    card is visible.  Otherwise the one shared null context, so a span
    left in a hot loop costs a check, and nothing reaches NVTX."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
