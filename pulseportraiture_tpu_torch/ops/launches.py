"""Launch bookkeeping of the hand-written kernels: the stream a launch
goes to, and the launch counts.

The ctypes entries launch into the current device's context, so each
wrapper makes its tensors' device current and passes that device's
current stream (stream()).  Each kernel wrapper (ops.setup_dft.fused_setup,
ops.moments.phase_moments, scattering_moments, phase_moments_merged)
keeps its count in the function's `launches` attribute and adds one
through counted() where it launches its kernel, and nowhere else.  The
sharded fits (parallel.mesh) run batch shards in threads: the counts are
taken under a lock, and a tally() scope also counts the launches of one
shard (mesh.launches).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import threading

_lock = threading.Lock()
_tally = contextvars.ContextVar("pp_launch_tally", default=None)


def stream(device):
    """The current stream of `device`, as the ctypes entries take it."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def counted(fn, route=None):
    """One launch of fn's kernel: fn.launches, fn.routes[route] when a
    route is named, and the tally in scope (a dict by fn.__name__)."""
    with _lock:
        fn.launches += 1
        if route is not None:
            fn.routes[route] += 1
        tally_dict = _tally.get()
        if tally_dict is not None:
            tally_dict[fn.__name__] = tally_dict.get(fn.__name__, 0) + 1


@contextlib.contextmanager
def tally(into):
    """Count the launches made in this scope (this thread or task) into
    the dict `into` as well; None counts nowhere else."""
    token = _tally.set(into)
    try:
        yield into
    finally:
        _tally.reset(token)
