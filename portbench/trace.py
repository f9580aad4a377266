"""Reading a torch.profiler trace: kernel intervals, busy time, idle gaps.

The busy union and the kernel classes follow the port's own profiling
script (scripts/torch_profile_fit.py); this copy is the benchmark's, so a
change to the program cannot move the yardstick.
"""

import bisect
import re

# a kernel's name in the breakdown, cut after its template's first part
NAME_CHARS = 160


def union_s(intervals):
    """Total length [s] of a union of (start, end) intervals in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


class Trace:
    """The device kernels and host spans of one profiled window.

    kernels: [(name, start_us, end_us)] of every operation that ran on
    the device; spans: [(name, start_us, end_us, depth)] of the host's
    record_function ranges and operators; t0_us, t1_us: the window."""

    def __init__(self, kernels, spans, t0_us, t1_us, calls, items):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.spans = spans
        self.t0_us, self.t1_us = t0_us, t1_us
        self.calls, self.items = calls, items

    @classmethod
    def from_profile(cls, prof, t0_us, t1_us, calls, items):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        kernels, spans = [], []
        for e in prof.events():
            iv = (e.time_range.start, e.time_range.end)
            if e.device_type != cuda:
                spans.append((e.name, *iv))
            elif not (getattr(e, "is_user_annotation", False) or
                      e.name.startswith("pb:")):
                # the device's own operations; a range a host span casts
                # on the device's timeline is not one
                kernels.append((e.name, *iv))
        return cls(kernels, spans, t0_us, t1_us, calls, items)

    @property
    def window_s(self):
        return (self.t1_us - self.t0_us) / 1e6

    def busy_s(self):
        """Seconds in which an operation ran on the device."""
        return union_s([(s, e) for _, s, e in self.kernels])

    def matching(self, pattern):
        """[(name, start, end)] of the kernels whose name matches."""
        return [k for k in self.kernels if re.search(pattern, k[0])]

    def top_kernels(self, n=10):
        """[[name, seconds]] of the n kernels that took most time."""
        by = {}
        for name, s, e in self.kernels:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n=10):
        """[[host activity, seconds]]: the device's idle time inside the
        window, cut where a benchmark span ("pb:") begins or ends, each
        piece named by the innermost benchmark span and the outermost
        operator the host was in when the piece began, summed by that
        name; the n largest."""
        gaps, cur = [], self.t0_us
        for _, s, e in self.kernels:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1_us > cur:
            gaps.append((cur, self.t1_us))
        # by start, the outer of two that start together first: the last
        # that holds a time is the innermost
        bench = sorted(((s, e, name) for name, s, e in self.spans
                        if name.startswith("pb:")),
                       key=lambda b: (b[0], -b[1]))
        cuts = sorted({t for s, e, _ in bench for t in (s, e)})
        outer, end = [], float("-inf")
        for s, e, name in sorted((s, -e, name) for name, s, e in self.spans
                                 if not name.startswith("pb:")):
            if s >= end:
                outer.append((s, -e, name))
                end = -e
        starts = [o[0] for o in outer]
        by = {}
        for g0, g1 in gaps:
            inside = cuts[bisect.bisect_right(cuts, g0):
                          bisect.bisect_left(cuts, g1)]
            for p0, p1 in zip([g0, *inside], [*inside, g1]):
                inner = [b for b in bench if b[0] <= p0 < b[1]]
                i = bisect.bisect_right(starts, p0) - 1
                op = outer[i][2] if i >= 0 and p0 < outer[i][1] else "idle"
                name = (inner[-1][2] if inner else "pb:outside") + "/" + op
                by[name] = by.get(name, 0.0) + (p1 - p0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
