#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (imports, the CUDA context, the kernel library, the data
made from the seed, the warm-up calls) is timed as setup_s; then calls
run back to back, one caller, until --seconds have passed.  --trace 1
then profiles the cell's trace_calls calls more and prints the per-layer
metrics, the device's busy time and a breakdown.  Every answer is held
against the plain reference once the window has closed; the numbers
compared are printed with their limits as the last lines of standard
error and under "checks", the last key of the result line, which is the
last line of standard output.  Exits 2 without the cards.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "pulseportraiture_tpu")


def load_file(path, name):
    """A module from a file found by name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """What BENCHMARK.json and the cell's files say of one cell."""

    def __init__(self, name):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.spec = name, cells[name]
        cfg = {c["name"]: c for c in self.bench["configs"]}[
            self.spec["config"]]
        with open(os.path.join(ROOT, cfg["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, "traffic",
                               self.spec["traffic"] + ".json")) as f:
            self.mix = json.load(f)
        with open(os.path.join(HERE, "workloads", name + ".json")) as f:
            self.limits = json.load(f)["limits"]

    def metrics(self, kind):
        """The metrics of BENCHMARK.json's kind ("end_to_end" or
        "per_layer") that this cell reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def entry(self):
        return load_file(os.path.join(HERE, "entries",
                                      self.mix["entry"] + ".py"),
                         "portbench_entry_" + self.mix["entry"])

    def reader(self, metric):
        return load_file(os.path.join(HERE, "metrics",
                                      metric + ".py"),
                         "portbench_metric_" + metric.replace(".", "_"))


class Context:
    """What a metric reader reads: the cell, the window's calls
    [(start s, end s, items)], set-up, the entry (its shapes and
    counters) and, with --trace 1, the Trace of the profiled calls."""

    def __init__(self, cell, entry, calls, setup_s, trace):
        self.cell, self.entry, self.calls = cell, entry, calls
        self.setup_s, self.trace = setup_s, trace
        self.window_s = calls[-1][1] - calls[0][0]
        self.items = sum(c[2] for c in calls)


def card(device):
    """name, power limit [W] of the card."""
    import torch
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        limit = None
    return name, limit


def run_cell(cell, seed, seconds, trace, device, t0):
    """Runs the cell (a Cell); returns the result line's object."""
    import torch
    split = {}
    Entry = cell.entry().Entry
    import pulseportraiture_tpu_torch  # noqa: F401  (timed as "import")
    split["import"] = time.perf_counter() - t0
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    split["context"] = time.perf_counter() - t
    entry = Entry(cell.config, cell.mix, seed, device, split)
    t = time.perf_counter()
    def plain(_):
        return contextlib.nullcontext()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    for i in range(cell.mix["warm_calls"]):
        entry.call(i, plain)
    sync()
    split["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    calls, i = [], 0
    start = time.perf_counter()
    while True:
        s = time.perf_counter()
        n = entry.call(i, plain)
        e = time.perf_counter()
        calls.append((s, e, n))
        entry.keep()
        i += 1
        if e - start >= seconds:
            break
    tr = None
    if trace:
        tr = profile(entry, i, cell.mix["trace_calls"], sync)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    attempted, failed, worst = entry.check(cell.limits)
    check_s = time.perf_counter() - t
    ctx = Context(cell, entry, calls, setup_s, tr)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kind, limit = card(device) if device.type == "cuda" else ("cpu", None)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak),
           "power_limit_w": limit}
    out = {"correct": bool(attempted > 0 and failed == 0),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_kernels(10),
                            "idle_gaps": tr.idle_gaps(10)}
    ms = sorted((e - s) * 1e3 for s, e, _ in calls)
    out["call_ms"] = {"calls": len(ms), "min": ms[0],
                      "median": ms[len(ms) // 2], "max": ms[-1]}
    out["setup_split_s"] = split
    out["check_s"] = check_s
    out["checks"] = {n: {"value": v, "limit": cell.limits[n]}
                     for n, v in worst.items()}
    return out


def profile(entry, i, n, sync):
    """Trace of n more calls under torch.profiler (CPU and CUDA)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from torch.profiler import record_function

    from portbench.trace import Trace
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function("pb:traced_window"):
            for k in range(n):
                with record_function("pb:call"):
                    entry.call(i + k, record_function)
                entry.keep()
            sync()
    win = [e for e in prof.events() if e.name == "pb:traced_window"][0]
    return Trace.from_profile(prof, win.time_range.start,
                              win.time_range.end, n,
                              n * entry.mix["batch"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = Cell(args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0), T0)
    bad = [m for m in sys.modules
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    if bad:
        print(f"portbench: imported {sorted(bad)[:5]}", file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
