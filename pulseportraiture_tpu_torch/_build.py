"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded
with ctypes: no PyTorch headers, so a build takes seconds.  The library
lands in <checkout>/build/pp_kernels/, named by a hash of the sources,
headers and flags, at first use; a later process reuses it.  Nothing is
imported or built while a module is imported.

Flags: sm_90a (Hopper), -O3, and no --use_fast_math: the moments kernels
rely on precise sincosf, IEEE division and rounding (csrc/phase_trig.cuh).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = ("setup_epilogue.cu", "setup_fft.cu", "moments.cu",
            "scat_moments.cu", "moments_merged.cu", "tr_solve.cu",
            "load_stats.cu")
_HEADERS = ("phase_trig.cuh", "fft_passes.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_DIR = _PKG.parent / "build" / "pp_kernels"

_lib = None
_lock = threading.Lock()
build_info = {"seconds": 0.0, "cached": None, "log": ""}


def _nvcc():
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pp_phase_moments.argtypes = [vp, vp, vp, vp, i64, i32, vp]
    lib.pp_phase_moments.restype = i32
    lib.pp_phase_moments_merged.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.pp_phase_moments_merged.restype = i32
    lib.pp_setup_epilogue.argtypes = [vp, i32, vp, vp, vp, vp, i32, vp, vp,
                                      vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, i32, i32, i32, i32, i32, vp]
    lib.pp_setup_epilogue.restype = i32
    lib.pp_setup_epilogue_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.pp_setup_epilogue_blocks_per_sm.restype = i32
    lib.pp_fused_setup_fft.argtypes = [vp, i32, vp, i32, vp, vp, vp, vp, i32,
                                       vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                       i32, i32, i32, vp]
    lib.pp_fused_setup_fft.restype = i32
    lib.pp_scat_moments.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32,
                                    i32, i32, i64, vp]
    lib.pp_scat_moments.restype = i32
    lib.pp_tr_solve.argtypes = [vp, i64, i64, vp, i64, i64, i64, vp, i64, vp,
                                vp, i64, i32, i32, i32, vp]
    lib.pp_tr_solve.restype = i32
    lib.pp_load_stats.argtypes = [vp, vp, vp, i32, vp, i64, i32, i32, vp]
    lib.pp_load_stats.restype = i32
    lib.pp_error_string.argtypes = [i32]
    lib.pp_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels():
    """The loaded kernel library, building it first if needed (once, when
    the shards of a sharded fit ask for it from several threads)."""
    if _lib is not None:
        return _lib
    with _lock:
        return _lib if _lib is not None else _load()


def _load():
    global _lib
    csrc = _PKG / "csrc"
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    out = BUILD_DIR / f"libpp_kernels_{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    if out.exists():
        build_info["cached"] = True
        build_info["log"] = log.read_text() if log.exists() else ""
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *_FLAGS, "-c", "-o", str(o),
                              str(csrc / s)]
                             for s, o in zip(_SOURCES, objs))]
        logs, failed = [], []
        for cmd, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + logs[-1])
        tmp = out.with_name(f"{out.name}.{tag}")
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + logs[-1])
        for o in objs:
            o.unlink(missing_ok=True)
        build_info["log"] = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        log.write_text(build_info["log"])
        os.replace(tmp, out)
        build_info["cached"] = False
    _lib = _declare(ctypes.CDLL(str(out)))
    build_info["seconds"] = time.perf_counter() - t0
    return _lib
