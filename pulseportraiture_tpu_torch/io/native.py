"""ctypes binding for the native I/O core (native/ppio.cpp).

Loads native/libppio.so if present (``make -C native``); every entry
point has a NumPy fallback so the package works without the build step.
The native path multithreads the FITS column deinterleave/byteswap and
the 16-bit dequantize/quantize — the data-loader work that sits at the
reference's PSRCHIVE/cfitsio C++ boundary (SURVEY.md section 2).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cands = [os.path.join(here, "native", "libppio.so"),
             os.environ.get("PPIO_LIB", "")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    # build on first use when the source tree is present (a fresh
    # checkout otherwise silently runs the slow NumPy fallback; the
    # build is one g++ invocation, ~2 s).  PP_NATIVE_BUILD=0 disables.
    src = os.path.join(here, "native", "ppio.cpp")
    if os.path.exists(src) and \
            os.environ.get("PP_NATIVE_BUILD", "1") not in ("0", "false"):
        import subprocess
        try:
            subprocess.run(["make", "-C", os.path.join(here, "native")],
                           capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        c = os.path.join(here, "native", "libppio.so")
        if os.path.exists(c):
            return c
    return None


def get_lib():
    """The loaded CDLL, or None when the native library is unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64, i32 = ctypes.c_int64, ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.pp_col_extract.argtypes = [u8p, i64, i64, i64, i64, i32, u8p]
    lib.pp_col_insert.argtypes = [u8p, i64, i64, i64, i64, i32, u8p]
    lib.pp_dequantize_i2.argtypes = [i16p, f32p, f32p, i64, i64, f32p]
    lib.pp_quantize_i2.argtypes = [f32p, i64, i64, i16p, f32p, f32p]
    _LIB = lib
    return _LIB


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def col_extract(rows, col_off, nbytes, elem_size):
    """Extract+byteswap one column from (nrow, row_bytes) u1 rows.

    Returns a (nrow, nbytes) native-endian u1 array (caller views/casts).
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    nrow, row_bytes = rows.shape
    lib = get_lib()
    if lib is None:
        chunk = rows[:, col_off:col_off + nbytes]
        if elem_size > 1:
            dt = {2: ">u2", 4: ">u4", 8: ">u8"}[elem_size]
            arr = np.frombuffer(chunk.tobytes(), dtype=dt)
            arr = arr.astype(arr.dtype.newbyteorder("="))
            return arr.view(np.uint8).reshape(nrow, nbytes)
        return np.ascontiguousarray(chunk)
    out = np.empty((nrow, nbytes), dtype=np.uint8)
    lib.pp_col_extract(_ptr(rows, ctypes.c_uint8), nrow, row_bytes,
                       col_off, nbytes, elem_size,
                       _ptr(out, ctypes.c_uint8))
    return out


def col_insert(src, rows, col_off, elem_size):
    """Byteswap+scatter a (nrow, nbytes) u1 column into u1 rows."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    nrow, nbytes = src.shape
    lib = get_lib()
    if lib is None:
        if elem_size > 1:
            dt = {2: "u2", 4: "u4", 8: "u8"}[elem_size]
            arr = np.frombuffer(src.tobytes(), dtype=dt)
            arr = arr.astype(arr.dtype.newbyteorder(">"))
            src = arr.view(np.uint8).reshape(nrow, nbytes)
        rows[:, col_off:col_off + nbytes] = src
        return
    lib.pp_col_insert(_ptr(src, ctypes.c_uint8), nrow, rows.shape[1],
                      col_off, nbytes, elem_size,
                      _ptr(rows, ctypes.c_uint8))


def dequantize_i2(raw, scl, offs):
    """float32 = scl*raw + offs per profile; raw (..., nbin) int16."""
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    shape = raw.shape
    nbin = shape[-1]
    nprof = raw.size // nbin
    scl = np.ascontiguousarray(scl, dtype=np.float32).reshape(nprof)
    offs = np.ascontiguousarray(offs, dtype=np.float32).reshape(nprof)
    lib = get_lib()
    if lib is None:
        return (scl[:, None] * raw.reshape(nprof, nbin) +
                offs[:, None]).reshape(shape).astype(np.float32)
    out = np.empty((nprof, nbin), dtype=np.float32)
    lib.pp_dequantize_i2(_ptr(raw, ctypes.c_int16),
                         _ptr(scl, ctypes.c_float),
                         _ptr(offs, ctypes.c_float), nprof, nbin,
                         _ptr(out, ctypes.c_float))
    return out.reshape(shape)


def quantize_i2(data):
    """Per-profile min/max int16 quantization (DAT_SCL/DAT_OFFS).

    data (..., nbin) float -> (raw int16 same shape, scl, offs of
    shape data.shape[:-1]).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    shape = data.shape
    nbin = shape[-1]
    nprof = data.size // nbin
    flat = data.reshape(nprof, nbin)
    lib = get_lib()
    if lib is None:
        mn = flat.min(axis=1)
        mx = flat.max(axis=1)
        span = mx - mn
        scl = np.where(span > 0, span / 65534.0, 1.0).astype(np.float32)
        offs = (0.5 * (mn + mx)).astype(np.float32)
        raw = np.round((flat - offs[:, None]) / scl[:, None]).astype(
            np.int16)
        return (raw.reshape(shape), scl.reshape(shape[:-1]),
                offs.reshape(shape[:-1]))
    raw = np.empty((nprof, nbin), dtype=np.int16)
    scl = np.empty(nprof, dtype=np.float32)
    offs = np.empty(nprof, dtype=np.float32)
    lib.pp_quantize_i2(_ptr(flat, ctypes.c_float), nprof, nbin,
                       _ptr(raw, ctypes.c_int16),
                       _ptr(scl, ctypes.c_float),
                       _ptr(offs, ctypes.c_float))
    return (raw.reshape(shape), scl.reshape(shape[:-1]),
            offs.reshape(shape[:-1]))
