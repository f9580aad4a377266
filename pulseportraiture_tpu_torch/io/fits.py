"""Minimal FITS reader/writer: primary header + binary table extensions.

Implements exactly the subset PSRFITS needs (the environment has no
astropy/cfitsio): 2880-byte blocks, 80-char header cards, BINTABLE
extensions with column types L/B/I/J/K/E/D/A including repeat counts.
Data are big-endian per the FITS standard.  This replaces the reference's
native PSRCHIVE/cfitsio boundary (SURVEY.md section 2); the hot DATA
unpack/quantization path has a C++ fast path in native/ (ctypes), with
this pure-Python implementation as the portable fallback.
"""

from __future__ import annotations

import re

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM_DTYPES = {
    "L": ("u1", 1), "B": ("u1", 1), "I": (">i2", 2), "J": (">i4", 4),
    "K": (">i8", 8), "E": (">f4", 4), "D": (">f8", 8), "A": ("S1", 1),
}


class HDU:
    """A FITS HDU: ordered header cards + optional binary-table columns."""

    def __init__(self, header=None, columns=None, name=""):
        self.header = dict(header or {})
        self.columns = columns or {}  # name -> (nrow, ...) arrays
        self.name = name

    def __repr__(self):
        return f"HDU({self.name!r}, cols={list(self.columns)})"


def _format_card(key, value, comment=""):
    if key in ("COMMENT", "HISTORY", "END"):
        return (key.ljust(8) + str(value))[:CARD].ljust(CARD)
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        body = f"{key:<8}= {value:>20.14G}"
    else:
        s = str(value).replace("'", "''")
        body = f"{key:<8}= '{s:<8}'"
    if comment:
        body += f" / {comment}"
    return body[:CARD].ljust(CARD)


def _parse_value(raw):
    raw = raw.strip()
    if raw.startswith("'"):
        end = raw.rfind("'")
        return raw[1:end].replace("''", "'").rstrip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        if any(c in raw for c in ".EeDd") and not raw.lstrip("+-").isdigit():
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    except ValueError:
        return raw


def _write_header(f, cards):
    buf = b""
    for key, val in cards:
        if isinstance(val, tuple):
            buf += _format_card(key, val[0], val[1]).encode("ascii")
        else:
            buf += _format_card(key, val).encode("ascii")
    buf += "END".ljust(CARD).encode("ascii")
    pad = (-len(buf)) % BLOCK
    f.write(buf + b" " * pad)


def _read_header(f):
    cards = {}
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            raise EOFError("Truncated FITS header")
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return cards
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] == "= ":
                body = card[10:]
                # strip inline comment (respecting strings)
                if body.lstrip().startswith("'"):
                    q = body.find("'", body.find("'") + 1)
                    while q + 1 < len(body) and body[q + 1] == "'":
                        q = body.find("'", q + 2)
                    comment_at = body.find("/", q)
                else:
                    comment_at = body.find("/")
                if comment_at >= 0:
                    body = body[:comment_at]
                cards[key] = _parse_value(body)


def _parse_tform(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


def write_fits(path, hdus):
    """Write HDUs; hdus[0] is the primary (header only), the rest tables.

    Each table HDU needs header keys set by the caller only for extras;
    the structural keys (BITPIX/NAXIS/TFIELDS/TFORM/TTYPE...) are derived
    from the column arrays.  Column dict values may be 1-D (scalar per
    row) or 2-D (vector per row); strings are fixed-width bytes.
    """
    with open(path, "wb") as f:
        primary = hdus[0]
        cards = [("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                 ("EXTEND", True)]
        cards += [(k, v) for k, v in primary.header.items()
                  if not _is_structural(k)]
        _write_header(f, cards)
        for hdu in hdus[1:]:
            _write_table(f, hdu)


_STRUCTURAL = re.compile(
    r"^(SIMPLE|BITPIX|NAXIS\d*|EXTEND|PCOUNT|GCOUNT|TFIELDS|XTENSION|"
    r"EXTNAME|END|TTYPE\d+|TFORM\d+|TUNIT\d+|TDIM\d+)$")


def _is_structural(key):
    """Keys derived from the data at write time; dropping them makes
    write_fits(read_fits(path)) round-trips safe after column edits."""
    return bool(_STRUCTURAL.match(key))


def _col_spec(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind in ("U", "S"):
        width = int(arr.dtype.itemsize if arr.dtype.kind == "S"
                    else arr.dtype.itemsize // 4)
        return f"{width}A", arr.astype(f"S{width}").view("S1").reshape(
            len(arr), width), width
    kind_map = {("i", 2): "I", ("i", 4): "J", ("i", 8): "K",
                ("f", 4): "E", ("f", 8): "D", ("u", 1): "B"}
    code = kind_map[(arr.dtype.kind, arr.dtype.itemsize)]
    flat = arr.reshape(len(arr), -1)
    repeat = flat.shape[1]
    tform = f"{repeat}{code}" if repeat != 1 else code
    be = flat.astype(_TFORM_DTYPES[code][0])
    return tform, be, repeat


def _write_table(f, hdu):
    names = list(hdu.columns)
    specs = []
    nrow = None
    for name in names:
        arr = np.asarray(hdu.columns[name])
        if nrow is None:
            nrow = len(arr)
        tform, data, repeat = _col_spec(arr)
        specs.append((name, tform, data))
    row_bytes = sum(d.shape[1] * d.dtype.itemsize if d.ndim > 1
                    else d.dtype.itemsize for _, _, d in specs)
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", row_bytes), ("NAXIS2", nrow), ("PCOUNT", 0),
             ("GCOUNT", 1), ("TFIELDS", len(names))]
    # per-column metadata (TUNIT/TDIM) from a previously read header,
    # remapped by column NAME so edits that renumber columns stay valid
    old_index = {}
    for k, v in hdu.header.items():
        m = re.match(r"^TTYPE(\d+)$", k)
        if m:
            old_index[str(v).strip()] = m.group(1)
    for i, (name, tform, _) in enumerate(specs):
        cards.append((f"TTYPE{i + 1}", name))
        cards.append((f"TFORM{i + 1}", tform))
        oi = old_index.get(name)
        if oi is not None:
            for meta in ("TUNIT", "TDIM"):
                val = hdu.header.get(f"{meta}{oi}")
                if val is not None:
                    cards.append((f"{meta}{i + 1}", val))
    cards.append(("EXTNAME", hdu.name))
    cards += [(k, v) for k, v in hdu.header.items()
              if not _is_structural(k)]
    _write_header(f, cards)
    # interleave rows (native multithreaded scatter when available)
    from pulseportraiture_tpu_torch.io import native
    row = np.zeros((nrow, row_bytes), dtype="u1")
    off = 0
    for _, _, data in specs:
        # data is already big-endian from _col_spec: scatter bytes as-is
        col_u1 = np.ascontiguousarray(data.reshape(nrow, -1)).view(
            "u1").reshape(nrow, -1)
        native.col_insert(col_u1, row, off, 1)
        off += col_u1.shape[1]
    buf = row.tobytes()
    pad = (-len(buf)) % BLOCK
    f.write(buf + b"\x00" * pad)


def read_fits(path):
    """Read all HDUs.  Table columns come back as native-endian arrays."""
    hdus = []
    with open(path, "rb") as f:
        header = _read_header(f)  # primary, NAXIS=0 assumed
        hdus.append(HDU(header=header, name="PRIMARY"))
        while True:
            try:
                header = _read_header(f)
            except EOFError:
                break
            nrow = header["NAXIS2"]
            row_bytes = header["NAXIS1"]
            tfields = header["TFIELDS"]
            raw = f.read(nrow * row_bytes)
            pad = (-(nrow * row_bytes)) % BLOCK
            f.read(pad)
            rows = np.frombuffer(raw, dtype="u1").reshape(nrow, row_bytes)
            cols = {}
            off = 0
            for i in range(1, tfields + 1):
                name = header[f"TTYPE{i}"]
                repeat, code = _parse_tform(header[f"TFORM{i}"])
                dt, size = _TFORM_DTYPES[code]
                nbytes = repeat * size
                chunk = rows[:, off:off + nbytes]
                off += nbytes
                if code == "A":
                    cols[name] = chunk.reshape(nrow, repeat).view(
                        f"S{repeat}")[:, 0]
                else:
                    from pulseportraiture_tpu_torch.io import native
                    ext = native.col_extract(rows, off - nbytes, nbytes,
                                             size)
                    arr = ext.view(dt.lstrip(">")).reshape(nrow, repeat)
                    cols[name] = arr[:, 0] if repeat == 1 else arr
            hdus.append(HDU(header=header, columns=cols,
                            name=header.get("EXTNAME", "")))
    return hdus
