"""Telescope -> TEMPO site-code table for TOA lines.

Parses $TEMPO2/observatory/observatories.dat + aliases when available
(mirroring reference telescope_codes.py:7-30); otherwise falls back to a
built-in table covering the reference's ~90-entry fallback dict
(reference telescope_codes.py:32-132) plus a few extras (CHIME, FAST
short code, barycenter/geocenter).  The first code listed is preferred
— the reference emits ``telescope_code_dict[name][0]`` on TOA lines
(reference pplib.py:2675-2676), so ordering follows the reference.
"""

from __future__ import annotations

import os


def _load_tempo2_codes():
    t2 = os.environ.get("TEMPO2")
    if not t2:
        return None
    obs_file = os.path.join(t2, "observatory", "observatories.dat")
    alias_file = os.path.join(t2, "observatory", "aliases")
    if not os.path.isfile(obs_file):
        return None
    table = {}
    try:
        with open(obs_file) as f:
            for line in f:
                toks = line.split()
                if len(toks) >= 5 and not line.startswith("#"):
                    name, code = toks[-2].upper(), toks[-1]
                    table.setdefault(name, []).append(code)
        if os.path.isfile(alias_file):
            with open(alias_file) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) >= 2 and not line.startswith("#"):
                        for name, codes in table.items():
                            if toks[0] == codes[0]:
                                codes.extend(toks[1:])
    except OSError:
        return None
    return table or None


# "NAME: code [code ...]" — first code preferred.  Factual content matches
# the reference fallback table (telescope_codes.py:32-132), which is itself
# derived from TEMPO2's observatories.dat + aliases.
_BUILTIN_SPEC = """
ARECIBO: ao 3 arecebo arecibo
AXIS: axi
CAMBRIDGE: cam
COE: coe
DARNHALL: l
DEFFORD: n
DSS_43: tid43 6
EFFELSBERG: eff g
EFFELSBERG_ASTERIX: effix
FAST: fast k
GB140: gb140 a
GB300: gb300 9
GB853: gb853 b
GBT: gbt 1 gb
GEO600: geo600
GMRT: gmrt r
GOLDSTONE: gs
GRAO: grao
HAMBURG: hamburg
HANFORD: lho
HARTEBEESTHOEK: hart d
HOBART: hob 4
JBOAFB: jbafb
JBODFB: jbdfb q
JBOROACH: jbroach
JB_42FT: jb42
JB_MKII: jbmk2 h
JB_MKII_DFB: jbmk2dfb
JB_MKII_RCH: jbmk2roach
JODRELL: jb 8 y z
JODRELL2: q
JODRELLM4: jbm4
KAGRA: kagra
KAT-7: k7
KNOCKIN: m
LA_PALMA: p c lap
LIVINGSTON: llo
LOFAR: lofar t
LWA1: lwa1 x
MEERKAT: meerkat m
MKIII: jbmk3 j
MOST: mo
MWA: mwa u
NANCAY: ncy f nancay
NANSHAN: NS
NARRABRI: atca 2
NUPPI: ncyobs w
OP: obspm
PARKES: pks 7 parkes
PRINCETON: princeton 5
SRT: srt z
STL_BAT: STL_BAT
TABLEY: k
UAO: NS
UTR-2: UTR2
VIRGO: virgo
VLA: vla c 6
WARKWORTH_12M: wark12m
WARKWORTH_30M: wark30m
WSRT: wsrt i
"""

# International LOFAR stations: DE/FR/SE/UK/FI + site prefix, each with
# plain / HBA / LBA / LBH variants (reference telescope_codes.py:38-61,
# 66-76, 110-121).
_LOFAR_STATIONS = {
    "DE601": "EF", "DE602": "UW", "DE603": "TB", "DE604": "PO",
    "DE605": "JU", "DE609": "ND", "FI609": "Fi", "FR606": "FR",
    "SE607": "ON", "UK608": "UK",
}

# Aliases and extras not in the reference table.
_EXTRA_SPEC = """
AO: ao 3
GB: gbt 1
GREENBANK: gbt 1
PKS: pks 7
JB: jb 8
EFF: eff g
NCY: ncy f
WESTERBORK: wsrt i
QUABBIN: qu 2
SHAO: shao s
ATA: ata j
VLT: vlt v
CHIME: chime y
BARYCENTER: @ bat
GEOCENTER: 0 coe
FAKE: o fake
"""


def _parse_spec(spec):
    table = {}
    for line in spec.strip().splitlines():
        name, codes = line.split(":")
        table[name.strip()] = codes.split()
    return table


def _builtin():
    table = _parse_spec(_BUILTIN_SPEC)
    for station, prefix in _LOFAR_STATIONS.items():
        table[station] = [prefix + "lfr"]
        for band in ("HBA", "LBA", "LBH"):
            table[station + band] = [prefix + "lfr" + band.lower()]
    for name, codes in _parse_spec(_EXTRA_SPEC).items():
        table.setdefault(name, codes)
    return table


telescope_code_dict = _load_tempo2_codes() or _builtin()


def telescope_code(name: str) -> str:
    """Preferred site code for a telescope name (falls back to the name)."""
    try:
        return telescope_code_dict[name.upper()][0]
    except KeyError:
        return name
