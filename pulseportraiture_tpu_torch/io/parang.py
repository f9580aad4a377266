"""Parallactic angles for TOA flags.

The reference obtains parallactic angles from PSRCHIVE's C++ Archive
(pptoas.py print_parangle path); here they are computed directly:
local sidereal time from GMST (IAU 1982 polynomial, good to well under
a second) plus the observatory east longitude, hour angle against the
source RA, then

    q = atan2(sin H, tan(lat) cos(dec) - sin(dec) cos H).

Observatory geodetic coordinates cover the common pulsar-timing sites;
unknown telescopes return NaN (and the flag is omitted).
"""

from __future__ import annotations

import math

# (latitude deg, east longitude deg) — geodetic, ~arcsecond grade is
# ample for a diagnostic angle
OBSERVATORY_COORDS = {
    "GBT": (38.4330, -79.8398),
    "GB": (38.4330, -79.8398),
    "ARECIBO": (18.3442, -66.7528),
    "AO": (18.3442, -66.7528),
    "VLA": (34.0784, -107.6184),
    "PARKES": (-32.9980, 148.2636),
    "JODRELL": (53.2367, -2.3085),
    "JB": (53.2367, -2.3085),
    "NANCAY": (47.3817, 2.1933),
    "NCY": (47.3817, 2.1933),
    "EFFELSBERG": (50.5248, 6.8836),
    "EFF": (50.5248, 6.8836),
    "WSRT": (52.9146, 6.6031),
    "GMRT": (19.0931, 74.0506),
    "CHIME": (49.3208, -119.6236),
    "FAST": (25.6529, 106.8566),
    "MEERKAT": (-30.7110, 21.4439),
    "LOFAR": (52.9089, 6.8689),
    "SRT": (39.4928, 9.2451),
    "VLT": (-24.6275, -70.4044),
}


def hms_to_deg(hms: str) -> float:
    """'hh:mm:ss.s' -> degrees of RA."""
    parts = [float(p) for p in hms.split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    return 15.0 * (parts[0] + parts[1] / 60.0 + parts[2] / 3600.0)


def dms_to_deg(dms: str) -> float:
    """'[+-]dd:mm:ss.s' -> degrees of declination."""
    sign = -1.0 if dms.strip().startswith("-") else 1.0
    parts = [abs(float(p)) for p in dms.split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    return sign * (parts[0] + parts[1] / 60.0 + parts[2] / 3600.0)


def gmst_deg(mjd_ut: float) -> float:
    """Greenwich mean sidereal time [deg] (IAU 1982)."""
    d = mjd_ut - 51544.5
    T = d / 36525.0
    gmst = (280.46061837 + 360.98564736629 * d +
            0.000387933 * T * T - T * T * T / 38710000.0)
    return gmst % 360.0


def parallactic_angle(telescope: str, raj: str, decj: str,
                      mjd_ut: float) -> float:
    """Parallactic angle [deg] at the given UT epoch; NaN if the
    telescope's coordinates are unknown."""
    coords = OBSERVATORY_COORDS.get(str(telescope).upper())
    if coords is None:
        return float("nan")
    lat, lon = coords
    ra = hms_to_deg(raj)
    dec = math.radians(dms_to_deg(decj))
    lst = (gmst_deg(mjd_ut) + lon) % 360.0
    H = math.radians((lst - ra + 540.0) % 360.0 - 180.0)
    lat_r = math.radians(lat)
    q = math.atan2(math.sin(H),
                   math.tan(lat_r) * math.cos(dec) -
                   math.sin(dec) * math.cos(H))
    return math.degrees(q)
