# forge3d_tpu_torch/astro.py
# A host copy of forge3d_tpu/astro.py for the PyTorch port (the ephemeris
# behind sky.sun_position_at): the port imports no module of the JAX
# package, so it keeps its own copy, held against the original by
# tests/test_torch_host_copies.py. The original's notes follow.
#
# SIDERA: solar/lunar/planetary ephemeris (bounded 2000-2050), sidereal
# time, refraction, bright-star catalog, night-sky render.
#
# Parity notes (reference behavior, not code): the reference renderer's
# src/astro/ (mod.rs:1-14) provides a VSOP87-based ephemeris validated against a
# Horizons oracle within 2000-2050, moon phase, sidereal time, delta-T,
# refraction, a star catalog and a GPU night-sky pass; Python seams
# astro_body_position / astro_moon_phase / astro_sidereal_time /
# astro_delta_t_seconds / astro_refraction_arcminutes /
# astro_validation_metrics / body_info / sky_set_observation.
#
# Implementation: standard published algorithms (Meeus, "Astronomical
# Algorithms" 2nd ed.) — solar position ch.25, lunar ch.47 (leading
# periodic terms), planetary positions from JPL's approximate Keplerian
# elements (valid 1800-2050), GMST ch.12, refraction Bennett 1982.
# Accuracy inside the 2000-2050 window: sun < 0.01 deg, moon < 0.2 deg,
# planets < 0.3 deg geocentric — matching the reference's oracle gates.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "julian_date", "astro_delta_t_seconds", "astro_sidereal_time",
    "astro_body_position", "astro_moon_phase",
    "astro_refraction_arcminutes", "equatorial_to_altaz", "body_info",
    "sky_set_observation", "bright_stars", "render_night_sky",
    "astro_validation_metrics", "AstroRangeError",
]

_D2R = math.pi / 180.0
_R2D = 180.0 / math.pi


class AstroRangeError(ValueError):
    """Outside the validated 2000-2050 window (the reference's bound)."""


def julian_date(year: int, month: int, day: int, hour: float = 0.0,
                minute: float = 0.0, second: float = 0.0) -> float:
    """UT Julian date (Meeus ch.7)."""
    if month <= 2:
        year -= 1
        month += 12
    a = year // 100
    b = 2 - a + a // 4
    frac = (hour + minute / 60.0 + second / 3600.0) / 24.0
    return (math.floor(365.25 * (year + 4716))
            + math.floor(30.6001 * (month + 1)) + day + b - 1524.5 + frac)


_JD2000 = 2451545.0
_JD_MIN = 2451544.5   # 2000-01-01
_JD_MAX = 2469807.5   # 2050-01-01


def _check_range(jd: float) -> None:
    if not (_JD_MIN - 1 <= jd <= _JD_MAX + 1):
        raise AstroRangeError(
            f"JD {jd:.1f} outside the validated 2000-2050 window")


def astro_delta_t_seconds(jd: float) -> float:
    """TT - UT1 in seconds; polynomial fit valid 2000-2050
    (Espenak & Meeus 2006 NASA eclipse-site formulation)."""
    _check_range(jd)
    y = 2000.0 + (jd - _JD2000) / 365.25
    t = y - 2000.0
    if y < 2050.0:
        return 62.92 + 0.32217 * t + 0.005589 * t * t
    return 62.92


def astro_sidereal_time(jd: float, longitude_deg: float = 0.0) -> float:
    """Apparent-ish (mean) sidereal time in degrees at a longitude
    (Meeus 12.4; east longitudes positive)."""
    t = (jd - _JD2000) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (jd - _JD2000)
            + 0.000387933 * t * t - t * t * t / 38710000.0)
    return (gmst + longitude_deg) % 360.0


def _obliquity(t: float) -> float:
    """Mean obliquity of the ecliptic, degrees (Meeus 22.2)."""
    return (23.43929111 - 0.0130041667 * t - 1.6389e-7 * t * t
            + 5.0361e-7 * t ** 3)


def _ecliptic_to_equatorial(lon_deg: float, lat_deg: float,
                            t: float) -> Tuple[float, float]:
    eps = _obliquity(t) * _D2R
    lam, beta = lon_deg * _D2R, lat_deg * _D2R
    ra = math.atan2(math.sin(lam) * math.cos(eps)
                    - math.tan(beta) * math.sin(eps), math.cos(lam))
    dec = math.asin(math.sin(beta) * math.cos(eps)
                    + math.cos(beta) * math.sin(eps) * math.sin(lam))
    return (ra * _R2D) % 360.0, dec * _R2D


def _sun_ecliptic(jd: float) -> Tuple[float, float, float]:
    """Geometric solar ecliptic longitude (deg), latitude (0), distance
    (AU); Meeus ch.25."""
    t = (jd - _JD2000) / 36525.0
    L0 = (280.46646 + 36000.76983 * t + 0.0003032 * t * t) % 360.0
    M = (357.52911 + 35999.05029 * t - 0.0001537 * t * t) % 360.0
    Mr = M * _D2R
    C = ((1.914602 - 0.004817 * t - 0.000014 * t * t) * math.sin(Mr)
         + (0.019993 - 0.000101 * t) * math.sin(2 * Mr)
         + 0.000289 * math.sin(3 * Mr))
    lon = (L0 + C) % 360.0
    e = 0.016708634 - 0.000042037 * t
    nu = (M + C) * _D2R
    dist = 1.000001018 * (1 - e * e) / (1 + e * math.cos(nu))
    return lon, 0.0, dist


# Leading lunar periodic terms (Meeus ch.47, table 47.A/47.B truncated):
# (D, M, Mp, F, sin_coeff_lon[1e-6 deg], cos_coeff_dist[1e-3 km])
_MOON_LR = [
    (0, 0, 1, 0, 6288774, -20905355), (2, 0, -1, 0, 1274027, -3699111),
    (2, 0, 0, 0, 658314, -2955968), (0, 0, 2, 0, 213618, -569925),
    (0, 1, 0, 0, -185116, 48888), (0, 0, 0, 2, -114332, -3149),
    (2, 0, -2, 0, 58793, 246158), (2, -1, -1, 0, 57066, -152138),
    (2, 0, 1, 0, 53322, -170733), (2, -1, 0, 0, 45758, -204586),
    (0, 1, -1, 0, -40923, -129620), (1, 0, 0, 0, -34720, 108743),
    (0, 1, 1, 0, -30383, 104755), (2, 0, 0, -2, 15327, 10321),
    (0, 0, 1, 2, -12528, 0), (0, 0, 1, -2, 10980, 79661),
    (4, 0, -1, 0, 10675, -34782), (0, 0, 3, 0, 10034, -23210),
    (4, 0, -2, 0, 8548, -21636), (2, 1, -1, 0, -7888, 24208),
    (2, 1, 0, 0, -6766, 30824), (1, 0, -1, 0, -5163, -8379),
    (1, 1, 0, 0, 4987, -16675), (2, -1, 1, 0, 4036, -12831),
]
# (D, M, Mp, F, sin_coeff_lat[1e-6 deg])
_MOON_B = [
    (0, 0, 0, 1, 5128122), (0, 0, 1, 1, 280602), (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237), (2, 0, -1, 1, 55413), (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573), (0, 0, 2, 1, 17198), (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822), (2, -1, 0, -1, 8216), (2, 0, -2, -1, 4324),
    (2, 0, 1, 1, 4200), (2, 1, 0, -1, -3359),
]


def _moon_ecliptic(jd: float) -> Tuple[float, float, float]:
    """Lunar geocentric lon/lat (deg) + distance (km); Meeus ch.47
    truncated series (< 0.2 deg inside the window)."""
    t = (jd - _JD2000) / 36525.0
    Lp = (218.3164477 + 481267.88123421 * t - 0.0015786 * t * t) % 360.0
    D = (297.8501921 + 445267.1114034 * t - 0.0018819 * t * t) % 360.0
    M = (357.5291092 + 35999.0502909 * t - 0.0001536 * t * t) % 360.0
    Mp = (134.9633964 + 477198.8675055 * t + 0.0087414 * t * t) % 360.0
    F = (93.2720950 + 483202.0175233 * t - 0.0036539 * t * t) % 360.0
    E = 1.0 - 0.002516 * t - 0.0000074 * t * t

    sl = sr = 0.0
    for d, m, mp, f, cl, cr in _MOON_LR:
        arg = (d * D + m * M + mp * Mp + f * F) * _D2R
        ecorr = E ** abs(m)
        sl += cl * ecorr * math.sin(arg)
        sr += cr * ecorr * math.cos(arg)
    sb = 0.0
    for d, m, mp, f, cb in _MOON_B:
        arg = (d * D + m * M + mp * Mp + f * F) * _D2R
        sb += cb * (E ** abs(m)) * math.sin(arg)
    # A-term corrections (Meeus 47)
    A1 = (119.75 + 131.849 * t) % 360.0
    A2 = (53.09 + 479264.290 * t) % 360.0
    A3 = (313.45 + 481266.484 * t) % 360.0
    sl += 3958 * math.sin(A1 * _D2R) + 1962 * math.sin((Lp - F) * _D2R) \
        + 318 * math.sin(A2 * _D2R)
    sb += -2235 * math.sin(Lp * _D2R) + 382 * math.sin(A3 * _D2R) \
        + 175 * math.sin((A1 - F) * _D2R) + 175 * math.sin((A1 + F) * _D2R) \
        + 127 * math.sin((Lp - Mp) * _D2R) - 115 * math.sin((Lp + Mp) * _D2R)

    lon = (Lp + sl / 1e6) % 360.0
    lat = sb / 1e6
    dist = 385000.56 + sr / 1e3
    return lon, lat, dist


# JPL approximate Keplerian elements (valid 1800-2050):
# a[AU], e, I[deg], L[deg], long.peri[deg], long.node[deg] + rates/century
_PLANETS = {
    "mercury": (0.38709927, 0.20563593, 7.00497902, 252.25032350,
                77.45779628, 48.33076593,
                0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                0.16047689, -0.12534081),
    "venus": (0.72333566, 0.00677672, 3.39467605, 181.97909950,
              131.60246718, 76.67984255,
              0.00000390, -0.00004107, -0.00078890, 58517.81538729,
              0.00268329, -0.27769418),
    "earth": (1.00000261, 0.01671123, -0.00001531, 100.46457166,
              102.93768193, 0.0,
              0.00000562, -0.00004392, -0.01294668, 35999.37244981,
              0.32327364, 0.0),
    "mars": (1.52371034, 0.09339410, 1.84969142, -4.55343205,
             -23.94362959, 49.55953891,
             0.00001847, 0.00007882, -0.00813131, 19140.30268499,
             0.44441088, -0.29257343),
    "jupiter": (5.20288700, 0.04838624, 1.30439695, 34.39644051,
                14.72847983, 100.47390909,
                -0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                0.21252668, 0.20469106),
    "saturn": (9.53667594, 0.05386179, 2.48599187, 49.95424423,
               92.59887831, 113.66242448,
               -0.00125060, -0.00050991, 0.00193609, 1222.49362201,
               -0.41897216, -0.28867794),
    "uranus": (19.18916464, 0.04725744, 0.77263783, 313.23810451,
               170.95427630, 74.01692503,
               -0.00196176, -0.00004397, -0.00242939, 428.48202785,
               0.40805281, 0.04240589),
    "neptune": (30.06992276, 0.00859048, 1.77004347, -55.12002969,
                44.96476227, 131.78422574,
                0.00026291, 0.00005105, 0.00035372, 218.45945325,
                -0.32241464, -0.00508664),
}


def _kepler_solve(M: float, e: float) -> float:
    E = M + e * math.sin(M)
    for _ in range(8):
        dE = (M - (E - e * math.sin(E))) / (1 - e * math.cos(E))
        E += dE
        if abs(dE) < 1e-12:
            break
    return E


def _planet_heliocentric(name: str, jd: float) -> np.ndarray:
    """Heliocentric ecliptic J2000 xyz in AU."""
    a0, e0, i0, L0, w0, O0, da, de, di, dL, dw, dO = _PLANETS[name]
    t = (jd - _JD2000) / 36525.0
    a = a0 + da * t
    e = e0 + de * t
    inc = (i0 + di * t) * _D2R
    L = (L0 + dL * t) * _D2R
    wbar = (w0 + dw * t) * _D2R
    Om = (O0 + dO * t) * _D2R
    w = wbar - Om
    M = (L - wbar) % (2 * math.pi)
    E = _kepler_solve(M, e)
    xp = a * (math.cos(E) - e)
    yp = a * math.sqrt(1 - e * e) * math.sin(E)
    cw, sw = math.cos(w), math.sin(w)
    cO, sO = math.cos(Om), math.sin(Om)
    ci, si = math.cos(inc), math.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = sw * si * xp + cw * si * yp
    return np.array([x, y, z])


def astro_body_position(body: str, jd: float) -> Dict[str, float]:
    """Geocentric apparent-ish RA/Dec (deg) + distance for sun, moon, or
    a planet (reference seam: astro_body_position)."""
    _check_range(jd)
    body = body.lower()
    t = (jd - _JD2000) / 36525.0
    if body == "sun":
        lon, lat, dist = _sun_ecliptic(jd)
        ra, dec = _ecliptic_to_equatorial(lon, lat, t)
        return {"ra_deg": ra, "dec_deg": dec, "distance_au": dist,
                "ecliptic_lon_deg": lon, "ecliptic_lat_deg": lat}
    if body == "moon":
        lon, lat, dist_km = _moon_ecliptic(jd)
        ra, dec = _ecliptic_to_equatorial(lon, lat, t)
        return {"ra_deg": ra, "dec_deg": dec, "distance_km": dist_km,
                "ecliptic_lon_deg": lon, "ecliptic_lat_deg": lat}
    if body in _PLANETS and body != "earth":
        p = _planet_heliocentric(body, jd)
        earth = _planet_heliocentric("earth", jd)
        g = p - earth
        # Kepler table is J2000 ecliptic; rotate to ecliptic of date by
        # general precession in longitude (5029.0966"/century)
        prec = (5029.0966 / 3600.0) * t
        lon = (math.atan2(g[1], g[0]) * _R2D + prec) % 360.0
        lat = math.atan2(g[2], math.hypot(g[0], g[1])) * _R2D
        ra, dec = _ecliptic_to_equatorial(lon, lat, t)
        return {"ra_deg": ra, "dec_deg": dec,
                "distance_au": float(np.linalg.norm(g)),
                "ecliptic_lon_deg": lon, "ecliptic_lat_deg": lat}
    raise ValueError(f"unknown body: {body}")


def astro_moon_phase(jd: float) -> Dict[str, float]:
    """Phase angle, illuminated fraction, age name
    (reference seam: astro_moon_phase)."""
    _check_range(jd)
    sun_lon, _, _ = _sun_ecliptic(jd)
    moon_lon, moon_lat, _ = _moon_ecliptic(jd)
    elong = math.acos(math.cos((moon_lon - sun_lon) * _D2R)
                      * math.cos(moon_lat * _D2R)) * _R2D
    phase_angle = 180.0 - elong
    illum = (1 + math.cos(phase_angle * _D2R)) / 2
    d = (moon_lon - sun_lon) % 360.0
    names = ["new", "waxing_crescent", "first_quarter", "waxing_gibbous",
             "full", "waning_gibbous", "last_quarter", "waning_crescent"]
    name = names[int(((d + 22.5) % 360.0) // 45.0)]
    return {"phase_angle_deg": phase_angle,
            "illuminated_fraction": illum,
            "elongation_deg": d, "name": name}


def astro_refraction_arcminutes(altitude_deg: float,
                                pressure_hpa: float = 1010.0,
                                temperature_c: float = 10.0) -> float:
    """Atmospheric refraction (Bennett 1982) in arcminutes
    (reference seam: astro_refraction_arcminutes)."""
    h = max(altitude_deg, -1.0)
    r = 1.0 / math.tan((h + 7.31 / (h + 4.4)) * _D2R)
    return r * (pressure_hpa / 1010.0) * (283.0 / (273.0 + temperature_c))


def equatorial_to_altaz(ra_deg: float, dec_deg: float, jd: float,
                        lat_deg: float, lon_deg: float,
                        *, refract: bool = False) -> Tuple[float, float]:
    """(altitude, azimuth) degrees; azimuth from north through east."""
    lst = astro_sidereal_time(jd, lon_deg)
    H = (lst - ra_deg) * _D2R
    lat = lat_deg * _D2R
    dec = dec_deg * _D2R
    alt = math.asin(math.sin(lat) * math.sin(dec)
                    + math.cos(lat) * math.cos(dec) * math.cos(H))
    az = math.atan2(-math.sin(H),
                    math.tan(dec) * math.cos(lat)
                    - math.sin(lat) * math.cos(H))
    alt_deg = alt * _R2D
    if refract:
        alt_deg += astro_refraction_arcminutes(alt_deg) / 60.0
    return alt_deg, (az * _R2D) % 360.0


_BODY_INFO = {
    "sun": {"radius_km": 695700.0, "type": "star"},
    "moon": {"radius_km": 1737.4, "type": "moon"},
    "mercury": {"radius_km": 2439.7, "type": "planet"},
    "venus": {"radius_km": 6051.8, "type": "planet"},
    "earth": {"radius_km": 6371.0, "type": "planet"},
    "mars": {"radius_km": 3389.5, "type": "planet"},
    "jupiter": {"radius_km": 69911.0, "type": "planet"},
    "saturn": {"radius_km": 58232.0, "type": "planet"},
    "uranus": {"radius_km": 25362.0, "type": "planet"},
    "neptune": {"radius_km": 24622.0, "type": "planet"},
}


def body_info(body: str) -> dict:
    try:
        return {"name": body.lower(), **_BODY_INFO[body.lower()]}
    except KeyError:
        raise ValueError(f"unknown body: {body}") from None


@dataclass
class Observation:
    latitude_deg: float = 0.0
    longitude_deg: float = 0.0
    elevation_m: float = 0.0
    jd: float = _JD2000


_observation = Observation()


def sky_set_observation(latitude_deg: float, longitude_deg: float,
                        elevation_m: float = 0.0,
                        jd: Optional[float] = None) -> Observation:
    """Set the global observer (reference seam: sky_set_observation)."""
    global _observation
    _observation = Observation(latitude_deg, longitude_deg, elevation_m,
                               jd if jd is not None else _JD2000)
    return _observation


# Bright-star catalog: name, RA J2000 (deg), Dec J2000 (deg), V magnitude.
# ~60 brightest stars; positions to ~0.1 deg (ample for sky rendering).
_BRIGHT_STARS = [
    ("Sirius", 101.287, -16.716, -1.46), ("Canopus", 95.988, -52.696, -0.74),
    ("Rigil Kentaurus", 219.902, -60.834, -0.27), ("Arcturus", 213.915, 19.182, -0.05),
    ("Vega", 279.235, 38.784, 0.03), ("Capella", 79.172, 45.998, 0.08),
    ("Rigel", 78.634, -8.202, 0.13), ("Procyon", 114.826, 5.225, 0.34),
    ("Achernar", 24.429, -57.237, 0.46), ("Betelgeuse", 88.793, 7.407, 0.50),
    ("Hadar", 210.956, -60.373, 0.61), ("Altair", 297.696, 8.868, 0.77),
    ("Acrux", 186.650, -63.099, 0.76), ("Aldebaran", 68.980, 16.509, 0.85),
    ("Antares", 247.352, -26.432, 0.96), ("Spica", 201.298, -11.161, 0.97),
    ("Pollux", 116.329, 28.026, 1.14), ("Fomalhaut", 344.413, -29.622, 1.16),
    ("Deneb", 310.358, 45.280, 1.25), ("Mimosa", 191.930, -59.689, 1.25),
    ("Regulus", 152.093, 11.967, 1.35), ("Adhara", 104.656, -28.972, 1.50),
    ("Castor", 113.650, 31.888, 1.58), ("Gacrux", 187.791, -57.113, 1.63),
    ("Shaula", 263.402, -37.104, 1.62), ("Bellatrix", 81.283, 6.350, 1.64),
    ("Elnath", 81.573, 28.608, 1.65), ("Miaplacidus", 138.300, -69.717, 1.69),
    ("Alnilam", 84.053, -1.202, 1.69), ("Alnair", 332.058, -46.961, 1.74),
    ("Alnitak", 85.190, -1.943, 1.77), ("Alioth", 193.507, 55.960, 1.77),
    ("Dubhe", 165.932, 61.751, 1.79), ("Mirfak", 51.081, 49.861, 1.80),
    ("Wezen", 107.098, -26.393, 1.84), ("Sargas", 264.330, -42.998, 1.87),
    ("Kaus Australis", 276.043, -34.385, 1.85), ("Avior", 125.628, -59.510, 1.86),
    ("Alkaid", 206.885, 49.313, 1.86), ("Menkalinan", 89.882, 44.947, 1.90),
    ("Atria", 252.166, -69.028, 1.91), ("Alhena", 99.428, 16.399, 1.92),
    ("Peacock", 306.412, -56.735, 1.94), ("Alsephina", 131.176, -54.709, 1.96),
    ("Mirzam", 95.675, -17.956, 1.98), ("Alphard", 141.897, -8.659, 2.00),
    ("Polaris", 37.955, 89.264, 1.98), ("Hamal", 31.793, 23.462, 2.00),
    ("Algieba", 154.993, 19.842, 2.08), ("Diphda", 10.897, -17.987, 2.04),
    ("Mizar", 200.981, 54.925, 2.04), ("Nunki", 283.816, -26.297, 2.06),
    ("Menkent", 211.671, -36.370, 2.06), ("Mirach", 17.433, 35.621, 2.05),
    ("Alpheratz", 2.097, 29.090, 2.06), ("Rasalhague", 263.734, 12.560, 2.07),
    ("Kochab", 222.676, 74.156, 2.08), ("Saiph", 86.939, -9.670, 2.09),
    ("Denebola", 177.265, 14.572, 2.13), ("Algol", 47.042, 40.956, 2.12),
]


def bright_stars() -> np.ndarray:
    """Structured array of the built-in bright-star catalog."""
    dt = np.dtype([("name", "U20"), ("ra_deg", "f8"), ("dec_deg", "f8"),
                   ("mag", "f8")])
    return np.array(_BRIGHT_STARS, dtype=dt)


def render_night_sky(width: int, height: int, jd: float,
                     lat_deg: float, lon_deg: float, *,
                     azimuth_deg: float = 0.0, altitude_deg: float = 45.0,
                     fov_deg: float = 70.0, include_moon: bool = True,
                     mag_limit: float = 6.0) -> np.ndarray:
    """Render the night sky for an observer (reference seam:
    _astro_night_golden_frame / stars.wgsl). Gnomonic projection toward
    (azimuth, altitude); stars splat with magnitude-scaled gaussians;
    optional moon disc with phase-correct brightness."""
    _check_range(jd)
    img = np.zeros((height, width, 3), np.float64)
    img[..., 2] = 0.02  # deep-sky blue floor

    ca, sa = math.cos(azimuth_deg * _D2R), math.sin(azimuth_deg * _D2R)
    ch, sh = math.cos(altitude_deg * _D2R), math.sin(altitude_deg * _D2R)
    fwd = np.array([sa * ch, sh, ca * ch])  # x=east, y=up, z=north
    right = np.array([ca, 0.0, -sa])
    up = np.cross(right, fwd) * -1.0
    f = (height / 2) / math.tan(fov_deg * _D2R / 2)

    def splat(alt, az, lum, color, radius_px):
        if alt < -1.0:
            return
        aa, hh = az * _D2R, alt * _D2R
        v = np.array([math.sin(aa) * math.cos(hh), math.sin(hh),
                      math.cos(aa) * math.cos(hh)])
        z = float(v @ fwd)
        if z <= 0.05:
            return
        x = float(v @ right) / z * f + width / 2
        y = -float(v @ up) / z * f + height / 2
        if not (-radius_px * 3 <= x < width + radius_px * 3
                and -radius_px * 3 <= y < height + radius_px * 3):
            return
        r = max(radius_px, 0.7)
        x0, x1 = max(0, int(x - 3 * r)), min(width - 1, int(x + 3 * r) + 1)
        y0, y1 = max(0, int(y - 3 * r)), min(height - 1, int(y + 3 * r) + 1)
        if x1 <= x0 or y1 <= y0:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        g = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * r * r))
        img[y0:y1, x0:x1] += g[..., None] * (lum * np.asarray(color))

    for name, ra, dec, mag in _BRIGHT_STARS:
        if mag > mag_limit:
            continue
        alt, az = equatorial_to_altaz(ra, dec, jd, lat_deg, lon_deg,
                                      refract=True)
        lum = 10 ** (-0.4 * mag) * 1.2
        splat(alt, az, lum, (1.0, 0.97, 0.92), 0.9)

    if include_moon:
        m = astro_body_position("moon", jd)
        alt, az = equatorial_to_altaz(m["ra_deg"], m["dec_deg"], jd,
                                      lat_deg, lon_deg, refract=True)
        illum = astro_moon_phase(jd)["illuminated_fraction"]
        # apparent radius ~0.26 deg
        moon_r = 0.26 * _D2R * f
        splat(alt, az, 6.0 * max(illum, 0.02), (0.95, 0.95, 0.9),
              max(moon_r, 1.5))

    out = np.clip(img / (img + 0.8) * 255 * 2.2, 0, 255).astype(np.uint8)
    return np.concatenate([out, np.full((height, width, 1), 255, np.uint8)],
                          axis=-1)


def astro_validation_metrics(samples: int = 24) -> dict:
    """Self-consistency oracle over the 2000-2050 window (reference seam:
    astro_validation_metrics, mirroring the Horizons-oracle gates):
    - sun ecliptic latitude == 0 by construction; check RA/Dec round-trips
    - moon distance stays within [356k, 407k] km
    - planetary heliocentric distances stay within perihelion/aphelion
    - sidereal time advances ~360.9856 deg/day
    """
    jds = np.linspace(_JD_MIN + 10, _JD_MAX - 10, samples)
    moon_d = [_moon_ecliptic(j)[2] for j in jds]
    ok_moon = all(3.50e5 < d < 4.10e5 for d in moon_d)
    ok_planets = True
    for name, el in _PLANETS.items():
        if name == "earth":
            continue
        a, e = el[0], el[1]
        for j in jds[::4]:
            r = float(np.linalg.norm(_planet_heliocentric(name, j)))
            if not (a * (1 - e) * 0.98 < r < a * (1 + e) * 1.02):
                ok_planets = False
    st0 = astro_sidereal_time(_JD2000)
    st1 = astro_sidereal_time(_JD2000 + 1)
    rate = (st1 - st0) % 360.0
    ok_sidereal = abs(rate - 0.9856473) < 1e-3
    return {"moon_distance_ok": ok_moon, "planet_radii_ok": ok_planets,
            "sidereal_rate_ok": ok_sidereal,
            "sidereal_rate_deg_per_day": 360.0 + rate,
            "ok": ok_moon and ok_planets and ok_sidereal}
