"""Split-precision MJD arithmetic.

TOA epochs need ~0.1 ns precision over 1e5 days; a single float64 day
value only gives ~1 us.  Like PSRCHIVE's MJD (used throughout the
reference: pplib.py:2647, 3438, write_TOAs pplib.py:3467-3473), the epoch
is kept as (integer days, integer seconds, fractional seconds).
"""

from __future__ import annotations

import math


class MJD:
    """MJD as (int days, int seconds, float fractional seconds)."""

    __slots__ = ("days", "secs", "frac")

    def __init__(self, days=0, secs=0, frac=0.0):
        # allow MJD(57000.123) or MJD(days, secs, fracsec)
        if isinstance(days, float) and secs == 0 and frac == 0.0:
            d = math.floor(days)
            rem = (days - d) * 86400.0
            s = math.floor(rem)
            self.days, self.secs, self.frac = int(d), int(s), rem - s
        else:
            self.days, self.secs, self.frac = int(days), int(secs), \
                float(frac)
            self._normalize()

    def _normalize(self):
        extra_s = math.floor(self.frac)
        self.secs += int(extra_s)
        self.frac -= extra_s
        extra_d, self.secs = divmod(self.secs, 86400)
        self.days += int(extra_d)

    def intday(self) -> int:
        return self.days

    def fracday(self) -> float:
        return (self.secs + self.frac) / 86400.0

    def in_days(self) -> float:
        return self.days + self.fracday()

    def add_seconds(self, seconds: float) -> "MJD":
        s = math.floor(seconds)
        return MJD(self.days, self.secs + int(s), self.frac + (seconds - s))

    def __add__(self, seconds):
        """Add seconds (PSRCHIVE convention: MJD + float adds seconds,
        cf. pplib.py:3158 'Yes add seconds to days')."""
        return self.add_seconds(float(seconds))

    def __sub__(self, other):
        if isinstance(other, MJD):
            return (self.days - other.days) * 86400.0 + \
                (self.secs - other.secs) + (self.frac - other.frac)
        return self.add_seconds(-float(other))

    def __lt__(self, other):
        return (self - other) < 0.0

    def __eq__(self, other):
        return isinstance(other, MJD) and self - other == 0.0

    def day_fracstr(self, ndigits: int = 15) -> str:
        """'<days>.<frac>' with the fractional day rounded to ndigits.

        Carries the rounding overflow into the integer day: an epoch
        within half an ulp of midnight must print as the NEXT day with a
        zero fraction, not a >=1.0 fractional part (malformed TOA).
        """
        scale = 10 ** ndigits
        frac_i = int(round(self.fracday() * scale))
        days = self.days
        if frac_i >= scale:
            days += frac_i // scale
            frac_i %= scale
        return "%d.%0*d" % (days, ndigits, frac_i)

    def __repr__(self):
        return f"MJD({self.days}, {self.secs}, {self.frac!r})"

    def __str__(self):
        return self.day_fracstr(15)
