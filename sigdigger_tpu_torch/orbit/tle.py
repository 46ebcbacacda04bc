"""TLE (two-line element) parsing (counterpart of
``sigdigger_tpu/orbit/tle.py``, the same parser).

reference include/Suscan/Library.h:154-250 wraps the sgdp4 C library's
`orbit_init_from_data/file`; satellites are registered from TLE sets
downloaded by TLEDownloaderTask.  This parser accepts standard 2-line
and 3-line (named) element sets with checksum validation.
"""

from __future__ import annotations

from dataclasses import dataclass

_DEG2RAD = 3.141592653589793 / 180.0
_TWO_PI = 2.0 * 3.141592653589793
_MIN_PER_DAY = 1440.0


def _checksum(line: str) -> int:
    s = 0
    for ch in line[:68]:
        if ch.isdigit():
            s += int(ch)
        elif ch == "-":
            s += 1
    return s % 10


def _implied_decimal(field: str) -> float:
    """TLE exponent fields like ' 12345-4' → 0.12345e-4."""
    field = field.strip()
    if not field or field in ("+", "-"):
        return 0.0
    sign = -1.0 if field[0] == "-" else 1.0
    body = field.lstrip("+-")
    if "-" in body:
        mant, exp = body.split("-")
        e = -int(exp)
    elif "+" in body:
        mant, exp = body.split("+")
        e = int(exp)
    else:
        mant, e = body, 0
    return sign * float(f"0.{mant.strip()}") * 10.0 ** e


@dataclass
class TLE:
    name: str
    satnum: int
    epoch_year: int
    epoch_day: float            # day of year with fraction
    ndot: float                 # rev/day^2 / 2
    nddot: float                # rev/day^3 / 6
    bstar: float                # 1/earth radii
    incl: float                 # radians
    raan: float                 # radians
    ecc: float
    argp: float                 # radians
    mean_anomaly: float         # radians
    mean_motion: float          # rad/min
    rev_number: int

    @property
    def epoch_unix(self) -> float:
        """Epoch as unix seconds (UTC)."""
        import calendar

        year = self.epoch_year
        base = calendar.timegm((year, 1, 1, 0, 0, 0))
        return base + (self.epoch_day - 1.0) * 86400.0

    @property
    def period_minutes(self) -> float:
        return _TWO_PI / self.mean_motion


def parse_tle(text: str) -> list[TLE]:
    """Parse a TLE file body (2- or 3-line sets) → list of TLEs."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    out: list[TLE] = []
    i = 0
    name = ""
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("1 ") and i + 1 < len(lines) and \
                lines[i + 1].startswith("2 "):
            l1, l2 = ln, lines[i + 1]
            if len(l1) >= 69 and l1[68].isdigit() and \
                    _checksum(l1) != int(l1[68]):
                raise ValueError(f"TLE line 1 checksum mismatch: {l1!r}")
            if len(l2) >= 69 and l2[68].isdigit() and \
                    _checksum(l2) != int(l2[68]):
                raise ValueError(f"TLE line 2 checksum mismatch: {l2!r}")
            epoch_year = int(l1[18:20])
            epoch_year += 2000 if epoch_year < 57 else 1900
            n_rev_day = float(l2[52:63])
            out.append(TLE(
                name=name or f"SAT-{int(l1[2:7])}",
                satnum=int(l1[2:7]),
                epoch_year=epoch_year,
                epoch_day=float(l1[20:32]),
                ndot=float(l1[33:43]),
                nddot=_implied_decimal(l1[44:52]),
                bstar=_implied_decimal(l1[53:61]),
                incl=float(l2[8:16]) * _DEG2RAD,
                raan=float(l2[17:25]) * _DEG2RAD,
                ecc=float(f"0.{l2[26:33].strip()}"),
                argp=float(l2[34:42]) * _DEG2RAD,
                mean_anomaly=float(l2[43:51]) * _DEG2RAD,
                mean_motion=n_rev_day * _TWO_PI / _MIN_PER_DAY,
                rev_number=int(l2[63:68]) if l2[63:68].strip() else 0,
            ))
            name = ""
            i += 2
        else:
            name = ln.strip()
            i += 1
    return out
