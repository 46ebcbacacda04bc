"""SGP4/SDP4 orbit propagation + observer geometry (counterpart of
``sigdigger_tpu/orbit/sgp4.py``: the same model in the same float64
numpy operations, so its state vectors and predictions are the
reference's).

Equivalent of the sgdp4 C library the reference links for satellite
Doppler prediction (reference include/Suscan/Library.h:154-250,
`<sgdp4/sgdp4.h>`; consumed by FrequencyCorrectionDialog and the audio
inspector's Doppler correction, Default/Audio/AudioProcessor.cpp:429-450).

Implements the standard SGP4 model (Spacetrack Report #3 / Vallado's
revisited formulation).  Near-earth objects (period < 225 min) get
secular gravity + atmospheric drag and long-/short-period periodics;
deep-space objects additionally get the SDP4 extension: lunar-solar
secular rates and periodics (dscom/dsinit/dpper) and the 12 h / 24 h
geopotential resonance integrator (dspace), so any catalogued TLE —
GEO, Molniya, GPS — propagates.  All in the TEME frame; plus the
observer-side math (GMST rotation, site vectors, range rate → Doppler
shift).  Control-rate math → plain numpy on host, like the reference
(it is evaluated once per UI tick).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.orbit.tle import TLE

# WGS-72 constants (the sgdp4/SGP4 standard set)
_XKE = 7.43669161e-2          # sqrt(GM) in earth-radii^1.5/min
_J2 = 1.082616e-3
_J3 = -2.53881e-6
_J4 = -1.65597e-6
_CK2 = 0.5 * _J2
_CK4 = -0.375 * _J4
_XKMPER = 6378.135            # km per earth radius
_S0 = 1.01222928              # s parameter (78 km + ae)
_QOMS2T = 1.88027916e-9       # (q0 - s)^4 in er^4
_A3OVK2 = -_J3 / _CK2
_TWO_PI = 2.0 * np.pi
_MIN_PER_DAY = 1440.0
_EARTH_ROT = 7.29211510e-5    # rad/s
SPEED_OF_LIGHT = 299_792_458.0


@dataclass
class StateVector:
    position: np.ndarray    # km, TEME
    velocity: np.ndarray    # km/s, TEME


class SGP4:
    """Initialize once per TLE; ``propagate(tsince_min)`` → state."""

    def __init__(self, tle: TLE) -> None:
        self.tle = tle
        ecc = tle.ecc
        incl = tle.incl
        n0 = tle.mean_motion      # rad/min

        cosio = np.cos(incl)
        theta2 = cosio * cosio
        x3thm1 = 3.0 * theta2 - 1.0
        eosq = ecc * ecc
        betao2 = 1.0 - eosq
        betao = np.sqrt(betao2)

        # un-Kozai the mean motion
        a1 = (_XKE / n0) ** (2.0 / 3.0)
        del1 = 1.5 * _CK2 * x3thm1 / (a1 * a1 * betao * betao2)
        ao = a1 * (1.0 - del1 * (1.0 / 3.0 + del1 *
                                 (1.0 + 134.0 / 81.0 * del1)))
        delo = 1.5 * _CK2 * x3thm1 / (ao * ao * betao * betao2)
        self.n0dp = n0 / (1.0 + delo)          # rad/min
        self.aodp = ao / (1.0 - delo)          # earth radii

        self.deep_space = _TWO_PI / self.n0dp >= 225.0

        # drag terms
        s4 = _S0
        qoms24 = _QOMS2T
        perigee = (self.aodp * (1.0 - ecc) - 1.0) * _XKMPER
        if perigee < 156.0:
            s4 = perigee - 78.0 if perigee > 98.0 else 20.0
            qoms24 = ((120.0 - s4) / _XKMPER) ** 4
            s4 = s4 / _XKMPER + 1.0
        pinvsq = 1.0 / (self.aodp ** 2 * betao2 ** 2)
        tsi = 1.0 / (self.aodp - s4)
        self.eta = self.aodp * ecc * tsi
        etasq = self.eta ** 2
        eeta = ecc * self.eta
        psisq = abs(1.0 - etasq)
        coef = qoms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        c2 = coef1 * self.n0dp * (
            self.aodp * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.75 * _CK2 * tsi / psisq * x3thm1 *
            (8.0 + 3.0 * etasq * (8.0 + etasq)))
        self.c1 = tle.bstar * c2
        self.sinio = np.sin(incl)
        c3 = 0.0
        if ecc > 1e-4:
            c3 = coef * tsi * _A3OVK2 * self.n0dp * self.sinio / ecc
        self.c3 = c3
        self.omgcof = tle.bstar * c3 * np.cos(tle.argp)
        self.xmcof = 0.0
        if ecc > 1e-4:
            self.xmcof = -(2.0 / 3.0) * coef * tle.bstar / eeta
        x1mth2 = 1.0 - theta2
        self.c4 = 2.0 * self.n0dp * coef1 * self.aodp * betao2 * (
            self.eta * (2.0 + 0.5 * etasq)
            + ecc * (0.5 + 2.0 * etasq)
            - 2.0 * _CK2 * tsi / (self.aodp * psisq) *
            (-3.0 * x3thm1 * (1.0 - 2.0 * eeta + etasq *
                              (1.5 - 0.5 * eeta))
             + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq)) *
             np.cos(2.0 * tle.argp)))
        self.c5 = 2.0 * coef1 * self.aodp * betao2 * (
            1.0 + 2.75 * (etasq + eeta) + eeta * etasq)

        temp1 = 3.0 * _CK2 * pinvsq * self.n0dp
        temp2 = temp1 * _CK2 * pinvsq
        temp3 = 1.25 * _CK4 * pinvsq * pinvsq * self.n0dp
        self.mdot = (self.n0dp + 0.5 * temp1 * betao * x3thm1
                     + 0.0625 * temp2 * betao *
                     (13.0 - 78.0 * theta2 + 137.0 * theta2 ** 2))
        x1m5th = 1.0 - 5.0 * theta2
        self.omgdot = (-0.5 * temp1 * x1m5th + 0.0625 * temp2 *
                       (7.0 - 114.0 * theta2 + 395.0 * theta2 ** 2)
                       + temp3 * (3.0 - 36.0 * theta2 +
                                  49.0 * theta2 ** 2))
        xhdot1 = -temp1 * cosio
        self.xnodot = xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * theta2)
                                + 2.0 * temp3 * (3.0 - 7.0 * theta2)) \
            * cosio
        self.xnodcf = 3.5 * betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        self.xlcof = 0.125 * _A3OVK2 * self.sinio * \
            (3.0 + 5.0 * cosio) / (1.0 + cosio)
        self.aycof = 0.25 * _A3OVK2 * self.sinio
        self.delmo = (1.0 + self.eta * np.cos(tle.mean_anomaly)) ** 3
        self.sinmo = np.sin(tle.mean_anomaly)
        self.x7thm1 = 7.0 * theta2 - 1.0
        self.cosio = cosio
        self.theta2 = theta2
        self.x3thm1 = x3thm1
        self.x1mth2 = x1mth2

        self.isimp = (self.aodp * (1.0 - ecc) / 1.0) < \
            (220.0 / _XKMPER + 1.0)
        if not self.isimp:
            c1sq = self.c1 ** 2
            self.d2 = 4.0 * self.aodp * tsi * c1sq
            temp = self.d2 * tsi * self.c1 / 3.0
            self.d3 = (17.0 * self.aodp + s4) * temp
            self.d4 = 0.5 * temp * self.aodp * tsi * \
                (221.0 * self.aodp + 31.0 * s4) * self.c1
            self.t3cof = self.d2 + 2.0 * c1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.c1 *
                                 (12.0 * self.d2 + 10.0 * c1sq))
            self.t5cof = 0.2 * (3.0 * self.d4 + 12.0 * self.c1 *
                                self.d3 + 6.0 * self.d2 ** 2 +
                                15.0 * c1sq * (2.0 * self.d2 + c1sq))

        if self.deep_space:
            # SDP4: drop the high-order drag terms (isimp) and set up
            # the lunar-solar + resonance machinery
            self.isimp = True
            self._ds_init()

    def propagate(self, tsince: float) -> StateVector:
        """Propagate ``tsince`` minutes from epoch → km, km/s (TEME)."""
        if self.deep_space:
            return self._propagate_deep(tsince)
        tle = self.tle
        ecc = tle.ecc

        xmdf = tle.mean_anomaly + self.mdot * tsince
        omgadf = tle.argp + self.omgdot * tsince
        xnoddf = tle.raan + self.xnodot * tsince
        omega = omgadf
        xmp = xmdf
        tsq = tsince * tsince
        xnode = xnoddf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * tsince
        tempe = tle.bstar * self.c4 * tsince
        templ = self.t2cof * tsq
        if not self.isimp:
            delomg = self.omgcof * tsince
            delm = self.xmcof * (
                (1.0 + self.eta * np.cos(xmdf)) ** 3 - self.delmo)
            temp = delomg + delm
            xmp = xmdf + temp
            omega = omgadf - temp
            tcube = tsq * tsince
            tfour = tsince * tcube
            tempa = tempa - self.d2 * tsq - self.d3 * tcube - \
                self.d4 * tfour
            tempe = tempe + tle.bstar * self.c5 * \
                (np.sin(xmp) - self.sinmo)
            templ = templ + self.t3cof * tcube + tfour * \
                (self.t4cof + tsince * self.t5cof)
        a = self.aodp * tempa ** 2
        e = ecc - tempe
        e = min(max(e, 1e-6), 0.999999)
        xl = xmp + omega + xnode + self.n0dp * templ
        return self._orbital_to_state(a, e, xl, xnode, omega,
                                      self.tle.incl)

    def _orbital_to_state(self, a: float, e: float, xl: float,
                          xnode: float, omega: float,
                          incl: float) -> StateVector:
        """Long-period periodics + Kepler solve + short-period
        periodics → TEME state.  Shared by the near-earth and deep-space
        paths; the inclination-dependent constants are recomputed from
        ``incl`` because SDP4's lunar-solar periodics perturb it."""
        sinio = np.sin(incl)
        cosio = np.cos(incl)
        theta2 = cosio * cosio
        x3thm1 = 3.0 * theta2 - 1.0
        x1mth2 = 1.0 - theta2
        x7thm1 = 7.0 * theta2 - 1.0
        # denominator floor guards retrograde incl near 180 deg
        # (reachable since SDP4 periodics perturb incl per call)
        xlcof = 0.125 * _A3OVK2 * sinio * \
            (3.0 + 5.0 * cosio) / max(1.0 + cosio, 1.5e-12)
        aycof = 0.25 * _A3OVK2 * sinio
        beta = np.sqrt(1.0 - e * e)
        xn = _XKE / a ** 1.5

        # long period periodics
        axn = e * np.cos(omega)
        temp = 1.0 / (a * beta * beta)
        xll = temp * xlcof * axn
        aynl = temp * aycof
        xlt = xl + xll
        ayn = e * np.sin(omega) + aynl

        # Kepler solve for (E + omega)
        capu = np.fmod(xlt - xnode, _TWO_PI)
        epw = capu
        for _ in range(10):
            sinepw = np.sin(epw)
            cosepw = np.cos(epw)
            # solve capu = epw - axn*sin(epw) + ayn*cos(epw) (Newton)
            f = capu - epw + axn * sinepw - ayn * cosepw
            fdot = 1.0 - axn * cosepw - ayn * sinepw
            delta = f / fdot
            if abs(delta) > 0.95:
                delta = np.sign(delta) * 0.95
            epw = epw + delta
            if abs(delta) < 1e-12:
                break
        sinepw = np.sin(epw)
        cosepw = np.cos(epw)

        # short period preliminary quantities
        ecose = axn * cosepw + ayn * sinepw
        esine = axn * sinepw - ayn * cosepw
        elsq = axn * axn + ayn * ayn
        temp = 1.0 - elsq
        pl_ = a * temp
        r = a * (1.0 - ecose)
        temp1 = 1.0 / r
        rdot = _XKE * np.sqrt(a) * esine * temp1
        rfdot = _XKE * np.sqrt(pl_) * temp1
        temp2 = a * temp1
        betal = np.sqrt(temp)
        temp3 = 1.0 / (1.0 + betal)
        cosu = temp2 * (cosepw - axn + ayn * esine * temp3)
        sinu = temp2 * (sinepw - ayn - axn * esine * temp3)
        u = np.arctan2(sinu, cosu)
        sin2u = 2.0 * sinu * cosu
        cos2u = 2.0 * cosu * cosu - 1.0
        temp = 1.0 / pl_
        temp1 = _CK2 * temp
        temp2 = temp1 * temp

        # short period periodics
        rk = r * (1.0 - 1.5 * temp2 * betal * x3thm1) + \
            0.5 * temp1 * x1mth2 * cos2u
        uk = u - 0.25 * temp2 * x7thm1 * sin2u
        xnodek = xnode + 1.5 * temp2 * cosio * sin2u
        xinck = incl + 1.5 * temp2 * cosio * sinio * cos2u
        rdotk = rdot - xn * temp1 * x1mth2 * sin2u
        rfdotk = rfdot + xn * temp1 * (x1mth2 * cos2u +
                                       1.5 * x3thm1)

        # orientation vectors → position/velocity
        sinuk = np.sin(uk)
        cosuk = np.cos(uk)
        sinik = np.sin(xinck)
        cosik = np.cos(xinck)
        sinnok = np.sin(xnodek)
        cosnok = np.cos(xnodek)
        xmx = -sinnok * cosik
        xmy = cosnok * cosik
        ux = xmx * sinuk + cosnok * cosuk
        uy = xmy * sinuk + sinnok * cosuk
        uz = sinik * sinuk
        vx = xmx * cosuk - cosnok * sinuk
        vy = xmy * cosuk - sinnok * sinuk
        vz = sinik * cosuk

        pos = rk * np.array([ux, uy, uz]) * _XKMPER
        vel = (rdotk * np.array([ux, uy, uz]) +
               rfdotk * np.array([vx, vy, vz])) * _XKMPER / 60.0
        return StateVector(position=pos, velocity=vel)


    # -- SDP4 deep-space extension -------------------------------------
    # Lunar-solar secular + periodic terms and the 12 h / 24 h
    # geopotential resonance integrator, per Spacetrack Report #3 /
    # Vallado's revisited formulation (public equations; the reference
    # links the sgdp4 C library as a binary dependency,
    # include/Suscan/Library.h:154-250).

    _ZNS = 1.19459e-5
    _ZES = 0.01675
    _ZNL = 1.5835218e-4
    _ZEL = 0.05490
    _RPTIM = 4.37526908801129966e-3   # earth rotation, rad/min
    _STEP = 720.0                     # resonance integrator step, min

    def _ds_init(self) -> None:
        tle = self.tle
        ecco, inclo = tle.ecc, tle.incl
        nodeo, argpo, mo = tle.raan, tle.argp, tle.mean_anomaly
        no = self.n0dp
        emsq = ecco * ecco
        sinim, cosim = np.sin(inclo), np.cos(inclo)
        snodm, cnodm = np.sin(nodeo), np.cos(nodeo)
        sinomm, cosomm = np.sin(argpo), np.cos(argpo)
        betasq = 1.0 - emsq
        rtemsq = np.sqrt(betasq)
        self.gsto = gmst(tle.epoch_unix)

        # ---- dscom: lunar & solar geometry at epoch ----
        # days since 1900 Jan 0.5 (JD 2415020.0) — the epoch the
        # Spacetrack/Vallado lunar-solar polynomials (xnodce, gam,
        # zmol, zmos) are referenced to
        day = tle.epoch_unix / 86400.0 + 2440587.5 - 2415020.0
        xnodce = np.fmod(4.5236020 - 9.2422029e-4 * day, _TWO_PI)
        stem, ctem = np.sin(xnodce), np.cos(xnodce)
        zcosil = 0.91375164 - 0.03568096 * ctem
        zsinil = np.sqrt(1.0 - zcosil * zcosil)
        zsinhl = 0.089683511 * stem / zsinil
        zcoshl = np.sqrt(1.0 - zsinhl * zsinhl)
        gam = 5.8351514 + 0.0019443680 * day
        zx = 0.39785416 * stem / zsinil
        zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
        zx = gam + np.arctan2(zx, zy) - xnodce
        zcosgl, zsingl = np.cos(zx), np.sin(zx)

        # two passes: solar then lunar
        zcosg, zsing = 0.1945905, -0.98088458     # zcosgs, zsings
        zcosi, zsini = 0.91744867, 0.39785416     # zcosis, zsinis
        zcosh, zsinh = cnodm, snodm
        cc = 2.9864797e-6                         # c1ss
        xnoi = 1.0 / no
        ss = sz = None
        for lsflg in (1, 2):
            a1 = zcosg * zcosh + zsing * zcosi * zsinh
            a3 = -zsing * zcosh + zcosg * zcosi * zsinh
            a7 = -zcosg * zsinh + zsing * zcosi * zcosh
            a8 = zsing * zsini
            a9 = zsing * zsinh + zcosg * zcosi * zcosh
            a10 = zcosg * zsini
            a2 = cosim * a7 + sinim * a8
            a4 = cosim * a9 + sinim * a10
            a5 = -sinim * a7 + cosim * a8
            a6 = -sinim * a9 + cosim * a10

            x1 = a1 * cosomm + a2 * sinomm
            x2 = a3 * cosomm + a4 * sinomm
            x3 = -a1 * sinomm + a2 * cosomm
            x4 = -a3 * sinomm + a4 * cosomm
            x5 = a5 * sinomm
            x6 = a6 * sinomm
            x7 = a5 * cosomm
            x8 = a6 * cosomm

            z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
            z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
            z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
            z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
            z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
            z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
            z11 = -6.0 * a1 * a5 + emsq * \
                (-24.0 * x1 * x7 - 6.0 * x3 * x5)
            z12 = (-6.0 * (a1 * a6 + a3 * a5) + emsq *
                   (-24.0 * (x2 * x7 + x1 * x8)
                    - 6.0 * (x3 * x6 + x4 * x5)))
            z13 = -6.0 * a3 * a6 + emsq * \
                (-24.0 * x2 * x8 - 6.0 * x4 * x6)
            z21 = 6.0 * a2 * a5 + emsq * \
                (24.0 * x1 * x5 - 6.0 * x3 * x7)
            z22 = (6.0 * (a4 * a5 + a2 * a6) + emsq *
                   (24.0 * (x2 * x5 + x1 * x6)
                    - 6.0 * (x4 * x7 + x3 * x8)))
            z23 = 6.0 * a4 * a6 + emsq * \
                (24.0 * x2 * x6 - 6.0 * x4 * x8)
            z1 = z1 + z1 + betasq * z31
            z2 = z2 + z2 + betasq * z32
            z3 = z3 + z3 + betasq * z33
            s3 = cc * xnoi
            s2 = -0.5 * s3 / rtemsq
            s4 = s3 * rtemsq
            s1 = -15.0 * ecco * s4
            s5 = x1 * x3 + x2 * x4
            s6 = x2 * x3 + x1 * x4
            s7 = x2 * x4 - x1 * x3
            if lsflg == 1:
                ss = (s1, s2, s3, s4, s5, s6, s7)
                sz = (z1, z2, z3, z11, z12, z13,
                      z21, z22, z23, z31, z32, z33)
                zcosg, zsing = zcosgl, zsingl
                zcosi, zsini = zcosil, zsinil
                zcosh = cnodm * zcoshl + snodm * zsinhl
                zsinh = snodm * zcoshl - cnodm * zsinhl
                cc = 4.7968065e-7                 # c1l
        ss1, ss2, ss3, ss4, ss5, ss6, ss7 = ss
        (sz1, sz2, sz3, sz11, sz12, sz13,
         sz21, sz22, sz23, sz31, sz32, sz33) = sz

        self.zmol = np.fmod(4.7199672 + 0.22997150 * day - gam, _TWO_PI)
        self.zmos = np.fmod(6.2565837 + 0.017201977 * day, _TWO_PI)

        # periodic coefficients (solar s*, lunar x*/e*)
        zes, zel = self._ZES, self._ZEL
        self.se2 = 2.0 * ss1 * ss6
        self.se3 = 2.0 * ss1 * ss7
        self.si2 = 2.0 * ss2 * sz12
        self.si3 = 2.0 * ss2 * (sz13 - sz11)
        self.sl2 = -2.0 * ss3 * sz2
        self.sl3 = -2.0 * ss3 * (sz3 - sz1)
        self.sl4 = -2.0 * ss3 * (-21.0 - 9.0 * emsq) * zes
        self.sgh2 = 2.0 * ss4 * sz32
        self.sgh3 = 2.0 * ss4 * (sz33 - sz31)
        self.sgh4 = -18.0 * ss4 * zes
        self.sh2 = -2.0 * ss2 * sz22
        self.sh3 = -2.0 * ss2 * (sz23 - sz21)
        self.ee2 = 2.0 * s1 * s6
        self.e3 = 2.0 * s1 * s7
        self.xi2 = 2.0 * s2 * z12
        self.xi3 = 2.0 * s2 * (z13 - z11)
        self.xl2 = -2.0 * s3 * z2
        self.xl3 = -2.0 * s3 * (z3 - z1)
        self.xl4 = -2.0 * s3 * (-21.0 - 9.0 * emsq) * zel
        self.xgh2 = 2.0 * s4 * z32
        self.xgh3 = 2.0 * s4 * (z33 - z31)
        self.xgh4 = -18.0 * s4 * zel
        self.xh2 = -2.0 * s2 * z22
        self.xh3 = -2.0 * s2 * (z23 - z21)

        # ---- dsinit: secular rates + resonance terms ----
        zns, znl = self._ZNS, self._ZNL
        ses = ss1 * zns * ss5
        sis = ss2 * zns * (sz11 + sz13)
        sls = -zns * ss3 * (sz1 + sz3 - 14.0 - 6.0 * emsq)
        sghs = ss4 * zns * (sz31 + sz33 - 6.0)
        shs = -zns * ss2 * (sz21 + sz23)
        polar = inclo < 5.2359877e-2 or inclo > np.pi - 5.2359877e-2
        if polar:
            shs = 0.0
        if sinim != 0.0:
            shs = shs / sinim
        sgs = sghs - cosim * shs

        self.dedt = ses + s1 * znl * s5
        self.didt = sis + s2 * znl * (z11 + z13)
        self.dmdt = sls - znl * s3 * (z1 + z3 - 14.0 - 6.0 * emsq)
        sghl = s4 * znl * (z31 + z33 - 6.0)
        shll = -znl * s2 * (z21 + z23)
        if polar:
            shll = 0.0
        self.domdt = sgs + sghl
        self.dnodt = shs
        if sinim != 0.0:
            self.domdt -= cosim / sinim * shll
            self.dnodt += shll / sinim

        # resonance classification
        self.irez = 0
        if 0.0034906585 < no < 0.0052359877:
            self.irez = 1                          # 24 h (geosync)
        if 8.26e-3 <= no <= 9.24e-3 and ecco >= 0.5:
            self.irez = 2                          # 12 h (Molniya)

        theta = np.fmod(self.gsto, _TWO_PI)
        aonv = (no / _XKE) ** (2.0 / 3.0)          # 1/a, earth radii
        em = ecco
        eoc = em * emsq
        xpidot = self.omgdot + self.xnodot
        if self.irez == 2:
            root22, root32 = 1.7891679e-6, 3.7393792e-7
            root44, root52 = 7.3636953e-9, 1.1428639e-7
            root54 = 2.1765803e-9
            g201 = -0.306 - (em - 0.64) * 0.440
            if em <= 0.65:
                g211 = 3.616 - 13.2470 * em + 16.2900 * emsq
                g310 = (-19.302 + 117.3900 * em - 228.4190 * emsq
                        + 156.5910 * eoc)
                g322 = (-18.9068 + 109.7927 * em - 214.6334 * emsq
                        + 146.5816 * eoc)
                g410 = (-41.122 + 242.6940 * em - 471.0940 * emsq
                        + 313.9530 * eoc)
                g422 = (-146.407 + 841.8800 * em - 1629.014 * emsq
                        + 1083.4350 * eoc)
                g520 = (-532.114 + 3017.977 * em - 5740.032 * emsq
                        + 3708.2760 * eoc)
            else:
                g211 = (-72.099 + 331.819 * em - 508.738 * emsq
                        + 266.724 * eoc)
                g310 = (-346.844 + 1582.851 * em - 2415.925 * emsq
                        + 1246.113 * eoc)
                g322 = (-342.585 + 1554.908 * em - 2366.899 * emsq
                        + 1215.972 * eoc)
                g410 = (-1052.797 + 4758.686 * em - 7193.992 * emsq
                        + 3651.957 * eoc)
                g422 = (-3581.690 + 16178.110 * em - 24462.770 * emsq
                        + 12422.520 * eoc)
                if em > 0.715:
                    g520 = (-5149.66 + 29936.92 * em - 54087.36 * emsq
                            + 31324.56 * eoc)
                else:
                    g520 = 1464.74 - 4664.75 * em + 3763.64 * emsq
            if em < 0.7:
                g533 = (-919.22770 + 4988.6100 * em - 9064.7700 * emsq
                        + 5542.21 * eoc)
                g521 = (-822.71072 + 4568.6173 * em - 8491.4146 * emsq
                        + 5337.524 * eoc)
                g532 = (-853.66600 + 4690.2500 * em - 8624.7700 * emsq
                        + 5341.4 * eoc)
            else:
                g533 = (-37995.780 + 161616.52 * em - 229838.20 * emsq
                        + 109377.94 * eoc)
                g521 = (-51752.104 + 218913.95 * em - 309468.16 * emsq
                        + 146349.42 * eoc)
                g532 = (-40023.880 + 170470.89 * em - 242699.48 * emsq
                        + 115605.82 * eoc)
            sini2 = sinim * sinim
            cosisq = cosim * cosim
            f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
            f221 = 1.5 * sini2
            f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
            f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
            f441 = 35.0 * sini2 * f220
            f442 = 39.3750 * sini2 * sini2
            f522 = 9.84375 * sinim * (
                sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
                + 0.33333333 * (-2.0 + 4.0 * cosim + 6.0 * cosisq))
            f523 = sinim * (
                4.92187512 * sini2 * (-2.0 - 4.0 * cosim
                                      + 10.0 * cosisq)
                + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq))
            f542 = 29.53125 * sinim * (
                2.0 - 8.0 * cosim
                + cosisq * (-12.0 + 8.0 * cosim + 10.0 * cosisq))
            f543 = 29.53125 * sinim * (
                -2.0 - 8.0 * cosim
                + cosisq * (12.0 + 8.0 * cosim - 10.0 * cosisq))
            xno2 = no * no
            ainv2 = aonv * aonv
            temp1 = 3.0 * xno2 * ainv2
            temp = temp1 * root22
            self.d2201 = temp * f220 * g201
            self.d2211 = temp * f221 * g211
            temp1 *= aonv
            temp = temp1 * root32
            self.d3210 = temp * f321 * g310
            self.d3222 = temp * f322 * g322
            temp1 *= aonv
            temp = 2.0 * temp1 * root44
            self.d4410 = temp * f441 * g410
            self.d4422 = temp * f442 * g422
            temp1 *= aonv
            temp = temp1 * root52
            self.d5220 = temp * f522 * g520
            self.d5232 = temp * f523 * g532
            temp = 2.0 * temp1 * root54
            self.d5421 = temp * f542 * g521
            self.d5433 = temp * f543 * g533
            self.xlamo = np.fmod(
                mo + 2.0 * nodeo - 2.0 * theta, _TWO_PI)
            self.xfact = (self.mdot + self.dmdt
                          + 2.0 * (self.xnodot + self.dnodt
                                   - self._RPTIM) - no)
        elif self.irez == 1:
            q22, q31, q33 = 1.7891679e-6, 2.1460748e-6, 2.2123015e-7
            g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
            g310 = 1.0 + 2.0 * emsq
            g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
            f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim)
            f311 = (0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
                    - 0.75 * (1.0 + cosim))
            f330 = 1.0 + cosim
            f330 = 1.875 * f330 * f330 * f330
            del1 = 3.0 * no * no * aonv * aonv
            self.del2 = 2.0 * del1 * f220 * g200 * q22
            self.del3 = 3.0 * del1 * f330 * g300 * q33 * aonv
            self.del1 = del1 * f311 * g310 * q31 * aonv
            self.xlamo = np.fmod(mo + nodeo + argpo - theta, _TWO_PI)
            self.xfact = (self.mdot + xpidot - self._RPTIM
                          + self.dmdt + self.domdt + self.dnodt - no)
        if self.irez != 0:
            self.xli = self.xlamo
            self.xni = no
            self.atime = 0.0

    def _dspace(self, t: float) -> tuple[float, ...]:
        """Deep-space secular effects + resonance integrator →
        (em, inclm, nodem_delta, argpm_delta, mm, nm)."""
        tle = self.tle
        no = self.n0dp
        em = tle.ecc + self.dedt * t
        inclm = tle.incl + self.didt * t
        d_node = self.dnodt * t
        d_argp = self.domdt * t
        mm_extra = self.dmdt * t
        nm = no
        xl_mm = None

        if self.irez != 0:
            theta = np.fmod(self.gsto + t * self._RPTIM, _TWO_PI)
            # Euler-Maclaurin integrator restart rules
            if (self.atime == 0.0 or t * self.atime <= 0.0
                    or abs(t) < abs(self.atime)):
                self.atime = 0.0
                self.xni = no
                self.xli = self.xlamo
            delt = self._STEP if t > 0.0 else -self._STEP
            step2 = self._STEP * self._STEP * 0.5
            fasx2, fasx4, fasx6 = 0.13130908, 2.8843198, 0.37448087
            g22, g32 = 5.7686396, 0.95240898
            g44, g52, g54 = 1.8014998, 1.0508330, 4.4108898
            ft = 0.0
            while True:
                xli, xni = self.xli, self.xni
                if self.irez != 2:
                    xndt = (self.del1 * np.sin(xli - fasx2)
                            + self.del2 * np.sin(2.0 * (xli - fasx4))
                            + self.del3 * np.sin(3.0 * (xli - fasx6)))
                    xldot = xni + self.xfact
                    xnddt = (self.del1 * np.cos(xli - fasx2)
                             + 2.0 * self.del2 *
                             np.cos(2.0 * (xli - fasx4))
                             + 3.0 * self.del3 *
                             np.cos(3.0 * (xli - fasx6)))
                    xnddt *= xldot
                else:
                    xomi = tle.argp + self.omgdot * self.atime
                    x2omi = 2.0 * xomi
                    x2li = 2.0 * xli
                    xndt = (self.d2201 * np.sin(x2omi + xli - g22)
                            + self.d2211 * np.sin(xli - g22)
                            + self.d3210 * np.sin(xomi + xli - g32)
                            + self.d3222 * np.sin(-xomi + xli - g32)
                            + self.d4410 * np.sin(x2omi + x2li - g44)
                            + self.d4422 * np.sin(x2li - g44)
                            + self.d5220 * np.sin(xomi + xli - g52)
                            + self.d5232 * np.sin(-xomi + xli - g52)
                            + self.d5421 * np.sin(xomi + x2li - g54)
                            + self.d5433 * np.sin(-xomi + x2li - g54))
                    xldot = xni + self.xfact
                    xnddt = (self.d2201 * np.cos(x2omi + xli - g22)
                             + self.d2211 * np.cos(xli - g22)
                             + self.d3210 * np.cos(xomi + xli - g32)
                             + self.d3222 * np.cos(-xomi + xli - g32)
                             + self.d5220 * np.cos(xomi + xli - g52)
                             + self.d5232 * np.cos(-xomi + xli - g52)
                             + 2.0 * (self.d4410 *
                                      np.cos(x2omi + x2li - g44)
                                      + self.d4422 * np.cos(x2li - g44)
                                      + self.d5421 *
                                      np.cos(xomi + x2li - g54)
                                      + self.d5433 *
                                      np.cos(-xomi + x2li - g54)))
                    xnddt *= xldot
                if abs(t - self.atime) < self._STEP:
                    ft = t - self.atime
                    break
                self.xli += xldot * delt + xndt * step2
                self.xni += xndt * delt + xnddt * step2
                self.atime += delt
            nm = self.xni + xndt * ft + xnddt * ft * ft * 0.5
            xl = self.xli + xldot * ft + xndt * ft * ft * 0.5
            xl_mm = (xl, theta)
        return em, inclm, d_node, d_argp, mm_extra, nm, xl_mm

    def _dpper(self, t: float, ep: float, inclp: float, nodep: float,
               argpp: float, mp: float
               ) -> tuple[float, float, float, float, float]:
        """Lunar-solar periodics at time t (applied, not epoch-
        differenced — the standard sgp4fix convention)."""
        zns, zes = self._ZNS, self._ZES
        znl, zel = self._ZNL, self._ZEL
        zm = self.zmos + zns * t
        zf = zm + 2.0 * zes * np.sin(zm)
        sinzf = np.sin(zf)
        f2 = 0.5 * sinzf * sinzf - 0.25
        f3 = -0.5 * sinzf * np.cos(zf)
        ses = self.se2 * f2 + self.se3 * f3
        sis = self.si2 * f2 + self.si3 * f3
        sls = self.sl2 * f2 + self.sl3 * f3 + self.sl4 * sinzf
        sghs = self.sgh2 * f2 + self.sgh3 * f3 + self.sgh4 * sinzf
        shs = self.sh2 * f2 + self.sh3 * f3
        zm = self.zmol + znl * t
        zf = zm + 2.0 * zel * np.sin(zm)
        sinzf = np.sin(zf)
        f2 = 0.5 * sinzf * sinzf - 0.25
        f3 = -0.5 * sinzf * np.cos(zf)
        sel = self.ee2 * f2 + self.e3 * f3
        sil = self.xi2 * f2 + self.xi3 * f3
        sll = self.xl2 * f2 + self.xl3 * f3 + self.xl4 * sinzf
        sghl = self.xgh2 * f2 + self.xgh3 * f3 + self.xgh4 * sinzf
        shll = self.xh2 * f2 + self.xh3 * f3
        pe = ses + sel
        pinc = sis + sil
        pl = sls + sll
        pgh = sghs + sghl
        ph = shs + shll

        inclp += pinc
        ep += pe
        sinip, cosip = np.sin(inclp), np.cos(inclp)
        if inclp >= 0.2:
            ph /= sinip
            pgh -= cosip * ph
            argpp += pgh
            nodep += ph
            mp += pl
        else:
            # Lyddane modification for low inclination
            sinop, cosop = np.sin(nodep), np.cos(nodep)
            alfdp = sinip * sinop
            betdp = sinip * cosop
            dalf = ph * cosop + pinc * cosip * sinop
            dbet = -ph * sinop + pinc * cosip * cosop
            alfdp += dalf
            betdp += dbet
            nodep = np.fmod(nodep, _TWO_PI)
            if nodep < 0.0:
                nodep += _TWO_PI
            xls = mp + argpp + cosip * nodep \
                + pl + pgh - pinc * nodep * sinip
            xnoh = nodep
            nodep = np.arctan2(alfdp, betdp)
            if nodep < 0.0:
                nodep += _TWO_PI
            if abs(xnoh - nodep) > np.pi:
                nodep += _TWO_PI if nodep < xnoh else -_TWO_PI
            mp += pl
            argpp = xls - mp - cosip * nodep
        return ep, inclp, nodep, argpp, mp

    def _propagate_deep(self, tsince: float) -> StateVector:
        """SDP4 propagation path (period >= 225 min)."""
        tle = self.tle
        t = float(tsince)
        xmdf = tle.mean_anomaly + self.mdot * t
        argpdf = tle.argp + self.omgdot * t
        nodedf = tle.raan + self.xnodot * t
        tsq = t * t
        nodem = nodedf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * t
        tempe = tle.bstar * self.c4 * t
        templ = self.t2cof * tsq

        em, inclm, d_node, d_argp, mm_extra, nm, xl_mm = self._dspace(t)
        argpm = argpdf + d_argp
        nodem += d_node
        mm = xmdf + mm_extra
        if xl_mm is not None:
            xl, theta = xl_mm
            if self.irez != 1:
                mm = xl - 2.0 * nodem + 2.0 * theta
            else:
                mm = xl - nodem - argpm + theta

        if nm <= 0.0:
            raise ValueError("sdp4: mean motion collapsed")
        am = (_XKE / nm) ** (2.0 / 3.0) * tempa * tempa
        nm = _XKE / am ** 1.5
        em -= tempe
        em = min(max(em, 1e-6), 0.999999)
        mm += self.n0dp * templ
        xlm = mm + argpm + nodem
        nodem = np.fmod(nodem, _TWO_PI)
        argpm = np.fmod(argpm, _TWO_PI)
        xlm = np.fmod(xlm, _TWO_PI)
        mm = np.fmod(xlm - argpm - nodem, _TWO_PI)

        ep, xincp, nodep, argpp, mp = self._dpper(
            t, em, inclm, nodem, argpm, mm)
        if xincp < 0.0:
            xincp = -xincp
            nodep += np.pi
            argpp -= np.pi
        ep = min(max(ep, 1e-6), 0.999999)
        xl = mp + argpp + nodep
        return self._orbital_to_state(am, ep, xl, nodep, argpp, xincp)


# ---------------------------------------------------------------------------
# Observer geometry: site position, range rate, Doppler
# ---------------------------------------------------------------------------

def gmst(unix_time: float) -> float:
    """Greenwich mean sidereal time (radians) from unix seconds."""
    jd = unix_time / 86400.0 + 2440587.5
    t = (jd - 2451545.0) / 36525.0
    g = (67310.54841 + (876600.0 * 3600.0 + 8640184.812866) * t
         + 0.093104 * t * t - 6.2e-6 * t ** 3)
    return np.fmod(np.deg2rad(np.fmod(g / 240.0, 360.0)), _TWO_PI)


def site_teme(lat_deg: float, lon_deg: float, alt_km: float,
              unix_time: float) -> tuple[np.ndarray, np.ndarray]:
    """Observer position/velocity in TEME (km, km/s)."""
    lat = np.deg2rad(lat_deg)
    theta = gmst(unix_time) + np.deg2rad(lon_deg)
    # WGS-72 oblate site vector
    f = 1.0 / 298.26
    c = 1.0 / np.sqrt(1.0 + f * (f - 2.0) * np.sin(lat) ** 2)
    s = (1.0 - f) ** 2 * c
    achcp = (_XKMPER * c + alt_km) * np.cos(lat)
    pos = np.array([achcp * np.cos(theta), achcp * np.sin(theta),
                    (_XKMPER * s + alt_km) * np.sin(lat)])
    vel = np.cross([0.0, 0.0, _EARTH_ROT], pos)
    return pos, vel


@dataclass
class PassInfo:
    range_km: float
    range_rate_kms: float
    doppler_hz: float            # at the given downlink frequency
    elevation_deg: float
    azimuth_deg: float


class OrbitPredictor:
    """Satellite Doppler/el/az prediction for a ground site — the
    engine behind the reference's frequency-correction dialog."""

    def __init__(self, tle: TLE, lat_deg: float, lon_deg: float,
                 alt_km: float = 0.0) -> None:
        self.tle = tle
        self.model = SGP4(tle)
        self.site = (lat_deg, lon_deg, alt_km)

    def predict(self, unix_time: float, freq_hz: float) -> PassInfo:
        tsince = (unix_time - self.tle.epoch_unix) / 60.0
        sv = self.model.propagate(tsince)
        rs, vs = site_teme(*self.site, unix_time)
        rel = sv.position - rs
        relv = sv.velocity - vs
        rng = float(np.linalg.norm(rel))
        rate = float(np.dot(rel, relv) / rng)
        dopp = -rate * 1000.0 / SPEED_OF_LIGHT * freq_hz

        # topocentric el/az (SEZ frame)
        lat = np.deg2rad(self.site[0])
        theta = gmst(unix_time) + np.deg2rad(self.site[1])
        sin_lat, cos_lat = np.sin(lat), np.cos(lat)
        sin_th, cos_th = np.sin(theta), np.cos(theta)
        top_s = (sin_lat * cos_th * rel[0] + sin_lat * sin_th * rel[1]
                 - cos_lat * rel[2])
        top_e = -sin_th * rel[0] + cos_th * rel[1]
        top_z = (cos_lat * cos_th * rel[0] + cos_lat * sin_th * rel[1]
                 + sin_lat * rel[2])
        el = np.rad2deg(np.arcsin(np.clip(top_z / rng, -1.0, 1.0)))
        az = np.rad2deg(np.arctan2(top_e, -top_s)) % 360.0
        return PassInfo(range_km=rng, range_rate_kms=rate,
                        doppler_hz=dopp, elevation_deg=float(el),
                        azimuth_deg=float(az))
