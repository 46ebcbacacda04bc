"""Satellite orbits of the port (counterpart of ``sigdigger_tpu/orbit``):
TLE parsing and the SGP4/SDP4 predictor behind Doppler correction.
Host-side float64 numpy, evaluated once per block or UI tick; nothing of
it runs on the card."""

from sigdigger_tpu_torch.orbit.sgp4 import (
    SGP4,
    OrbitPredictor,
    PassInfo,
    StateVector,
    gmst,
    site_teme,
)
from sigdigger_tpu_torch.orbit.tle import TLE, parse_tle

__all__ = [
    "SGP4",
    "OrbitPredictor",
    "PassInfo",
    "StateVector",
    "TLE",
    "gmst",
    "parse_tle",
    "site_teme",
]
