"""SoapySDR live-device source via ctypes (counterpart of
``sigdigger_tpu/sources/soapy.py``).

The reference captures from real radios through SoapySDR (reference
include/Suscan/Source.h:69-120 `soapysdr` source type; device facade
include/Suscan/Device.h:78-150).  This binding targets the stable
SoapySDR C ABI (libSoapySDR.so.0.8): enumerate → makeStrArgs →
setSampleRate/setFrequency/setGain → setupStream(CF32) → readStream.
The library handle is injectable so CI exercises the full ctypes path
against a compiled mock .so (tests/test_hw_backends.py); on machines
without SoapySDR, enumeration is empty and opening raises.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from sigdigger_tpu_torch.device import (
    DeviceFacade,
    DeviceGainDesc,
    DeviceProperties,
)
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource

SOAPY_SDR_RX = 1
SOAPY_SDR_TIMEOUT = -1
SOAPY_SDR_OVERFLOW = -2
_READ_TIMEOUT_US = 500_000


class SoapyKwargs(ctypes.Structure):
    _fields_ = [("size", ctypes.c_size_t),
                ("keys", ctypes.POINTER(ctypes.c_char_p)),
                ("vals", ctypes.POINTER(ctypes.c_char_p))]


class SoapyRange(ctypes.Structure):
    _fields_ = [("minimum", ctypes.c_double),
                ("maximum", ctypes.c_double),
                ("step", ctypes.c_double)]


def load_soapy(path: str | None = None) -> ctypes.CDLL | None:
    """Load libSoapySDR; None when absent."""
    candidates = [path] if path else [
        ctypes.util.find_library("SoapySDR"),
        "libSoapySDR.so.0.8", "libSoapySDR.so"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        _declare(lib)
        return lib
    return None


def _declare(lib: ctypes.CDLL) -> None:
    lib.SoapySDRDevice_enumerate.argtypes = [
        ctypes.POINTER(SoapyKwargs), ctypes.POINTER(ctypes.c_size_t)]
    lib.SoapySDRDevice_enumerate.restype = ctypes.POINTER(SoapyKwargs)
    lib.SoapySDRKwargsList_clear.argtypes = [
        ctypes.POINTER(SoapyKwargs), ctypes.c_size_t]
    lib.SoapySDRKwargsList_clear.restype = None
    lib.SoapySDRDevice_makeStrArgs.argtypes = [ctypes.c_char_p]
    lib.SoapySDRDevice_makeStrArgs.restype = ctypes.c_void_p
    lib.SoapySDRDevice_unmake.argtypes = [ctypes.c_void_p]
    lib.SoapySDRDevice_unmake.restype = ctypes.c_int
    lib.SoapySDRDevice_setSampleRate.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
    lib.SoapySDRDevice_setSampleRate.restype = ctypes.c_int
    lib.SoapySDRDevice_setFrequency.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double,
        ctypes.POINTER(SoapyKwargs)]
    lib.SoapySDRDevice_setFrequency.restype = ctypes.c_int
    lib.SoapySDRDevice_setGain.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
    lib.SoapySDRDevice_setGain.restype = ctypes.c_int
    lib.SoapySDRDevice_setGainElement.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_double]
    lib.SoapySDRDevice_setGainElement.restype = ctypes.c_int
    lib.SoapySDRDevice_setAntenna.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p]
    lib.SoapySDRDevice_setAntenna.restype = ctypes.c_int
    lib.SoapySDRDevice_listGains.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    lib.SoapySDRDevice_listGains.restype = \
        ctypes.POINTER(ctypes.c_char_p)
    lib.SoapySDRDevice_getGainElementRange.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p]
    lib.SoapySDRDevice_getGainElementRange.restype = SoapyRange
    lib.SoapySDRDevice_setupStream.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t,
        ctypes.POINTER(SoapyKwargs)]
    lib.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
    lib.SoapySDRDevice_activateStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_size_t]
    lib.SoapySDRDevice_activateStream.restype = ctypes.c_int
    lib.SoapySDRDevice_deactivateStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
    lib.SoapySDRDevice_deactivateStream.restype = ctypes.c_int
    lib.SoapySDRDevice_closeStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.SoapySDRDevice_closeStream.restype = ctypes.c_int
    lib.SoapySDRDevice_readStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long]
    lib.SoapySDRDevice_readStream.restype = ctypes.c_int
    lib.SoapySDRDevice_lastError.argtypes = []
    lib.SoapySDRDevice_lastError.restype = ctypes.c_char_p


class SoapyError(RuntimeError):
    pass


def _kwargs_to_dict(kw: SoapyKwargs) -> dict[str, str]:
    out: dict[str, str] = {}
    for i in range(kw.size):
        key = kw.keys[i]
        val = kw.vals[i]
        out[key.decode() if key else ""] = val.decode() if val else ""
    return out


def _dict_to_strargs(spec: dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(spec.items()))


def enumerate_devices(lib: ctypes.CDLL | None = None
                      ) -> list[dict[str, str]]:
    """Device kwargs dicts, one per attached radio."""
    lib = lib or load_soapy()
    if lib is None:
        return []
    length = ctypes.c_size_t(0)
    arr = lib.SoapySDRDevice_enumerate(None, ctypes.byref(length))
    if not arr:
        return []
    found = [_kwargs_to_dict(arr[i]) for i in range(length.value)]
    lib.SoapySDRKwargsList_clear(arr, length.value)
    return found


def soapy_discoverer(lib: ctypes.CDLL | None = None
                     ) -> list[DeviceProperties]:
    """DeviceFacade discoverer: SoapySDR kwargs → DeviceProperties
    (reference Device.h gain descriptors filled from
    listGains/getGainElementRange)."""
    lib = lib or load_soapy()
    if lib is None:
        return []
    devices: list[DeviceProperties] = []
    for spec in enumerate_devices(lib):
        props = DeviceProperties(
            label=spec.get("label", spec.get("driver", "SDR")),
            driver="soapysdr", spec=spec, freq_min=0.0, freq_max=6e9)
        dev = lib.SoapySDRDevice_makeStrArgs(
            _dict_to_strargs(spec).encode())
        if dev:
            try:
                ngains = ctypes.c_size_t(0)
                names = lib.SoapySDRDevice_listGains(
                    dev, SOAPY_SDR_RX, 0, ctypes.byref(ngains))
                for i in range(ngains.value):
                    name = names[i].decode() if names[i] else ""
                    rng = lib.SoapySDRDevice_getGainElementRange(
                        dev, SOAPY_SDR_RX, 0, name.encode())
                    props.gains.append(DeviceGainDesc(
                        name=name, min=rng.minimum, max=rng.maximum,
                        step=rng.step or 1.0))
            finally:
                lib.SoapySDRDevice_unmake(dev)
        devices.append(props)
    return devices


class SoapySource(SignalSource):
    """Live SDR capture source (profile.type == "soapysdr").

    The profile's ``device`` dict selects the radio (driver=..., etc.);
    ``gains``/``antenna``/``freq``/``sample_rate`` map to the
    corresponding SoapySDR calls, mirroring the reference's source
    open sequence (reference Suscan source_config → suscan_source_open).
    """

    def __init__(self, profile: SourceProfile,
                 lib: ctypes.CDLL | None = None) -> None:
        super().__init__(profile)
        self._lib = lib or load_soapy()
        if self._lib is None:
            raise SoapyError("libSoapySDR not available")
        self._dev = self._lib.SoapySDRDevice_makeStrArgs(
            _dict_to_strargs(profile.device).encode())
        if not self._dev:
            raise SoapyError(f"make: {self._last_error()}")
        lib_ = self._lib
        if lib_.SoapySDRDevice_setSampleRate(
                self._dev, SOAPY_SDR_RX, 0,
                float(profile.sample_rate)) != 0:
            raise SoapyError(f"setSampleRate: {self._last_error()}")
        self.set_frequency(profile.freq)
        if profile.antenna:
            lib_.SoapySDRDevice_setAntenna(
                self._dev, SOAPY_SDR_RX, 0, profile.antenna.encode())
        for name, value in profile.gains.items():
            lib_.SoapySDRDevice_setGainElement(
                self._dev, SOAPY_SDR_RX, 0, name.encode(), float(value))
        chan = ctypes.c_size_t(0)
        self._stream = lib_.SoapySDRDevice_setupStream(
            self._dev, SOAPY_SDR_RX, b"CF32", ctypes.byref(chan), 1, None)
        if not self._stream:
            raise SoapyError(f"setupStream: {self._last_error()}")
        if lib_.SoapySDRDevice_activateStream(
                self._dev, self._stream, 0, 0, 0) != 0:
            raise SoapyError(f"activateStream: {self._last_error()}")
        self.overflows = 0

    def _last_error(self) -> str:
        msg = self._lib.SoapySDRDevice_lastError()
        return msg.decode() if msg else "unknown"

    def set_frequency(self, freq: float) -> None:
        if self._lib.SoapySDRDevice_setFrequency(
                self._dev, SOAPY_SDR_RX, 0,
                float(freq) - self.profile.lnb_freq, None) != 0:
            raise SoapyError(f"setFrequency: {self._last_error()}")
        self.profile.freq = float(freq)

    def set_gain(self, value: float) -> None:
        self._lib.SoapySDRDevice_setGain(
            self._dev, SOAPY_SDR_RX, 0, float(value))

    def _read_impl(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.complex64)
        got = 0
        flags = ctypes.c_int(0)
        time_ns = ctypes.c_longlong(0)
        while got < n:
            chunk = out[got:]
            buf = (ctypes.c_void_p * 1)(
                chunk.ctypes.data_as(ctypes.c_void_p).value)
            ret = self._lib.SoapySDRDevice_readStream(
                self._dev, self._stream, buf, n - got,
                ctypes.byref(flags), ctypes.byref(time_ns),
                _READ_TIMEOUT_US)
            if ret == SOAPY_SDR_TIMEOUT:
                continue
            if ret == SOAPY_SDR_OVERFLOW:
                self.overflows += 1
                continue
            if ret < 0:
                # hard stream error → EOS + zero pad (engine emits
                # READ_ERROR, reference Analyzer.cpp:87-92)
                self._eos = True
                break
            got += int(ret)
        return out

    def close(self) -> None:
        if getattr(self, "_stream", None):
            self._lib.SoapySDRDevice_deactivateStream(
                self._dev, self._stream, 0, 0)
            self._lib.SoapySDRDevice_closeStream(self._dev, self._stream)
            self._stream = None
        if getattr(self, "_dev", None):
            self._lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None


def register_if_available() -> bool:
    """Register the soapysdr source type + facade discoverer when the
    library is present (reference App/Application.cpp:729-740 device
    discovery flow)."""
    if load_soapy() is None:
        return False
    from sigdigger_tpu_torch.sources import register_source

    register_source("soapysdr", SoapySource)
    DeviceFacade.instance().register_discoverer(soapy_discoverer)
    return True
