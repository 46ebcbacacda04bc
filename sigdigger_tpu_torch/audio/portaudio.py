"""PortAudio playback backend via ctypes (counterpart of
``sigdigger_tpu/audio/portaudio.py``).

Equivalent of the reference's PortAudioPlayer (reference
Audio/PortAudioPlayer.cpp: Pa_Initialize once + atexit finalizer,
device lookup by name with "default" → Pa_GetDefaultOutputDevice,
mono paFloat32 blocking stream at the device's default high output
latency, Pa_WriteStream loop).  Runtime backend order is
ALSA → PortAudio → Null (the reference selects at compile time,
Audio/AudioPlayback.cpp:122-135; a runtime probe is the portable
equivalent).  Binds the stable portaudio-2.0 ABI and takes an
injectable library handle so CI exercises the full ctypes path against
a compiled mock (tests/test_hw_backends.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from sigdigger_tpu_torch.audio.playback import GenericAudioPlayer, register_player

PA_FLOAT32 = 0x00000001
PA_NO_DEVICE = -1
PA_NO_ERROR = 0
PA_OUTPUT_UNDERFLOWED = -9980


class PaStreamParameters(ctypes.Structure):
    _fields_ = [
        ("device", ctypes.c_int),
        ("channelCount", ctypes.c_int),
        ("sampleFormat", ctypes.c_ulong),
        ("suggestedLatency", ctypes.c_double),
        ("hostApiSpecificStreamInfo", ctypes.c_void_p),
    ]


class PaDeviceInfo(ctypes.Structure):
    _fields_ = [
        ("structVersion", ctypes.c_int),
        ("name", ctypes.c_char_p),
        ("hostApi", ctypes.c_int),
        ("maxInputChannels", ctypes.c_int),
        ("maxOutputChannels", ctypes.c_int),
        ("defaultLowInputLatency", ctypes.c_double),
        ("defaultLowOutputLatency", ctypes.c_double),
        ("defaultHighInputLatency", ctypes.c_double),
        ("defaultHighOutputLatency", ctypes.c_double),
        ("defaultSampleRate", ctypes.c_double),
    ]


def _declare(lib: ctypes.CDLL) -> None:
    lib.Pa_Initialize.restype = ctypes.c_int
    lib.Pa_Terminate.restype = ctypes.c_int
    lib.Pa_GetDeviceCount.restype = ctypes.c_int
    lib.Pa_GetDefaultOutputDevice.restype = ctypes.c_int
    lib.Pa_GetDeviceInfo.argtypes = [ctypes.c_int]
    lib.Pa_GetDeviceInfo.restype = ctypes.POINTER(PaDeviceInfo)
    lib.Pa_OpenStream.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),            # stream out
        ctypes.POINTER(PaStreamParameters),         # input (NULL)
        ctypes.POINTER(PaStreamParameters),         # output
        ctypes.c_double,                            # sampleRate
        ctypes.c_ulong,                             # framesPerBuffer
        ctypes.c_ulong,                             # flags
        ctypes.c_void_p,                            # callback (NULL)
        ctypes.c_void_p,                            # userData
    ]
    lib.Pa_OpenStream.restype = ctypes.c_int
    lib.Pa_StartStream.argtypes = [ctypes.c_void_p]
    lib.Pa_StartStream.restype = ctypes.c_int
    lib.Pa_WriteStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
    lib.Pa_WriteStream.restype = ctypes.c_int
    lib.Pa_StopStream.argtypes = [ctypes.c_void_p]
    lib.Pa_StopStream.restype = ctypes.c_int
    lib.Pa_CloseStream.argtypes = [ctypes.c_void_p]
    lib.Pa_CloseStream.restype = ctypes.c_int
    lib.Pa_GetErrorText.argtypes = [ctypes.c_int]
    lib.Pa_GetErrorText.restype = ctypes.c_char_p


def load_portaudio(path: str | None = None) -> ctypes.CDLL | None:
    """Load libportaudio; None when absent (headless CI)."""
    candidates = [path] if path else [
        ctypes.util.find_library("portaudio"), "libportaudio.so.2"]
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


class PortAudioError(RuntimeError):
    pass


class PortAudioPlayer(GenericAudioPlayer):
    """Blocking mono float32 PortAudio sink.

    Device string "default" picks Pa_GetDefaultOutputDevice; any other
    string matches a device name substring (reference
    PortAudioPlayer::strToDeviceIndex semantics).  Output underflows
    are counted and ignored, like the ALSA backend's EPIPE path.
    """

    _initialized: set[int] = set()

    def __init__(self, sample_rate: int, device: str = "default",
                 frames_per_buffer: int = 0,
                 lib: ctypes.CDLL | None = None) -> None:
        super().__init__(sample_rate)
        self._lib = lib or load_portaudio()
        if self._lib is None:
            raise PortAudioError("libportaudio not available")
        key = id(self._lib)
        if key not in self._initialized:
            err = self._lib.Pa_Initialize()
            if err != PA_NO_ERROR:
                raise PortAudioError(
                    f"Pa_Initialize: {self._strerror(err)}")
            self._initialized.add(key)

        index = self._device_index(device)
        if index == PA_NO_DEVICE:
            raise PortAudioError(f"playback device not found: {device}")
        info = self._lib.Pa_GetDeviceInfo(index)
        latency = (info.contents.defaultHighOutputLatency
                   if info else 0.1)
        params = PaStreamParameters(
            device=index, channelCount=1, sampleFormat=PA_FLOAT32,
            suggestedLatency=latency, hostApiSpecificStreamInfo=None)
        self._stream = ctypes.c_void_p()
        err = self._lib.Pa_OpenStream(
            ctypes.byref(self._stream), None, ctypes.byref(params),
            float(sample_rate), int(frames_per_buffer), 0, None, None)
        if err != PA_NO_ERROR:
            raise PortAudioError(f"Pa_OpenStream: {self._strerror(err)}")
        err = self._lib.Pa_StartStream(self._stream)
        if err != PA_NO_ERROR:
            self._lib.Pa_CloseStream(self._stream)
            raise PortAudioError(
                f"Pa_StartStream: {self._strerror(err)}")
        self.underruns = 0

    def _strerror(self, err: int) -> str:
        msg = self._lib.Pa_GetErrorText(err)
        return msg.decode() if msg else str(err)

    def _device_index(self, device: str) -> int:
        if device in ("", "default"):
            return int(self._lib.Pa_GetDefaultOutputDevice())
        count = int(self._lib.Pa_GetDeviceCount())
        for i in range(count):
            info = self._lib.Pa_GetDeviceInfo(i)
            if not info:
                continue
            name = (info.contents.name or b"").decode()
            if device in name and info.contents.maxOutputChannels > 0:
                return i
        return PA_NO_DEVICE

    def play(self, samples: np.ndarray) -> None:
        buf = np.ascontiguousarray(samples, np.float32)
        if not len(buf):
            return
        err = self._lib.Pa_WriteStream(
            self._stream, buf.ctypes.data_as(ctypes.c_void_p), len(buf))
        if err == PA_OUTPUT_UNDERFLOWED:
            self.underruns += 1
        elif err != PA_NO_ERROR:
            raise PortAudioError(f"Pa_WriteStream: {self._strerror(err)}")

    def close(self) -> None:
        if self._stream:
            self._lib.Pa_StopStream(self._stream)
            self._lib.Pa_CloseStream(self._stream)
            self._stream = ctypes.c_void_p()


def register_if_available() -> bool:
    """Register the "portaudio" backend when libportaudio loads
    (runtime analog of the reference's compile-time selection)."""
    if load_portaudio() is None:
        return False
    register_player("portaudio", PortAudioPlayer)
    return True
