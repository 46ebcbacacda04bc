"""ALSA playback backend via ctypes (counterpart of
``sigdigger_tpu/audio/alsa.py``).

Equivalent of the reference's AlsaPlayer (reference Audio/AlsaPlayer.cpp:
33-95: snd_pcm_open → snd_pcm_set_params(FLOAT_LE, RW_INTERLEAVED,
1 ch, rate, resample, latency) → snd_pcm_writei loop with -EPIPE
recovery).  The binding targets the stable libasound.so.2 ABI and takes
an injectable library handle so CI can exercise the full ctypes path
against a compiled mock (tests/test_hw_backends.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from sigdigger_tpu_torch.audio.playback import GenericAudioPlayer, register_player

# libasound constants (alsa/pcm.h)
SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3
_EPIPE = 32
_DEFAULT_LATENCY_US = 100_000   # reference AlsaPlayer.cpp: 100 ms


def load_alsa(path: str | None = None) -> ctypes.CDLL | None:
    """Load libasound; returns None when ALSA is absent (headless CI)."""
    candidates = [path] if path else [
        ctypes.util.find_library("asound"), "libasound.so.2"]
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
    lib.snd_pcm_open.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int]
    lib.snd_pcm_open.restype = ctypes.c_int
    lib.snd_pcm_set_params.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
    lib.snd_pcm_set_params.restype = ctypes.c_int
    lib.snd_pcm_writei.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
    lib.snd_pcm_writei.restype = ctypes.c_long
    lib.snd_pcm_recover.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.snd_pcm_recover.restype = ctypes.c_int
    lib.snd_pcm_drain.argtypes = [ctypes.c_void_p]
    lib.snd_pcm_drain.restype = ctypes.c_int
    lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
    lib.snd_pcm_close.restype = ctypes.c_int
    lib.snd_strerror.argtypes = [ctypes.c_int]
    lib.snd_strerror.restype = ctypes.c_char_p


class AlsaError(RuntimeError):
    pass


class AlsaPlayer(GenericAudioPlayer):
    """Blocking interleaved-write ALSA sink, mono float32.

    Underruns (-EPIPE) are recovered silently, matching the reference's
    `snd_pcm_recover` path (Audio/AlsaPlayer.cpp:77-86).
    """

    def __init__(self, sample_rate: int, device: str = "default",
                 latency_us: int = _DEFAULT_LATENCY_US,
                 lib: ctypes.CDLL | None = None) -> None:
        super().__init__(sample_rate)
        self._lib = lib or load_alsa()
        if self._lib is None:
            raise AlsaError("libasound not available")
        self._pcm = ctypes.c_void_p()
        err = self._lib.snd_pcm_open(
            ctypes.byref(self._pcm), device.encode(),
            SND_PCM_STREAM_PLAYBACK, 0)
        if err < 0:
            raise AlsaError(f"snd_pcm_open: {self._strerror(err)}")
        err = self._lib.snd_pcm_set_params(
            self._pcm, SND_PCM_FORMAT_FLOAT_LE,
            SND_PCM_ACCESS_RW_INTERLEAVED, 1, int(sample_rate), 1,
            int(latency_us))
        if err < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise AlsaError(f"snd_pcm_set_params: {self._strerror(err)}")
        self.underruns = 0

    def _strerror(self, err: int) -> str:
        msg = self._lib.snd_strerror(err)
        return msg.decode() if msg else str(err)

    def play(self, samples: np.ndarray) -> None:
        buf = np.ascontiguousarray(samples, np.float32)
        view = buf
        while len(view):
            n = self._lib.snd_pcm_writei(
                self._pcm, view.ctypes.data_as(ctypes.c_void_p), len(view))
            if n == -_EPIPE:
                self.underruns += 1
                self._lib.snd_pcm_recover(self._pcm, int(n), 1)
                continue
            if n < 0:
                raise AlsaError(f"snd_pcm_writei: {self._strerror(int(n))}")
            view = view[int(n):]

    def close(self) -> None:
        if self._pcm:
            self._lib.snd_pcm_drain(self._pcm)
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = ctypes.c_void_p()


def register_if_available() -> bool:
    """Register the "alsa" backend when libasound loads; called from
    the audio package import (mirrors the reference's compile-time
    backend selection, Audio/AudioPlayback.cpp:122-135)."""
    if load_alsa() is None:
        return False
    register_player("alsa", AlsaPlayer)
    return True
