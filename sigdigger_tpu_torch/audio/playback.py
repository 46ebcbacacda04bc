"""Audio playback: buffered worker + pluggable output backends
(counterpart of ``sigdigger_tpu/audio/playback.py``).

reference Audio/AudioPlayback.cpp:47-143 (ring of buffers, gain,
starvation signal, worker thread) with backend selection at
Audio/AudioPlayback.cpp:122-135 (ALSA / PortAudio).  This environment
has no sound device, so the shipped backends are:

- :class:`NullAudioPlayer` — consumes at the nominal rate (wall-clock
  paced), for tests and headless runs;
- :class:`AudioFileSaver` — WAV recording backend (reference
  Audio/AudioFileSaver.cpp);

third parties register real device backends via
``register_player``.  Buffer sizing follows the reference: 20 ms
clamped to >= 256 samples (reference include/AudioPlayback.h:32-39).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np

from sigdigger_tpu_torch.io.wav import WavWriter

BUFFER_SECONDS = 0.02     # 20 ms (reference include/AudioPlayback.h:32)
MIN_BUFFER_SAMPLES = 256


class GenericAudioPlayer:
    """Output backend interface (reference Audio/GenericAudioPlayer)."""

    def __init__(self, sample_rate: int) -> None:
        self.sample_rate = int(sample_rate)

    def play(self, samples: np.ndarray) -> None:  # float32 mono
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullAudioPlayer(GenericAudioPlayer):
    """Wall-clock-paced sink (headless playback)."""

    def __init__(self, sample_rate: int) -> None:
        super().__init__(sample_rate)
        self.samples_played = 0
        self._t0: float | None = None

    def play(self, samples: np.ndarray) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()
        self.samples_played += len(samples)
        due = self._t0 + self.samples_played / self.sample_rate
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)


class AudioFileSaver(GenericAudioPlayer):
    """WAV recording backend (reference Audio/AudioFileSaver.cpp)."""

    def __init__(self, path: str, sample_rate: int) -> None:
        super().__init__(sample_rate)
        self._writer = WavWriter(path, sample_rate, channels=1)

    def play(self, samples: np.ndarray) -> None:
        self._writer.write(np.asarray(samples, np.float32))

    def close(self) -> None:
        self._writer.close()


_BACKENDS: dict[str, Callable[[int], GenericAudioPlayer]] = {
    "null": NullAudioPlayer,
}


def available_backends() -> list[str]:
    """Registered playback backend names ('hw' present only when a
    real ALSA/PortAudio library loaded)."""
    return sorted(_BACKENDS)


def register_player(name: str,
                    ctor: Callable[[int], GenericAudioPlayer]) -> None:
    _BACKENDS[name] = ctor


class AudioPlayback:
    """Buffered playback pump (reference AudioPlayback + PlaybackWorker).

    ``write`` enqueues demodulated audio; a worker thread drains full
    buffers into the backend.  Starvation (underrun) raises the
    ``starved`` flag and invokes the optional callback — the reference's
    starvation signal.
    """

    def __init__(self, sample_rate: int, backend: str = "null",
                 player: GenericAudioPlayer | None = None,
                 max_buffers: int = 16,
                 on_starvation: Callable[[], None] | None = None) -> None:
        self.sample_rate = int(sample_rate)
        self.buffer_size = max(MIN_BUFFER_SAMPLES,
                               int(sample_rate * BUFFER_SECONDS))
        self._player = player or _BACKENDS[backend](self.sample_rate)
        self._q: queue.Queue[np.ndarray | None] = queue.Queue(max_buffers)
        self._partial = np.zeros(0, np.float32)
        self._gain = 1.0
        self.starved = False
        self._on_starvation = on_starvation
        self._stop = threading.Event()
        self._started = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def gain(self) -> float:
        return self._gain

    @gain.setter
    def gain(self, value: float) -> None:
        self._gain = float(value)

    def write(self, samples: np.ndarray) -> None:
        """Enqueue float32 mono samples (drops oldest when full — live
        audio must not block the DSP thread)."""
        buf = np.concatenate([self._partial,
                              np.asarray(samples, np.float32)])
        n = self.buffer_size
        while len(buf) >= n:
            chunk, buf = buf[:n], buf[n:]
            try:
                self._q.put_nowait(chunk)
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                self._q.put_nowait(chunk)
        self._partial = buf
        self._started = True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                chunk = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._started:
                    self.starved = True
                    if self._on_starvation:
                        self._on_starvation()
                continue
            if chunk is None:
                return
            self._player.play(chunk * self._gain)

    def drain(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=5.0)
        self._player.close()
