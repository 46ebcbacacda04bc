from sigdigger_tpu_torch.audio.alsa import AlsaPlayer
from sigdigger_tpu_torch.audio.alsa import (
    register_if_available as _alsa_register,
)
from sigdigger_tpu_torch.audio.playback import (
    AudioFileSaver,
    AudioPlayback,
    GenericAudioPlayer,
    NullAudioPlayer,
    register_player,
)
from sigdigger_tpu_torch.audio.portaudio import PortAudioPlayer
from sigdigger_tpu_torch.audio.portaudio import (
    register_if_available as _pa_register,
)

# runtime backend probe, preference order ALSA → PortAudio → Null
# (reference selects at compile time, Audio/AudioPlayback.cpp:122-135)
_have_alsa = _alsa_register()
_have_pa = _pa_register()
if _have_alsa:
    register_player("hw", AlsaPlayer)
elif _have_pa:
    register_player("hw", PortAudioPlayer)

__all__ = [
    "AlsaPlayer",
    "PortAudioPlayer",
    "AudioFileSaver",
    "AudioPlayback",
    "GenericAudioPlayer",
    "NullAudioPlayer",
]
