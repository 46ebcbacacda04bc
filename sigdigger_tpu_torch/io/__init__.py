"""File I/O of the port (counterpart of ``sigdigger_tpu/io``): the WAV
reader-writer so far."""

from sigdigger_tpu_torch.io.wav import WavWriter, read_wav, write_wav

__all__ = ["WavWriter", "read_wav", "write_wav"]
