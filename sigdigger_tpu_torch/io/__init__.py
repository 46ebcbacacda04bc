"""File I/O of the port (counterpart of ``sigdigger_tpu/io``): the WAV
reader-writer and the MAT5 / .m writers so far."""

from sigdigger_tpu_torch.io.mat import MatFileWriter, write_m_script, write_mat
from sigdigger_tpu_torch.io.wav import WavWriter, read_wav, write_wav

__all__ = ["MatFileWriter", "WavWriter", "read_wav", "write_m_script",
           "write_mat", "write_wav"]
