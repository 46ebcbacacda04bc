"""I/O of the port (counterpart of ``sigdigger_tpu/io``): the WAV
reader-writer and the MAT5 / .m writers here; the live session's
servers and savers in their modules (``suscan_wire``, ``cbor``,
``remote_analyzer``, ``remote``, ``webspectrum``, ``datasaver``,
``forwarder``, ``rmsviewer``)."""

from sigdigger_tpu_torch.io.mat import MatFileWriter, write_m_script, write_mat
from sigdigger_tpu_torch.io.wav import WavWriter, read_wav, write_wav

__all__ = ["MatFileWriter", "WavWriter", "read_wav", "write_m_script",
           "write_mat", "write_wav"]
