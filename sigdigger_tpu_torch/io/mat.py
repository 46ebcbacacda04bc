"""Streaming MATLAB Level-5 .mat writer (and .m text writer);
counterpart of ``sigdigger_tpu/io/mat.py``, writing the same bytes (the
header's text names the same writer, so a file of either package
differs only in its creation time).

The reference exports IQ selections as streaming MAT files through
sigutils' `su_mat_file_*` API (reference Tasks/ExportSamplesTask.cpp:
79-204).  This is a self-contained MAT5 implementation: single-precision
real or complex matrices, written incrementally (the element size and
dimensions are patched on close), readable by MATLAB/Octave and
scipy.io.loadmat.
"""

from __future__ import annotations

import struct
import time

import numpy as np

_miSINGLE = 7
_miINT8 = 1
_miINT32 = 5
_miUINT32 = 6
_miMATRIX = 14
_mxSINGLE_CLASS = 7


def _tag(mtype: int, nbytes: int) -> bytes:
    return struct.pack("<II", mtype, nbytes)


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


class MatFileWriter:
    """Streaming writer: one named matrix growing along its columns.

    Usage::

        with MatFileWriter(path, "X", complex_data=True) as m:
            m.write(chunk)        # complex64/float32 1-D chunks
    """

    def __init__(self, path: str, var_name: str = "X",
                 complex_data: bool = True) -> None:
        self.path = path
        self.var_name = var_name
        self.complex = complex_data
        self._n = 0
        self._f = open(path, "wb")
        self._write_header()
        # reserve the matrix element; lengths patched on close
        self._matrix_tag_pos = self._f.tell()
        self._write_matrix_header(0)
        self._re_tag_pos = self._f.tell()
        self._f.write(_tag(_miSINGLE, 0))
        # real data streams straight to disk; imaginary parts are
        # buffered until close (MAT5 stores them as a second block)
        self._im: list[np.ndarray] = []

    def _write_header(self) -> None:
        desc = (f"MATLAB 5.0 MAT-file, created by sigdigger_tpu "
                f"on {time.ctime()}").encode()[:116]
        self._f.write(desc + b" " * (116 - len(desc)))
        self._f.write(b"\x00" * 8)          # subsys offset
        self._f.write(struct.pack("<HH", 0x0100, ord("M") << 8 | ord("I")))

    def _write_matrix_header(self, n: int) -> None:
        name = self.var_name.encode()
        name_pad = _pad8(len(name))
        data_bytes = n * 4
        data_pad = _pad8(data_bytes)
        body = (
            16                                   # array flags
            + 16                                 # dimensions
            + 8 + len(name) + name_pad           # name
            + 8 + data_bytes + data_pad          # real part
            + ((8 + data_bytes + data_pad) if self.complex else 0)
        )
        flags = _mxSINGLE_CLASS | (0x0800 if self.complex else 0)
        self._f.write(_tag(_miMATRIX, body))
        self._f.write(_tag(_miUINT32, 8))
        self._f.write(struct.pack("<II", flags, 0))
        self._f.write(_tag(_miINT32, 8))
        self._f.write(struct.pack("<ii", 1, n))
        self._f.write(_tag(_miINT8, len(name)))
        self._f.write(name + b"\x00" * name_pad)

    def write(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk)
        if self.complex:
            c = chunk.astype(np.complex64)
            re = c.real.astype("<f4")
            self._im.append(c.imag.astype("<f4"))
        else:
            re = chunk.real.astype("<f4")
        self._n += len(chunk)
        self._f.write(re.tobytes())

    def close(self) -> None:
        if self._f.closed:
            return
        data_bytes = self._n * 4
        pad = _pad8(data_bytes)
        self._f.write(b"\x00" * pad)
        if self.complex:
            self._f.write(_tag(_miSINGLE, data_bytes))
            for chunk in self._im:
                self._f.write(chunk.tobytes())
            self._f.write(b"\x00" * pad)
        # patch matrix + real-part tags and dimensions
        self._f.seek(self._matrix_tag_pos)
        self._write_matrix_header(self._n)
        self._f.seek(self._re_tag_pos)
        self._f.write(_tag(_miSINGLE, data_bytes))
        self._f.seek(0, 2)
        self._f.close()

    def __enter__(self) -> "MatFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_mat(path: str, data: np.ndarray, var_name: str = "X") -> None:
    data = np.asarray(data)
    cplx = np.iscomplexobj(data)
    with MatFileWriter(path, var_name, complex_data=cplx) as m:
        m.write(data)


def write_m_script(path: str, data: np.ndarray, var_name: str = "X",
                   sample_rate: float | None = None) -> None:
    """Text .m script export (reference ExportSamplesTask's .m mode)."""
    data = np.asarray(data)
    with open(path, "w") as f:
        f.write(f"% generated by sigdigger_tpu on {time.ctime()}\n")
        if sample_rate:
            f.write(f"fs = {sample_rate!r};\n")
        f.write(f"{var_name} = [")
        if np.iscomplexobj(data):
            for v in data:
                f.write(f"{v.real!r}+({v.imag!r})*i ")
        else:
            for v in data:
                f.write(f"{float(v)!r} ")
        f.write("];\n")
