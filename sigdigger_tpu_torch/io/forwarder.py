"""TCP/UDP sample forwarder (counterpart of
``sigdigger_tpu/io/forwarder.py``).

reference UDP/SocketForwarder.cpp:62-156: a `GenericDataWriter` that
streams inspector output (raw IQ, soft bits, symbols) to an external
consumer over TCP or UDP.  Composes with :class:`GenericDataSaver` for
the async double buffering.
"""

from __future__ import annotations

import socket

from sigdigger_tpu_torch.io.datasaver import GenericDataSaver

_UDP_CHUNK = 1400   # stay under typical MTU


class SocketForwarder(GenericDataSaver):
    def __init__(self, host: str, port: int, udp: bool = False,
                 max_buffer: int = 1 << 24) -> None:
        self.host = host
        self.port = port
        self.udp = udp
        addr = socket.getaddrinfo(host, port, socket.AF_INET)[0][4]
        if udp:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._addr = addr
            write_fn = self._send_udp
        else:
            self._sock = socket.create_connection(addr, timeout=10.0)
            write_fn = self._send_tcp
        super().__init__(write_fn, max_buffer)

    def _send_tcp(self, data: bytes) -> int:
        self._sock.sendall(data)
        return len(data)

    def _send_udp(self, data: bytes) -> int:
        for off in range(0, len(data), _UDP_CHUNK):
            self._sock.sendto(data[off:off + _UDP_CHUNK], self._addr)
        return len(data)

    def close(self, timeout: float = 10.0) -> None:
        super().close(timeout)
        self._sock.close()
