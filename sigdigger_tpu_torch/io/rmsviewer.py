"""RMS feed protocol — RMSViewer server + inspector-side client
(counterpart of ``sigdigger_tpu/io/rmsviewer.py``).

reference Components/RMSViewer.cpp:90-116 (TCP server accepting feeds)
and Components/RMSViewTab.cpp:357-424 (line protocol): a client first
sends a `DESC,<description>` line, then CSV lines
`<timestamp>,<rms>[,<extra>…]`; the RMSInspector pushes its power log
this way (reference Default/RMSInspector/RMSInspector.cpp).
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field


@dataclass
class RMSFeed:
    description: str = ""
    rows: list[tuple[float, float]] = field(default_factory=list)


class RMSViewerServer:
    """Accepts RMS feeds; stores rows per connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
        self.feeds: list[RMSFeed] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            feed = RMSFeed()
            with self._lock:
                self.feeds.append(feed)
            threading.Thread(target=self._serve, args=(conn, feed),
                             daemon=True).start()

    def _serve(self, conn: socket.socket, feed: RMSFeed) -> None:
        with conn:
            f = conn.makefile("r", newline="\n")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("DESC,"):
                    feed.description = line[5:]
                    continue
                parts = line.split(",")
                try:
                    ts = float(parts[0])
                    rms = float(parts[1])
                except (ValueError, IndexError):
                    continue
                with self._lock:
                    feed.rows.append((ts, rms))

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


class RMSForwarder:
    """Inspector-side client pushing `DESC,` + CSV lines."""

    def __init__(self, host: str, port: int, description: str) -> None:
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._f = self._sock.makefile("w", newline="\n")
        self._f.write(f"DESC,{description}\n")
        self._f.flush()

    def push(self, timestamp: float, rms: float) -> None:
        self._f.write(f"{timestamp:.6f},{rms:.9e}\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._sock.close()
