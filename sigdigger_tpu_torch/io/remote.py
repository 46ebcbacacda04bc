"""Remote-control TCP server (counterpart of
``sigdigger_tpu/io/remote.py``).

reference App/RemoteControlServer.cpp:55-111: a line-oriented TCP REPL
over the GlobalProperty registry —

    get <name>        → <name>=<value>
    set <name> <val>  → OK / ERROR …
    list              → one property name per line
    quit

Each client runs on its own thread; the server binds loopback by
default.
"""

from __future__ import annotations

import socket
import threading

from sigdigger_tpu_torch.utils.globalprop import GlobalProperty


class RemoteControlServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
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
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            f = conn.makefile("rw", newline="\n")
            for line in f:
                reply = self._dispatch(line.strip())
                if reply is None:
                    return
                f.write(reply + "\n")
                f.flush()

    def _dispatch(self, line: str) -> str | None:
        if not line:
            return ""
        parts = line.split(None, 2)
        cmd = parts[0].lower()
        if cmd == "quit":
            return None
        if cmd == "list":
            return "\n".join(GlobalProperty.names())
        if cmd == "get" and len(parts) >= 2:
            prop = GlobalProperty.lookup(parts[1])
            if prop is None:
                return f"ERROR unknown property {parts[1]}"
            return f"{parts[1]}={prop.value}"
        if cmd == "set" and len(parts) >= 3:
            prop = GlobalProperty.lookup(parts[1])
            if prop is None:
                return f"ERROR unknown property {parts[1]}"
            if not prop.writable:
                return f"ERROR property {parts[1]} is read-only"
            prop.set(parts[2])
            return "OK"
        return f"ERROR bad command: {line}"

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
