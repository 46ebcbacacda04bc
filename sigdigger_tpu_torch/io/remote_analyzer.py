"""Remote analyzer — serve an Analyzer over TCP, drive it from a client
(counterpart of ``sigdigger_tpu/io/remote_analyzer.py``: the same frames,
so either package's client talks to either package's server).

The reference can connect to a remote suscan analyzer over TCP (profile
interface check at reference App/Application.cpp:361-377, QuickConnect
dialog; a permissions mask gates what remote clients may change,
reference include/Suscan/Analyzer.h:119-123).  Here:

- :class:`RemoteAnalyzerServer` wraps a local :class:`Analyzer`, pumps
  its message queue to every connected client and executes permitted
  control requests;
- :class:`RemoteAnalyzerClient` mirrors the Analyzer control surface
  (read()/poll(), set_frequency, inspector ops…) over the wire.

Framing: 4-byte big-endian length + payload.  Payloads are JSON control
dicts; bulk arrays (PSD rows, sample batches) ride as raw float32/
complex64 bytes after the JSON header — no pickle, so a malicious peer
cannot execute code.  A shared token (optional) gates connections,
mirroring the reference's user/password handshake.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
from typing import Any

import numpy as np

from sigdigger_tpu_torch.analyzer.engine import Analyzer
from sigdigger_tpu_torch.analyzer.messages import (
    ChannelMessage,
    InspectorMessage,
    InspectorMessageKind,
    Message,
    MessageKind,
    PSDMessage,
    SamplesMessage,
    SourceInfoMessage,
    StatusMessage,
)
from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS, Config
from sigdigger_tpu_torch.io.suscan_wire import _host
from sigdigger_tpu_torch.types import Channel, SourceInfo


def _send_frame(sock: socket.socket, header: dict[str, Any],
                blob: bytes = b"") -> None:
    payload = json.dumps(header).encode()
    sock.sendall(struct.pack(">II", len(payload) + len(blob) + 4,
                             len(payload)) + payload + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> tuple[dict[str, Any], bytes]:
    total, hlen = struct.unpack(">II", _recv_exact(sock, 8))
    body = _recv_exact(sock, total - 4)
    header = json.loads(body[:hlen])
    return header, body[hlen:]


def _encode_array(a: np.ndarray) -> tuple[dict[str, Any], bytes]:
    a = np.ascontiguousarray(_host(a))
    return ({"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes())


def _decode_array(meta: dict[str, Any], blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"]).copy()


def _msg_to_wire(msg: Message) -> tuple[dict[str, Any], bytes]:
    h: dict[str, Any] = {"kind": msg.kind.value,
                         "timestamp": msg.timestamp}
    blob = b""
    if isinstance(msg, PSDMessage):
        h.update(fft_size=msg.fft_size, sample_rate=msg.sample_rate,
                 measured_sample_rate=msg.measured_sample_rate,
                 frequency=msg.frequency, looped=msg.looped)
        meta, blob = _encode_array(msg.data)
        h["array"] = meta
    elif isinstance(msg, SamplesMessage):
        h.update(inspector_id=msg.inspector_id, handle=msg.handle)
        meta, blob = _encode_array(msg.samples)
        h["array"] = meta
        h["extras"] = {}
        for k, v in (msg.extras or {}).items():
            arr = _host(v)
            h["extras"][k] = {
                "dtype": str(arr.dtype), "shape": list(arr.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(arr).tobytes()).decode(),
            }
    elif isinstance(msg, InspectorMessage):
        h.update(inspector_kind=msg.inspector_kind.value,
                 request_id=msg.request_id, handle=msg.handle,
                 inspector_id=msg.inspector_id,
                 class_name=msg.class_name, equiv_rate=msg.equiv_rate,
                 bandwidth=msg.bandwidth, lo=msg.lo,
                 estimator_id=msg.estimator_id,
                 estimator_value=msg.estimator_value)
        if msg.config is not None:
            h["config"] = msg.config.as_dict()
        if msg.spectrum_data is not None:
            meta, blob = _encode_array(msg.spectrum_data)
            h["array"] = meta
            h["spectrum_rate"] = msg.spectrum_rate
    elif isinstance(msg, SourceInfoMessage):
        h["info"] = vars(msg.info).copy() if msg.info else {}
        h["info"].pop("gains", None)
        h["gains"] = dict(msg.info.gains) if msg.info else {}
    elif isinstance(msg, StatusMessage):
        h.update(code=msg.code, message=msg.message)
    elif isinstance(msg, ChannelMessage):
        h["channels"] = [vars(c) for c in msg.channels]
    return h, blob


def _msg_from_wire(h: dict[str, Any], blob: bytes) -> Message:
    kind = MessageKind(h["kind"])
    if kind == MessageKind.PSD:
        return PSDMessage(
            fft_size=h["fft_size"], sample_rate=h["sample_rate"],
            measured_sample_rate=h["measured_sample_rate"],
            frequency=h["frequency"], looped=h["looped"],
            data=_decode_array(h["array"], blob),
            timestamp=h["timestamp"])
    if kind == MessageKind.SAMPLES:
        extras = {}
        for k, meta in (h.get("extras") or {}).items():
            raw = base64.b64decode(meta["b64"])
            extras[k] = np.frombuffer(
                raw, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
        return SamplesMessage(
            inspector_id=h["inspector_id"], handle=h["handle"],
            samples=_decode_array(h["array"], blob), extras=extras,
            timestamp=h["timestamp"])
    if kind == MessageKind.INSPECTOR:
        cfg = None
        if "config" in h:
            schema = INSPECTOR_SCHEMAS.get(h.get("class_name", ""))
            if schema is not None:
                cfg = Config(schema, h["config"])
        return InspectorMessage(
            inspector_kind=InspectorMessageKind(h["inspector_kind"]),
            request_id=h["request_id"], handle=h["handle"],
            inspector_id=h["inspector_id"], class_name=h["class_name"],
            equiv_rate=h["equiv_rate"], bandwidth=h["bandwidth"],
            lo=h["lo"], estimator_id=h["estimator_id"],
            estimator_value=h["estimator_value"], config=cfg,
            spectrum_data=_decode_array(h["array"], blob)
            if "array" in h else None,
            spectrum_rate=h.get("spectrum_rate", 0.0),
            timestamp=h["timestamp"])
    if kind == MessageKind.SOURCE_INFO:
        info = SourceInfo(**{k: v for k, v in h["info"].items()
                             if k in SourceInfo.__dataclass_fields__})
        info.gains = h.get("gains", {})
        return SourceInfoMessage(info=info, timestamp=h["timestamp"])
    if kind == MessageKind.STATUS:
        return StatusMessage(code=h["code"], message=h["message"],
                             timestamp=h["timestamp"])
    if kind == MessageKind.CHANNEL:
        return ChannelMessage(
            channels=[Channel(**c) for c in h["channels"]],
            timestamp=h["timestamp"])
    return Message(kind=kind, timestamp=h["timestamp"])


class RemoteAnalyzerServer:
    """Serves a local Analyzer to remote clients."""

    def __init__(self, analyzer: Analyzer, host: str = "127.0.0.1",
                 port: int = 0, token: str = "",
                 permissions: int = 0xFFFFFFFF) -> None:
        self.analyzer = analyzer
        self.token = token
        self.permissions = permissions
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._pump_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                hello, _ = _recv_frame(conn)
                if self.token and hello.get("token") != self.token:
                    _send_frame(conn, {"ok": False,
                                       "error": "bad token"})
                    conn.close()
                    continue
                _send_frame(conn, {"ok": True,
                                   "permissions": self.permissions})
            except (ConnectionError, json.JSONDecodeError, OSError):
                conn.close()
                continue
            with self._lock:
                self._clients.append(conn)
            threading.Thread(target=self._control_loop, args=(conn,),
                             daemon=True).start()

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            msg = self.analyzer.read(timeout=0.25)
            if msg is None:
                continue
            h, blob = _msg_to_wire(msg)
            with self._lock:
                clients = list(self._clients)
            for c in clients:
                try:
                    _send_frame(c, h, blob)
                except OSError:
                    with self._lock:
                        if c in self._clients:
                            self._clients.remove(c)

    def _control_loop(self, conn: socket.socket) -> None:
        an = self.analyzer
        perm = self.permissions
        while not self._stop.is_set():
            try:
                req, _ = _recv_frame(conn)
            except (ConnectionError, OSError):
                return
            cmd = req.get("cmd")
            try:
                if cmd == "set_frequency" and \
                        perm & SourceInfo.PERM_SET_FREQ:
                    an.set_frequency(req["freq"], req.get("lnb", 0.0))
                elif cmd == "seek" and perm & SourceInfo.PERM_SEEK:
                    an.seek(req["position"])
                elif cmd == "set_throttle" and \
                        perm & SourceInfo.PERM_THROTTLE:
                    an.set_throttle(req["enabled"])
                elif cmd == "open_inspector" and \
                        perm & SourceInfo.PERM_OPEN_INSPECTOR:
                    an.open_inspector(
                        req["class"], Channel(fc=req["fc"], bw=req["bw"]),
                        request_id=req.get("request_id", 0),
                        config=req.get("config"))
                elif cmd == "set_inspector_config":
                    an.set_inspector_config(req["handle"], req["config"],
                                            req.get("request_id", 0))
                elif cmd == "set_inspector_freq":
                    an.set_inspector_freq(req["handle"], req["freq"],
                                          req.get("request_id", 0))
                elif cmd == "set_inspector_bandwidth":
                    an.set_inspector_bandwidth(req["handle"], req["bw"],
                                               req.get("request_id", 0))
                elif cmd == "set_estimator":
                    an.set_estimator(req["handle"], req["estimator"],
                                     req["enabled"])
                elif cmd == "set_spectrum_source":
                    an.set_spectrum_source(req["handle"], req["source"])
                elif cmd == "close_inspector":
                    an.close_inspector(req["handle"],
                                       req.get("request_id", 0))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                an._emit(StatusMessage(code=-10, message=str(e)))

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()


class RemoteAnalyzerClient:
    """Client-side mirror of the Analyzer control/message surface."""

    def __init__(self, host: str, port: int, token: str = "",
                 timeout: float = 10.0) -> None:
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        _send_frame(self._sock, {"token": token})
        ack, _ = _recv_frame(self._sock)
        if not ack.get("ok"):
            raise ConnectionError(ack.get("error", "rejected"))
        self.permissions = ack.get("permissions", 0)
        self._sock.settimeout(0.25)
        import queue

        self._mq: "queue.Queue[Message]" = queue.Queue()
        self._stop = threading.Event()
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx.start()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                h, blob = _recv_frame(self._sock)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                return
            try:
                self._mq.put(_msg_from_wire(h, blob))
            except Exception:  # noqa: BLE001 — skip malformed frames
                continue

    # -- message stream ----------------------------------------------------
    def read(self, timeout: float | None = None) -> Message | None:
        import queue

        try:
            return self._mq.get(timeout=timeout)
        except queue.Empty:
            return None

    def poll(self) -> list[Message]:
        import queue

        out = []
        while True:
            try:
                out.append(self._mq.get_nowait())
            except queue.Empty:
                return out

    # -- control -----------------------------------------------------------
    def _send(self, **req: Any) -> None:
        _send_frame(self._sock, req)

    def set_frequency(self, freq: float, lnb: float = 0.0) -> None:
        self._send(cmd="set_frequency", freq=freq, lnb=lnb)

    def seek(self, position: int) -> None:
        self._send(cmd="seek", position=position)

    def set_throttle(self, enabled: bool) -> None:
        self._send(cmd="set_throttle", enabled=enabled)

    def open_inspector(self, class_name: str, channel: Channel,
                       request_id: int = 0,
                       config: dict[str, Any] | None = None) -> None:
        self._send(cmd="open_inspector", **{"class": class_name},
                   fc=channel.fc, bw=channel.bw, request_id=request_id,
                   config=config)

    def set_inspector_config(self, handle: int, config: dict[str, Any],
                             request_id: int = 0) -> None:
        self._send(cmd="set_inspector_config", handle=handle,
                   config=config, request_id=request_id)

    def set_inspector_freq(self, handle: int, freq: float,
                           request_id: int = 0) -> None:
        self._send(cmd="set_inspector_freq", handle=handle, freq=freq,
                   request_id=request_id)

    def set_inspector_bandwidth(self, handle: int, bw: float,
                                request_id: int = 0) -> None:
        self._send(cmd="set_inspector_bandwidth", handle=handle, bw=bw,
                   request_id=request_id)

    def set_estimator(self, handle: int, estimator: str,
                      enabled: bool) -> None:
        self._send(cmd="set_estimator", handle=handle,
                   estimator=estimator, enabled=enabled)

    def set_spectrum_source(self, handle: int, source: int) -> None:
        self._send(cmd="set_spectrum_source", handle=handle,
                   source=source)

    def close_inspector(self, handle: int, request_id: int = 0) -> None:
        self._send(cmd="close_inspector", handle=handle,
                   request_id=request_id)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
