"""suscan-style binary remote-analyzer wire protocol (counterpart of
``sigdigger_tpu/io/suscan_wire.py``: every PDU is byte-equal to the
reference's for the same call or message, so the two packages' clients
and servers talk to each other).

The reference connects to remote analyzers over TCP (profile interface
check, reference App/Application.cpp:361-377; QuickConnect dialog
host/user/password/port fields, Components/QuickConnectDialog.cpp:37-45;
a permission mask gates what remote clients may set, reference
include/Suscan/Analyzer.h:113-123 ``getPermissions``/``testPermission``).
The protocol implementation itself lives in the suscan C library, whose
sources are NOT part of the reference tree — only the behavioral
surface is visible (the setter/inspector API of Suscan/Analyzer.cpp and
the message taxonomy of include/Suscan/Messages/*.h).

This module implements that surface as a binary protocol in the suscan
style:

- magic-framed PDUs (8-byte header: ``uint32 magic | uint32 size``),
  with transparent zlib compression of large PDUs under a second magic;
- CBOR-serialized call payloads (``sigdigger_tpu_torch.io.cbor``): every PDU
  is one CBOR array ``[call_type, ...fields]``;
- a salted SHA-256 challenge handshake: the server sends a HELLO with
  its name, protocol version and a random 32-byte salt; the client
  answers AUTH with the user name and ``sha256(salt + sha256(password))``
  so the password never crosses the wire;
- the full remote-settable analyzer surface, gated per-call by the
  server's permission mask (the same ``SourceInfo.PERM_*`` bits the
  local engine reports);
- analyzer messages (PSD/SAMPLES/INSPECTOR/SOURCE_INFO/STATUS/CHANNEL/
  EOS/...) streamed server→client as MESSAGE calls, arrays as raw
  little-endian payload bytes with dtype/shape tags.

Every constant that a byte-compatible peer would need is collected in
:class:`WireSpec`.  The values marked *reconstructed* are NOT derivable
from the reference tree (the suscan C sources are absent); aligning
with a specific suscan build is a ``WireSpec``-only change — the
framing, handshake and payload schemas here are pinned by golden byte
vectors in ``tests/test_suscan_wire.py`` and ``tests/test_torch_wire.py``
so any wire-image change is an intentional diff.  Only host values
reach the encoder: the engines' messages carry numpy arrays, and a
``torch.Tensor`` in a message is refused with ``TypeError`` rather than
copied to the host behind the caller's back.
"""

from __future__ import annotations

import enum
import hashlib
import hmac
import os
import socket
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.analyzer.messages import (
    ChannelMessage,
    InspectorMessage,
    InspectorMessageKind,
    Message,
    MessageKind,
    OrbitReport,
    PSDMessage,
    SamplesMessage,
    SourceInfoMessage,
    StatusMessage,
)
from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS, Config
from sigdigger_tpu_torch.io import cbor
from sigdigger_tpu_torch.types import Channel, SourceInfo


@dataclass(frozen=True)
class WireSpec:
    """Every wire-image constant in one place (see module docstring)."""

    pdu_magic: int = 0x75736373          # "sucs" — reconstructed
    pdu_magic_compressed: int = 0x7573637A   # "sucz" — reconstructed
    protocol_major: int = 0
    protocol_minor: int = 1
    auth_mode_none: int = 0
    auth_mode_user_password: int = 1
    compress_threshold: int = 1 << 14    # PDUs above this deflate
    max_pdu_size: int = 1 << 26          # reject larger (DoS guard)


SPEC = WireSpec()


class CallType(enum.IntEnum):
    """Remote call codes.

    The set mirrors the remote-settable analyzer surface visible in the
    reference C++ wrapper (Suscan/Analyzer.cpp setters + async inspector
    ops + the permission bits of include/Suscan/Analyzer.h); the
    numeric values are reconstructed (see module docstring).
    """

    HELLO = 0
    AUTH = 1
    AUTH_REJECTED = 2
    STARTUP_ERROR = 3
    SOURCE_INFO = 4
    MESSAGE = 5
    REQ_HALT = 6
    SET_FREQUENCY = 7
    SET_GAIN = 8
    SET_ANTENNA = 9
    SET_BANDWIDTH = 10
    SET_PPM = 11
    SET_DC_REMOVE = 12
    SET_IQ_REVERSE = 13
    SET_AGC = 14
    SET_SWEEP_STRATEGY = 15
    SET_SPECTRUM_PARTITIONING = 16
    SET_HOP_RANGE = 17
    SET_BUFFERING_SIZE = 18
    SEEK = 19
    SET_THROTTLE = 20
    SET_HISTORY_SIZE = 21
    REPLAY = 22
    OPEN_INSPECTOR = 23
    CLOSE_INSPECTOR = 24
    SET_INSPECTOR_CONFIG = 25
    SET_INSPECTOR_ID = 26
    SET_INSPECTOR_FREQ = 27
    SET_INSPECTOR_BANDWIDTH = 28
    SET_INSPECTOR_WATERMARK = 29
    SET_INSPECTOR_ESTIMATOR = 30
    SET_INSPECTOR_SPECTRUM = 31
    PING = 32
    PONG = 33
    # inspector Doppler correction (reference
    # suscan_analyzer_inspector_set_tle_async, Suscan/Analyzer.cpp:
    # 568-592: orbit present = enable, nullptr = disable)
    SET_INSPECTOR_DOPPLER = 34
    DISABLE_INSPECTOR_DOPPLER = 35


# permission required per client→server call (SourceInfo.PERM_* bits;
# reference gates identically: e.g. InspToolWidget.cpp:267-270,
# SourceWidget.cpp:571-597, FFTWidget.cpp:708-714)
CALL_PERMISSIONS: dict[CallType, int] = {
    CallType.SET_FREQUENCY: SourceInfo.PERM_SET_FREQ,
    CallType.SET_GAIN: SourceInfo.PERM_SET_GAIN,
    CallType.SET_ANTENNA: SourceInfo.PERM_SET_ANTENNA,
    CallType.SET_BANDWIDTH: SourceInfo.PERM_SET_BW,
    CallType.SET_PPM: SourceInfo.PERM_SET_PPM,
    CallType.SET_DC_REMOVE: SourceInfo.PERM_SET_DC_REMOVE,
    CallType.SET_IQ_REVERSE: SourceInfo.PERM_SET_IQ_REVERSE,
    CallType.SET_AGC: SourceInfo.PERM_SET_AGC,
    CallType.SEEK: SourceInfo.PERM_SEEK,
    CallType.SET_THROTTLE: SourceInfo.PERM_THROTTLE,
    CallType.OPEN_INSPECTOR: SourceInfo.PERM_OPEN_INSPECTOR,
}


# ---------------------------------------------------------------------------
# PDU framing
# ---------------------------------------------------------------------------

def write_pdu(payload: bytes, spec: WireSpec = SPEC) -> bytes:
    """Frame one CBOR payload as a PDU (compressing large ones)."""
    if len(payload) >= spec.compress_threshold:
        z = zlib.compress(payload, 6)
        if len(z) < len(payload):
            return struct.pack(">II", spec.pdu_magic_compressed,
                               len(z)) + z
    return struct.pack(">II", spec.pdu_magic, len(payload)) + payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def read_pdu(sock: socket.socket, spec: WireSpec = SPEC) -> bytes:
    magic, size = struct.unpack(">II", _recv_exact(sock, 8))
    if magic not in (spec.pdu_magic, spec.pdu_magic_compressed):
        raise ConnectionError(f"bad PDU magic 0x{magic:08x}")
    if size > spec.max_pdu_size:
        raise ConnectionError(f"oversized PDU ({size} bytes)")
    payload = _recv_exact(sock, size)
    if magic == spec.pdu_magic_compressed:
        # bounded inflate: a small deflate payload must not be allowed
        # to expand past max_pdu_size (decompression-bomb guard)
        d = zlib.decompressobj()
        try:
            out = d.decompress(payload, spec.max_pdu_size)
        except zlib.error as e:
            raise ConnectionError(f"bad deflate payload: {e}") from e
        if d.unconsumed_tail:
            raise ConnectionError("oversized PDU after inflate")
        if not d.eof:
            raise ConnectionError("truncated deflate payload")
        payload = out
    return payload


def encode_call(call_type: CallType, *fields: Any) -> bytes:
    return cbor.encode([int(call_type), *fields])


def decode_call(payload: bytes) -> tuple[CallType, list[Any]]:
    obj = cbor.decode(payload)
    if not isinstance(obj, list) or not obj:
        raise ValueError("malformed call payload")
    return CallType(obj[0]), obj[1:]


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------

def auth_token(salt: bytes, password: str) -> bytes:
    """``sha256(salt + sha256(password))`` — the password itself never
    crosses the wire; the salt makes tokens non-replayable across
    connections."""
    return hashlib.sha256(
        salt + hashlib.sha256(password.encode("utf-8")).digest()).digest()


def make_hello(server_name: str, salt: bytes,
               spec: WireSpec = SPEC, auth_required: bool = True) -> bytes:
    mode = (spec.auth_mode_user_password if auth_required
            else spec.auth_mode_none)
    return encode_call(CallType.HELLO, spec.protocol_major,
                       spec.protocol_minor, server_name, mode, salt)


def make_auth(user: str, salt: bytes, password: str) -> bytes:
    return encode_call(CallType.AUTH, user, auth_token(salt, password))


# ---------------------------------------------------------------------------
# array + message codecs
# ---------------------------------------------------------------------------

def _host(a: Any) -> np.ndarray:
    """``a`` as a numpy array; a tensor (on any device) is refused."""
    if isinstance(a, torch.Tensor):
        raise TypeError(f"suscan-wire: a message field holds a "
                        f"{a.dtype} tensor on {a.device}; the wire takes "
                        f"host (numpy) arrays only")
    return np.asarray(a)


_DTYPE_NAMES: dict[np.dtype, str] = {}   # str(dtype) takes microseconds


def _pack_array(a: np.ndarray | None) -> list[Any] | None:
    if a is None:
        return None
    a = np.ascontiguousarray(_host(a))
    name = _DTYPE_NAMES.get(a.dtype)
    if name is None:
        name = _DTYPE_NAMES.setdefault(a.dtype, str(a.dtype))
    return [name, list(a.shape), a.tobytes()]


def _unpack_array(t: list[Any] | None) -> np.ndarray | None:
    if t is None:
        return None
    dtype, shape, raw = t
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


_MSG_KIND_CODE = {k: i for i, k in enumerate(MessageKind)}
_MSG_KIND_FROM = dict(enumerate(MessageKind))
_INSP_KIND_CODE = {k: i for i, k in enumerate(InspectorMessageKind)}
_INSP_KIND_FROM = dict(enumerate(InspectorMessageKind))


def encode_message(msg: Message) -> bytes:
    """Serialize one analyzer message as a MESSAGE call.

    Field layout per kind is a fixed positional CBOR array (documented
    by the decoder below and pinned by the golden vectors)."""
    code = _MSG_KIND_CODE[msg.kind]
    body: list[Any]
    if isinstance(msg, PSDMessage):
        body = [msg.fft_size, msg.sample_rate, msg.measured_sample_rate,
                msg.frequency, bool(msg.looped), _pack_array(msg.data)]
    elif isinstance(msg, SamplesMessage):
        extras = {k: _pack_array(_host(v))
                  for k, v in (msg.extras or {}).items()}
        body = [msg.inspector_id, msg.handle,
                _pack_array(msg.samples), extras]
    elif isinstance(msg, InspectorMessage):
        body = [_INSP_KIND_CODE[msg.inspector_kind], msg.request_id,
                msg.handle, msg.inspector_id, msg.class_name,
                msg.config.as_dict() if msg.config is not None else None,
                msg.equiv_rate, msg.bandwidth, msg.lo,
                msg.estimator_id, msg.estimator_value,
                _pack_array(msg.spectrum_data), msg.spectrum_rate,
                # trailing optional: ORBIT_REPORT payload (rx_time,
                # az, el, dist_km, freq_corr_hz, vlos_kms)
                ([msg.payload.rx_time, msg.payload.azimuth_deg,
                  msg.payload.elevation_deg, msg.payload.distance_km,
                  msg.payload.freq_corr_hz, msg.payload.vlos_vel_kms]
                 if msg.inspector_kind
                 == InspectorMessageKind.ORBIT_REPORT
                 and msg.payload is not None else None)]
    elif isinstance(msg, SourceInfoMessage):
        info = msg.info
        d = {k: v for k, v in vars(info).items()} if info else {}
        gains = {k: float(v) for k, v in d.pop("gains", {}).items()}
        d = {k: v for k, v in d.items()
             if isinstance(v, (int, float, str, bool)) or v is None}
        body = [d, gains]
    elif isinstance(msg, StatusMessage):
        body = [msg.code, msg.message]
    elif isinstance(msg, ChannelMessage):
        body = [[[c.fc, c.f_low, c.f_high, c.bw] for c in msg.channels]]
    else:
        body = []
    return encode_call(CallType.MESSAGE, code, msg.timestamp, body)


def decode_message(fields: list[Any]) -> Message:
    code, timestamp, body = fields
    kind = _MSG_KIND_FROM[code]
    if kind == MessageKind.PSD:
        return PSDMessage(fft_size=body[0], sample_rate=body[1],
                          measured_sample_rate=body[2], frequency=body[3],
                          looped=body[4], data=_unpack_array(body[5]),
                          timestamp=timestamp)
    if kind == MessageKind.SAMPLES:
        return SamplesMessage(
            inspector_id=body[0], handle=body[1],
            samples=_unpack_array(body[2]),
            extras={k: _unpack_array(v) for k, v in body[3].items()},
            timestamp=timestamp)
    if kind == MessageKind.INSPECTOR:
        cfg = None
        if body[5] is not None:
            schema = INSPECTOR_SCHEMAS.get(body[4])
            if schema is not None:
                cfg = Config(schema, body[5])
        return InspectorMessage(
            inspector_kind=_INSP_KIND_FROM[body[0]], request_id=body[1],
            handle=body[2], inspector_id=body[3], class_name=body[4],
            config=cfg, equiv_rate=body[6], bandwidth=body[7], lo=body[8],
            estimator_id=body[9], estimator_value=body[10],
            spectrum_data=_unpack_array(body[11]), spectrum_rate=body[12],
            payload=(OrbitReport(*body[13])
                     if len(body) > 13 and body[13] is not None
                     else None),
            timestamp=timestamp)
    if kind == MessageKind.SOURCE_INFO:
        info = SourceInfo(**{k: v for k, v in body[0].items()
                             if k in SourceInfo.__dataclass_fields__})
        info.gains = dict(body[1])
        return SourceInfoMessage(info=info, timestamp=timestamp)
    if kind == MessageKind.STATUS:
        return StatusMessage(code=body[0], message=body[1],
                             timestamp=timestamp)
    if kind == MessageKind.CHANNEL:
        return ChannelMessage(
            channels=[Channel(fc=c[0], f_low=c[1], f_high=c[2], bw=c[3])
                      for c in body[0]], timestamp=timestamp)
    return Message(kind=kind, timestamp=timestamp)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class SuscanWireServer:
    """Serve a local analyzer to suscan-wire clients.

    ``analyzer`` is anything with the Analyzer control surface
    (``read``, ``set_frequency``, ``open_inspector``...); both the
    generic CPU engine and the KernelAnalyzer qualify.

    Every message goes to every connection, as in the reference.  The
    pump takes every message waiting in the analyzer's queue at once
    (up to ``batch``), frames each one and sends the run's PDUs in
    pieces of about ``send_bytes`` (one ``sendall`` each, which the
    connection's timeout bounds as it bounds one large PDU's): the byte
    stream is the same as one send a PDU, and the pump gives up the
    interpreter lock once a piece instead of once a message.  The run's
    large payloads deflate on a few
    worker threads (zlib lets go of the lock): a wide session's
    digital inspectors send ~16 KiB of symbols a block each, ~0.5 ms of
    deflate apiece, which one thread could not keep up with."""

    batch = 256
    send_bytes = 1 << 16
    deflate_workers = 4

    def __init__(self, analyzer: Any, host: str = "127.0.0.1",
                 port: int = 0, user: str = "", password: str = "",
                 server_name: str = "sigdigger-tpu",
                 permissions: int | None = None,
                 spec: WireSpec = SPEC) -> None:
        self.analyzer = analyzer
        self.spec = spec
        self.user = user
        self.password = password
        self.server_name = server_name
        self.permissions = (SourceInfo.PERM_ALL if permissions is None
                            else permissions)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
        # per-connection send locks: the pump thread broadcasts MESSAGE
        # PDUs while each control thread answers PONG/error PDUs on the
        # SAME socket — unsynchronized sendall calls can interleave
        # mid-PDU and corrupt the framing
        self._clients: dict[socket.socket, threading.Lock] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._deflate: Any = None     # the deflate workers, made on use
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._pump_loop, daemon=True).start()

    # -- connection handling ------------------------------------------------
    def _accept_loop(self) -> None:
        self._srv.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            salt = os.urandom(32)
            auth_required = bool(self.password)
            conn.sendall(write_pdu(
                make_hello(self.server_name, salt, self.spec,
                           auth_required), self.spec))
            if auth_required:
                ct, fields = decode_call(read_pdu(conn, self.spec))
                ok = (ct == CallType.AUTH and len(fields) >= 2
                      and isinstance(fields[0], str)
                      and isinstance(fields[1], bytes)
                      and hmac.compare_digest(
                          fields[1],
                          auth_token(salt, self.password))
                      and hmac.compare_digest(
                          fields[0].encode(), self.user.encode()))
                if not ok:
                    conn.sendall(write_pdu(
                        encode_call(CallType.AUTH_REJECTED,
                                    "authentication failed"), self.spec))
                    conn.close()
                    return
            info = getattr(self.analyzer, "source_info", None)
            d = {}
            gains: dict[str, float] = {}
            if info is not None:
                d = {k: v for k, v in vars(info).items()
                     if isinstance(v, (int, float, str, bool))}
                gains = {k: float(v)
                         for k, v in getattr(info, "gains", {}).items()}
            conn.sendall(write_pdu(
                encode_call(CallType.SOURCE_INFO, self.permissions,
                            d, gains), self.spec))
        except (ConnectionError, ValueError, OSError):
            try:
                conn.close()
            except OSError:
                pass
            return
        conn.settimeout(0.25)
        with self._lock:
            self._clients[conn] = threading.Lock()
        self._control_loop(conn)

    def _send(self, conn: socket.socket, pdu: bytes) -> None:
        """Serialized send: one PDU at a time per connection."""
        with self._lock:
            slock = self._clients.get(conn)
        if slock is None:             # pre-registration (handshake)
            conn.sendall(pdu)
            return
        with slock:
            conn.sendall(pdu)

    # -- message pump -------------------------------------------------------
    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            msg = self.analyzer.read(timeout=0.25)
            if msg is None:
                continue
            msgs = [msg]
            while len(msgs) < self.batch:
                msg = self.analyzer.read(timeout=0.0)
                if msg is None:
                    break
                msgs.append(msg)
            try:
                pieces = self._frame(msgs)
            except RuntimeError:          # the deflate workers shut down
                if self._stop.is_set():
                    return
                raise
            with self._lock:
                clients = list(self._clients)
            for c in clients:
                try:
                    for piece in pieces:
                        self._send(c, piece)
                except OSError:
                    self._drop(c)

    def _frame(self, msgs: list[Message]) -> list[bytes]:
        """The PDUs of ``msgs``, in order, joined into pieces of about
        ``send_bytes``."""
        payloads = [encode_message(m) for m in msgs]
        pdus: list[bytes | None] = [None] * len(payloads)
        big = [i for i, p in enumerate(payloads)
               if len(p) >= self.spec.compress_threshold]
        if len(big) > 1:
            if self._deflate is None:
                from concurrent.futures import ThreadPoolExecutor

                self._deflate = ThreadPoolExecutor(
                    self.deflate_workers, thread_name_prefix="wire-deflate")
            framed = self._deflate.map(
                write_pdu, [payloads[i] for i in big],
                [self.spec] * len(big))
            for i, pdu in zip(big, framed):
                pdus[i] = pdu
        pieces: list[bytes] = []
        run: list[bytes] = []
        size = 0
        for pdu, p in zip(pdus, payloads):
            run.append(pdu if pdu is not None else write_pdu(p, self.spec))
            size += len(run[-1])
            if size >= self.send_bytes:
                pieces.append(b"".join(run))
                run, size = [], 0
        if run:
            pieces.append(b"".join(run))
        return pieces

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            self._clients.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    # -- control ------------------------------------------------------------
    def _control_loop(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                payload = read_pdu(conn, self.spec)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                self._drop(conn)
                return
            try:
                ct, fields = decode_call(payload)
                self._dispatch(conn, ct, fields)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                try:
                    self._send(conn, write_pdu(encode_message(
                        StatusMessage(code=-10, message=str(e))),
                        self.spec))
                except OSError:
                    self._drop(conn)
                    return

    def _dispatch(self, conn: socket.socket, ct: CallType,
                  f: list[Any]) -> None:
        need = CALL_PERMISSIONS.get(ct, 0)
        if need and not (self.permissions & need) == need:
            self._send(conn, write_pdu(encode_message(StatusMessage(
                code=-11, message=f"permission denied: {ct.name}")),
                self.spec))
            return
        an = self.analyzer
        if ct == CallType.PING:
            self._send(conn, write_pdu(encode_call(CallType.PONG, *f),
                                       self.spec))
        elif ct == CallType.SET_FREQUENCY:
            an.set_frequency(f[0], f[1])
        elif ct == CallType.SET_GAIN:
            an.set_gain(f[0], f[1])
        elif ct == CallType.SET_ANTENNA:
            an.set_antenna(f[0])
        elif ct == CallType.SET_BANDWIDTH:
            an.set_bandwidth(f[0])
        elif ct == CallType.SET_PPM:
            an.set_ppm(f[0])
        elif ct == CallType.SET_DC_REMOVE:
            an.set_dc_remove(f[0])
        elif ct == CallType.SET_IQ_REVERSE:
            an.set_iq_reverse(f[0])
        elif ct == CallType.SET_AGC:
            an.set_agc(f[0])
        elif ct == CallType.SEEK:
            an.seek(f[0])
        elif ct == CallType.SET_THROTTLE:
            an.set_throttle(f[0])
        elif ct == CallType.SET_SWEEP_STRATEGY:
            an.set_sweep_strategy(f[0])
        elif ct == CallType.SET_SPECTRUM_PARTITIONING:
            an.set_spectrum_partitioning(f[0])
        elif ct == CallType.SET_HOP_RANGE:
            an.set_hop_range(f[0], f[1])
        elif ct == CallType.SET_BUFFERING_SIZE:
            an.set_buffering_size(f[0])
        elif ct == CallType.SET_HISTORY_SIZE:
            an.set_history_size(f[0])
        elif ct == CallType.REPLAY:
            an.replay(f[0])
        elif ct == CallType.OPEN_INSPECTOR:
            an.open_inspector(f[0], Channel(fc=f[1], bw=f[2]),
                              request_id=f[3], config=f[4])
        elif ct == CallType.CLOSE_INSPECTOR:
            an.close_inspector(f[0], f[1])
        elif ct == CallType.SET_INSPECTOR_CONFIG:
            an.set_inspector_config(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_ID:
            an.set_inspector_id(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_FREQ:
            an.set_inspector_freq(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_BANDWIDTH:
            an.set_inspector_bandwidth(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_WATERMARK:
            an.set_inspector_watermark(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_ESTIMATOR:
            an.set_estimator(f[0], f[1], f[2])
        elif ct == CallType.SET_INSPECTOR_SPECTRUM:
            an.set_spectrum_source(f[0], f[1])
        elif ct == CallType.SET_INSPECTOR_DOPPLER:
            from sigdigger_tpu_torch.orbit import OrbitPredictor, parse_tle

            tle = parse_tle(f[1])[0]
            an.set_inspector_doppler_correction(
                f[0], OrbitPredictor(tle, f[2], f[3], f[4]),
                request_id=f[5])
        elif ct == CallType.DISABLE_INSPECTOR_DOPPLER:
            an.disable_doppler_correction(f[0], f[1])
        elif ct == CallType.REQ_HALT:
            an.halt()
        else:
            raise ValueError(f"unhandled call {ct.name}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        if self._deflate is not None:
            self._deflate.shutdown(wait=False)
        with self._lock:
            for c in list(self._clients):
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class SuscanWireClient:
    """Client mirror of the analyzer control surface over suscan-wire.

    Mirrors the QuickConnect parameters of the reference
    (host/port/user/password, Components/QuickConnectDialog.cpp)."""

    def __init__(self, host: str, port: int, user: str = "",
                 password: str = "", timeout: float = 10.0,
                 spec: WireSpec = SPEC) -> None:
        self.spec = spec
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        ct, fields = decode_call(read_pdu(self._sock, spec))
        if ct != CallType.HELLO:
            raise ConnectionError(f"expected HELLO, got {ct.name}")
        (self.protocol_major, self.protocol_minor, self.server_name,
         auth_mode, salt) = fields
        if auth_mode == spec.auth_mode_user_password:
            self._sock.sendall(write_pdu(make_auth(user, salt, password),
                                         spec))
        ct, fields = decode_call(read_pdu(self._sock, spec))
        if ct == CallType.AUTH_REJECTED:
            raise ConnectionError(f"auth rejected: {fields[0]}")
        if ct != CallType.SOURCE_INFO:
            raise ConnectionError(f"expected SOURCE_INFO, got {ct.name}")
        self.permissions = fields[0]
        self.source_info = SourceInfo(
            **{k: v for k, v in fields[1].items()
               if k in SourceInfo.__dataclass_fields__})
        self.source_info.gains = dict(fields[2])
        self.source_info.permissions = self.permissions

        import queue

        self._mq: "queue.Queue[Message]" = queue.Queue()
        self._stop = threading.Event()
        self._sock.settimeout(0.25)
        threading.Thread(target=self._recv_loop, daemon=True).start()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload = read_pdu(self._sock, self.spec)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                return
            try:
                ct, fields = decode_call(payload)
                if ct == CallType.MESSAGE:
                    self._mq.put(decode_message(fields))
            except (ValueError, KeyError):
                continue          # skip malformed frames, keep the link

    # -- message stream ------------------------------------------------------
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

    # -- control -------------------------------------------------------------
    def _send(self, ct: CallType, *fields: Any) -> None:
        self._sock.sendall(write_pdu(encode_call(ct, *fields), self.spec))

    def set_frequency(self, freq: float, lnb: float = 0.0) -> None:
        self._send(CallType.SET_FREQUENCY, float(freq), float(lnb))

    def set_gain(self, name: str, value: float) -> None:
        self._send(CallType.SET_GAIN, name, float(value))

    def set_antenna(self, name: str) -> None:
        self._send(CallType.SET_ANTENNA, name)

    def set_bandwidth(self, bw: float) -> None:
        self._send(CallType.SET_BANDWIDTH, float(bw))

    def set_ppm(self, ppm: float) -> None:
        self._send(CallType.SET_PPM, float(ppm))

    def set_dc_remove(self, enabled: bool) -> None:
        self._send(CallType.SET_DC_REMOVE, bool(enabled))

    def set_iq_reverse(self, enabled: bool) -> None:
        self._send(CallType.SET_IQ_REVERSE, bool(enabled))

    def set_agc(self, enabled: bool) -> None:
        self._send(CallType.SET_AGC, bool(enabled))

    def seek(self, position: int) -> None:
        self._send(CallType.SEEK, int(position))

    def set_throttle(self, enabled: bool) -> None:
        self._send(CallType.SET_THROTTLE, bool(enabled))

    def set_sweep_strategy(self, strategy) -> None:
        self._send(CallType.SET_SWEEP_STRATEGY,
                   getattr(strategy, "value", str(strategy)))

    def set_spectrum_partitioning(self, part) -> None:
        self._send(CallType.SET_SPECTRUM_PARTITIONING,
                   getattr(part, "value", str(part)))

    def set_hop_range(self, lo: float, hi: float) -> None:
        self._send(CallType.SET_HOP_RANGE, float(lo), float(hi))

    def set_buffering_size(self, size: int) -> None:
        self._send(CallType.SET_BUFFERING_SIZE, int(size))

    def set_history_size(self, size: int) -> None:
        self._send(CallType.SET_HISTORY_SIZE, int(size))

    def replay(self, enabled: bool) -> None:
        self._send(CallType.REPLAY, bool(enabled))

    def open_inspector(self, class_name: str, channel: Channel,
                       request_id: int = 0,
                       config: dict[str, Any] | None = None) -> None:
        self._send(CallType.OPEN_INSPECTOR, class_name,
                   float(channel.fc), float(channel.bw),
                   int(request_id), config)

    def close_inspector(self, handle: int, request_id: int = 0) -> None:
        self._send(CallType.CLOSE_INSPECTOR, int(handle), int(request_id))

    def set_inspector_config(self, handle: int, config: dict[str, Any],
                             request_id: int = 0) -> None:
        self._send(CallType.SET_INSPECTOR_CONFIG, int(handle), config,
                   int(request_id))

    def set_inspector_id(self, handle: int, inspector_id: int,
                         request_id: int = 0) -> None:
        self._send(CallType.SET_INSPECTOR_ID, int(handle),
                   int(inspector_id), int(request_id))

    def set_inspector_freq(self, handle: int, freq: float,
                           request_id: int = 0) -> None:
        self._send(CallType.SET_INSPECTOR_FREQ, int(handle), float(freq),
                   int(request_id))

    def set_inspector_bandwidth(self, handle: int, bw: float,
                                request_id: int = 0) -> None:
        self._send(CallType.SET_INSPECTOR_BANDWIDTH, int(handle),
                   float(bw), int(request_id))

    def set_inspector_watermark(self, handle: int, watermark: int,
                                request_id: int = 0) -> None:
        self._send(CallType.SET_INSPECTOR_WATERMARK, int(handle),
                   int(watermark), int(request_id))

    def set_inspector_doppler_correction(
            self, handle: int, tle_text: str, lat_deg: float,
            lon_deg: float, alt_km: float = 0.0,
            request_id: int = 0) -> None:
        """Enable satellite Doppler tracking on an inspector: the
        server builds an OrbitPredictor from the TLE + ground site and
        retunes the channel live (reference setInspectorDopplerCorrection,
        Suscan/Analyzer.cpp:568-579)."""
        self._send(CallType.SET_INSPECTOR_DOPPLER, int(handle),
                   str(tle_text), float(lat_deg), float(lon_deg),
                   float(alt_km), int(request_id))

    def disable_doppler_correction(self, handle: int,
                                   request_id: int = 0) -> None:
        self._send(CallType.DISABLE_INSPECTOR_DOPPLER, int(handle),
                   int(request_id))

    def set_estimator(self, handle: int, estimator: str,
                      enabled: bool) -> None:
        self._send(CallType.SET_INSPECTOR_ESTIMATOR, int(handle),
                   estimator, bool(enabled))

    def set_spectrum_source(self, handle: int, source: int) -> None:
        self._send(CallType.SET_INSPECTOR_SPECTRUM, int(handle),
                   int(source))

    def req_halt(self) -> None:
        self._send(CallType.REQ_HALT)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
