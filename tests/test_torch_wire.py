"""The port's suscan-wire protocol (``sigdigger_tpu_torch/io/suscan_wire.py``
and ``io/cbor.py``) against the reference's, on the CPU.

The wire image is the contract, so the checks are byte-for-byte:
- the CBOR and PDU golden vectors of ``tests/test_suscan_wire.py``;
- ``encode_call``, ``encode_message``, ``make_hello`` and ``make_auth``
  equal between the packages on a seeded corpus (every call type, every
  message kind, random arrays, configs, orbit reports and salts);
- each package decodes the other's bytes to the same fields.

Then interop over loopback in both directions (the reference's client
against the port's server, and the port's client against the
reference's server): auth and its rejection, PSD streaming, permission
denial, the sync setters, inspector open / retune / watermark / close,
PING floods beside the broadcast, and the inflate-bomb and truncation
guards on a live connection.  The port's server broadcasts every
message to every connection as the reference's does, and its byte
stream is the reference's PDUs in order however the pump batches them.
No tolerance: every comparison is exact.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from sigdigger_tpu import config as ref_config
from sigdigger_tpu.analyzer import messages as ref_msgs
from sigdigger_tpu.io import cbor as ref_cbor
from sigdigger_tpu.io import suscan_wire as ref_wire
from sigdigger_tpu_torch import config as port_config
from sigdigger_tpu_torch.analyzer import messages as port_msgs
from sigdigger_tpu_torch.io import cbor
from sigdigger_tpu_torch.io import suscan_wire as port_wire
from sigdigger_tpu_torch.types import Channel, SourceInfo

SALT = bytes(range(32))


# ---------------------------------------------------------------------------
# golden vectors (tests/test_suscan_wire.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obj,expect", [
    (0, b"\x00"), (23, b"\x17"), (24, b"\x18\x18"), (256, b"\x19\x01\x00"),
    (-1, b"\x20"), (-100, b"\x38\x63"), (True, b"\xf5"), (False, b"\xf4"),
    (None, b"\xf6"), ("a", b"\x61\x61"), (b"\x01\x02", b"\x42\x01\x02"),
    ([1, 2], b"\x82\x01\x02"), ({1: 2}, b"\xa1\x01\x02"),
    (1.5, b"\xfb\x3f\xf8\x00\x00\x00\x00\x00\x00"),
    (np.float32(1.5), b"\xfa\x3f\xc0\x00\x00"),
])
def test_cbor_golden(obj, expect):
    assert cbor.encode(obj) == expect
    assert cbor.decode(expect) == obj


def test_cbor_rejects_trailing_truncated_and_tensors():
    for bad in (b"\x00\x00", b"\x42\x01"):
        with pytest.raises(ValueError):
            cbor.decode(bad)
    with pytest.raises(TypeError):
        cbor.encode([torch.zeros(2)])


def _cbor_value(rng, depth: int = 0):
    """A seeded nested value of every kind the codec takes."""
    kind = int(rng.integers(13 if depth < 4 else 9))
    if kind == 0:
        return int(rng.choice([0, 23, 24, 255, 256, 65535, 65536, 2**32 - 1,
                               2**32, 2**63, -1, -24, -25, -257, -2**40,
                               int(rng.integers(-10**12, 10**12))]))
    if kind == 1:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 5)))
    if kind == 2:
        return np.float32(rng.normal())
    if kind == 3:
        return [None, True, False][int(rng.integers(3))]
    if kind == 4:
        return rng.bytes(int(rng.choice([0, 5, 23, 24, 300, 70000])))
    if kind == 5:
        return "".join(rng.choice(list("abé€x"), int(rng.choice([0, 3, 30]))))
    if kind == 6:
        return np.int64(rng.integers(-1000, 10**6))
    if kind == 7:
        return np.float64(rng.normal())
    if kind == 8:
        return bytearray(b"xy")
    if kind in (9, 10):
        return [_cbor_value(rng, depth + 1)
                for _ in range(int(rng.choice([0, 2, 23, 24, 30])))]
    if kind == 11:
        return tuple(_cbor_value(rng, depth + 1) for _ in range(3))
    return {["k", "a", 1, -2][int(rng.integers(4))]: _cbor_value(rng, depth + 1)
            for _ in range(int(rng.integers(4)))}


def _outcome(fn, buf):
    try:
        return "ok", repr(fn(buf))
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("seed", range(3))
def test_cbor_matches_reference_on_a_seeded_corpus(seed):
    """Every value encodes to the reference's bytes and decodes to the
    same value; every prefix of an encoding (truncations) and a few
    unsupported items give the reference's result or error."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        obj = _cbor_value(rng)
        want = ref_cbor.encode(obj)
        assert cbor.encode(obj) == want
        assert _outcome(cbor.decode, want) == _outcome(ref_cbor.decode, want)
        cut = want[:int(rng.integers(len(want) + 1))]
        assert _outcome(cbor.decode, cut) == _outcome(ref_cbor.decode, cut)
    for junk in (b"\xc0\x00", b"\x1c", b"\xff", b"\xf7", b"\x5f", b"\x9f",
                 b"\x00\x00"):
        assert _outcome(cbor.decode, junk) == _outcome(ref_cbor.decode, junk)


def test_pdu_and_handshake_golden():
    spec = port_wire.SPEC
    assert port_wire.write_pdu(b"\x01\x02\x03") == struct.pack(
        ">II", spec.pdu_magic, 3) + b"\x01\x02\x03"
    big = b"\x00" * (spec.compress_threshold + 1)
    pdu = port_wire.write_pdu(big)
    magic, size = struct.unpack(">II", pdu[:8])
    assert magic == spec.pdu_magic_compressed and size == len(pdu) - 8
    assert zlib.decompress(pdu[8:]) == big
    assert port_wire.make_hello("sigdigger-tpu", SALT) == (
        b"\x86\x00\x00\x01\x6dsigdigger-tpu\x01\x58\x20" + SALT)
    tok = hashlib.sha256(SALT + hashlib.sha256(b"hunter2").digest()).digest()
    assert port_wire.auth_token(SALT, "hunter2") == tok
    assert port_wire.make_auth("op", SALT, "hunter2") == \
        b"\x83\x01\x62op\x58\x20" + tok
    assert port_wire.encode_call(port_wire.CallType.SET_FREQUENCY, 100e6,
                                 0.0) == (
        b"\x83\x07\xfb\x41\x97\xd7\x84\x00\x00\x00\x00"
        b"\xfb\x00\x00\x00\x00\x00\x00\x00\x00")


def test_psd_message_golden():
    data = np.arange(4, dtype=np.float32)
    msg = port_msgs.PSDMessage(fft_size=4, sample_rate=1e6,
                               measured_sample_rate=1e6, frequency=100e6,
                               looped=False, data=data, timestamp=0.0)
    assert port_wire.encode_message(msg) == (
        b"\x84\x05\x00"
        b"\xfb\x00\x00\x00\x00\x00\x00\x00\x00"
        b"\x86\x04"
        b"\xfb\x41\x2e\x84\x80\x00\x00\x00\x00"
        b"\xfb\x41\x2e\x84\x80\x00\x00\x00\x00"
        b"\xfb\x41\x97\xd7\x84\x00\x00\x00\x00"
        b"\xf4"
        b"\x83\x67float32\x81\x04\x50" + data.tobytes())


def test_wire_constants_equal():
    assert port_wire.SPEC.__dict__ == ref_wire.SPEC.__dict__
    assert [(c.name, c.value) for c in port_wire.CallType] == \
        [(c.name, c.value) for c in ref_wire.CallType]
    assert {c.name: p for c, p in port_wire.CALL_PERMISSIONS.items()} == \
        {c.name: p for c, p in ref_wire.CALL_PERMISSIONS.items()}


# ---------------------------------------------------------------------------
# byte equality on a seeded corpus
# ---------------------------------------------------------------------------

def _message_specs(seed: int) -> list:
    """(class name, fields) of every message kind, arrays from a seed."""
    rng = np.random.default_rng(seed)

    def arr(n, dt):
        if dt == np.complex64:
            return (rng.standard_normal(n)
                    + 1j * rng.standard_normal(n)).astype(dt)
        if dt == np.bool_:
            return rng.integers(0, 2, n).astype(bool)
        if np.issubdtype(dt, np.integer):
            return rng.integers(0, 4, n).astype(dt)
        return rng.standard_normal(n).astype(dt)

    ts = float(rng.uniform(0, 2e9))
    n = int(rng.integers(1, 300))
    specs = [
        ("PSDMessage", dict(fft_size=n, sample_rate=float(rng.uniform(1e3,
                                                                    1e8)),
                            measured_sample_rate=float(rng.uniform(1e3,
                                                                   1e8)),
                            frequency=float(rng.uniform(0, 6e9)),
                            looped=bool(rng.integers(2)),
                            data=arr(n, np.float32), timestamp=ts)),
        ("SamplesMessage", dict(
            inspector_id=int(rng.integers(0, 1 << 31)),
            handle=int(rng.integers(0, 4096)),
            samples=arr(n, np.complex64),
            extras={"strobes": arr(n, np.bool_),
                    "symbols": arr(n, np.uint8),
                    "squelch_open": bool(rng.integers(2))},
            timestamp=ts)),
        ("SamplesMessage", dict(inspector_id=1, handle=2,
                                samples=arr(n, np.float32), timestamp=ts)),
        ("StatusMessage", dict(code=int(rng.integers(-20, 20)),
                               message=f"status {rng.integers(1000)} µ",
                               timestamp=ts)),
        ("ChannelMessage", dict(channels=[
            ("Channel", dict(fc=float(rng.normal()), f_low=-1.0, f_high=2.5,
                             bw=float(rng.uniform(1, 1e5))))
            for _ in range(int(rng.integers(0, 4)))], timestamp=ts)),
        ("SourceInfoMessage", dict(info=("SourceInfo", dict(
            sample_rate=float(rng.uniform(1e3, 1e8)),
            frequency=float(rng.uniform(0, 6e9)), antenna="RX2",
            seekable=bool(rng.integers(2)),
            gains={"LNA": float(rng.normal()), "VGA": 3.0})),
            timestamp=ts)),
    ]
    for kind in ("EOS", "HALT", "READ_ERROR"):
        specs.append(("Message", dict(kind=("MessageKind", kind),
                                      timestamp=ts)))
    for ik in ("OPEN", "SET_FREQ", "ESTIMATOR", "SPECTRUM", "ORBIT_REPORT",
               "WRONG_HANDLE"):
        cls = ["audio", "psk", "raw"][int(rng.integers(3))]
        specs.append(("InspectorMessage", dict(
            inspector_kind=("InspectorMessageKind", ik),
            request_id=int(rng.integers(0, 1 << 20)),
            handle=int(rng.integers(0, 4096)), inspector_id=3,
            class_name=cls,
            config=(("Config", cls, {}) if ik == "OPEN" else None),
            equiv_rate=float(rng.uniform(1e3, 1e6)),
            bandwidth=float(rng.uniform(1e3, 1e6)),
            lo=float(rng.normal() * 1e5), estimator_id="baud",
            estimator_value=float(rng.normal()),
            spectrum_data=(arr(16, np.float32) if ik == "SPECTRUM"
                           else None),
            spectrum_rate=float(rng.uniform(0, 10)),
            payload=(("OrbitReport", tuple(float(v) for v in
                                           rng.normal(size=6)))
                     if ik == "ORBIT_REPORT" else None),
            timestamp=ts)))
    return specs


def _build(pkg, spec):
    """A message of ``pkg`` (messages, config, types) from a spec."""
    msgs, config, types = pkg

    def val(v):
        if isinstance(v, tuple) and v and v[0] in ("MessageKind",
                                                   "InspectorMessageKind"):
            return getattr(getattr(msgs, v[0]), v[1])
        if isinstance(v, tuple) and v and v[0] == "Config":
            schema = config.INSPECTOR_SCHEMAS[v[1]]
            return config.Config(schema, v[2])
        if isinstance(v, tuple) and v and v[0] == "OrbitReport":
            return msgs.OrbitReport(*v[1])
        if isinstance(v, tuple) and v and v[0] in ("Channel", "SourceInfo"):
            return getattr(types, v[0])(**v[1])
        if isinstance(v, list):
            return [val(x) for x in v]
        return v

    name, fields = spec
    return getattr(msgs, name)(**{k: val(v) for k, v in fields.items()})


REF = (ref_msgs, ref_config, __import__("sigdigger_tpu.types",
                                        fromlist=["types"]))
PORT = (port_msgs, port_config, __import__("sigdigger_tpu_torch.types",
                                           fromlist=["types"]))


@pytest.mark.parametrize("seed", range(4))
def test_encode_message_byte_equal(seed):
    for spec in _message_specs(seed):
        want = ref_wire.encode_message(_build(REF, spec))
        got = port_wire.encode_message(_build(PORT, spec))
        assert got == want, spec[0]
        # each decodes the other's bytes to the same wire image
        back = port_wire.decode_message(port_wire.decode_call(want)[1])
        assert type(back).__module__ == port_msgs.__name__
        assert port_wire.encode_message(back) == want
        back = ref_wire.decode_message(ref_wire.decode_call(got)[1])
        assert ref_wire.encode_message(back) == got


def _call_fields(rng, ct_name: str) -> list:
    """Seeded fields for one call type, of every CBOR kind."""
    pick = [
        lambda: float(rng.normal() * 1e8),
        lambda: np.float32(rng.normal()),
        lambda: int(rng.integers(-1 << 40, 1 << 40)),
        lambda: bool(rng.integers(2)),
        lambda: f"name{rng.integers(100)}",
        lambda: rng.bytes(int(rng.integers(0, 40))),
        lambda: None,
        lambda: {"audio.volume": float(rng.uniform()),
                 "audio.demodulator": int(rng.integers(1, 6))},
        lambda: [int(rng.integers(9)), "x", [1.5]],
    ]
    return [pick[int(rng.integers(len(pick)))]()
            for _ in range(int(rng.integers(0, 7)))]


@pytest.mark.parametrize("seed", range(4))
def test_encode_call_hello_auth_byte_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for ct in ref_wire.CallType:
        fields = _call_fields(rng, ct.name)
        assert cbor.encode(fields) == ref_cbor.encode(fields)
        want = ref_wire.encode_call(ct, *fields)
        assert port_wire.encode_call(port_wire.CallType[ct.name],
                                     *fields) == want
        assert port_wire.write_pdu(want) == ref_wire.write_pdu(want)
    for auth in (True, False):
        salt = rng.bytes(32)
        name = f"server-{rng.integers(1000)}"
        assert port_wire.make_hello(name, salt, auth_required=auth) == \
            ref_wire.make_hello(name, salt, auth_required=auth)
        pw = rng.bytes(12).hex()
        assert port_wire.make_auth("op", salt, pw) == \
            ref_wire.make_auth("op", salt, pw)


def test_encoder_refuses_tensors():
    """A tensor in a message is a TypeError, never a silent copy."""
    cases = [
        port_msgs.PSDMessage(fft_size=4, data=torch.zeros(4)),
        port_msgs.SamplesMessage(samples=torch.zeros(4, dtype=torch.complex64)),
        port_msgs.SamplesMessage(samples=np.zeros(4, np.float32),
                                 extras={"strobes": torch.ones(4,
                                                               dtype=bool)}),
        port_msgs.InspectorMessage(spectrum_data=torch.ones(3)),
    ]
    for msg in cases:
        with pytest.raises(TypeError, match="tensor"):
            port_wire.encode_message(msg)


class _Stub:
    """A socket that replays ``raw``."""

    def __init__(self, raw: bytes) -> None:
        self._raw, self._pos = raw, 0

    def recv(self, n):
        chunk = self._raw[self._pos:self._pos + n]
        self._pos += len(chunk)
        return chunk


def _bomb() -> bytes:
    spec = port_wire.SPEC
    z = zlib.compress(b"\x00" * (spec.max_pdu_size * 4), 9)
    assert len(z) < spec.max_pdu_size
    return struct.pack(">II", spec.pdu_magic_compressed, len(z)) + z


def test_read_pdu_guards():
    spec = port_wire.SPEC
    with pytest.raises(ConnectionError, match="oversized"):
        port_wire.read_pdu(_Stub(_bomb()))
    z = zlib.compress(b"hello world" * 100)[:-4]
    with pytest.raises(ConnectionError):
        port_wire.read_pdu(_Stub(struct.pack(
            ">II", spec.pdu_magic_compressed, len(z)) + z))
    with pytest.raises(ConnectionError, match="magic"):
        port_wire.read_pdu(_Stub(struct.pack(">II", 0xDEADBEEF, 1) + b"x"))
    with pytest.raises(ConnectionError, match="oversized"):
        port_wire.read_pdu(_Stub(struct.pack(">II", spec.pdu_magic,
                                             spec.max_pdu_size + 1)))
    a, b = socket.socketpair()
    try:
        for payload in (b"xyz", b"\x07" * (spec.compress_threshold * 2)):
            a.sendall(port_wire.write_pdu(payload))
            assert port_wire.read_pdu(b) == payload
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# interop over loopback, both directions
# ---------------------------------------------------------------------------

def _port_analyzer():
    from sigdigger_tpu_torch.analyzer.engine import Analyzer
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import ToneGenSource
    from sigdigger_tpu_torch.types import AnalyzerParams

    prof = SourceProfile(type="tonegen", sample_rate=64_000, tone_freq=8e3,
                         freq=100e6)
    return Analyzer(source=ToneGenSource(prof),
                    params=AnalyzerParams(window_size=512), block_size=4096,
                    device="cpu")


def _ref_analyzer():
    from test_suscan_wire import _make_analyzer

    return _make_analyzer()


# (server module, analyzer maker, client module)
DIRECTIONS = {
    "ref_client_port_server": (port_wire, _port_analyzer, ref_wire),
    "port_client_ref_server": (ref_wire, _ref_analyzer, port_wire),
}


def _wait(cl, pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        m = cl.read(timeout=0.5)
        if m is not None and pred(m):
            return m
    return None


def _until(pred, timeout=5.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.05)
    return pred()


@pytest.fixture(params=sorted(DIRECTIONS))
def link(request):
    srv_mod, make, cli_mod = DIRECTIONS[request.param]
    an = make()
    servers = []

    def serve(**kw):
        srv = srv_mod.SuscanWireServer(an, **kw)
        servers.append(srv)
        return srv

    yield an, serve, cli_mod
    for srv in servers:
        srv.close()
    an.halt()


def _is(m, kind: str, ikind: str | None = None) -> bool:
    if m.kind.name != kind:
        return False
    return ikind is None or m.inspector_kind.name == ikind


def test_interop_auth_stream_and_inspector(link):
    an, serve, cl_mod = link
    srv = serve(user="op", password="s3cret")
    with pytest.raises(ConnectionError, match="auth rejected"):
        cl_mod.SuscanWireClient("127.0.0.1", srv.address[1], user="op",
                                password="wrong")
    cl = cl_mod.SuscanWireClient("127.0.0.1", srv.address[1], user="op",
                                 password="s3cret")
    try:
        assert cl.server_name == "sigdigger-tpu"
        assert cl.permissions == SourceInfo.PERM_ALL
        assert cl.source_info.sample_rate == 64_000
        an.start()
        psd = _wait(cl, lambda m: _is(m, "PSD"))
        assert psd is not None and psd.fft_size == 512
        freqs = np.linspace(-32e3, 32e3, 512, endpoint=False)
        assert abs(freqs[np.argmax(psd.data)] - 8e3) < 300.0
        cl.open_inspector("audio", cl_mod.Channel(fc=8e3, bw=4e3),
                          request_id=77,
                          config={"audio.demodulator": 2,
                                  "audio.sample-rate": 8000.0})
        opened = _wait(cl, lambda m: _is(m, "INSPECTOR", "OPEN"))
        assert opened is not None and opened.request_id == 77
        assert opened.class_name == "audio"
        h = opened.handle
        got = _wait(cl, lambda m: _is(m, "SAMPLES") and m.handle == h)
        assert got is not None and len(got.samples) > 0
        cl.set_inspector_freq(h, -8e3, request_id=6)
        ack = _wait(cl, lambda m: _is(m, "INSPECTOR", "SET_FREQ"))
        assert ack is not None and ack.lo == -8e3 and ack.request_id == 6
        cl.set_inspector_watermark(h, 9999, request_id=5)
        ack = _wait(cl, lambda m: _is(m, "INSPECTOR", "SET_WATERMARK"))
        assert ack is not None and ack.request_id == 5
        assert an._inspectors[h].watermark == 9999
        cl.close_inspector(h, request_id=8)
        ack = _wait(cl, lambda m: _is(m, "INSPECTOR", "CLOSE"))
        assert ack is not None and ack.request_id == 8
        assert _until(lambda: h not in an._inspectors)
        cl.set_frequency(433e6)
        assert _until(lambda: an.profile.freq == 433e6)
    finally:
        cl.close()


def test_interop_permission_denied(link):
    an, serve, cl_mod = link
    srv = serve(permissions=SourceInfo.PERM_ALL & ~SourceInfo.PERM_SET_FREQ)
    cl = cl_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    try:
        assert cl.permissions == SourceInfo.PERM_ALL \
            & ~SourceInfo.PERM_SET_FREQ
        cl.set_frequency(1e6)
        denied = _wait(cl, lambda m: _is(m, "STATUS") and m.code == -11)
        assert denied is not None and "SET_FREQUENCY" in denied.message
        assert an.profile.freq != 1e6
    finally:
        cl.close()


def test_interop_sync_setters(link):
    an, serve, cl_mod = link
    srv = serve()
    cl = cl_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    try:
        cl.set_gain("LNA", 30.0)
        cl.set_antenna("RX2")
        cl.set_ppm(1.5)
        cl.set_dc_remove(True)
        cl.set_iq_reverse(True)
        cl.set_agc(True)
        cl.set_throttle(False)
        assert _until(lambda: an.profile.agc)
        p = an.profile
        assert (p.gains["LNA"], p.antenna, p.ppm) == (30.0, "RX2", 1.5)
        assert p.dc_remove and p.iq_reverse and not p.throttle
        # an unknown inspector handle answers, the link stays up
        cl.set_inspector_freq(4095, 1e3, request_id=3)
        wrong = _wait(cl, lambda m: _is(m, "INSPECTOR", "WRONG_HANDLE"))
        assert wrong is not None and wrong.request_id == 3
    finally:
        cl.close()


def test_interop_ping_flood_beside_broadcast(link):
    an, serve, cl_mod = link
    srv = serve()
    cl = cl_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    stop = threading.Event()

    def pinger():
        i = 0
        while not stop.is_set():
            cl._send(cl_mod.CallType.PING, i)
            i += 1
            time.sleep(0.001)

    t = threading.Thread(target=pinger, daemon=True)
    try:
        an.start()
        t.start()
        n = 0
        deadline = time.time() + 8.0
        while time.time() < deadline and n < 40:
            n += cl.read(timeout=0.5) is not None
        assert n >= 40
    finally:
        stop.set()
        t.join(timeout=2.0)
        assert not t.is_alive()
        cl.close()


def test_interop_bomb_drops_only_that_link(link):
    """A client that sends an inflate bomb is dropped; the server keeps
    serving the next one."""
    an, serve, cl_mod = link
    srv = serve()
    raw = socket.create_connection(("127.0.0.1", srv.address[1]), timeout=5)
    try:
        ct, _ = cl_mod.decode_call(cl_mod.read_pdu(raw))
        assert ct.name == "HELLO"
        ct, _ = cl_mod.decode_call(cl_mod.read_pdu(raw))
        assert ct.name == "SOURCE_INFO"
        raw.sendall(_bomb())
        raw.settimeout(5.0)
        closed = False
        deadline = time.time() + 5.0
        while time.time() < deadline and not closed:
            try:
                closed = raw.recv(65536) == b""
            except ConnectionError:
                closed = True
        assert closed
    finally:
        raw.close()
    cl = cl_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    try:
        cl.set_ppm(2.5)
        assert _until(lambda: an.profile.ppm == 2.5)
    finally:
        cl.close()


@pytest.mark.parametrize("cli_mod", [port_wire, ref_wire],
                         ids=["port_client", "ref_client"])
def test_port_server_broadcasts_samples_like_the_reference(cli_mod):
    """Every message goes to every connection, as the reference's server
    sends it: each client sees both OPEN acks and the SAMPLES of every
    inspector, its own, the other client's and a server-side one."""
    an = _port_analyzer()
    srv = port_wire.SuscanWireServer(an)
    a = cli_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    b = cli_mod.SuscanWireClient("127.0.0.1", srv.address[1])
    try:
        own = an.open_inspector("audio", Channel(fc=-8e3, bw=4e3))
        a.open_inspector("audio", cli_mod.Channel(fc=8e3, bw=4e3),
                         request_id=1)
        b.open_inspector("raw", cli_mod.Channel(fc=8e3, bw=4e3),
                         request_id=2)
        acks = {}
        for cl in (a, b):              # each connection sees both acks
            got = {}
            deadline = time.time() + 10.0
            while not {1, 2} <= set(got) and time.time() < deadline:
                m = cl.read(timeout=0.5)
                if m is not None and _is(m, "INSPECTOR", "OPEN"):
                    got[m.request_id] = m.handle
            assert {1, 2} <= set(got)
            acks.update(got)
        an.start()
        handles = {own, acks[1], acks[2]}
        for cl in (a, b):
            seen: dict = {h: 0 for h in handles}
            deadline = time.time() + 10.0
            while time.time() < deadline and min(seen.values()) < 3:
                m = cl.read(timeout=0.5)
                if m is not None and _is(m, "SAMPLES"):
                    seen[m.handle] += 1
            assert min(seen.values()) >= 3, seen
        # a closed inspector's ack reaches the other client too
        a.close_inspector(acks[1], request_id=3)
        assert _wait(b, lambda m: _is(m, "INSPECTOR", "CLOSE")
                     and m.request_id == 3) is not None
        assert _wait(a, lambda m: _is(m, "PSD")) is not None
    finally:
        a.close()
        b.close()
        srv.close()
        an.halt()


class _Scripted:
    """An analyzer whose queue the test fills: the server's pump reads
    it with ``read(timeout)``."""

    source_info = None

    def __init__(self) -> None:
        import queue

        self.q = queue.Queue()

    def read(self, timeout=None):
        import queue

        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


@pytest.mark.parametrize("n", [1, 700, 2500])
def test_port_server_stream_is_the_reference_pdus_in_order(n):
    """The pump sends whatever waits in the queue as one run of PDUs: the
    bytes a connection receives are the reference's PDU of each message,
    in the queue's order, with nothing between (runs of up to
    ``batch`` messages and runs longer than that, the large payloads
    deflated on the server's worker threads)."""
    an = _Scripted()
    srv = port_wire.SuscanWireServer(an)
    raw = socket.create_connection(("127.0.0.1", srv.address[1]), timeout=10)
    corpus = [spec for seed in range(8) for spec in _message_specs(seed)]
    rng = np.random.default_rng(n)
    # every 40th a squeezed block's worth of symbols: deflated PDUs
    big = [("SamplesMessage", dict(
        inspector_id=5, handle=9, timestamp=1.5,
        samples=(rng.standard_normal(m) + 1j * rng.standard_normal(m))
        .astype(np.complex64))) for m in (2048, 4096, 3000)]
    specs = [big[i % 3] if i % 40 == 39 else corpus[i % len(corpus)]
             for i in range(n)]
    try:
        for want in ("HELLO", "SOURCE_INFO"):
            ct, _ = port_wire.decode_call(port_wire.read_pdu(raw))
            assert ct.name == want
        assert _until(lambda: len(srv._clients) == 1)
        for spec in specs:
            an.q.put(_build(PORT, spec))
        want = b"".join(ref_wire.write_pdu(ref_wire.encode_message(
            _build(REF, spec))) for spec in specs)
        got = bytearray()
        raw.settimeout(10.0)
        while len(got) < len(want):
            chunk = raw.recv(1 << 20)
            assert chunk
            got += chunk
        assert bytes(got) == want
    finally:
        raw.close()
        srv.close()
