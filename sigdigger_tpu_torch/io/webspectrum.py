"""Live web waterfall — HTTP view AND control of a running session
(counterpart of ``sigdigger_tpu/io/webspectrum.py``; the PNG comes from
the port's ``utils/waterfall``).

Headless counterpart of the reference's MainSpectrum window (reference
Components/MainSpectrum.cpp waterfall feed 196-210 and its
click-to-tune / filter-box control surface): one thread, the stdlib
HTTP server —

  GET  /                 self-refreshing page (waterfall + peak info;
                         click the waterfall to tune when control is
                         attached)
  GET  /waterfall.png    the current waterfall raster
  GET  /psd.json         latest PSD row + metadata
  GET  /control/state    tuner frequency + open inspectors

and, when constructed with ``analyzer=...`` (control endpoints on the
live view; JSON bodies):

  POST /control/tune               {"frequency": Hz}
  POST /control/inspector/open     {"class","fc","bw","config"} → handle
  POST /control/inspector/close    {"handle"}
  POST /control/inspector/config   {"handle","config"}  (squelch,
                                   volume, agc, … — the inspector
                                   config-key contract)
  POST /control/inspector/freq     {"handle","freq"}
  POST /control/inspector/bandwidth {"handle","bw"}

The session feeds :meth:`feed` with every PSDMessage; rendering cost
is paid per HTTP request, not per message.  The server binds loopback
by default — front it with the wire server's authenticated protocol
for remote control.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>sigdigger_tpu_torch live spectrum</title>
<style>body{background:#111;color:#ddd;font-family:monospace}
img{width:100%;image-rendering:pixelated;border:1px solid #444}
</style></head><body>
<h3>sigdigger_tpu_torch live spectrum</h3>
<div id=i>&nbsp;</div>
<img id=w src="/waterfall.png">
<script>
let J=null;
async function tick(){
 try{
  const r=await fetch('/psd.json');const j=await r.json();J=j;
  document.getElementById('i').textContent=
   `center ${(j.frequency/1e6).toFixed(4)} MHz  rate ${(j.sample_rate/1e6).toFixed(3)} Msps  `+
   `peak ${(j.peak_freq/1e6).toFixed(4)} MHz ${j.peak_db.toFixed(1)} dB  rows ${j.rows}`+
   (j.control?'  [click waterfall to tune]':'');
  document.getElementById('w').src='/waterfall.png?t='+Date.now();
 }catch(e){}
 setTimeout(tick,1000);
}
document.getElementById('w').onclick=async e=>{
 if(!J||!J.control)return;
 const r=e.target.getBoundingClientRect();
 const f=J.frequency+((e.clientX-r.left)/r.width-0.5)*J.sample_rate;
 await fetch('/control/tune',{method:'POST',
  body:JSON.stringify({frequency:f})});
};
tick();
</script></body></html>"""


class WebSpectrumServer:
    """Serve the live waterfall + PSD over HTTP."""

    def __init__(self, waterfall, host: str = "127.0.0.1",
                 port: int = 0, analyzer=None) -> None:
        self._wf = waterfall
        self._an = analyzer
        self._lock = threading.Lock()
        self._psd: np.ndarray | None = None
        self._meta: dict = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/waterfall.png":
                    with outer._lock:
                        png = outer._wf.png_bytes()
                    self._send(200, "image/png", png)
                elif path == "/psd.json":
                    self._send(200, "application/json",
                               outer._psd_json())
                elif path == "/control/state":
                    self._json(200, outer._state())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._json(400, {"error": "bad json"})
                    return
                try:
                    out = outer._control(path, body)
                except KeyError as e:
                    self._json(400, {"error": f"missing field {e}"})
                    return
                except Exception as e:  # noqa: BLE001 → HTTP error
                    self._json(400, {"error": str(e)})
                    return
                if out is None:
                    self._send(404, "text/plain", b"not found")
                else:
                    self._json(200, out)

            def _json(self, code, obj):
                self._send(code, "application/json",
                           json.dumps(obj).encode())

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.address = self._srv.server_address
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True, name="web-spectrum").start()

    def feed(self, msg) -> None:
        """Consume one PSDMessage (the session's pump calls this)."""
        data = np.asarray(msg.data, np.float32)
        with self._lock:
            self._psd = data
            self._meta = {
                "frequency": float(msg.frequency),
                "sample_rate": float(msg.sample_rate),
                "measured_sample_rate": float(
                    msg.measured_sample_rate),
                "timestamp": float(msg.timestamp),
                "fft_size": int(msg.fft_size),
            }

    def _state(self) -> dict:
        """Tuner + open-inspector snapshot (MainSpectrum's control
        readback)."""
        an = self._an
        if an is None:
            return {"control": False, "inspectors": []}
        with an._lock:
            insp = [{"handle": slot.handle,
                     "class": slot.class_name,
                     "lo": float(slot.lo),
                     "bandwidth": float(slot.bandwidth)}
                    for slot in an._inspectors.values()]
        return {"control": True,
                "frequency": float(an.profile.freq),
                "sample_rate": float(an.sample_rate),
                "inspectors": insp}

    def _control(self, path: str, body: dict):
        """Dispatch one control POST onto the live engine APIs."""
        an = self._an
        if an is None:
            raise RuntimeError(
                "view-only server: no analyzer attached")
        if path == "/control/tune":
            f = float(body["frequency"])
            an.set_frequency(f)
            return {"ok": True, "frequency": f}
        if path == "/control/inspector/open":
            from sigdigger_tpu_torch.types import Channel

            handle = an.open_inspector(
                str(body.get("class", "audio")),
                Channel(fc=float(body["fc"]),
                        bw=float(body.get("bw", 10e3))),
                config=body.get("config") or None)
            return {"ok": True, "handle": handle}
        if path == "/control/inspector/close":
            an.close_inspector(int(body["handle"]))
            return {"ok": True}
        if path == "/control/inspector/config":
            an.set_inspector_config(int(body["handle"]),
                                    dict(body["config"]))
            return {"ok": True}
        if path == "/control/inspector/freq":
            an.set_inspector_freq(int(body["handle"]),
                                  float(body["freq"]))
            return {"ok": True}
        if path == "/control/inspector/bandwidth":
            an.set_inspector_bandwidth(int(body["handle"]),
                                       float(body["bw"]))
            return {"ok": True}
        return None

    def _psd_json(self) -> bytes:
        with self._lock:
            psd = self._psd
            meta = dict(self._meta)
        if psd is None:
            return json.dumps(
                {"rows": 0, "control": self._an is not None}).encode()
        db = 10.0 * np.log10(np.asarray(psd, np.float64) + 1e-30)
        k = int(np.argmax(db))
        fs = meta.get("sample_rate", 0.0)
        n = len(db)
        meta.update({
            "rows": int(self._wf.rows),
            "control": self._an is not None,
            "peak_db": float(db[k]),
            "peak_freq": meta.get("frequency", 0.0)
            + (k - n // 2) * fs / n,
            "psd_db": [round(float(v), 2) for v in db],
        })
        return json.dumps(meta).encode()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
