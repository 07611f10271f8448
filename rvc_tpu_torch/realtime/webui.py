"""Browser client app for the realtime conversion server (a copy of
`rvc_tpu/realtime/webui.py`).

The reference ships a native SwiftUI app as its interactive surface
(`Demos/iOS/RVCNative`, SURVEY L10). The server-side analog
is a self-contained web app: one dependency-free HTML page (mic capture
-> float32 blocks over the same WebSocket protocol the reference's
ws-audio clients speak, `rvc_mlx/realtime/client.py:16` -> playback),
served by a tiny asyncio HTTP server next to the WS endpoint. Controls
cover the session params the WS server accepts (pitch, index_rate,
protect, autotune, chunk size) and a live latency readout.
"""

from __future__ import annotations

import asyncio
import threading

WEB_CLIENT_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>rvc-tpu realtime</title>
<style>
  body { font: 14px system-ui, sans-serif; margin: 2rem auto; max-width: 40rem;
         color: #1a1a1a; }
  h1 { font-size: 1.2rem; }
  fieldset { border: 1px solid #ccc; border-radius: 6px; margin: .6rem 0; }
  label { display: inline-block; min-width: 11rem; }
  input[type=number] { width: 5rem; }
  #status { padding: .4rem .6rem; border-radius: 4px; background: #eee; }
  #status.live { background: #d3f2d3; }
  button { padding: .4rem 1rem; margin-right: .5rem; }
</style>
</head>
<body>
<h1>rvc-tpu realtime voice changer</h1>
<fieldset><legend>session</legend>
  <div><label>WebSocket URL</label><input id="ws_url" size="28" value="__WS_URL__"/></div>
  <div><label>pitch (semitones)</label><input id="pitch" type="number" value="0" step="1"/></div>
  <div><label>index_rate</label><input id="index_rate" type="number" value="0" step="0.05" min="0" max="1"/></div>
  <div><label>protect</label><input id="protect" type="number" value="0.5" step="0.05" min="0" max="0.5"/></div>
  <div><label>autotune</label><input id="autotune" type="checkbox"/></div>
  <div><label>chunk_size (x128 @48k)</label><input id="chunk" type="number" value="192" step="32" min="32"/></div>
</fieldset>
<p>
  <button id="start">start</button>
  <button id="stop" disabled>stop</button>
  <span id="status">idle</span>
</p>
<p id="latency"></p>
<script>
let ws = null, ctx = null, node = null, stream = null, playT = 0;
const blockOf = () => 128 * parseInt(document.getElementById("chunk").value);
function setStatus(s, live) {
  const el = document.getElementById("status");
  el.textContent = s; el.className = live ? "live" : "";
}
async function start() {
  const block = blockOf();
  ctx = new AudioContext({sampleRate: 48000});
  stream = await navigator.mediaDevices.getUserMedia({audio: {
    echoCancellation: true, noiseSuppression: true, sampleRate: 48000}});
  ws = new WebSocket(document.getElementById("ws_url").value);
  ws.binaryType = "arraybuffer";
  ws.onopen = () => {
    ws.send(JSON.stringify({
      chunk_size: parseInt(document.getElementById("chunk").value),
      pitch: parseFloat(document.getElementById("pitch").value),
      index_rate: parseFloat(document.getElementById("index_rate").value),
      protect: parseFloat(document.getElementById("protect").value),
      autotune: document.getElementById("autotune").checked,
    }));
    setStatus("live", true);
    const src = ctx.createMediaStreamSource(stream);
    node = ctx.createScriptProcessor(4096, 1, 1);
    let buf = new Float32Array(0);
    node.onaudioprocess = (e) => {
      const x = e.inputBuffer.getChannelData(0);
      const merged = new Float32Array(buf.length + x.length);
      merged.set(buf); merged.set(x, buf.length);
      buf = merged;
      while (buf.length >= block) {
        if (ws && ws.readyState === 1) ws.send(buf.slice(0, block).buffer);
        buf = buf.slice(block);
      }
    };
    src.connect(node); node.connect(ctx.destination);
  };
  ws.onmessage = (ev) => {
    if (typeof ev.data === "string") {
      const m = JSON.parse(ev.data);
      if (m.type === "latency")
        document.getElementById("latency").textContent =
          "server latency: " + (1000 * m.value).toFixed(1) + " ms";
      if (m.type === "error") setStatus("server error: " + m.value, false);
      return;
    }
    const samples = new Float32Array(ev.data);
    const ab = ctx.createBuffer(1, samples.length, 48000);
    ab.copyToChannel(samples, 0);
    const s = ctx.createBufferSource();
    s.buffer = ab; s.connect(ctx.destination);
    playT = Math.max(playT, ctx.currentTime + 0.05);
    s.start(playT); playT += ab.duration;
  };
  ws.onclose = () => setStatus("disconnected", false);
  document.getElementById("start").disabled = true;
  document.getElementById("stop").disabled = false;
}
function stop() {
  if (node) { node.disconnect(); node = null; }
  if (stream) { stream.getTracks().forEach(t => t.stop()); stream = null; }
  if (ws) { ws.close(); ws = null; }
  if (ctx) { ctx.close(); ctx = null; }
  setStatus("idle", false);
  document.getElementById("start").disabled = false;
  document.getElementById("stop").disabled = true;
}
document.getElementById("start").onclick = () => start().catch(
  e => setStatus("mic/ws failed: " + e, false));
document.getElementById("stop").onclick = stop;
// wildcard listen addresses are not routable from a browser — swap in
// the hostname the page itself was loaded from
(function () {
  const i = document.getElementById("ws_url");
  i.value = i.value.replace("0.0.0.0", location.hostname)
                   .replace("[::]", location.hostname);
})();
</script>
</body>
</html>
"""


class WebUIServer:
    """Minimal dependency-free HTTP server for the client page.

    Serves GET / (the app, with the ws URL templated in) and
    GET /healthz; everything else 404. Run next to
    RealtimeWebSocketServer (`cmd_serve --webui`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6007,
                 ws_url: str = "ws://127.0.0.1:6006"):
        self.host = host
        self.port = port
        self.ws_url = ws_url
        self._server = None
        self._started = threading.Event()

    def _page(self) -> bytes:
        return WEB_CLIENT_HTML.replace("__WS_URL__", self.ws_url).encode()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) > 1 else "/"
            if path in ("/", "/index.html"):
                body, code, ctype = self._page(), "200 OK", "text/html"
            elif path == "/healthz":
                body, code, ctype = b"ok", "200 OK", "text/plain"
            else:
                body, code, ctype = b"not found", "404 Not Found", "text/plain"
            writer.write(
                f"HTTP/1.1 {code}\r\nContent-Type: {ctype}; charset=utf-8\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                .encode() + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionResetError):
            pass
        finally:
            writer.close()

    async def serve(self):
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def serve_in_thread(self) -> threading.Thread:
        self._error = None

        def run():
            try:
                asyncio.run(self.serve())
            except BaseException as e:  # surfaced to the caller below
                self._error = e
                self._started.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._started.wait(timeout=10)
        if self._error is not None:
            raise RuntimeError(
                f"web client failed to start on {self.host}:{self.port}"
            ) from self._error
        if self._server is None:
            raise RuntimeError(
                f"web client did not start listening on "
                f"{self.host}:{self.port} within 10 s")
        return t
