"""The port's realtime serving surface on the CPU: the length-prefixed TCP
server and the WebSocket server (the reference ws-audio protocol), each
with a stub converter as in `tests/unit/test_realtime_server.py` and with
the port's `VoiceChanger` on the small models against the same engine
driven in process; the web client page; and the `serve` subcommand: its
flags against `rvc_tpu/cli.py`'s, its refusal to start without a card
unless given `--device cpu`, and one TCP session through
`python -m rvc_tpu_torch.cli serve --protocol tcp --device cpu`."""

import asyncio
import json
import os
import socket
import struct
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rvc_tpu_torch.realtime.core import VoiceChanger
from rvc_tpu_torch.realtime.server import (AudioDeviceStream, RealtimeSocketServer,
                                           RealtimeWebSocketServer)
from rvc_tpu_torch.realtime.webui import WebUIServer
from test_torch_realtime import BLOCK, SESSION, _clip48, make_pair

ROOT = Path(__file__).resolve().parents[1]


class StubVC:
    block_frame = 1024

    def on_request(self, block, **kw):
        return block * 0.5, 0.1, [0, 1.0, 0]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_rvc():
    return make_pair().port


def _tcp_session(port: int, blocks) -> list:
    """Send each block as one length-prefixed frame, read each reply."""
    outs = []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        for b in blocks:
            data = np.asarray(b, "<f4").tobytes()
            s.sendall(struct.pack("<I", len(data)) + data)
            (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
            buf = b""
            while len(buf) < n:
                buf += s.recv(n - len(buf))
            outs.append(np.frombuffer(buf, dtype="<f4"))
        s.sendall(struct.pack("<I", 0))
    return outs


def _serve_tcp(srv, blocks) -> list:
    async def run():
        server = await asyncio.start_server(srv._handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, _tcp_session, port, blocks)
        finally:
            server.close()
            await server.wait_closed()

    return asyncio.run(asyncio.wait_for(run(), timeout=120))


def test_socket_server_roundtrip():
    out = _serve_tcp(RealtimeSocketServer(StubVC()), [np.arange(8, dtype=np.float32)])
    np.testing.assert_allclose(out[0], np.arange(8) * 0.5, atol=1e-6)


def test_socket_server_converts_like_the_engine(port_rvc):
    """Three blocks over TCP through a per-connection VoiceChanger (the
    fused path) equal the same engine driven in process."""
    def factory():
        return VoiceChanger(port_rvc, silent_threshold=-90, **SESSION)

    clip = _clip48(3, seed=8)
    blocks = [clip[i * BLOCK: (i + 1) * BLOCK] for i in range(3)]
    got = _serve_tcp(RealtimeSocketServer(vc_factory=factory, index_rate=0.0), blocks)
    vc = factory()
    for b, g in zip(blocks, got):
        ref, _, _ = vc.on_request(b, index_rate=0.0)
        assert g.shape == (BLOCK,)
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6)


def _ws_session(srv, params: dict, blocks) -> list:
    websockets = pytest.importorskip("websockets")

    async def run():
        async with websockets.serve(srv._handle, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            async with websockets.connect(f"ws://127.0.0.1:{port}/ws-audio",
                                          max_size=None) as ws:
                await ws.send(json.dumps(params))
                results = []
                for b in blocks:
                    await ws.send(np.asarray(b, "<f4").tobytes())
                    lat = json.loads(await ws.recv())
                    assert lat["type"] == "latency" and lat["value"] > 0
                    results.append(np.frombuffer(await ws.recv(), dtype="<f4"))
                return results

    return asyncio.run(asyncio.wait_for(run(), timeout=120))


def test_websocket_server_reference_protocol():
    """JSON params frame, then binary blocks; a latency text frame and the
    converted block back for each (`rvc_mlx/realtime/client.py:16-96`)."""
    params = {"chunk_size": 2, "pitch": 0, "index_rate": 0, "protect": 0.5,
              "input_audio_gain": 100.0, "autotune": False, "autotune_strength": 1.0,
              "kwargs": {}}
    block = np.arange(256, dtype="<f4")
    for out in _ws_session(RealtimeWebSocketServer(voice_changer=StubVC()), params,
                           [block, block]):
        np.testing.assert_allclose(out, block * 0.5, atol=1e-6)


def test_websocket_server_builds_the_session_engine(port_rvc):
    """With an `rvc`, each connection gets its own VoiceChanger built from
    the client's params (chunk size, crossfade, extra, gate, sid, pitch,
    protect, gain): equal to that engine driven in process."""
    params = {"chunk_size": 48, "cross_fade_overlap_size": 0.05, "extra_convert_size": 0.2,
              "silent_threshold": -90, "sid": 1, "pitch": 2.0, "protect": 0.33,
              "index_rate": 0.0, "input_audio_gain": 50.0}
    clip = _clip48(2, seed=9)
    blocks = [clip[i * BLOCK: (i + 1) * BLOCK] for i in range(2)]
    got = _ws_session(RealtimeWebSocketServer(rvc=port_rvc), params, blocks)
    vc = VoiceChanger(port_rvc, silent_threshold=-90, sid=1, **SESSION)
    for b, g in zip(blocks, got):
        ref, _, _ = vc.on_request(b * 0.5, f0_up_key=2.0, index_rate=0.0, protect=0.33,
                                  f0_autotune=False, f0_autotune_strength=1.0)
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6)


def test_webui_serves_client_page():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = WebUIServer(host="127.0.0.1", port=port, ws_url="ws://127.0.0.1:16006")
    srv.serve_in_thread()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
        body = r.read().decode()
    assert r.status == 200
    assert "<html" in body and "ws://127.0.0.1:16006" in body
    assert "getUserMedia" in body and "WebSocket" in body
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        assert r.read() == b"ok"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    assert e.value.code == 404


def test_audio_device_stream_needs_sounddevice():
    from rvc_tpu_torch.realtime import server

    if server.sd is not None:
        pytest.skip("sounddevice is installed")
    with pytest.raises(RuntimeError, match="sounddevice"):
        AudioDeviceStream(StubVC())


# ----------------------------------------------------------------------------
# the serve subcommand


def _jax_serve_args(monkeypatch, argv) -> dict:
    """The namespace that `rvc_tpu/cli.py`'s parser gives `serve`."""
    import rvc_tpu.cli as jax_cli

    seen = {}
    monkeypatch.setattr(jax_cli, "cmd_serve", lambda args: seen.update(vars(args)))
    jax_cli.main(argv)
    return seen


@pytest.mark.parametrize("argv", [
    ["serve", "--model_path", "m.pth"],
    ["serve", "--model_path", "m.pth", "--index_path", "m.index", "--hubert_path", "h.pt",
     "--embedder_model", "custom", "--embedder_model_custom", "c.pt", "--protocol", "tcp",
     "--host", "0.0.0.0", "--port", "7001", "--chunk_size", "96", "--f0_method",
     "hybrid[rmvpe+pm]", "--sid", "2", "--webui", "--webui_port", "7002"],
], ids=["defaults", "every_flag"])
def test_serve_flags_match_reference(monkeypatch, argv):
    from rvc_tpu_torch.cli import build_parser

    ref = _jax_serve_args(monkeypatch, argv)
    got = vars(build_parser().parse_args(argv))
    for d in (ref, got):
        d.pop("fn")
    assert got == ref                 # `--device` is None on both sides


def test_serve_needs_the_card(monkeypatch, tmp_path):
    """Without --device, serve loads the model on the card, and with none
    it raises before it listens."""
    from rvc_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "--model_path", str(tmp_path / "m.pth"), "--protocol", "tcp"])


def test_serve_tcp_subcommand(tmp_path):
    """`serve --protocol tcp --device cpu` with a 768-wide .pth (HuBERT and
    RMVPE: the seeded full-size random inits): five 48-chunk blocks round
    trip as finite blocks of the same length, equal to
    `VoiceChanger` on `RVC(model_path, device="cpu")` in process within
    1e-4. `serve` builds its engines with the reference's silent_threshold
    of 0 dB, which gates every block whose volume window has an RMS under 1
    (as `rvc_tpu/cli.py` does). So of three blocks of a loud tone (RMS 1.1)
    the first, whose window still holds the start's zeros, comes back
    silent and the next two converted; and two blocks at speech level
    (peak 0.4, RMS 0.28) come back silent, but for the crossfade that
    fades the last converted block out."""
    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.utils.weights import export_pth
    from test_torch_cli import V2_ARGS

    torch.manual_seed(3)
    cfg = get_config(32000, **V2_ARGS)
    model = export_pth(build_synthesizer(cfg).state_dict(), cfg, str(tmp_path / "m.pth"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, RVC_TPU_MODELS_DIR=str(tmp_path / "models"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rvc_tpu_torch.cli", "serve", "--model_path", model,
         "--protocol", "tcp", "--device", "cpu", "--port", str(port), "--chunk_size", "48"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving tcp on 127.0.0.1:{port}"), (
            line + proc.stderr.read() if proc.poll() is not None else line)
        clip = _clip48(5, seed=10)
        clip[: 3 * BLOCK] *= 4.0
        blocks = [clip[i * BLOCK: (i + 1) * BLOCK] for i in range(5)]
        got = _tcp_session(port, blocks)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RVC_TPU_MODELS_DIR", str(tmp_path / "models"))
        vc = VoiceChanger(RVC(model_path=model, device="cpu"), read_chunk_size=48)
    for b, g in zip(blocks, got):
        ref, _, _ = vc.on_request(b)
        assert g.shape == (BLOCK,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4)
    assert not got[0].any() and np.abs(got[1]).max() > 1e-3 and np.abs(got[2]).max() > 1e-3
    # the first gated block only fades the last converted tail out (SOLA)
    assert not got[3][vc.crossfade_frame:].any() and not got[4].any()
