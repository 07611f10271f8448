"""Realtime serving surface (counterpart of `rvc_tpu/realtime/server.py`):
audio-device streaming, a TCP server and a WebSocket server.

Capability parity with `rvc_mlx/realtime/audio.py` (sounddevice stream +
callback + queue) and `rvc_mlx/realtime/client.py` (WebSocket endpoint).
Device streaming needs sounddevice; the network path is a dependency-free
asyncio TCP server speaking a length-prefixed float32 frame protocol, and
the WebSocket server needs the `websockets` package, imported when it
serves.
"""

from __future__ import annotations

import asyncio
import json
import queue
import struct
import sys
import threading
import traceback
from typing import Callable, Optional

import numpy as np

try:
    import sounddevice as sd
except (ImportError, OSError):  # OSError: the package is there, PortAudio is not
    sd = None


class AudioDeviceStream:
    """Microphone -> VoiceChanger -> speakers loop (sounddevice-backed)."""

    def __init__(self, voice_changer, sample_rate: int = 48000,
                 block_size: Optional[int] = None, **convert_kwargs):
        if sd is None:
            raise RuntimeError(
                "sounddevice is not installed; use RealtimeSocketServer or "
                "drive VoiceChanger.on_request directly")
        self.vc = voice_changer
        self.sample_rate = sample_rate
        self.block_size = block_size or voice_changer.block_frame
        self.convert_kwargs = convert_kwargs
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=8)
        self._stream = None

    def _callback(self, indata, outdata, frames, time_info, status):
        mono = indata.mean(axis=1).astype(np.float32)
        out, vol, _ = self.vc.on_request(mono, **self.convert_kwargs)
        outdata[:, 0] = out[: len(outdata)]
        if outdata.shape[1] > 1:
            outdata[:, 1:] = outdata[:, :1]

    def start(self):
        self._stream = sd.Stream(
            samplerate=self.sample_rate, blocksize=self.block_size,
            channels=(1, 2), dtype="float32", callback=self._callback)
        self._stream.start()

    def stop(self):
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None

    @staticmethod
    def list_devices():
        return sd.query_devices() if sd is not None else []


class RealtimeSocketServer:
    """Length-prefixed float32 frame server.

    Wire format per message (both directions):
        uint32 little-endian byte length | float32[] samples @48 kHz
    Each inbound block is converted through the VoiceChanger and the
    converted block is written back. A zero length (or one above 16 MiB)
    ends the connection.
    """

    def __init__(self, voice_changer=None, host: str = "127.0.0.1",
                 port: int = 6006, vc_factory: Optional[Callable] = None,
                 **convert_kwargs):
        if voice_changer is None and vc_factory is None:
            raise ValueError("pass a VoiceChanger or a vc_factory")
        self.vc = voice_changer
        # vc_factory: one engine per accepted connection — SOLA crossfade
        # and pitch buffers are per-stream state, so a shared engine
        # corrupts concurrent clients
        self.vc_factory = vc_factory
        self.host = host
        self.port = port
        self.convert_kwargs = convert_kwargs
        self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        vc = self.vc_factory() if self.vc_factory is not None else self.vc
        try:
            while True:
                hdr = await reader.readexactly(4)
                (nbytes,) = struct.unpack("<I", hdr)
                if nbytes == 0 or nbytes > 1 << 24:
                    break
                payload = await reader.readexactly(nbytes)
                block = np.frombuffer(payload, dtype="<f4")
                out, vol, timings = vc.on_request(
                    block.copy(), **self.convert_kwargs)
                data = out.astype("<f4").tobytes()
                writer.write(struct.pack("<I", len(data)) + data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    async def serve(self, on_listening=None):
        """Serve until cancelled; on_listening(host, port) is called once the
        socket listens, with the port it bound (port 0 takes a free one)."""
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        if on_listening is not None:
            on_listening(self.host, self._server.sockets[0].getsockname()[1])
        async with self._server:
            await self._server.serve_forever()

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=lambda: asyncio.run(self.serve()), daemon=True)
        t.start()
        return t


class RealtimeWebSocketServer:
    """WebSocket endpoint speaking the reference client protocol
    (`rvc_mlx/realtime/client.py:16-96`): the client first sends a JSON
    text frame of session params, then binary float32 blocks @48 kHz;
    the server answers each block with a `{"type": "latency"}` text
    frame followed by the converted float32 block. Built on the
    `websockets` package (no FastAPI needed); existing ws-audio clients
    connect unchanged. A conversion that raises is reported to the client
    (`{"type": "error"}`, close code 1011) and its traceback printed to
    stderr; the server keeps serving other connections.
    """

    def __init__(self, voice_changer=None, rvc=None, host: str = "127.0.0.1",
                 port: int = 6006):
        if voice_changer is None and rvc is None:
            raise ValueError("pass a VoiceChanger or an RVC instance")
        self.vc = voice_changer
        self.rvc = rvc
        self.host = host
        self.port = port
        self._started = threading.Event()
        self._loop = None

    def _ensure_vc(self, params: dict):
        # an injected VoiceChanger is shared (caller owns it); otherwise
        # each connection gets its OWN engine — sessions carry SOLA and
        # pitch state plus buffers sized to the client's chunk_size, so
        # reusing one across connections corrupts both streams
        if self.vc is not None:
            return self.vc
        from rvc_tpu_torch.realtime.core import VoiceChanger

        return VoiceChanger(
            self.rvc,
            read_chunk_size=int(params.get("chunk_size", 192)),
            cross_fade_overlap_size=float(
                params.get("cross_fade_overlap_size", 0.1)),
            extra_convert_size=float(params.get("extra_convert_size", 0.5)),
            f0_method=params.get("f0_method", "rmvpe"),
            silent_threshold=int(params.get("silent_threshold", 0)),
            vad_enabled=bool(params.get("vad_enabled", False)),
            sid=int(params.get("sid", 0)),
            post_process=bool(params.get("post_process", False)),
            **params.get("kwargs", {}),
        )

    async def _handle(self, ws):
        from websockets.exceptions import ConnectionClosed

        try:
            params = json.loads(await ws.recv())
        except (ConnectionClosed, TypeError, ValueError):  # not a JSON text frame
            await ws.close()
            return
        vc = self._ensure_vc(params)
        block_frame = int(params.get("chunk_size", 192)) * 128
        gain = float(params.get("input_audio_gain", 100.0)) / 100.0
        convert_kwargs = dict(
            f0_up_key=float(params.get("pitch", 0.0)),
            index_rate=float(params.get("index_rate", 0.0)),
            protect=float(params.get("protect", 0.5)),
            f0_autotune=bool(params.get("autotune", False)),
            f0_autotune_strength=float(params.get("autotune_strength", 1.0)),
        )
        try:
            async for msg in ws:
                if not isinstance(msg, (bytes, bytearray)):
                    continue  # ignore mid-stream text frames
                arr = np.frombuffer(msg, dtype=np.float32)
                if arr.size < block_frame:
                    arr = np.pad(arr, (0, block_frame - arr.size))
                else:
                    arr = arr[:block_frame]
                out, _vol, perf = vc.on_request(arr.astype(np.float32) * gain,
                                                **convert_kwargs)
                await ws.send(json.dumps({"type": "latency",
                                          "value": perf[1]}))
                await ws.send(out.astype("<f4").tobytes())
        except ConnectionClosed:
            pass
        except Exception as e:  # noqa: BLE001 — per-connection boundary
            # tell the client WHY instead of leaving it waiting for a
            # reply that never comes, and surface the error server-side
            traceback.print_exc(file=sys.stderr)
            try:
                await ws.send(json.dumps({"type": "error", "value": str(e)}))
                await ws.close(code=1011, reason=str(e)[:100])
            except ConnectionClosed:
                pass

    async def serve(self, on_listening=None):
        """Serve until cancelled; on_listening(host, port) is called once the
        socket listens, with the port it bound (port 0 takes a free one)."""
        import websockets

        async with websockets.serve(self._handle, self.host, self.port) as server:
            self._started.set()
            if on_listening is not None:
                on_listening(self.host, next(iter(server.sockets)).getsockname()[1])
            await asyncio.Future()

    def serve_in_thread(self) -> threading.Thread:
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self.serve())

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._started.wait(timeout=30)
        return t
