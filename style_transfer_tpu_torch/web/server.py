"""Live web preview server.

Port of ``style_transfer_tpu/web/server.py``: an aiohttp app in a separate
OS process, fed per-iteration events over a bounded ``multiprocessing``
queue; browsers get ``STIterate`` stats pushed over a WebSocket
(``/websocket``, then ``WIDone``) and poll ``GET /image`` for the current
iterate as a JPEG (quality 95, 4:4:4, sRGB ICC profile embedded).

The child is started with the ``spawn`` context, not fork: the parent holds
a live CUDA context by then, which a forked child cannot use safely. The
child never touches CUDA; the image crosses the process boundary as uint8
HWC and the ICC profile as bytes. ``WebInterface`` waits until the server
listens and raises if it cannot (no aiohttp, the port taken), so a run that
asked for a preview never goes on without one.
"""

import asyncio
import importlib.util
import io
import json
import multiprocessing as mp
import queue as queue_mod
from dataclasses import asdict, is_dataclass
from pathlib import Path

import numpy as np

__all__ = ["WebInterface"]

_STATIC = Path(__file__).resolve().parent / "static"
# Seconds the parent waits for the child to listen (a spawned child imports
# the package, torch included, before it can bind).
_START_TIMEOUT = 60.0


def _encode_event(obj):
    if is_dataclass(obj):
        d = asdict(obj)
        d["_type"] = type(obj).__name__
        return d
    return obj


def _to_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        return arr
    return np.uint8(np.round(np.clip(arr, 0.0, 1.0) * 255.0))


class _Server:
    """Runs inside the child process."""

    def __init__(self, host, port, q, srgb_profile):
        self.host = host
        self.port = port
        self.q = q
        self.srgb_profile = srgb_profile
        self.image = None
        self.wss = []
        self.loop = None
        self.runner = None
        self._pump_task = None

    def _compress(self):
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(self.image).save(
            buf, format="jpeg", icc_profile=self.srgb_profile,
            quality=95, subsampling=0,
        )
        return buf.getvalue()

    async def _broadcast(self, payload):
        text = json.dumps(payload)
        for ws in list(self.wss):
            try:
                await ws.send_str(text)
            except (ConnectionError, RuntimeError):
                try:
                    self.wss.remove(ws)
                except ValueError:
                    pass

    async def _pump(self):
        while True:
            event = await self.loop.run_in_executor(None, self.q.get)
            kind = event[0]
            if kind == "iterate":
                _, iterate_dict, image = event
                self.image = image
                iterate_dict = dict(iterate_dict)
                iterate_dict["_type"] = "STIterate"
                await self._broadcast(iterate_dict)
            elif kind == "done":
                await self._broadcast({"_type": "WIDone"})
                if self.wss:
                    print("Waiting for web clients to finish...")
                    for _ in range(50):  # at most 5 s; clients close on WIDone
                        if not self.wss:
                            break
                        await asyncio.sleep(0.1)
            elif kind == "stop":
                for ws in list(self.wss):
                    await ws.close()
                await self.runner.cleanup()
                self.loop.stop()
                return

    async def handle_index(self, request):
        from aiohttp import web

        return web.Response(
            body=(_STATIC / "index.html").read_bytes(), content_type="text/html"
        )

    async def handle_image(self, request):
        from aiohttp import web

        if self.image is None:
            raise web.HTTPNotFound()
        body = await self.loop.run_in_executor(None, self._compress)
        return web.Response(body=body, content_type="image/jpeg")

    async def handle_websocket(self, request):
        from aiohttp import web

        ws = web.WebSocketResponse()
        await ws.prepare(request)
        self.wss.append(ws)
        async for _ in ws:
            pass
        try:
            self.wss.remove(ws)
        except ValueError:
            pass
        return ws

    async def _start_app(self):
        from aiohttp import web

        app = web.Application()
        app.router.add_routes(
            [
                web.get("/", self.handle_index),
                web.get("/image", self.handle_image),
                web.get("/websocket", self.handle_websocket),
                web.static("/", _STATIC),
            ]
        )
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, self.host, self.port, shutdown_timeout=5)
        await site.start()

    def run(self, ready):
        """Serves until a 'stop' event; ``ready`` gets None once the server
        listens, or the reason it could not start."""
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self._start_app())
        except Exception as err:  # e.g. OSError: the address is in use
            ready.send(f"{type(err).__name__}: {err}")
            return
        ready.send(None)
        self._pump_task = self.loop.create_task(self._pump())
        try:
            self.loop.run_forever()
        except KeyboardInterrupt:
            self.q.put(("stop",))
            self.loop.run_forever()


def _child_main(host, port, q, srgb_profile, ready):
    _Server(host, port, q, srgb_profile).run(ready)


class WebInterface:
    """Engine-side handle: spawns the server process and feeds it events."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080, max_queue: int = 8):
        from .. import srgb_profile

        if importlib.util.find_spec("aiohttp") is None:
            raise RuntimeError("--web needs the aiohttp package, which is not installed")
        self.host = host
        self.port = port
        ctx = mp.get_context("spawn")
        # Bounded queue: backpressure comes from put_nowait raising Full,
        # never from qsize() (unimplemented on macOS). Control events
        # ('done'/'stop') use bounded blocking puts.
        self.q = ctx.Queue(maxsize=max_queue)
        self.max_queue = max_queue
        self._closed = False
        print(f"Starting web interface at http://{host}:{port}/")
        ready_recv, ready_send = ctx.Pipe(duplex=False)
        self.process = ctx.Process(
            target=_child_main, args=(host, port, self.q, srgb_profile, ready_send),
            daemon=True,
        )
        self.process.start()
        ready_send.close()
        try:
            if ready_recv.poll(_START_TIMEOUT):
                err = ready_recv.recv()
            else:
                err = f"no answer within {_START_TIMEOUT:g} s"
        except EOFError:
            err = f"the server process exited (code {self.process.exitcode})"
        finally:
            ready_recv.close()
        if err is not None:
            self._closed = True
            self.process.terminate()
            self.process.join(5)
            raise RuntimeError(
                f"the web interface could not start at http://{host}:{port}/: {err}")

    def put_iterate(self, iterate, image):
        """iterate: STIterate dataclass; image: HWC array, f32 [0,1] or uint8.

        Backpressure: if the preview process is behind, drop frames rather
        than stall the optimization loop or grow the queue unboundedly.
        """
        try:
            self.q.put_nowait(("iterate", asdict(iterate), _to_uint8(image)))
        except queue_mod.Full:
            pass

    def put_done(self):
        # A stalled child must not hang the run: bounded blocking, then give
        # up (close() tears an unresponsive child down).
        try:
            self.q.put(("done",), timeout=5)
        except queue_mod.Full:
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            try:
                self.q.put(("stop",), timeout=5)
            except queue_mod.Full:
                pass
            self.process.join(12)
        finally:
            if self.process.is_alive():
                self.process.terminate()
                self.process.join(5)
            # Frames still buffered for a child that is gone must not hold
            # this process's exit (the queue's feeder thread would wait).
            self.q.cancel_join_thread()
            self.q.close()
