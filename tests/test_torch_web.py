"""PyTorch port: the live web preview server, on the CPU.

The server runs in a child process started with ``spawn``; every socket,
join and queue wait here has its own timeout, and each test ends the child
in ``finally``.
"""

import io
import json
import socket
import threading
import time

import numpy as np
import pytest
from PIL import Image

from style_transfer_tpu_torch import srgb_profile
from style_transfer_tpu_torch.utils.trace import STIterate
from style_transfer_tpu_torch.web import client
from style_transfer_tpu_torch.web.server import WebInterface, _encode_event, _to_uint8

HOST = "127.0.0.1"


def free_port():
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _iterate(w=24, h=16, i=1, i_max=2):
    return STIterate(w=w, h=h, i=i, i_max=i_max, loss=0.5, time=1.0, gpu_ram=0)


def test_encode_event_adds_type():
    d = _encode_event(_iterate())
    assert d["_type"] == "STIterate" and d["w"] == 24 and d["i_max"] == 2
    assert json.loads(json.dumps(d)) == d
    assert _encode_event({"x": 1}) == {"x": 1}


def test_to_uint8():
    out = _to_uint8(np.asarray([[[0.0, 0.5, 1.0]], [[-1.0, 0.25, 2.0]]], np.float32))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, [[[0, 128, 255]], [[0, 64, 255]]])
    u8 = np.zeros((2, 2, 3), np.uint8)
    assert _to_uint8(u8) is u8


def test_server_endpoints_and_events():
    """``/`` is the page, ``/image`` is 404 until an iterate arrives and then
    a JPEG of its size with the sRGB profile, the static files are served,
    and the WebSocket pushes each STIterate, then WIDone."""
    port = free_port()
    wi = WebInterface(HOST, port)
    got = []
    try:
        status, body, headers = client.get(HOST, port, "/")
        assert status == 200 and headers["Content-Type"].startswith("text/html")
        assert b"style_transfer_tpu_torch" in body
        assert client.get(HOST, port, "/image")[0] == 404
        status, body, _ = client.get(HOST, port, "/main.js")
        assert status == 200 and b"/websocket" in body

        stream = client.EventStream(HOST, port, timeout=20)  # handshake done
        reader = threading.Thread(target=lambda: got.extend(stream), daemon=True)
        reader.start()
        img = np.random.RandomState(0).rand(16, 24, 3).astype(np.float32)
        wi.put_iterate(_iterate(i=1), img)
        wi.put_iterate(_iterate(i=2), img)
        deadline = time.time() + 20
        status = 404
        while status == 404 and time.time() < deadline:
            status, body, headers = client.get(HOST, port, "/image")
            time.sleep(0.05)
        assert status == 200 and headers["Content-Type"] == "image/jpeg"
        with Image.open(io.BytesIO(body)) as jpeg:
            assert jpeg.format == "JPEG" and jpeg.size == (24, 16)
            assert jpeg.info["icc_profile"] == srgb_profile
        wi.put_done()
        reader.join(20)
        assert not reader.is_alive()
        stream.close()
    finally:
        wi.close()
    assert [e["_type"] for e in got] == ["STIterate", "STIterate", "WIDone"]
    assert [e["i"] for e in got[:2]] == [1, 2] and got[0]["w"] == 24
    assert not wi.process.is_alive()


def test_backpressure_drops_frames():
    """A full queue drops the frame instead of blocking the run: 200 frames
    into a 2-deep queue return at once, and a queue that is always full
    (a stalled child) is never waited on."""
    import queue

    port = free_port()
    wi = WebInterface(HOST, port, max_queue=2)
    try:
        img = np.zeros((8, 8, 3), np.float32)
        t0 = time.time()
        for _ in range(200):
            wi.put_iterate(_iterate(w=8, h=8), img)
        assert time.time() - t0 < 5.0

        class Stalled:
            dropped = 0

            def put_nowait(self, item):
                Stalled.dropped += 1
                raise queue.Full

        live, wi.q = wi.q, Stalled()
        for _ in range(3):
            wi.put_iterate(_iterate(w=8, h=8), img)
        wi.q = live
        assert Stalled.dropped == 3
    finally:
        wi.close()


def test_close_ends_the_child():
    port = free_port()
    wi = WebInterface(HOST, port)
    try:
        assert wi.process.is_alive()
    finally:
        wi.close()
    assert not wi.process.is_alive() and wi.process.exitcode is not None
    wi.close()  # a second close is a no-op


def test_start_failure_raises():
    """A port already taken: the constructor raises instead of running on
    without a preview, and leaves no child behind."""
    held = socket.socket()
    held.bind((HOST, 0))
    held.listen(1)
    try:
        with pytest.raises(RuntimeError, match="could not start"):
            WebInterface(HOST, held.getsockname()[1])
    finally:
        held.close()
