"""A client of the live web preview, standard library only: ``get`` for
the pages and ``EventStream`` for the events over the WebSocket (RFC 6455;
the server sends unmasked text frames). The smoke run on the card and the
tests follow a run with it.
"""

import base64
import json
import os
import socket
import struct
import urllib.request

__all__ = ["EventStream", "get"]


def get(host, port, path, timeout=10.0):
    """(status, body bytes, headers) of ``GET path``; HTTP errors are
    returned, not raised."""
    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as err:
        return err.code, b"", err.headers


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    return buf


class EventStream:
    """The preview's WebSocket: the constructor connects and completes the
    handshake, so the server counts this client from then on; iterating
    yields the events (dicts) until ``WIDone`` or the server closes. Every
    socket read waits at most ``timeout`` seconds."""

    def __init__(self, host, port, timeout=30.0):
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            self.sock.sendall((
                f"GET /websocket HTTP/1.1\r\nHost: {host}:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
            ).encode())
            head = b""
            while b"\r\n\r\n" not in head:
                head += _read_exact(self.sock, 1)
            if not head.startswith(b"HTTP/1.1 101"):
                raise ConnectionError(
                    f"no WebSocket upgrade: {head.splitlines()[0]!r}")
        except BaseException:
            self.sock.close()
            raise

    def __iter__(self):
        sock = self.sock
        while True:
            b0, b1 = _read_exact(sock, 2)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", _read_exact(sock, 2))
            elif n == 127:
                (n,) = struct.unpack(">Q", _read_exact(sock, 8))
            mask = _read_exact(sock, 4) if b1 & 0x80 else None
            payload = _read_exact(sock, n)
            if mask:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            opcode = b0 & 0x0F
            if opcode == 0x8:  # close
                return
            if opcode == 0x1:  # text
                event = json.loads(payload)
                yield event
                if event.get("_type") == "WIDone":
                    return

    def close(self):
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
