"""Minimal NATS client — dependency-free (raw TCP text protocol).

The reference's NATS reader/writer are native Rust over async-nats
(reference: src/connectors/data_storage.rs:2226 NatsReader / :2300
NatsWriter). This build speaks the NATS wire protocol directly — it is
a deliberately small, line-oriented protocol:

    server → INFO {...}            client → CONNECT {...}
    client → SUB <subject> <sid>   client → [H]PUB <subject> ...
    server → MSG/HMSG ...          both   → PING / PONG

HPUB carries the ``pathway_time`` / ``pathway_diff`` headers the
reference writer attaches to every message.
"""

from __future__ import annotations

import json
import socket
import urllib.parse


class NatsConnection:
    def __init__(self, uri: str, timeout: float = 10.0):
        parsed = urllib.parse.urlsplit(
            uri if "://" in uri else "nats://" + uri
        )
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 4222
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._buf = b""
        line = self._read_line()  # INFO {...}
        if not line.startswith(b"INFO"):
            raise ConnectionError(f"not a NATS server: {line[:80]!r}")
        self.server_info = json.loads(line[4:].strip() or b"{}")
        connect = {
            "verbose": False,
            "pedantic": False,
            "lang": "python-pathway-tpu",
            "version": "1",
            "headers": True,
        }
        if parsed.username:
            connect["user"] = parsed.username
            connect["pass"] = parsed.password or ""
        self._send(b"CONNECT " + json.dumps(connect).encode() + b"\r\n")

    # -- io ---------------------------------------------------------------
    def _send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("NATS connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("NATS connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # -- protocol ----------------------------------------------------------
    def publish(
        self, subject: str, payload: bytes,
        headers: dict[str, str] | None = None,
    ) -> None:
        if headers:
            hdr = b"NATS/1.0\r\n" + b"".join(
                f"{k}: {v}\r\n".encode() for k, v in headers.items()
            ) + b"\r\n"
            total = len(hdr) + len(payload)
            self._send(
                f"HPUB {subject} {len(hdr)} {total}\r\n".encode()
                + hdr + payload + b"\r\n"
            )
        else:
            self._send(
                f"PUB {subject} {len(payload)}\r\n".encode()
                + payload + b"\r\n"
            )

    def subscribe(self, subject: str, sid: int = 1) -> None:
        self._send(f"SUB {subject} {sid}\r\n".encode())

    def next_msg(self, timeout: float | None = None):
        """Returns (subject, payload, headers) or None on timeout.
        Handles PING keepalives transparently.

        The poll timeout applies only to the FIRST line of a frame —
        returning None there is safe because no bytes were consumed.
        Once a MSG/HMSG header arrived, payload reads switch to a long
        deadline and a timeout mid-frame is a hard protocol error (the
        stream would be desynced if we returned)."""
        base_timeout = self.sock.gettimeout()
        try:
            while True:
                if timeout is not None:
                    self.sock.settimeout(timeout)
                try:
                    line = self._read_line()
                except (socket.timeout, TimeoutError):
                    return None
                self.sock.settimeout(30.0)  # committed to a frame now
                if line == b"PING":
                    self._send(b"PONG\r\n")
                    continue
                if line in (b"PONG", b"+OK") or not line:
                    continue
                if line.startswith(b"-ERR"):
                    raise ConnectionError(line.decode(errors="replace"))
                parts = line.split(b" ")

                def size_of(raw: bytes) -> int:
                    # malformed/corrupt size fields must fail cleanly —
                    # a negative or absurd size would silently desync
                    # the stream (max NATS payload is 64MB)
                    try:
                        n = int(raw)
                    except ValueError:
                        raise ConnectionError(
                            f"malformed NATS size field {raw[:40]!r}"
                        ) from None
                    if n < 0 or n > 64 * 1024 * 1024:
                        raise ConnectionError(
                            f"malformed NATS frame size {n}"
                        )
                    return n

                try:
                    if parts[0] == b"MSG":
                        # MSG <subject> <sid> [reply-to] <#bytes>
                        nbytes = size_of(parts[-1])
                        payload = self._read_exact(nbytes)
                        self._read_exact(2)  # trailing \r\n
                        return parts[1].decode(), payload, {}
                    if parts[0] == b"HMSG":
                        # HMSG <subject> <sid> [reply-to] <hdr_len> <total>
                        hdr_len = size_of(parts[-2])
                        total = size_of(parts[-1])
                        if hdr_len > total:
                            raise ConnectionError(
                                "malformed NATS HMSG: hdr_len > total"
                            )
                        blob = self._read_exact(total)
                        self._read_exact(2)
                        headers = {}
                        for h in blob[:hdr_len].split(b"\r\n")[1:]:
                            if b":" in h:
                                k, _, v = h.partition(b":")
                                headers[k.decode().strip()] = v.decode().strip()
                        return parts[1].decode(), blob[hdr_len:], headers
                except (socket.timeout, TimeoutError) as e:
                    raise ConnectionError(
                        "NATS stream desync: timed out mid-frame"
                    ) from e
                raise ConnectionError(
                    f"unexpected NATS frame: {line[:80]!r}"
                )
        finally:
            # Restore the pre-call timeout unconditionally: both the poll
            # timeout and the mid-frame settimeout(30.0) would otherwise
            # leak into later publish/flush calls (and settimeout(None)
            # would leave a hung broker stalling the pipeline forever).
            self.sock.settimeout(base_timeout)

    def flush(self) -> None:
        self._send(b"PING\r\n")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
