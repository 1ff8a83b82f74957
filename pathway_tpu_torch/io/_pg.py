"""Minimal PostgreSQL wire-protocol (v3) client — dependency-free.

The reference's Postgres writer drives the postgres crate over the same
protocol (reference: src/connectors/data_storage.rs PsqlWriter). This
build implements the subset the sink needs: startup, cleartext/MD5
password auth, and the Simple Query flow (``Q`` → CommandComplete* →
ReadyForQuery). Statements are produced by the Psql formatters
(io/_formats.py), which quote all values as SQL literals.
"""

from __future__ import annotations

import hashlib
import socket
import struct


class PgError(RuntimeError):
    pass


class PgConnection:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 5432,
        user: str = "postgres",
        password: str = "",
        dbname: str = "postgres",
        timeout: float = 30.0,
        **_extra,
    ):
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self._buf = b""
        params = {"user": user, "database": dbname}
        body = b"".join(
            k.encode() + b"\x00" + v.encode() + b"\x00"
            for k, v in params.items()
        ) + b"\x00"
        payload = struct.pack("!i", 196608) + body  # protocol 3.0
        self.sock.sendall(struct.pack("!i", len(payload) + 4) + payload)
        self._auth(user, password)

    # -- framing -----------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("postgres connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # backend messages are small (errors, command tags); a length beyond
    # this is a corrupt/desynced stream, not a real frame
    _MAX_FRAME = 64 * 1024 * 1024

    def _read_msg(self) -> tuple[bytes, bytes]:
        kind = self._read_exact(1)
        (length,) = struct.unpack("!i", self._read_exact(4))
        if length < 4 or length - 4 > self._MAX_FRAME:
            raise PgError(
                f"malformed postgres frame: kind={kind!r} length={length} "
                "(stream corrupt or not a postgres server)"
            )
        return kind, self._read_exact(length - 4)

    def _send_msg(self, kind: bytes, payload: bytes) -> None:
        self.sock.sendall(kind + struct.pack("!i", len(payload) + 4) + payload)

    # -- startup -----------------------------------------------------------
    def _auth(self, user: str, password: str) -> None:
        while True:
            kind, payload = self._read_msg()
            if kind == b"R":
                (code,) = struct.unpack("!i", payload[:4])
                if code == 0:  # AuthenticationOk
                    continue
                if code == 3:  # cleartext password
                    self._send_msg(b"p", password.encode() + b"\x00")
                elif code == 5:  # MD5: md5(md5(password+user)+salt)
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt
                    ).hexdigest()
                    self._send_msg(
                        b"p", b"md5" + digest.encode() + b"\x00"
                    )
                else:
                    raise PgError(
                        f"unsupported postgres auth method code {code} "
                        "(supported: trust, password, md5)"
                    )
            elif kind == b"E":
                raise PgError(self._error_text(payload))
            elif kind == b"Z":  # ReadyForQuery
                return
            # S (ParameterStatus), K (BackendKeyData), N (Notice): skip

    @staticmethod
    def _error_text(payload: bytes) -> str:
        fields = {}
        for part in payload.split(b"\x00"):
            if part:
                fields[chr(part[0])] = part[1:].decode(errors="replace")
        return fields.get("M", "postgres error")

    # -- simple query ------------------------------------------------------
    def execute(self, sql: str) -> None:
        """Run statements via the Simple Query protocol; raises on error."""
        self._send_msg(b"Q", sql.encode() + b"\x00")
        error = None
        while True:
            kind, payload = self._read_msg()
            if kind == b"E":
                error = PgError(self._error_text(payload))
            elif kind == b"Z":
                if error is not None:
                    raise error
                return
            # C (CommandComplete), T/D (row data), N (notices): skip

    def close(self) -> None:
        try:
            self._send_msg(b"X", b"")
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
