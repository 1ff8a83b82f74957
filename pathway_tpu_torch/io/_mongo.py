"""Minimal MongoDB wire-protocol client — dependency-free (OP_MSG).

The reference's MongoWriter drives the mongodb crate (reference:
src/connectors/data_storage.rs MongoWriter; BSON payloads from
data_format.rs:1982). This build speaks OP_MSG (opcode 2013, the only
opcode modern MongoDB requires) directly: one section-0 command document
per request, BSON-encoded by the same hand-rolled encoder the Bson
formatter uses (io/_formats.py bson_document), plus a small BSON decoder
for command replies.
"""

from __future__ import annotations

import socket
import struct

from pathway_tpu_torch.io._formats import bson_document

OP_MSG = 2013


def bson_decode(data: bytes, offset: int = 0) -> dict:
    """Decode one BSON document (subset: the types server replies use)."""
    (length,) = struct.unpack_from("<i", data, offset)
    end = offset + length - 1
    pos = offset + 4
    out: dict = {}
    while pos < end:
        etype = data[pos]
        pos += 1
        nend = data.index(b"\x00", pos)
        name = data[pos:nend].decode()
        pos = nend + 1
        if etype == 0x01:  # double
            (out[name],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif etype == 0x02:  # string
            (slen,) = struct.unpack_from("<i", data, pos)
            out[name] = data[pos + 4 : pos + 3 + slen].decode()
            pos += 4 + slen
        elif etype in (0x03, 0x04):  # document / array
            (dlen,) = struct.unpack_from("<i", data, pos)
            sub = bson_decode(data, pos)
            out[name] = (
                [sub[k] for k in sorted(sub, key=int)] if etype == 0x04 else sub
            )
            pos += dlen
        elif etype == 0x05:  # binary
            (blen,) = struct.unpack_from("<i", data, pos)
            out[name] = data[pos + 5 : pos + 5 + blen]
            pos += 5 + blen
        elif etype == 0x08:  # bool
            out[name] = data[pos] == 1
            pos += 1
        elif etype == 0x09:  # datetime (ms)
            (out[name],) = struct.unpack_from("<q", data, pos)
            pos += 8
        elif etype == 0x0A:  # null
            out[name] = None
        elif etype == 0x10:  # int32
            (out[name],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif etype == 0x12:  # int64
            (out[name],) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise ValueError(f"unsupported BSON type 0x{etype:02x} in reply")
    return out


class MongoConnection:
    def __init__(self, connection_string: str, timeout: float = 30.0):
        import urllib.parse

        parsed = urllib.parse.urlsplit(
            connection_string
            if "://" in connection_string
            else "mongodb://" + connection_string
        )
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 27017
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._req_id = 0
        if parsed.username:
            query = urllib.parse.parse_qs(parsed.query)
            auth_db = query.get("authSource", ["admin"])[0]
            self._scram_auth(
                urllib.parse.unquote(parsed.username),
                urllib.parse.unquote(parsed.password or ""),
                auth_db,
            )

    def _scram_auth(self, user: str, password: str, auth_db: str) -> None:
        """SCRAM-SHA-256 (RFC 7677) over saslStart/saslContinue — the
        default MongoDB mechanism the reference's driver negotiates."""
        import base64
        import hashlib
        import hmac
        import os

        nonce = base64.b64encode(os.urandom(18)).decode()
        user_esc = user.replace("=", "=3D").replace(",", "=2C")
        first_bare = f"n={user_esc},r={nonce}"
        reply = self.command(
            {
                "saslStart": 1,
                "mechanism": "SCRAM-SHA-256",
                "payload": b"n,," + first_bare.encode(),
                "$db": auth_db,
            }
        )
        server_first = reply["payload"].decode()
        fields = dict(kv.split("=", 1) for kv in server_first.split(","))
        if not fields["r"].startswith(nonce):
            raise ConnectionError("mongodb SCRAM: server nonce mismatch")
        salt = base64.b64decode(fields["s"])
        iterations = int(fields["i"])
        salted = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, iterations
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={fields['r']}"
        auth_message = (
            f"{first_bare},{server_first},{without_proof}".encode()
        )
        client_sig = hmac.new(stored_key, auth_message, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        client_final = (
            f"{without_proof},p={base64.b64encode(proof).decode()}"
        )
        reply = self.command(
            {
                "saslContinue": 1,
                "conversationId": reply.get("conversationId", 1),
                "payload": client_final.encode(),
                "$db": auth_db,
            }
        )
        server_final = dict(
            kv.split("=", 1) for kv in reply["payload"].decode().split(",")
        )
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        expect = hmac.new(server_key, auth_message, hashlib.sha256).digest()
        import base64 as _b64

        if _b64.b64decode(server_final.get("v", "")) != expect:
            raise ConnectionError(
                "mongodb SCRAM: server signature verification failed"
            )
        while not reply.get("done", True):
            reply = self.command(
                {
                    "saslContinue": 1,
                    "conversationId": reply.get("conversationId", 1),
                    "payload": b"",
                    "$db": auth_db,
                }
            )

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("mongodb connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def command(self, doc: dict) -> dict:
        """Send one OP_MSG command document, return the reply document."""
        self._req_id += 1
        body = struct.pack("<i", 0) + b"\x00" + bson_document(doc)
        header = struct.pack(
            "<iiii", 16 + len(body), self._req_id, 0, OP_MSG
        )
        self.sock.sendall(header + body)
        (length, _rid, _rto, opcode) = struct.unpack(
            "<iiii", self._read_exact(16)
        )
        # 48MB is MongoDB's own max message size; 21 = header + flagBits +
        # section byte + minimal document. Anything outside is a corrupt
        # or non-mongo stream — fail cleanly instead of desyncing.
        if length < 21 or length > 48 * 1024 * 1024:
            raise ConnectionError(
                f"malformed mongodb frame: length={length} "
                "(stream corrupt or not a mongodb server)"
            )
        payload = self._read_exact(length - 16)
        if opcode != OP_MSG:
            raise ConnectionError(f"unexpected mongodb opcode {opcode}")
        # flagBits (4) + section kind byte, then the reply document
        reply = bson_decode(payload, 5)
        if not reply.get("ok"):
            raise RuntimeError(f"mongodb command failed: {reply}")
        # MongoDB reports per-document rejections (schema validation,
        # duplicate key, oversize doc) alongside ok:1 — treating those as
        # success silently drops rows from the sink.
        if reply.get("writeErrors"):
            raise RuntimeError(
                "mongodb bulk write failed for "
                f"{len(reply['writeErrors'])} document(s): "
                f"{reply['writeErrors']}"
            )
        if reply.get("writeConcernError"):
            raise RuntimeError(
                "mongodb write concern not satisfied: "
                f"{reply['writeConcernError']}"
            )
        return reply

    def insert_many(self, database: str, collection: str, docs: list[dict]):
        return self.command(
            {
                "insert": collection,
                "$db": database,
                "ordered": True,
                "documents": docs,
            }
        )

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
