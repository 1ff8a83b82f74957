"""pw.persistence — checkpoint/resume (reference:
python/pathway/persistence/__init__.py:13 Backend / :88 Config; engine
side src/persistence/: input snapshots (input_snapshot.rs:217), offset
frontiers (frontier.rs), commit tracker (tracker.rs:47), backends
(backends/{file,s3,memory,mock}.rs)).

Model: every connector's parsed event batches are journaled with their
commit timestamps (write-ahead, before the engine steps them); connector
subjects may persist their own scan state (`snapshot_state`/`seek`). On
restart the journal replays first — byte-identical batches at fresh
timestamps — then the subject resumes from its stored state, so outputs
continue exactly once past the last durable commit.
"""

from __future__ import annotations

import io as _io
import json as _json
import os
import pickle
import threading
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.internals import faults as _faults

# Trust boundary: anyone able to write the persistence root can influence
# what restarts load. Journal entries and subject scan states hold plain
# engine values, so they are deserialized through an allow-listed
# unpickler (no arbitrary class resolution -> no code execution on load,
# matching the reference's non-executable bincode snapshots). Operator
# snapshots may legitimately contain user-defined reducer state and DO use
# full pickle — the persistence root must be trusted to the same degree as
# the program's own code for OPERATOR_PERSISTING mode.
_SAFE_MODULES = {
    "collections",
    "datetime",
    "pathway_tpu_torch.internals.api",
}
# builtins and numpy must be NAME-allowlisted, not module-allowlisted:
# builtins.eval/exec and numpy.testing._private.utils.runstring (a thin
# exec wrapper) would reopen the code-execution hole
_SAFE_BUILTINS = {
    "list", "dict", "set", "frozenset", "tuple", "bytearray", "complex",
    "bytes", "str", "int", "float", "bool", "range", "slice", "object",
}
# the reconstructors ndarray/dtype/scalar pickles actually reference
_SAFE_NUMPY = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins":
            if name in _SAFE_BUILTINS:
                return super().find_class(module, name)
        elif module.split(".")[0] == "numpy":
            if (module, name) in _SAFE_NUMPY or (
                module == "numpy" and name.startswith(("int", "uint", "float", "bool", "complex"))
            ):
                return super().find_class(module, name)
        elif module in _SAFE_MODULES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"persistence journal refuses to resolve {module}.{name}; "
            "only plain engine values are allowed in journal/subject-state "
            "records"
        )


def _safe_loads(data: bytes):
    return _SafeUnpickler(_io.BytesIO(data)).load()


class _BackendBase:
    def write(self, key: str, data: bytes) -> None: ...

    def read(self, key: str) -> bytes | None: ...

    def list_keys(self, prefix: str) -> list[str]: ...


class _FsBackend(_BackendBase):
    def __init__(self, path: str):
        self.root = path
        os.makedirs(path, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key)

    def write(self, key: str, data: bytes) -> None:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic cut point (reference: tracker.rs)

    def append(self, key: str, data: bytes) -> None:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def read(self, key: str) -> bytes | None:
        try:
            with open(self._p(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def list_keys(self, prefix: str) -> list[str]:
        out = []
        for root, _, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(root, name), self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._p(key))
        except FileNotFoundError:
            pass


class _ObjectStoreBackend(_BackendBase):
    """Persistence over an object store (reference: S3 backend,
    src/persistence/backends/s3.rs:47 — whole-object put/get, no append).

    Appends map to sequential part objects ``<key>.part/<n>``; reads
    concatenate the base object plus parts in order, so the journal's
    append-only contract holds on stores without native append. ``client``
    is anything with ``upload(path, bytes)``, ``download(path) -> bytes |
    None`` and ``list(prefix) -> [path]`` — the GCS adapter below, or a
    fake in tests.
    """

    def __init__(self, client, root: str = ""):
        self.client = client
        self.root = root.strip("/")

    def _p(self, key: str) -> str:
        return f"{self.root}/{key}" if self.root else key

    def write(self, key: str, data: bytes) -> None:
        # truncate-replace semantics (matching _FsBackend.write): stale
        # appended parts must not survive a rewrite of the base object
        delete = getattr(self.client, "delete", None)
        if delete is not None:
            for part in self.client.list(self._p(key) + ".part/"):
                delete(part)
        self.client.upload(self._p(key), data)

    def append(self, key: str, data: bytes) -> None:
        part_prefix = self._p(key) + ".part/"
        existing = self.client.list(part_prefix)
        self.client.upload(part_prefix + f"{len(existing):08d}", data)

    def read(self, key: str) -> bytes | None:
        base = self.client.download(self._p(key))
        parts = sorted(self.client.list(self._p(key) + ".part/"))
        if base is None and not parts:
            return None
        chunks = [base or b""]
        for p in parts:
            chunk = self.client.download(p)
            if chunk is not None:
                chunks.append(chunk)
        return b"".join(chunks)

    def list_keys(self, prefix: str) -> list[str]:
        out = set()
        for path in self.client.list(self._p(prefix)):
            rel = path[len(self.root) + 1 :] if self.root else path
            out.add(rel.split(".part/")[0])
        return sorted(out)

    def delete(self, key: str) -> None:
        delete = getattr(self.client, "delete", None)
        if delete is None:
            return
        for part in self.client.list(self._p(key) + ".part/"):
            delete(part)
        delete(self._p(key))


class _GcsClient:
    """google-cloud-storage adapter for _ObjectStoreBackend."""

    def __init__(self, bucket_name: str, client=None):
        if client is None:
            from google.cloud import storage

            client = storage.Client()
        self.bucket = client.bucket(bucket_name)
        self._client = client
        self._bucket_name = bucket_name

    def upload(self, path: str, data: bytes) -> None:
        self.bucket.blob(path).upload_from_string(data)

    def download(self, path: str) -> bytes | None:
        blob = self.bucket.blob(path)
        try:
            return blob.download_as_bytes()
        except Exception:
            return None

    def list(self, prefix: str) -> list[str]:
        return [b.name for b in self._client.list_blobs(
            self._bucket_name, prefix=prefix
        )]

    def delete(self, path: str) -> None:
        try:
            self.bucket.blob(path).delete()
        except Exception:
            pass  # already gone


class _S3PersistClient:
    """io/_s3.S3Client adapter for _ObjectStoreBackend.

    Only a definitive 404 maps to "absent": transient transport errors
    MUST propagate — treating them as missing journals would resume from
    an empty/truncated journal and replay inputs past the last durable
    commit (breaking exactly-once), and a swallowed failed delete would
    leave stale .part objects corrupting the next read's concatenation.
    """

    def __init__(self, client):
        self._client = client

    def upload(self, path: str, data: bytes) -> None:
        self._client.put_object(path, data)

    def download(self, path: str) -> bytes | None:
        import urllib.error

        try:
            return self._client.get_object(path)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def list(self, prefix: str) -> list[str]:
        return [o.key for o in self._client.list_objects(prefix)]

    def delete(self, path: str) -> None:
        # S3Client.delete_object already treats 404 as success and
        # re-raises anything else
        self._client.delete_object(path)


class _MemoryBackend(_BackendBase):
    def __init__(self):
        self.data: dict[str, bytes] = {}

    def write(self, key: str, data: bytes) -> None:
        self.data[key] = data

    def append(self, key: str, data: bytes) -> None:
        self.data[key] = self.data.get(key, b"") + data

    def read(self, key: str) -> bytes | None:
        return self.data.get(key)

    def list_keys(self, prefix: str) -> list[str]:
        return sorted(k for k in self.data if k.startswith(prefix))

    def delete(self, key: str) -> None:
        self.data.pop(key, None)


class Backend:
    """reference: persistence/__init__.py:13 — factory namespace."""

    def __init__(self, engine_backend: _BackendBase):
        self._backend = engine_backend

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls(_FsBackend(path))

    @classmethod
    def memory(cls) -> "Backend":
        return cls(_MemoryBackend())

    @classmethod
    def mock(cls, events=None) -> "Backend":
        return cls(_MemoryBackend())

    @classmethod
    def gcs(cls, bucket: str, *, root_path: str = "", client=None) -> "Backend":
        """Google Cloud Storage backend (reference: backends/s3.rs — same
        object-store model). ``client`` overrides the google-cloud-storage
        Client (tests inject fakes/emulators)."""
        return cls(_ObjectStoreBackend(_GcsClient(bucket, client), root_path))

    @classmethod
    def object_store(cls, client, *, root_path: str = "") -> "Backend":
        """Persistence over any upload/download/list client (the transport
        behind gcs(); usable for S3/MinIO-compatible clients too)."""
        return cls(_ObjectStoreBackend(client, root_path))

    @classmethod
    def s3(cls, root_path: str, bucket_settings=None, *, _opener=None) -> "Backend":
        """S3/MinIO persistence backend (reference:
        persistence/backends/s3.rs:47) over the dependency-free SigV4
        client (io/_s3.py). ``bucket_settings`` is an AwsS3Settings;
        ``root_path`` may be ``s3://bucket/prefix`` or a bare prefix."""
        from pathway_tpu_torch.io._s3 import AwsS3Settings, S3Client
        from pathway_tpu_torch.io.s3 import _split_path

        bucket, prefix = _split_path(root_path)
        settings = (bucket_settings or AwsS3Settings()).with_bucket(bucket)
        client = _S3PersistClient(S3Client(settings, opener=_opener))
        return cls(_ObjectStoreBackend(client, prefix))


@dataclass
class Config:
    """reference: persistence/__init__.py:88."""

    backend: Backend
    snapshot_interval_ms: int = 0
    persistence_mode: str = "PERSISTING"

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs) -> "Config":
        return cls(backend=backend, **kwargs)


class PersistenceManager:
    """Engine-side journal/restore driver wired into the Runtime."""

    def __init__(self, config: Config):
        self.backend = config.backend._backend
        self.mode = (config.persistence_mode or "PERSISTING").upper()
        self.snapshot_interval_ms = config.snapshot_interval_ms
        self.lock = threading.Lock()

    # -- journaling (write-ahead, called before the engine steps) ----------
    def journal_batch(
        self, conn_name: str, time: int, deltas: list, state: Any = None
    ) -> None:
        # crash here = rows accepted by the engine this run but never
        # journaled; restart rescans them from the last durable state
        _faults.fault_point("persistence.journal_write")
        # the subject scan state rides INSIDE the journal entry: one atomic
        # append, so the journaled prefix and the state that claims it can
        # never diverge across a crash (two separate writes could)
        payload = pickle.dumps((time, deltas, state))
        header = len(payload).to_bytes(8, "little")
        with self.lock:
            self.backend.append(f"journal/{conn_name}", header + payload)
        # crash here = journaled but control never returned to the engine
        # loop; restart replays the entry exactly once
        _faults.fault_point("persistence.journal_write.post")

    def save_subject_state(self, conn_name: str, state: Any) -> None:
        _faults.fault_point("persistence.checkpoint")
        with self.lock:
            self.backend.write(
                f"subject_state/{conn_name}", pickle.dumps(state)
            )

    # -- restore ------------------------------------------------------------
    def load_journal(self, conn_name: str) -> list[tuple[int, list, Any]]:
        raw = self.backend.read(f"journal/{conn_name}")
        if not raw:
            return []
        out = []
        pos = 0
        while pos + 8 <= len(raw):
            n = int.from_bytes(raw[pos : pos + 8], "little")
            pos += 8
            if pos + n > len(raw):
                break  # torn tail from a crash mid-append: drop it
            entry = _safe_loads(raw[pos : pos + n])
            if len(entry) == 2:  # pre-state journal format
                entry = (*entry, None)
            out.append(entry)
            pos += n
        return out

    def load_subject_state(self, conn_name: str) -> Any | None:
        raw = self.backend.read(f"subject_state/{conn_name}")
        return _safe_loads(raw) if raw else None

    # -- operator snapshots (reference: operator_snapshot.rs) --------------
    def save_operator_snapshot(
        self,
        node_states: list,
        subject_states: dict,
        fingerprint: list,
        *,
        key: str = "operator_snapshot",
    ) -> None:
        # crash here = this snapshot never became durable; restart resumes
        # from the previous consistent cut
        _faults.fault_point("persistence.checkpoint")
        with self.lock:
            self.backend.write(
                key,
                pickle.dumps((node_states, subject_states, fingerprint)),
            )

    def load_operator_snapshot(self, *, key: str = "operator_snapshot"):
        raw = self.backend.read(key)
        return pickle.loads(raw) if raw else None

    # -- multi-process consistent cut (reference: tracker.rs:47,160-193 —
    # per-worker persistent storage; a snapshot timestamp only advances
    # when every worker has durably written it) ---------------------------
    def write_marker(self, name: str, value: Any) -> None:
        """Tiny commit-marker record (e.g. the globally agreed snapshot
        tag). Written by rank 0 only AFTER every rank acked its rank-local
        snapshot, so the marker always names a complete consistent cut."""
        with self.lock:
            self.backend.write(f"marker/{name}", pickle.dumps(value))

    def read_marker(self, name: str) -> Any | None:
        raw = self.backend.read(f"marker/{name}")
        return _safe_loads(raw) if raw else None

    def delete_key(self, key: str) -> None:
        """Best-effort cleanup of superseded rank snapshots."""
        try:
            with self.lock:
                self.backend.delete(key)
        except (AttributeError, OSError):
            pass

    def list_keys(self, prefix: str) -> list[str]:
        return self.backend.list_keys(prefix)

    def prune_operator_snapshots(self, prefix: str, keep: set) -> None:
        """Best-effort prune of a rank's superseded snapshot tags,
        retaining every tag in ``keep``. The runtime passes the
        just-committed tag AND the previously committed one: a rank
        crashing between its restore-read of the marker and a peer's
        post-commit prune must still find the snapshot it is loading on
        the next rollback — deleting all-but-the-newest would race the
        restore (the prune-race fix). Non-integer suffixes (foreign
        keys under the prefix) are left alone."""
        for key in self.list_keys(prefix):
            try:
                tag = int(key[len(prefix):].split("/")[0])
            except ValueError:
                continue
            if tag not in keep:
                self.delete_key(key)
