"""Multi-process communication backend for the relational plane.

The reference scales its relational dataflow across processes with a
timely TCP mesh: N workers each own a key shard, rows are exchanged at
groupby/join boundaries, and a global progress protocol keeps timestamps
consistent (reference: src/engine/dataflow.rs:5506-5650 enter_graph /
config::Config::from_env, dataflow/config.rs:88-127).

This is the equivalent for the batch-per-timestamp engine: a full TCP
mesh between `PATHWAY_PROCESSES` ranks carrying

* CONTROL traffic — the rank-0 clock master assigns globally ordered
  commit timestamps and coordinates the lockstep frontier (the set of
  pending timestamps that every rank must step through), and
* DATA traffic — `ExchangeNode` all-to-alls that hash-partition delta
  batches by their grouping/join key so each rank owns a key shard
  (engine/nodes.py ExchangeNode).

The dense plane does NOT ride this mesh: tensors move over the
device interconnect's collectives. This mesh is the control+relational
plane only, matching the reference's split between timely channels and
its data plane.

Framing: length-prefixed payloads in two formats — v1 control/fallback
frames are pickle (first byte 0x80), v2 exchange frames are typed
columnar buffers (magic ``PWX2``): one coalesced frame per peer carries
every ExchangeNode's slice for a (timestamp, wave) as dtype-tagged raw
column bytes (exec.cpp nb_encode) plus a small pickled header that names
the slices present — empty slices ship zero bytes, object/fallback
slices ride as pickled segments. Receiver threads cap frame sizes at
PATHWAY_MESH_MAX_FRAME_MB (default 256) so a corrupt length prefix
raises a clean ConnectionError instead of attempting the allocation,
and every v2 frame carries a CRC-32 over its header+segments that is
verified BEFORE the header is unpickled — a corrupted frame (the wire
fuzz battery in tests/test_native_exchange.py flips/truncates every
structural region) poisons the link with a clean MeshPeerFailure
instead of silently mis-routing a slice whose pickled node id decoded
to a different integer.

Fast wire — the recv-wait attack, three layers deep:

* **per-blob compression** — typed columnar blobs (dtype-tagged column
  runs, string arenas) are ideal fast-compressor input. The handshake
  advertises each side's available codecs (a bitmask carried in the
  hello AND bound into its MAC, so a downgrade cannot be injected) and
  each link settles on the best common one per
  ``PATHWAY_MESH_COMPRESSION`` (off | zlib | lz4 | zstd | auto; stdlib
  zlib is always available, lz4/zstd used when importable). Every v2
  segment then ships raw or compressed per the segment table's codec
  column: blobs under ``PATHWAY_MESH_COMPRESS_MIN_BYTES`` skip the
  codec, as do blobs a compressor cannot shrink (and, under ``auto``,
  blobs whose sampled byte entropy says they will not compress —
  exec.cpp ``wire_entropy``). The frame CRC covers the WIRE image, so
  corruption is detected before any decompressor touches the bytes
  (CRC first, then codec errors — both poison the link cleanly), and
  decompression runs on the receiver threads, off the engine loop,
  where it shows up as a decode leg instead of recv-wait.
* **sender threads** — every post-handshake frame to a peer is drained
  by that peer's dedicated sender thread through a bounded queue
  (``PATHWAY_MESH_SEND_QUEUE`` frames; a full queue blocks the producer
  — backpressure, not unbounded buffering; 0 = synchronous legacy
  sends). Exchange frames enqueue UNENCODED: encode + compress happen
  on the sender thread, outside the engine loop and outside
  ``_send_locks``, so the native executor keeps applying while frames
  ship. Per-peer frame order is preserved (one queue per peer carries
  control and data alike); heartbeats bypass the queue (they carry no
  ordering constraint and must not sit behind a multi-MB frame).
* **tree gathers** — the wave engine routes pure-gather waves over a
  k-ary reduction tree (``protocol.tree_*``; ``PATHWAY_MESH_TREE_FANOUT``)
  so rank 0 ingests ``fanout`` frames per wave instead of world-1; this
  module only ships the frames it is handed — the topology decision
  lives in parallel/protocol.py where the model checker explores it.
The mesh links trusted peer processes
of one pipeline (localhost by default, PATHWAY_HOSTS for multi-host);
it is not an external protocol surface: the listener binds 127.0.0.1
unless PATHWAY_HOSTS names remote hosts, and every connection must
complete a mutual challenge-response handshake (keyed blake2b over
fresh nonces, keyed by PATHWAY_MESH_SECRET) before any frame is
unpickled — an unauthenticated peer is disconnected, and a recorded
handshake cannot be replayed. Binding a non-loopback interface without
an explicitly configured PATHWAY_MESH_SECRET is refused outright:
frames are pickle, so mesh access is code execution, and a default
key on an open port would hand that to any network peer.

Fault tolerance (the detection layer of the mesh rollback-recovery
model; engine/runtime.py owns the abort path and
parallel/supervisor.py the respawn):

* every mesh carries a recovery **epoch** (``PATHWAY_MESH_EPOCH``,
  bumped by the supervisor on every rollback restart) that is bound
  into the handshake hello AND its MAC — a rank surviving from a dead
  epoch can neither join nor be joined by the recovered mesh, so
  in-flight state of the dead epoch can never leak across a rollback;
* a **heartbeat** thread sends a tiny ``PWHB`` frame to every peer each
  ``PATHWAY_MESH_HEARTBEAT_S`` (default 2, 0 = off) and every received
  byte refreshes the peer's liveness clock; a ``recv`` that waits past
  ``PATHWAY_MESH_PEER_TIMEOUT_S`` (default 10) without any life sign
  raises :class:`MeshPeerFailure` — crash detection that does not wait
  for the full collective deadline on lossy/multi-host paths;
* every collective (``recv``/``gather0``/``bcast0``/``all_to_all``/
  ``barrier``) observes a hard deadline ``PATHWAY_MESH_OP_TIMEOUT_S``
  (default 300, 0 = off) and raises :class:`MeshTimeout` naming the
  peer rank and the pending tag — a logically hung peer (alive but
  deadlocked) cannot block the mesh forever;
* ``close()`` ships an orderly-goodbye ``PWBY`` frame first, so a peer
  that finds the connection gone can distinguish clean shutdown
  (:class:`MeshPeerGone`) from a crash (:class:`MeshPeerFailure`).

All three error types subclass ConnectionError, which pre-existing
callers already treat as "the mesh is dead".
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import struct
import threading
import time as _time
import queue
import zlib
from typing import Any

from pathway_tpu_torch.internals.api import Pointer, _value_to_bytes
from pathway_tpu_torch.internals import faults as _faults
from pathway_tpu_torch.engine.stream import freeze_value, is_native_batch

# protocol decisions (handshake acceptance, liveness verdicts, the
# goodbye-vs-crash classification) come from the shared transition table
# that analysis/meshcheck.py model-checks — see parallel/protocol.py
from pathway_tpu_torch.parallel import protocol as _proto

_LEN = struct.Struct("<Q")
# exchange v2 frames: typed columnar buffers instead of pickle. The
# first payload byte discriminates — pickled frames (protocol 2+) always
# start with 0x80, so the magic can never collide with a v1 frame.
_V2_MAGIC = b"PWX2"
# (head_len, crc32 over head+blobs): the crc gates pickle.loads of the
# header — without it a single flipped bit inside the pickled node-id
# table decodes "successfully" to a different exchange id and the slice
# merges into the wrong boundary (found by the wire fuzz battery)
_V2_HEAD = struct.Struct("<II")
# control frames of the fault-tolerance layer: 4-byte payloads that the
# receiver consumes without queueing (neither collides with pickle's
# 0x80 first byte nor with PWX2)
_HB_MAGIC = b"PWHB"  # heartbeat: refreshes the peer's liveness clock
_BYE_MAGIC = b"PWBY"  # orderly goodbye: the peer is shutting down cleanly


class MeshTimeout(ConnectionError):
    """A collective exceeded PATHWAY_MESH_OP_TIMEOUT_S."""


class MeshPeerFailure(ConnectionError):
    """A peer crashed: connection lost (or liveness window exceeded)
    without an orderly goodbye."""


class MeshPeerGone(ConnectionError):
    """A peer shut down in an orderly fashion (goodbye frame seen) while
    this rank still expected traffic from it."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _max_frame_bytes() -> int:
    """Receiver-side frame-size cap: a corrupt length prefix must raise a
    clean ConnectionError, not attempt an unbounded allocation."""
    try:
        mb = float(os.environ.get("PATHWAY_MESH_MAX_FRAME_MB", "256"))
    except ValueError:
        mb = 256.0
    return max(1, int(mb * 1024 * 1024))


# -- wire codecs -------------------------------------------------
# Codec ids appear in the v2 segment table (0 = raw); codec BITS ride the
# handshake hello as this rank's advertised set. zlib is stdlib and
# always available; lz4/zstd are advertised only when importable, so a
# mixed deployment degrades to the best common codec instead of a
# decode error.

CODEC_ID = {"zlib": 1, "lz4": 2, "zstd": 3}
_ID_CODEC = {v: k for k, v in CODEC_ID.items()}
_CODEC_BIT = {"zlib": 1, "lz4": 2, "zstd": 4}
# negotiation preference, best first (measured ratio ~= equal on typed
# columnar frames; zstd/lz4 win on encode+decode CPU)
_CODEC_PREF = ("zstd", "lz4", "zlib")
# auto mode: sampled byte entropy (bits/byte) above which a blob is
# treated as incompressible (random/already-compressed payloads) and
# shipped raw without paying the codec
_ENTROPY_SKIP_BITS = 7.4

_lz4_mod = None
_zstd_mod = None


def _codec_module(name: str):
    """Resolve (and memoize) a non-stdlib codec's MODULE; None when the
    package is not importable in this environment. Compressor /
    decompressor objects are constructed per call: sender and receiver
    threads of several peers (de)compress concurrently, and neither
    python-zstandard contexts nor lz4 frame decompressors are safe to
    share across simultaneous calls."""
    global _lz4_mod, _zstd_mod
    if name == "lz4":
        if _lz4_mod is None:
            try:
                import lz4.frame as _lz4f  # type: ignore

                _lz4_mod = _lz4f
            except Exception:
                _lz4_mod = False
        return _lz4_mod or None
    if name == "zstd":
        if _zstd_mod is None:
            try:
                import zstandard as _zstd  # type: ignore

                _zstd_mod = _zstd
            except Exception:
                _zstd_mod = False
        return _zstd_mod or None
    return None


def codec_available(name: str) -> bool:
    if name == "zlib":
        return True
    if name in ("lz4", "zstd"):
        return _codec_module(name) is not None
    return False


def local_codec_mask(conf: str) -> int:
    """Advertised-codec bitmask for this rank's handshake hello, from
    the PATHWAY_MESH_COMPRESSION knob: ``off`` advertises nothing (the
    link stays raw no matter what the peer offers), a forced codec
    advertises only itself (unavailable forced codec = honest off, never
    a silent substitute), ``auto`` advertises everything importable."""
    conf = (conf or "auto").strip().lower()
    if conf == "off":
        return 0
    names = _CODEC_PREF if conf == "auto" else (conf,)
    mask = 0
    for n in names:
        if n in _CODEC_BIT and codec_available(n):
            mask |= _CODEC_BIT[n]
    return mask


def negotiate_codec(local_mask: int, peer_mask: int) -> str | None:
    """Best common codec of two advertised masks (None = ship raw)."""
    common = local_mask & peer_mask
    for name in _CODEC_PREF:
        if common & _CODEC_BIT[name]:
            return name
    return None


def _compress_blob(codec: str, blob) -> bytes:
    if codec == "zlib":
        # level 1: this is a wire codec on the latency path — typed
        # columnar frames compress >2x even at the fastest setting
        return zlib.compress(bytes(blob), 1)
    if codec == "lz4":
        return _codec_module("lz4").compress(bytes(blob))
    if codec == "zstd":
        # fresh context per call: contexts are not concurrency-safe
        return _codec_module("zstd").ZstdCompressor().compress(
            bytes(blob)
        )
    raise ValueError(f"unknown wire codec {codec!r}")


def _decompress_blob(codec_id: int, blob, max_out: int) -> bytes:
    """Inflate one v2 segment, output-bounded by the frame cap: the CRC
    already rules out wire corruption, so an overrun here is a buggy or
    hostile SENDER (zip bomb) — refuse the allocation, poison the link."""
    name = _ID_CODEC.get(codec_id)
    if name is None:
        raise ValueError(f"unknown wire codec id {codec_id}")
    if name == "zlib":
        d = zlib.decompressobj()
        out = d.decompress(bytes(blob), max_out)
        if d.unconsumed_tail or not d.eof:
            raise ValueError(
                "compressed segment exceeds PATHWAY_MESH_MAX_FRAME_MB"
            )
        return out
    if name == "lz4":
        mod = _codec_module("lz4")
        if mod is None:
            raise ValueError("lz4 segment received but lz4 not importable")
        # output-bounded like the other codecs: a hostile frame header
        # declaring a huge content size must be refused, not allocated
        d = mod.LZ4FrameDecompressor()
        out = d.decompress(bytes(blob), max_length=max_out)
        if not d.eof:
            raise ValueError(
                "compressed segment exceeds PATHWAY_MESH_MAX_FRAME_MB "
                "or is truncated"
            )
    else:
        mod = _codec_module("zstd")
        if mod is None:
            raise ValueError(
                "zstd segment received but zstandard not importable"
            )
        out = mod.ZstdDecompressor().decompress(
            bytes(blob), max_output_size=max_out
        )
    if len(out) > max_out:
        raise ValueError(
            "compressed segment exceeds PATHWAY_MESH_MAX_FRAME_MB"
        )
    return out


class RawSegment:
    """A received v2 segment kept as WIRE BYTES for tree relaying
   : an interior rank of a gather tree forwards its
    children's slices verbatim — no decompress, no typed decode, no
    re-encode, no re-compress; the bytes inflate exactly once, at rank
    0. Produced by ``_decode_exchange`` for frames tagged as relay
    legs (``("xwr", ...)``) and consumed by ``_wire_form``."""

    __slots__ = ("kind", "enc", "blob")

    def __init__(self, kind: int, enc: int, blob: bytes):
        self.kind = kind
        self.enc = enc
        self.blob = blob


class _EncEntry:
    """One encoded object in a wave's encode cache: the raw typed blob
    plus its per-codec wire forms, computed once under the entry lock no
    matter how many sender threads ship the same object (broadcast
    sides ship to world-1 peers)."""

    __slots__ = ("lock", "kind", "raw", "wire")

    def __init__(self):
        self.lock = threading.Lock()
        self.kind = None
        self.raw = None
        self.wire = {}  # codec name -> (enc_id, wire_bytes)


class WaveEncodeCache:
    """Per-wave encode/compress dedup, shared across the per-peer sender
    threads. The caller (one exchange wave) owns its lifetime, which is
    what keeps the id() keys valid — objects are alive for the wave."""

    __slots__ = ("_lock", "_entries")

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[int, _EncEntry] = {}

    def entry(self, obj) -> _EncEntry:
        with self._lock:
            e = self._entries.get(id(obj))
            if e is None:
                e = self._entries[id(obj)] = _EncEntry()
            return e


def shard_hash(value: Any) -> int:
    """The stable 64-bit key digest behind :func:`stable_shard` — the
    world-INDEPENDENT half of the mint. Exposed separately
    because the elastic-mesh re-shard reader (persistence/reshard.py)
    re-buckets committed store entries from N to M shards by feeding
    the same digest through ``protocol.shard_owner`` at the new world
    size: same bytes, same blake2b, different modulus — a pure
    re-bucketing, no re-hash of live data."""
    b = _value_to_bytes(freeze_value(value))
    return int.from_bytes(
        hashlib.blake2b(b, digest_size=8).digest(), "little"
    )


def stable_shard(value: Any, world: int) -> int:
    """Deterministic, process-stable partition of a key value: the same
    injective byte serialization that backs Pointer minting (api.py), so
    every rank routes a key to the same owner regardless of PYTHONHASHSEED.
    Exact parity with the native columnar mint (exec.cpp
    shard_partition_nb) is pinned by tests/test_native_exchange.py.
    The owner decision itself is the shared ``protocol.shard_owner``
    transition the rescale model checker explores (the batched path
    below inlines the identical modulus for speed — parity pinned)."""
    return _proto.shard_owner(shard_hash(value), world)


def stable_shard_many(values, world: int) -> list[int]:
    """Batched stable_shard — one pass, locals bound once; the tuple
    fallback path of ExchangeNode routes whole batches through this."""
    b2b = hashlib.blake2b
    vtb = _value_to_bytes
    fz = freeze_value
    fb = int.from_bytes
    return [
        fb(b2b(vtb(fz(v)), digest_size=8).digest(), "little") % world
        for v in values
    ]


def _bind_listener(
    host: str, port: int, backlog: int = 8, retry_s: float = 3.0
) -> socket.socket:
    """Bind the mesh listener with ``SO_REUSEADDR`` (a dead epoch's
    TIME_WAIT sockets must not block the recovered mesh) and a bounded
    in-place retry: the supervisor probes the port base before spawning,
    but the dying epoch's listener can still hold the port for a beat
    between reap and respawn — every rank must keep ``first_port + r``,
    so waiting it out briefly beats burning a rollback-budget restart on
    EADDRINUSE."""
    deadline = _time.monotonic() + retry_s
    while True:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
            s.listen(backlog)
            return s
        except OSError:
            s.close()
            if _time.monotonic() > deadline:
                raise
            _time.sleep(0.05)


# struct tcp_info (linux/tcp.h): 8 one-byte fields, then u32s — index 12
# of the u32 block is tcpi_last_ack_recv (ms since the peer's kernel last
# ACKed us). TCP_ESTABLISHED = 1.
_TCP_INFO_LAST_ACK_OFF = 8 + 12 * 4
_TCP_ESTABLISHED = 1


class _MeshError:
    """Receiver-thread verdict queued in place of a frame: recv() raises
    it as ConnectionError with the real reason (oversized/corrupt frame)
    instead of a bare 'peer disconnected'."""

    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


class ProcessGroup:
    """Full TCP mesh between the pipeline's ranks.

    Connection setup: rank r listens on ``first_port + r``; every rank
    connects to all lower ranks and accepts from all higher ranks, then
    handshakes its rank id. One receiver thread per peer demultiplexes
    length-prefixed pickled ``(tag, payload)`` frames into per-peer
    queues; `recv` asserts the expected tag so any protocol desync is a
    hard error, not silent corruption.
    """

    def __init__(
        self,
        rank: int,
        world: int,
        first_port: int,
        hosts: list[str] | None = None,
        timeout: float = 60.0,
        epoch: int | None = None,
    ):
        self.rank = rank
        self.world = world
        # recovery epoch: the supervisor bumps PATHWAY_MESH_EPOCH on every
        # rollback restart; the handshake binds it, so a straggler rank
        # from the dead epoch is rejected instead of poisoning the
        # recovered mesh with pre-rollback frames
        if epoch is None:
            try:
                epoch = int(os.environ.get("PATHWAY_MESH_EPOCH", "0") or 0)
            except ValueError:
                epoch = 0
        self.epoch = epoch
        self._op_timeout = _env_float("PATHWAY_MESH_OP_TIMEOUT_S", 300.0)
        self._hb_interval = _env_float("PATHWAY_MESH_HEARTBEAT_S", 2.0)
        self._peer_timeout = _env_float("PATHWAY_MESH_PEER_TIMEOUT_S", 10.0)
        # liveness clocks: monotonic() of the last byte seen from a peer
        # (heartbeats, data, anything); plain dict stores are GIL-atomic
        self._last_seen: dict[int, float] = {}
        self._goodbye: set[int] = set()
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        # the runtime attaches its ProberStats here so heartbeat misses
        # land on the OpenMetrics endpoint; None outside engine runs
        self.stats = None
        # flight recorder (internals/flight.py): receiver-thread decode
        # spans + heartbeat marks ride it; None when tracing is off
        self.recorder = None
        if hosts is None:
            env = os.environ.get("PATHWAY_HOSTS", "")
            hosts = (
                [h.strip() for h in env.split(",")]
                if env
                else ["127.0.0.1"] * world
            )
        if len(hosts) != world:
            raise ValueError(
                f"PATHWAY_HOSTS lists {len(hosts)} hosts for {world} processes"
            )
        self.hosts = hosts
        self._max_frame = _max_frame_bytes()
        # tree-gather relays aggregate up to a whole
        # subtree's slices into ONE frame: scale the per-frame sanity
        # cap by the largest possible subtree span so a legitimate
        # deep-tree frame is never mistaken for a corrupt length
        # prefix. PATHWAY_MESH_MAX_FRAME_MB keeps its per-ORIGIN
        # meaning; the scaled cap is still a finite bound.
        if (
            _proto.tree_fanout(
                world, os.environ.get("PATHWAY_MESH_TREE_FANOUT")
            )
            >= 2
        ):
            self._max_frame *= max(1, world - 1)
        self._socks: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._queues: dict[int, "queue.Queue"] = {
            p: queue.Queue() for p in range(world) if p != rank
        }
        self._recv_threads: list[threading.Thread] = []
        self._closed = False
        # fast wire: advertised codec set + negotiated
        # per-link codec, compression floor, and the per-peer sender
        # threads (bounded queues; 0 = synchronous legacy sends)
        self._codec_conf = (
            os.environ.get("PATHWAY_MESH_COMPRESSION", "auto") or "auto"
        ).strip().lower()
        self._codec_mask = local_codec_mask(self._codec_conf)
        self._codec_auto = self._codec_conf == "auto"
        try:
            self._compress_min = int(
                os.environ.get("PATHWAY_MESH_COMPRESS_MIN_BYTES", "512")
                or 512
            )
        except ValueError:
            self._compress_min = 512
        self._peer_codec: dict[int, str | None] = {}
        # each peer's raw advertised mask too: tree-gather frames are
        # relayed VERBATIM toward rank 0, so their segments must be
        # compressed with a codec the route DESTINATION advertised, not
        # merely the next hop (the mesh is a full graph — every rank
        # holds rank 0's advert even when the wave topology is a tree)
        self._peer_mask: dict[int, int] = {}
        raw_q = os.environ.get("PATHWAY_MESH_SEND_QUEUE", "")
        try:
            self._sendq_cap = int(raw_q) if raw_q.strip() else -1
        except ValueError:
            self._sendq_cap = -1
        if self._sendq_cap < 0:
            # adaptive default: a dedicated sender thread per peer only
            # pays when there are cores for it to run on — on a host
            # whose local ranks already saturate the CPUs, the per-frame
            # GIL handoff sits on every wave's critical path (measured
            # ~18% at 2 ranks on a 1-core host), so starved topologies
            # keep the synchronous inline send. Loopback meshes run all
            # `world` ranks on this host; multi-host meshes count only
            # the ranks sharing ours.
            local_ranks = max(
                1,
                sum(
                    1
                    for h in hosts
                    if h in ("127.0.0.1", "localhost", "::1")
                    or h == hosts[rank]
                ),
            )
            cores = os.cpu_count() or 1
            self._sendq_cap = 8 if cores >= 2 * local_ranks else 0
        self._sendqs: dict[int, "queue.Queue"] = {}
        self._send_threads: list[threading.Thread] = []
        # EWMA of encoded wire-frame size, feeding the memory
        # accountant's exchange components: queued frames are
        # un-encoded tuples, so queued bytes are estimated as
        # items x EWMA rather than paying an encode ahead of the sender
        self._frame_bytes_ewma = 4096.0
        # set AFTER close() enqueued every stop item: sender threads may
        # exit on an idle timeout only once this is set, so a stop (and
        # its goodbye) can never race past an exiting thread
        self._send_stop = threading.Event()
        # first sender-thread failure per peer: later send()s re-raise it
        # synchronously instead of queueing into a dead link
        self._send_errs: dict[int, str] = {}
        loopback_only = all(
            h in ("127.0.0.1", "localhost", "::1") for h in hosts
        )
        self._loopback = loopback_only
        # auto-mode engagement: `auto` means "compress when
        # it cannot cost wall-clock" — engage when the codec runs off
        # the engine's critical path (async sender threads armed: spare
        # cores drain encode+compress+decompress in parallel) OR when
        # the link is genuinely remote (bytes cross a real wire, worth
        # CPU even inline). A starved loopback mesh (sync sends, every
        # byte is a memcpy) ships raw: burning the cores the ranks
        # share to shrink memcpys was measured as a straight efficiency
        # loss. Forced codecs always engage; negotiation always
        # advertises (capability is not policy — the receiver inflates
        # whatever arrives, so per-link asymmetry is fine).
        self._auto_engage = (not loopback_only) or self._sendq_cap > 0
        if not loopback_only and not os.environ.get("PATHWAY_MESH_SECRET"):
            raise RuntimeError(
                "PATHWAY_HOSTS names non-loopback hosts but "
                "PATHWAY_MESH_SECRET is not set. Mesh frames are pickled "
                "objects, so the listener will not bind a routable "
                "interface under the built-in default key: set a shared "
                "PATHWAY_MESH_SECRET on every rank."
            )
        self._listener = _bind_listener(
            "127.0.0.1" if loopback_only else "0.0.0.0",
            first_port + rank,
            backlog=world,
        )
        self._connect_mesh(first_port, timeout)

    def _mac(
        self,
        role: bytes,
        nonces: bytes,
        prover: int,
        verifier: int,
        codecs: bytes = b"",
    ) -> bytes:
        """Keyed MAC for one direction of the handshake. Binds BOTH fresh
        nonces plus both rank ids (so a transcript cannot be replayed into
        another session or reflected back at its sender) AND the recovery
        epoch AND the world size (so a rank surviving from a rolled-back
        or RESCALED epoch cannot authenticate into the recovered mesh —
        a pre-rescale straggler's slices were minted for a different
        shard count) under PATHWAY_MESH_SECRET.
        Frames are pickle, so no un-authenticated byte
        may reach pickle.loads — both directions must verify before any
        frame is read. The connecting side proves knowledge of the secret
        FIRST: the listener never emits keyed output to an unauthenticated
        peer (no MAC oracle). The residual exposure is the initiator's MAC
        to a host-impersonating listener, which is inherent to 2-party PSK
        schemes; on untrusted network paths pair the secret with a secure
        transport."""
        import hashlib

        secret = os.environ.get("PATHWAY_MESH_SECRET", "").encode()
        return hashlib.blake2b(
            role
            + self.epoch.to_bytes(8, "little")
            + self.world.to_bytes(8, "little")
            # both advertised-codec masks (client||server) are MAC-bound
            # too: a network middleman cannot strip the compression
            # advert to force a downgrade
            + codecs
            + nonces
            + prover.to_bytes(8, "little")
            + verifier.to_bytes(8, "little"),
            key=secret or b"pathway-mesh",
            digest_size=16,
        ).digest()

    def _connect_mesh(self, first_port: int, timeout: float) -> None:
        expected_accepts = self.world - 1 - self.rank
        accepted: dict[int, socket.socket] = {}

        import hmac as _hmac

        acc_codec: dict[int, int] = {}

        def acceptor():
            while len(accepted) < expected_accepts:
                s, _addr = self._listener.accept()
                try:
                    s.settimeout(10)
                    peer = int(_LEN.unpack(_recv_exact(s, _LEN.size))[0])
                    peer_epoch = int(
                        _LEN.unpack(_recv_exact(s, _LEN.size))[0]
                    )
                    peer_world = int(
                        _LEN.unpack(_recv_exact(s, _LEN.size))[0]
                    )
                    # the peer's advertised wire-codec set:
                    # negotiation input only — acceptance never depends
                    # on it (an empty set is a valid raw link)
                    peer_codecs = int(
                        _LEN.unpack(_recv_exact(s, _LEN.size))[0]
                    )
                    nonce_c = _recv_exact(s, 16)
                    if not _proto.hello_accept(
                        self.rank, self.epoch, self.world, peer,
                        peer_epoch, peer_world,
                    ):
                        # bogus rank, a straggler from a rolled-back
                        # epoch, or a dead-WORLD straggler whose slices
                        # were minted for a different shard count
                        # (rescale): refuse before any keyed
                        # output — its MAC would fail anyway (epoch AND
                        # world are bound into the MAC input)
                        raise EOFError
                    nonce_s = os.urandom(16)
                    # challenge + our codec advert — no keyed output yet
                    s.sendall(_LEN.pack(self._codec_mask) + nonce_s)
                    codecs = (
                        int(peer_codecs).to_bytes(8, "little")
                        + self._codec_mask.to_bytes(8, "little")
                    )
                    mac_c = _recv_exact(s, 16)
                    if not _hmac.compare_digest(
                        mac_c,
                        self._mac(
                            b"C", nonce_c + nonce_s, peer, self.rank,
                            codecs,
                        ),
                    ):
                        raise EOFError
                    # peer is authenticated; now prove ourselves back
                    s.sendall(
                        self._mac(
                            b"S", nonce_c + nonce_s, self.rank, peer,
                            codecs,
                        )
                    )
                    s.settimeout(None)
                except (EOFError, OSError):
                    s.close()  # unauthenticated, stalled, or bogus peer
                    continue
                acc_codec[peer] = peer_codecs
                accepted[peer] = s

        at = threading.Thread(target=acceptor, daemon=True)
        at.start()
        # connect to all lower ranks, retrying while they come up
        for peer in range(self.rank):
            deadline = _time.monotonic() + timeout
            while True:
                try:
                    s = socket.create_connection(
                        (self.hosts[peer], first_port + peer), timeout=5
                    )
                    break
                except OSError:
                    if _time.monotonic() > deadline:
                        raise TimeoutError(
                            f"rank {self.rank}: cannot reach rank {peer}"
                        )
                    _time.sleep(0.05)
            nonce_c = os.urandom(16)
            s.settimeout(10)
            try:
                s.sendall(
                    _LEN.pack(self.rank)
                    + _LEN.pack(self.epoch)
                    + _LEN.pack(self.world)
                    + _LEN.pack(self._codec_mask)
                    + nonce_c
                )
                peer_codecs = int(
                    _LEN.unpack(_recv_exact(s, _LEN.size))[0]
                )
                nonce_s = _recv_exact(s, 16)
                codecs = (
                    self._codec_mask.to_bytes(8, "little")
                    + int(peer_codecs).to_bytes(8, "little")
                )
                s.sendall(
                    self._mac(
                        b"C", nonce_c + nonce_s, self.rank, peer, codecs
                    )
                )
                mac_s = _recv_exact(s, 16)
            except (EOFError, OSError) as exc:
                s.close()
                raise ConnectionError(
                    f"rank {self.rank}: rank {peer} rejected the mesh "
                    "handshake (PATHWAY_MESH_SECRET or PATHWAY_MESH_EPOCH "
                    f"mismatch? ours is epoch {self.epoch}): {exc!r}"
                ) from exc
            if not _hmac.compare_digest(
                mac_s,
                self._mac(b"S", nonce_c + nonce_s, peer, self.rank, codecs),
            ):
                s.close()
                raise ConnectionError(
                    f"rank {self.rank}: rank {peer} failed mesh "
                    "authentication (PATHWAY_MESH_SECRET or "
                    "PATHWAY_MESH_EPOCH mismatch?)"
                )
            s.settimeout(None)
            self._peer_codec[peer] = negotiate_codec(
                self._codec_mask, peer_codecs
            )
            self._peer_mask[peer] = int(peer_codecs)
            self._socks[peer] = s
        at.join(timeout)
        if len(accepted) != expected_accepts:
            raise TimeoutError(
                f"rank {self.rank}: expected {expected_accepts} peer "
                f"connections, got {len(accepted)}"
            )
        self._socks.update(accepted)
        for peer, mask in acc_codec.items():
            self._peer_codec[peer] = negotiate_codec(
                self._codec_mask, mask
            )
            self._peer_mask[peer] = int(mask)
        for peer, s in self._socks.items():
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # deep buffers keep coalesced exchange frames from blocking
            # the sender while a busy peer's receiver thread is starved
            # (best-effort: the kernel may clamp)
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                try:
                    s.setsockopt(socket.SOL_SOCKET, opt, 4 * 1024 * 1024)
                except OSError:
                    pass
            self._send_locks[peer] = threading.Lock()
            self._last_seen[peer] = _time.monotonic()
            t = threading.Thread(
                target=self._recv_loop, args=(peer, s), daemon=True
            )
            t.start()
            self._recv_threads.append(t)
            if self._sendq_cap > 0:
                # dedicated sender per peer: one bounded FIFO
                # carries control and exchange frames alike, so per-peer
                # order is preserved while encode/compress/sendall run
                # off the engine loop
                q = queue.Queue(maxsize=self._sendq_cap)
                self._sendqs[peer] = q
                st = threading.Thread(
                    target=self._send_loop, args=(peer, q), daemon=True
                )
                st.start()
                self._send_threads.append(st)
        if self._hb_interval > 0 and self.world > 1:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True
            )
            self._hb_thread.start()

    def _hb_loop(self) -> None:
        """Ship a PWHB frame to every peer each interval and account
        missed beats: a peer silent past 1.5 intervals scores one miss
        per further interval (OpenMetrics mesh_heartbeats_missed_total).
        Heartbeat SENDS skip peers whose send lock is busy — an in-flight
        data frame is itself proof of OUR liveness, and blocking behind a
        multi-GB send would make heartbeats lie about theirs."""
        payload = _LEN.pack(len(_HB_MAGIC)) + _HB_MAGIC
        while not self._hb_stop.wait(self._hb_interval):
            if self._closed:
                return
            now = None
            for peer, s in list(self._socks.items()):
                # miss accounting FIRST, independent of the send: whether
                # the PEER is beating has nothing to do with our own send
                # lock being busy streaming a large frame to it
                stats = self.stats
                if stats is not None and peer not in self._goodbye:
                    now = _time.monotonic() if now is None else now
                    seen = self._last_seen.get(peer, now)
                    if now - seen > 1.5 * self._hb_interval:
                        stats.on_mesh_heartbeat_missed()
                        if self.recorder is not None:
                            self.recorder.note_mark(
                                "heartbeat_missed", peer=peer
                            )
                lock = self._send_locks.get(peer)
                if lock is None or not lock.acquire(blocking=False):
                    continue
                try:
                    s.sendall(payload)
                except OSError:
                    pass  # the receiver path surfaces the death
                finally:
                    lock.release()

    def _recv_loop(self, peer: int, s: socket.socket) -> None:
        q = self._queues[peer]
        cap = self._max_frame
        last_seen = self._last_seen
        # cross-frame wire intern cache: this link's gather
        # vocabulary (group keys/strings) recurs commit after commit —
        # one capsule per receiver thread turns nearly every Pointer/
        # str mint in deltas_decode into a cache hit. Thread-local by
        # construction (only this loop touches it), bounded (epoch-
        # resets at capacity).
        ex = self._pwexec()
        intern = (
            ex.intern_new()
            if ex is not None and hasattr(ex, "intern_new")
            else None
        )

        def alive() -> None:
            # refreshed per received CHUNK, not per frame: a peer mid-way
            # through streaming a huge frame is demonstrably alive even
            # though no frame has completed (and its send lock may be
            # starving its heartbeats)
            last_seen[peer] = _time.monotonic()

        try:
            while True:
                head = _recv_exact(s, _LEN.size, on_bytes=alive)
                (n,) = _LEN.unpack(head)
                if n > cap:
                    # corrupt (or hostile) length prefix: refuse the
                    # allocation, poison this link with the reason
                    q.put(
                        _MeshError(
                            f"rank {self.rank}: frame from peer {peer} "
                            f"declares {n} bytes, over the "
                            f"PATHWAY_MESH_MAX_FRAME_MB cap ({cap} bytes)"
                        )
                    )
                    q.put(None)  # later recv()s see a dead peer, not a hang
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                payload = _recv_exact(s, n, on_bytes=alive)
                if payload == _HB_MAGIC:
                    continue  # liveness already refreshed; nothing queues
                if payload == _BYE_MAGIC:
                    # orderly shutdown announced: the EOF that follows is
                    # a clean goodbye, not a crash
                    self._goodbye.add(peer)
                    continue
                try:
                    if payload[:4] == _V2_MAGIC:
                        # exchange v2: decompress + decode typed columnar
                        # buffers HERE, on the receiver thread — the work
                        # overlaps the main loop's compute and shows up
                        # as a decode leg (with a decompress sub-span),
                        # not recv-wait (the flight recorder gives these
                        # their own per-peer trace track)
                        rec = self.recorder
                        t0 = (
                            _time.perf_counter_ns()
                            if rec is not None
                            else 0
                        )
                        decoded, dz = self._decode_exchange(
                            payload, intern
                        )
                        if rec is not None:
                            rec.note_decode(
                                peer, t0, _time.perf_counter_ns(),
                                len(payload),
                            )
                            if dz is not None:
                                rec.note_decompress(
                                    peer, dz[0], dz[0] + dz[1], dz[2],
                                    dz[3],
                                )
                    else:
                        decoded = pickle.loads(payload)
                except Exception as exc:
                    # a frame that passed the length cap but fails to
                    # decode (corrupt bytes, stale native build) must
                    # surface as a clean link error, not a silently dead
                    # receiver thread that hangs the next recv() forever
                    q.put(
                        _MeshError(
                            f"rank {self.rank}: undecodable frame from "
                            f"peer {peer}: {exc!r}"
                        )
                    )
                    q.put(None)
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                q.put(decoded)
        except (OSError, EOFError, ConnectionError):
            q.put(None)  # peer gone

    # -- primitives -------------------------------------------------------
    def _send_payload(self, peer: int, payload: bytes) -> None:
        """Synchronous low-level frame write (length prefix + payload)
        under the peer's socket-write lock — the heartbeat thread and
        this peer's sender thread interleave on the lock, never
        mid-frame."""
        try:
            with self._send_locks[peer]:
                self._socks[peer].sendall(
                    _LEN.pack(len(payload)) + payload
                )
        except OSError as exc:
            # a send into a crashed peer (EPIPE/RST) is a detection event,
            # not an anonymous socket error
            raise MeshPeerFailure(
                f"rank {self.rank}: send to peer {peer} failed "
                f"({exc!r}) — peer crashed or unreachable"
            ) from exc

    def _send_loop(self, peer: int, q: "queue.Queue") -> None:
        """Per-peer sender thread: drains the bounded queue
        in FIFO order, so control and exchange frames to one peer can
        never reorder. Exchange work items encode + compress HERE —
        outside the engine loop and outside ``_send_locks`` — which is
        the send half of the overlap: the native executor keeps
        applying while frames drain. A failed send poisons the link
        once (recorded for synchronous re-raise, and the peer's recv
        queue is woken with the reason); the thread then keeps draining
        and discarding so producers never block behind a dead peer."""
        dead = False
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                if self._send_stop.is_set():
                    # close() may not have managed to queue a stop item
                    # (jammed queue): exit on our own so the emulated
                    # lane / test meshes never accumulate blocked
                    # sender threads
                    return
                continue
            kind = item[0]
            if kind == "stop":
                bye = item[1]
                if not dead and bye is not None:
                    # orderly goodbye, sequenced AFTER every queued frame
                    lock = self._send_locks.get(peer)
                    try:
                        if lock is None or lock.acquire(timeout=0.5):
                            try:
                                self._socks[peer].sendall(bye)
                            finally:
                                if lock is not None:
                                    lock.release()
                    except OSError:
                        pass
                return
            if dead:
                continue
            try:
                if kind == "payload":
                    self._send_payload(peer, item[1])
                else:  # "xframe": (_, tag, entries, enc_cache, route)
                    self._frame_send(
                        peer, item[1], item[2], item[3], item[4]
                    )
            except Exception as exc:
                # not only transport errors: an encode/compress failure
                # (unpicklable cell, codec error) must ALSO poison the
                # link — silently skipping a frame would desync the
                # peer's tag stream, and a silently dead sender thread
                # would turn the bounded queue into a misleading
                # "peer not draining" timeout
                dead = True
                msg = (
                    f"rank {self.rank}: sender thread for peer {peer} "
                    f"failed: {exc}"
                )
                self._send_errs[peer] = msg
                rq = self._queues.get(peer)
                if rq is not None:
                    # wake any recv blocked on this peer with the real
                    # reason — a dead send side is a dead link
                    rq.put(_MeshError(msg))
                    rq.put(None)

    def _dispatch(self, peer: int, item: tuple) -> None:
        """Route one send item to the peer's sender thread (bounded
        queue = backpressure, PATHWAY_MESH_OP_TIMEOUT_S caps the block)
        or execute it inline when sender threads are off
        (PATHWAY_MESH_SEND_QUEUE=0)."""
        q = self._sendqs.get(peer)
        if q is None:
            if item[0] == "payload":
                self._send_payload(peer, item[1])
            else:
                self._frame_send(
                    peer, item[1], item[2], item[3], item[4]
                )
            return
        err = self._send_errs.get(peer)
        if err is not None:
            raise MeshPeerFailure(err)
        if self._op_timeout > 0:
            try:
                q.put(item, timeout=self._op_timeout)
            except queue.Full:
                raise MeshTimeout(
                    f"rank {self.rank}: sender queue for peer {peer} "
                    "stayed full for PATHWAY_MESH_OP_TIMEOUT_S="
                    f"{self._op_timeout:g}s — peer not draining"
                ) from None
        else:
            q.put(item)

    def send(self, peer: int, tag: Any, obj: Any) -> None:
        _faults.fault_point("mesh.send")
        # serialize on the CALLER thread (snapshot semantics: callers
        # mutate lockstep state right after send() returns) and OUTSIDE
        # the per-peer lock; only the socket write is deferred
        payload = pickle.dumps((tag, obj), protocol=pickle.HIGHEST_PROTOCOL)
        self._dispatch(peer, ("payload", payload))

    # -- exchange v2: coalesced typed-columnar frames ----------------------
    # One frame carries EVERY exchange node's slice for one (timestamp,
    # wave): native slices ride as nb_encode columnar buffers (kind 0),
    # tuple-path/object-column slices as pickled segments (kind 1),
    # retraction-bearing scalar slices as the deltas codec (kind 2),
    # empty slices are elided entirely — the pickled header doubles as
    # the presence map. Each segment ships raw (codec id 0) or
    # compressed under the link's negotiated codec. Layout:
    #   b"PWX2" | u32 head_len | u32 crc32(head + wire blobs)
    #   | pickle((tag, [(node_id, kind, wire_size, codec_id)...]))
    #   | blob_0 | blob_1 ...
    # The CRC covers the WIRE image: corruption is rejected before any
    # unpickle OR decompression (CRC first, then codec errors).
    def make_enc_cache(self) -> WaveEncodeCache:
        """Encode/compress dedup for one wave: an object shipped to
        several peers (broadcast sides) encodes and compresses once.
        Thread-safe — the per-peer sender threads share it; the caller
        owns its lifetime (one wave), which keeps the id() keys valid."""
        return WaveEncodeCache()

    def send_exchange(
        self,
        peer: int,
        tag: Any,
        entries: list,
        enc_cache=None,
        route_dest: int | None = None,
    ) -> int:
        """entries: [(node_id, NativeBatch | delta-list), ...]; returns
        bytes shipped on the synchronous path, 0 when the frame was
        handed to the peer's sender thread (frame/byte accounting then
        lands on ``self.stats`` from that thread either way).
        ``route_dest`` names the frame's FINAL rank when it differs
        from ``peer`` (tree-gather relays): segments are then
        compressed only with a codec the destination advertised, since
        relays forward them verbatim."""
        _faults.fault_point("mesh.send")
        q = self._sendqs.get(peer)
        if q is None:
            return self._frame_send(
                peer, tag, entries, enc_cache, route_dest
            )
        self._dispatch(
            peer, ("xframe", tag, entries, enc_cache, route_dest)
        )
        return 0

    def _encode_obj(self, ex, obj) -> tuple[int, bytes]:
        """One exchange object -> (segment kind, raw typed blob)."""
        if ex is not None and is_native_batch(obj):
            return 0, ex.nb_encode(obj)
        # retraction-bearing slices: typed columnar delta codec when
        # every cell is scalar, pickle for object columns
        blob = (
            ex.deltas_encode(obj)
            if ex is not None and hasattr(ex, "deltas_encode")
            else None
        )
        if blob is not None:
            return 2, blob
        return 1, pickle.dumps(list(obj), protocol=pickle.HIGHEST_PROTOCOL)

    def _maybe_compress(self, codec: str | None, raw: bytes):
        """(codec_id, wire_blob) for one raw segment: raw when the link
        negotiated no codec, auto-mode is not engaged on this topology
        (starved loopback — see ``_auto_engage``), the blob is under
        the PATHWAY_MESH_COMPRESS_MIN_BYTES floor, the auto-mode
        entropy probe says incompressible, or the codec failed to
        shrink it."""
        if codec is None or len(raw) < max(1, self._compress_min):
            return 0, raw
        if self._codec_auto and not self._auto_engage:
            return 0, raw
        if self._codec_auto and self._entropy_skip(raw):
            return 0, raw
        wire = _compress_blob(codec, raw)
        if len(wire) >= len(raw):
            return 0, raw
        return CODEC_ID[codec], wire

    def _entropy_skip(self, raw: bytes) -> bool:
        """auto-mode probe: sampled byte entropy (exec.cpp wire_entropy,
        GIL-free) above the skip threshold means random/pre-compressed
        bytes — paying the codec would burn sender CPU for ratio ~1."""
        ex = self._pwexec()
        if ex is not None and hasattr(ex, "wire_entropy"):
            try:
                return ex.wire_entropy(raw) > _ENTROPY_SKIP_BITS
            except Exception:
                return False
        # portable fallback: fastest-level probe over a prefix
        sample = bytes(raw[:4096])
        return len(zlib.compress(sample, 1)) > 0.9 * len(sample)

    def _wire_form(self, ex, obj, codec, cache):
        """(kind, codec_id, wire_blob, raw_len) for one entry, through
        the wave's encode cache when one is attached."""
        if isinstance(obj, RawSegment):
            # tree relay: forward the wire bytes untouched (already
            # compressed or raw as the ORIGINAL sender decided; its
            # rank accounted the raw->wire reduction once)
            return obj.kind, obj.enc, obj.blob, len(obj.blob)
        if isinstance(cache, WaveEncodeCache):
            e = cache.entry(obj)
            with e.lock:
                if e.raw is None:
                    e.kind, e.raw = self._encode_obj(ex, obj)
                key = codec or ""
                got = e.wire.get(key)
                if got is None:
                    got = e.wire[key] = self._maybe_compress(codec, e.raw)
                return e.kind, got[0], got[1], len(e.raw)
        if isinstance(cache, dict):  # legacy single-threaded cache
            got = cache.get(id(obj))
            if got is None:
                got = cache[id(obj)] = self._encode_obj(ex, obj)
            kind, raw = got
        else:
            kind, raw = self._encode_obj(ex, obj)
        enc, wire = self._maybe_compress(codec, raw)
        return kind, enc, wire, len(raw)

    def _frame_send(
        self,
        peer: int,
        tag: Any,
        entries: list,
        enc_cache=None,
        route_dest: int | None = None,
    ) -> int:
        """Build one coalesced v2 frame (encode + compress) and ship it,
        with frame/byte/compression accounting and the recorder's send
        span — shared verbatim by the synchronous path and the sender
        threads, so metrics cannot depend on which path ran."""
        rec = self.recorder
        t0 = _time.perf_counter_ns() if rec is not None else 0
        ex = self._pwexec()
        if route_dest is None or route_dest == peer:
            codec = self._peer_codec.get(peer)
        else:
            # the frame's segments will be relayed verbatim to
            # route_dest: only a codec the DESTINATION advertised may
            # touch them (a mixed deployment must degrade per path,
            # never hit a decode error at the root)
            codec = negotiate_codec(
                self._codec_mask, self._peer_mask.get(route_dest, 0)
            )
        meta = []
        blobs = []
        raw_total = 0
        for nid, obj in entries:
            kind, enc, wire, raw_len = self._wire_form(
                ex, obj, codec, enc_cache
            )
            meta.append((nid, kind, len(wire), enc))
            blobs.append(wire)
            raw_total += raw_len
        head = pickle.dumps((tag, meta), protocol=pickle.HIGHEST_PROTOCOL)
        crc = zlib.crc32(head)
        for blob in blobs:
            crc = zlib.crc32(blob, crc)
        payload = b"".join(
            [_V2_MAGIC, _V2_HEAD.pack(len(head), crc), head, *blobs]
        )
        self._send_payload(peer, payload)
        self._frame_bytes_ewma += 0.2 * (
            len(payload) - self._frame_bytes_ewma
        )
        stats = self.stats
        if stats is not None:
            stats.on_exchange_frame(len(payload), peer)
            # "uncompressed" = the frame's wire size had every segment
            # shipped raw — same framing overhead, so ratio 1.0 means
            # honestly off/ineffective, never framing noise
            stats.on_exchange_compression(
                peer,
                raw_total + len(payload) - sum(len(b) for b in blobs),
                len(payload),
            )
        if rec is not None:
            rec.note_send(peer, t0, _time.perf_counter_ns(), len(payload))
        return len(payload)

    def _decode_exchange(self, payload: bytes, intern=None):
        """((tag, [(node_id, part), ...]), dz) from a v2 frame; parts
        arrive as NativeBatch (columnar) or delta lists (pickled
        fallback); ``dz`` is ``(t0_ns, dur_ns, wire_bytes, raw_bytes)``
        decompression accounting (None when every segment shipped raw).
        The frame CRC is verified before ANY byte is unpickled OR
        inflated: corruption becomes a clean link error here (the
        receiver thread wraps this in _MeshError), never a silently
        mis-routed slice — and codec errors can only mean a buggy
        sender, not wire damage."""
        hlen, crc = _V2_HEAD.unpack_from(payload, 4)
        off = 4 + _V2_HEAD.size
        if zlib.crc32(payload[off:]) != crc:
            raise ValueError(
                "exchange frame checksum mismatch — frame corrupt"
            )
        if hlen > len(payload) - off:
            raise ValueError("exchange frame header overruns the frame")
        tag, meta = pickle.loads(payload[off:off + hlen])
        off += hlen
        ex = self._pwexec()
        items = []
        view = memoryview(payload)
        dz_t0 = dz_ns = dz_wire = dz_raw = 0
        # relay legs of a gather tree (tag ("xwr", ...)): this rank
        # forwards these segments to its tree parent verbatim — keep
        # them as wire bytes (no decompress, no typed decode); they
        # inflate exactly once, at rank 0
        relay_leg = (
            isinstance(tag, tuple) and bool(tag) and tag[0] == "xwr"
        )
        for entry in meta:
            if len(entry) == 4:
                nid, kind, size, enc = entry
            else:  # pre-compression 3-tuple segment table (always raw)
                nid, kind, size = entry
                enc = 0
            if size < 0 or off + size > len(payload):
                # the crc already rules out corruption; this guards a
                # buggy sender whose (validly-checksummed) size table
                # overruns the frame — fail loud, never mis-slice
                raise ValueError(
                    "exchange frame segment table overruns the frame"
                )
            blob = view[off:off + size]
            off += size
            if relay_leg:
                items.append((nid, RawSegment(kind, enc, bytes(blob))))
                continue
            if enc:
                dt0 = _time.perf_counter_ns()
                blob = _decompress_blob(enc, blob, self._max_frame)
                dt1 = _time.perf_counter_ns()
                if not dz_t0:
                    dz_t0 = dt0
                dz_ns += dt1 - dt0
                dz_wire += size
                dz_raw += len(blob)
            if kind == 0 or kind == 2:
                if ex is None:  # no toolchain on this rank: cannot happen
                    raise ConnectionError(
                        f"rank {self.rank}: received a columnar exchange "
                        "frame but the native executor is unavailable"
                    )
                items.append(
                    (
                        nid,
                        ex.nb_decode(blob, Pointer)
                        if kind == 0
                        else ex.deltas_decode(blob, Pointer, intern),
                    )
                )
            else:
                items.append((nid, pickle.loads(blob)))
        dz = (dz_t0, dz_ns, dz_wire, dz_raw) if dz_ns else None
        return (tag, items), dz

    @staticmethod
    def _pwexec():
        from pathway_tpu_torch.native import get_pwexec

        try:
            return get_pwexec()
        except Exception:
            return None

    def _transport_alive(self, peer: int) -> bool:
        """Busy-rank heartbeat fix: a peer whose
        Python threads are starved — a long GIL-held native dispatch, a
        fused device call, a multi-second pickle — sends neither frames
        nor PWHB beats, but its KERNEL still ACKs ours. Probe TCP_INFO:
        connection ESTABLISHED and an ACK received within the liveness
        window means the process exists and the host is reachable, so
        the app-level silence is busyness, not death. A crashed process
        FINs/RSTs (the receiver thread sees EOF → MeshPeerFailure via
        the disconnect path, no timer involved) and a dead host stops
        ACKing, so both real failure classes still fail fast. Non-Linux
        or probe failure returns False — the historical verdict."""
        s = self._socks.get(peer)
        if s is None:
            return False
        try:
            info = s.getsockopt(
                socket.IPPROTO_TCP, socket.TCP_INFO, 104
            )
        except (OSError, AttributeError):
            return False
        if len(info) <= _TCP_INFO_LAST_ACK_OFF + 4 or info[0] != _TCP_ESTABLISHED:
            return False
        last_ack_ms = int.from_bytes(
            info[_TCP_INFO_LAST_ACK_OFF:_TCP_INFO_LAST_ACK_OFF + 4],
            "little",
        )
        # the ACK clock only advances while WE send (heartbeats, every
        # interval) — recent ACKs therefore prove the round trip
        return last_ack_ms <= self._peer_timeout * 1000.0

    def op_deadline(self) -> float | None:
        """One PATHWAY_MESH_OP_TIMEOUT_S deadline, minted at the START of
        a multi-peer collective and passed to each of its recvs — so the
        whole collective observes a single hard deadline instead of
        re-arming per peer (world-1 × timeout for the last one)."""
        return (
            _time.monotonic() + self._op_timeout
            if self._op_timeout > 0
            else None
        )

    _NO_DEADLINE = object()  # sentinel: "mint a per-call deadline"

    def recv(self, peer: int, tag: Any, deadline=_NO_DEADLINE) -> Any:
        _faults.fault_point("mesh.recv")
        q = self._queues[peer]
        op_timeout = self._op_timeout
        if deadline is ProcessGroup._NO_DEADLINE:
            deadline = self.op_deadline()
        # liveness checks only make sense when the peer is expected to
        # beat: an unsupervised pair with heartbeats disabled keeps the
        # historical blocking get
        check_liveness = self._hb_interval > 0 and self._peer_timeout > 0
        if deadline is None and not check_liveness:
            got = q.get()
        else:
            while True:
                try:
                    got = q.get(timeout=0.2)
                    break
                except queue.Empty:
                    now = _time.monotonic()
                    if check_liveness:
                        idle = now - self._last_seen.get(peer, now)
                        # the liveness verdict is a protocol decision —
                        # the checker's detection model uses the same
                        # one. The transport probe (only consulted past
                        # the idle window, so no syscall on the hot
                        # path) keeps healthy-but-busy ranks alive: a
                        # GIL-starved peer can't beat, but its kernel
                        # still ACKs our heartbeats.
                        if _proto.peer_liveness(
                            idle, self._peer_timeout,
                            peer in self._goodbye,
                            transport_alive=(
                                idle > self._peer_timeout
                                and self._transport_alive(peer)
                            ),
                        ) == "failed":
                            if self.stats is not None:
                                self.stats.on_mesh_heartbeat_missed()
                            if self.recorder is not None:
                                self.recorder.note_mark(
                                    "peer_failed", peer=peer
                                )
                            raise MeshPeerFailure(
                                f"rank {self.rank}: peer {peer} sent no "
                                f"frame or heartbeat for {idle:.1f}s "
                                "(PATHWAY_MESH_PEER_TIMEOUT_S="
                                f"{self._peer_timeout:g}) while this rank "
                                f"waited for {tag!r} — presumed crashed"
                            )
                    if deadline is not None and now > deadline:
                        raise MeshTimeout(
                            f"rank {self.rank}: collective timed out "
                            "after PATHWAY_MESH_OP_TIMEOUT_S="
                            f"{op_timeout:g}s waiting for peer {peer}, "
                            f"pending tag {tag!r}"
                        )
        if got is None:
            # goodbye-vs-crash classification: a shared-table decision
            if _proto.classify_peer_loss(peer in self._goodbye) == "gone":
                raise MeshPeerGone(
                    f"rank {self.rank}: peer {peer} shut down cleanly "
                    f"(orderly goodbye) while {tag!r} was still pending"
                )
            raise MeshPeerFailure(
                f"rank {self.rank}: peer {peer} disconnected without a "
                f"goodbye — presumed crashed (waiting for {tag!r})"
            )
        if isinstance(got, _MeshError):
            # link-level verdict (oversized/corrupt/undecodable frame):
            # the peer is unusable — same recovery class as a crash
            raise MeshPeerFailure(got.message)
        got_tag, obj = got
        if got_tag != tag:
            raise RuntimeError(
                f"rank {self.rank}: protocol desync with peer {peer}: "
                f"expected {tag!r}, got {got_tag!r}"
            )
        return obj

    # -- collectives ------------------------------------------------------
    def gather0(self, tag: Any, obj: Any) -> list[Any] | None:
        """Rank 0 returns [obj_rank0, ..., obj_rankN-1]; others None."""
        if self.rank == 0:
            out = [obj]
            dl = self.op_deadline()  # one deadline for the whole gather
            for peer in range(1, self.world):
                out.append(self.recv(peer, tag, deadline=dl))
            return out
        self.send(0, tag, obj)
        return None

    def bcast0(self, tag: Any, obj: Any = None) -> Any:
        if self.rank == 0:
            for peer in range(1, self.world):
                self.send(peer, tag, obj)
            return obj
        return self.recv(0, tag)

    def all_to_all(self, tag: Any, per_rank: list[list]) -> list:
        """Send per_rank[j] to rank j; return own slot + everything
        received. Sends first (receiver threads always drain, so blocking
        sends cannot deadlock), then collects from every peer."""
        for peer in range(self.world):
            if peer != self.rank:
                self.send(peer, tag, per_rank[peer])
        merged = list(per_rank[self.rank])
        dl = self.op_deadline()  # one deadline across all peers
        for peer in range(self.world):
            if peer != self.rank:
                merged.extend(self.recv(peer, tag, deadline=dl))
        return merged

    def barrier(self, tag: Any) -> None:
        self.gather0(("b", tag), None)
        self.bcast0(("b2", tag), None)

    def drain(self) -> int:
        """Discard everything queued from every peer — the epoch-abort
        path calls this so in-flight frames of a dead epoch are dropped
        (never delivered to the engine) before the mesh closes. Returns
        the number of discarded frames."""
        n = 0
        for q in self._queues.values():
            while True:
                try:
                    if q.get_nowait() is not None:
                        n += 1
                except queue.Empty:
                    break
        return n

    def queued_exchange_bytes(self) -> tuple[int, int]:
        """(send_bytes, recv_bytes) estimates for the memory accountant
        (internals/memory.py): queued items x the EWMA wire-
        frame size. Send items sit un-encoded in the per-peer sender
        queues (exact bytes would cost an encode ahead of the sender
        thread) and recv items are already-decoded frames, so both sides
        use the same estimate — the watermark ladder needs a drainable
        signal, not a bill."""
        avg = self._frame_bytes_ewma
        send_items = sum(q.qsize() for q in self._sendqs.values())
        recv_items = sum(q.qsize() for q in self._queues.values())
        return int(send_items * avg), int(recv_items * avg)

    def close(self, goodbye: bool = True) -> None:
        """``goodbye=False`` is the failure-path close (runtime epoch
        abort): the links just drop, so peers classify the loss as a
        crash (MeshPeerFailure) — announcing an orderly shutdown from a
        rank that is dying of an exception would point the investigation
        away from the real failure."""
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        bye = (
            _LEN.pack(len(_BYE_MAGIC)) + _BYE_MAGIC if goodbye else None
        )
        # stop sender threads first: the stop item rides the SAME queue
        # as queued frames, so an orderly goodbye is sequenced after
        # every frame already enqueued (a bye overtaking queued data
        # would make peers classify a healthy link as prematurely gone)
        stopped: set[int] = set()
        for peer, sq in self._sendqs.items():
            try:
                sq.put(("stop", bye), timeout=0.5 if goodbye else 0.0)
                stopped.add(peer)
            except queue.Full:
                pass  # jammed link: socket shutdown below unblocks it
        self._send_stop.set()
        if goodbye:
            for t in self._send_threads:
                t.join(1.0)
            # orderly goodbye for sync-mode peers (and any whose jammed
            # sender queue never took the stop item): peers that still
            # wait on us can then report MeshPeerGone instead of a crash
            for peer, s in self._socks.items():
                if peer in stopped:
                    continue
                lock = self._send_locks.get(peer)
                try:
                    if lock is None:
                        s.sendall(bye)
                    elif lock.acquire(timeout=0.5):
                        try:
                            s.sendall(bye)
                        finally:
                            lock.release()
                except OSError:
                    pass  # peer already gone
        for s in self._socks.values():
            # shutdown BEFORE close: a concurrent recv() in a receiver
            # thread does not reliably wake on close() alone
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        # unblock any recv() waiting on a per-peer queue
        for q in self._queues.values():
            q.put(None)
        try:
            self._listener.close()
        except OSError:
            pass


def _recv_exact(s: socket.socket, n: int, on_bytes=None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise EOFError
        if on_bytes is not None:
            on_bytes()
        buf.extend(chunk)
    return bytes(buf)
