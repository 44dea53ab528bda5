"""Binary wire format for CDMT delivery (varint-framed).

Everything that crosses the client↔registry↔peer boundary is one of five
frame types, each ``MAGIC | version | type | uvarint(len) | payload``:

  ``INDEX``        a whole CDMT.  The encoding ships only the *leaf*
                   fingerprints plus per-level fanout runs — internal node ids
                   are blake2b over child ids, so the decoder *recomputes*
                   them.  This keeps the index at ~``n_leaves × digest`` bytes
                   (the paper's "KB-sized index") and makes the frame
                   self-verifying: a corrupted byte changes the recomputed
                   root.
  ``RECIPE``       ordered (fp, size) list reconstructing one artifact.
  ``CHUNK_BATCH``  fp-prefixed chunk payloads; the decoder checks each
                   payload's blake2b against its fp (authenticated transfer).
  ``WANT``         a fingerprint request list (pull / peer fetch).
  ``PUSH_HDR``     push envelope: lineage, tag, claimed root, parent version.
  ``HAS``          presence query: which of these fps does the server hold?
  ``MISSING``      the reply — fps the server does NOT hold (a push then
                   ships exactly these, enabling cross-lineage dedup).
  ``TAGS``         tag-listing query for one lineage (control plane — tag
                   names are protocol data, not an attribute reach).
  ``TAG_LIST``     the reply: the lineage's tag names in version order.
  ``ERROR``        protocol-level failure: an error code plus message, so a
                   remote server's rejection crosses the wire as data and is
                   re-raised client-side as the matching exception.
  ``RECEIPT``      a serialized :class:`~repro_torch.core.registry.PushReceipt` —
                   what a socket push gets back instead of a Python object.
  ``INFO``         server parameters a client needs to quote costs exactly
                   (today: the server's response batch split).
  ``SHIP``         a standby's journal-ship request: replica name, epoch,
                   resume offset, record budget (0 = pure status probe).
  ``RECORD``       one checksummed journal record in transit — the payload
                   is the *encoded* record (``wire.encode_record`` bytes),
                   so a standby re-verifies the checksum before replay.
  ``REPL_ACK``     replication position: replica name, epoch, offset.  Sent
                   by a standby to report applied progress, and returned by
                   the primary (as a ship-response header and as the ack
                   reply) to publish its current epoch and log head.
  ``METRICS``      a live metrics scrape: one UTF-8 JSON document in the
                   ``repro_torch.obs.MetricsSnapshot`` shape, so any client can
                   read a server's counters/gauges/histograms over the
                   same socket that moves chunks.
  ``SNAPSHOT``     a snapshot-bootstrap position: replica name, epoch,
                   resume offset.  Sent by a fresh standby to request a
                   compacted state snapshot, and returned by the primary as
                   the stream header announcing the epoch and the offset
                   ordinary ``JOURNAL_SHIP`` resumes from; the snapshot's
                   state records follow as ``RECORD`` frames.

All decoders raise :class:`WireError` on truncation, bad magic, trailing
garbage, or fingerprint mismatch — never a bare ``IndexError``/``KeyError``.

For real sockets, frames travel inside length-prefixed **envelopes** (see
``encode_request`` / ``encode_response_header``): a request names an
:class:`Op` plus lineage/tag routing strings and carries zero or more body
frames; a response is a status byte plus a frame count, then the frames —
which lets a server *stream* a multi-frame WANT answer while the client
decodes batches as they arrive.  Envelope overhead is exactly computable
(``request_envelope_bytes`` / ``response_envelope_bytes``), so a pull plan
can quote socket bytes to the byte before opening a connection.

The async data plane multiplexes many streams over one connection using
the **mux envelopes** (``encode_mux_request`` / ``encode_mux_response_*``):
the same frames, routed by a fixed-width stream id, with equally exact
sizing (``mux_request_envelope_bytes`` / ``mux_response_envelope_bytes``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import hashing
from repro_torch.core.cdmt import CDMT, CDMTNode, CDMTParams
from repro_torch.core.store import Recipe

MAGIC = b"CW"
VERSION = 1
_HEADER = len(MAGIC) + 2  # magic + version byte + type byte


class WireError(ValueError):
    """Malformed, truncated, or tampered wire data."""


class FrameType(enum.IntEnum):
    INDEX = 1
    RECIPE = 2
    CHUNK_BATCH = 3
    WANT = 4
    PUSH_HDR = 5
    HAS = 6
    MISSING = 7
    TAGS = 8
    TAG_LIST = 9
    ERROR = 10
    RECEIPT = 11
    INFO = 12
    SHIP = 13
    RECORD = 14
    REPL_ACK = 15
    METRICS = 16
    SNAPSHOT = 17


class Op(enum.IntEnum):
    """Request operations a delivery endpoint answers (socket envelope)."""
    INDEX = 1          # -> INDEX frame
    LATEST_INDEX = 2   # -> INDEX frame, or zero frames for a new lineage
    RECIPE = 3         # -> RECIPE frame
    WANT = 4           # WANT frame -> streamed CHUNK_BATCH frames
    HAS = 5            # HAS frame -> MISSING frame
    PUSH = 6           # PUSH_HDR + RECIPE + CHUNK_BATCH* -> RECEIPT frame
    TAGS = 7           # TAGS frame -> TAG_LIST frame
    INFO = 8           # -> INFO frame
    JOURNAL_SHIP = 9   # SHIP frame -> REPL_ACK frame + RECORD frames
    REPL_ACK = 10      # REPL_ACK frame -> REPL_ACK frame (primary's head)
    METRICS = 11       # -> METRICS frame (JSON metrics snapshot)
    SNAPSHOT_SHIP = 12  # SNAPSHOT frame -> SNAPSHOT frame + RECORD frames
                        # (streamed compacted state; standby bootstrap)


class ErrorCode(enum.IntEnum):
    """What kind of exception an ERROR frame re-raises client-side."""
    DELIVERY = 1       # repro_torch.core.errors.DeliveryError
    PUSH_REJECTED = 2  # repro_torch.core.registry.PushRejected
    WIRE = 3           # WireError (malformed request reached the server)
    INTERNAL = 4       # anything else — surfaced as DeliveryError
    BUSY = 5           # admission control shed the request (retryable;
                       # surfaced as DeliveryError)


# ----------------------------------------------------------------- varints

def encode_uvarint(n: int) -> bytes:
    """LEB128 unsigned varint."""
    if n < 0:
        raise WireError(f"uvarint cannot encode negative value {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: bytes, off: int = 0) -> Tuple[int, int]:
    """Returns ``(value, new_offset)``; raises :class:`WireError` on
    truncation or a varint longer than 10 bytes (overflow guard)."""
    result = 0
    shift = 0
    for i in range(10):
        if off + i >= len(buf):
            raise WireError("truncated uvarint")
        b = buf[off + i]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off + i + 1
        shift += 7
    raise WireError("uvarint too long (>10 bytes)")


def _take(buf: bytes, off: int, n: int, what: str) -> Tuple[bytes, int]:
    if off + n > len(buf):
        raise WireError(f"truncated {what}: need {n} bytes at offset {off}, "
                        f"have {len(buf) - off}")
    return buf[off:off + n], off + n


# ------------------------------------------------------------------ frames

def encode_frame(ftype: FrameType, payload: bytes) -> bytes:
    return (MAGIC + bytes((VERSION, int(ftype)))
            + encode_uvarint(len(payload)) + payload)


def decode_frame(buf: bytes, off: int = 0,
                 expect: Optional[FrameType] = None
                 ) -> Tuple[FrameType, bytes, int]:
    """Decode one frame at ``off``; returns ``(type, payload, new_offset)``."""
    hdr, off = _take(buf, off, _HEADER, "frame header")
    if hdr[:2] != MAGIC:
        raise WireError(f"bad magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported wire version {hdr[2]}")
    try:
        ftype = FrameType(hdr[3])
    except ValueError:
        raise WireError(f"unknown frame type {hdr[3]}") from None
    size, off = decode_uvarint(buf, off)
    payload, off = _take(buf, off, size, f"{ftype.name} payload")
    if expect is not None and ftype is not expect:
        raise WireError(f"expected {expect.name} frame, got {ftype.name}")
    return ftype, payload, off


def _decode_single(buf: bytes, expect: FrameType) -> bytes:
    ftype, payload, off = decode_frame(buf, 0, expect=expect)
    if off != len(buf):
        raise WireError(f"{len(buf) - off} trailing bytes after "
                        f"{expect.name} frame")
    return payload


# ------------------------------------------------------------------- INDEX

def encode_index(t: CDMT) -> bytes:
    """Serialize a CDMT: params, leaf fps, then per-level fanout runs.

    Internal-node fingerprints are NOT shipped — they are a pure function of
    the leaves and the cut structure, so the decoder recomputes (and thereby
    verifies) them.
    """
    p = t.params
    out = bytearray()
    out += encode_uvarint(p.window)
    out += encode_uvarint(p.rule_bits)
    out += encode_uvarint(p.max_fanout)
    out += encode_uvarint(hashing.DIGEST_SIZE)
    out += encode_uvarint(len(t.levels))
    if t.levels:
        leaves = t.levels[0]
        out += encode_uvarint(len(leaves))
        for fp in leaves:
            out += fp
        for lvl_i in range(1, len(t.levels)):
            lvl = t.levels[lvl_i]
            out += encode_uvarint(len(lvl))
            for pfp in lvl:
                out += encode_uvarint(len(t.nodes[pfp].children))
    return encode_frame(FrameType.INDEX, bytes(out))


def decode_index(buf: bytes) -> CDMT:
    """Rebuild a CDMT from an INDEX frame, recomputing internal node ids."""
    payload = _decode_single(buf, FrameType.INDEX)
    off = 0
    window, off = decode_uvarint(payload, off)
    rule_bits, off = decode_uvarint(payload, off)
    max_fanout, off = decode_uvarint(payload, off)
    digest, off = decode_uvarint(payload, off)
    if digest != hashing.DIGEST_SIZE:
        raise WireError(f"digest size {digest} != {hashing.DIGEST_SIZE}")
    if window < 1 or max_fanout < 1:
        raise WireError("invalid CDMT params on wire")
    n_levels, off = decode_uvarint(payload, off)
    t = CDMT(params=CDMTParams(window=window, rule_bits=rule_bits,
                               max_fanout=max_fanout))
    if n_levels == 0:
        if off != len(payload):
            raise WireError("trailing bytes in empty INDEX payload")
        return t

    n_leaves, off = decode_uvarint(payload, off)
    level: List[bytes] = []
    for _ in range(n_leaves):
        fp, off = _take(payload, off, digest, "leaf fp")
        level.append(fp)
        if fp not in t.nodes:
            t.nodes[fp] = CDMTNode(fp=fp, children=(), is_leaf=True,
                                   n_leaves=1)
    t.levels.append(list(level))

    for _ in range(n_levels - 1):
        n_parents, off = decode_uvarint(payload, off)
        if n_parents == 0:
            raise WireError("empty CDMT level on wire")
        nxt: List[bytes] = []
        pos = 0
        for _ in range(n_parents):
            fanout, off = decode_uvarint(payload, off)
            if fanout == 0 or pos + fanout > len(level):
                raise WireError("level fanouts do not partition child level")
            kids = tuple(level[pos:pos + fanout])
            pos += fanout
            fp = hashing.node_fingerprint(kids)
            if fp not in t.nodes:
                t.nodes[fp] = CDMTNode(
                    fp=fp, children=kids, is_leaf=False,
                    n_leaves=sum(t.nodes[c].n_leaves for c in kids))
            nxt.append(fp)
        if pos != len(level):
            raise WireError("level fanouts do not cover child level")
        t.levels.append(list(nxt))
        level = nxt
    if len(level) != 1:
        raise WireError(f"top level has {len(level)} roots, expected 1")
    if off != len(payload):
        raise WireError("trailing bytes in INDEX payload")
    t.root = level[0]
    return t


# ------------------------------------------------------------------ RECIPE

def encode_recipe(r: Recipe) -> bytes:
    name = r.name.encode("utf-8")
    out = bytearray()
    out += encode_uvarint(len(name))
    out += name
    out += encode_uvarint(len(r.fps))
    for fp in r.fps:
        out += fp
    for size in r.sizes:
        out += encode_uvarint(size)
    return encode_frame(FrameType.RECIPE, bytes(out))


def decode_recipe(buf: bytes) -> Recipe:
    payload = _decode_single(buf, FrameType.RECIPE)
    off = 0
    name_len, off = decode_uvarint(payload, off)
    name_b, off = _take(payload, off, name_len, "recipe name")
    n, off = decode_uvarint(payload, off)
    fps: List[bytes] = []
    for _ in range(n):
        fp, off = _take(payload, off, hashing.DIGEST_SIZE, "recipe fp")
        fps.append(fp)
    sizes: List[int] = []
    for _ in range(n):
        s, off = decode_uvarint(payload, off)
        sizes.append(s)
    if off != len(payload):
        raise WireError("trailing bytes in RECIPE payload")
    return Recipe(name=name_b.decode("utf-8"), fps=fps, sizes=sizes)


# ------------------------------------------------------------- CHUNK_BATCH

def encode_chunk_batch(chunks: Mapping[bytes, bytes]) -> bytes:
    """Batch chunk payloads: ``n | (fp | uvarint(len) | data)*``."""
    out = bytearray()
    out += encode_uvarint(len(chunks))
    for fp, data in chunks.items():
        if len(fp) != hashing.DIGEST_SIZE:
            raise WireError(f"bad fingerprint length {len(fp)}")
        out += fp
        out += encode_uvarint(len(data))
        out += data
    return encode_frame(FrameType.CHUNK_BATCH, bytes(out))


def decode_chunk_batch(buf: bytes, verify: bool = True) -> Dict[bytes, bytes]:
    """Decode a batch; with ``verify`` each payload's blake2b must equal its
    wire fp (the transfer is authenticated end-to-end)."""
    payload = _decode_single(buf, FrameType.CHUNK_BATCH)
    off = 0
    n, off = decode_uvarint(payload, off)
    out: Dict[bytes, bytes] = {}
    for _ in range(n):
        fp, off = _take(payload, off, hashing.DIGEST_SIZE, "chunk fp")
        size, off = decode_uvarint(payload, off)
        data, off = _take(payload, off, size, "chunk data")
        if verify and hashing.chunk_fingerprint(data) != fp:
            raise WireError(f"chunk {fp.hex()[:12]} payload hash mismatch")
        out[fp] = data
    if off != len(payload):
        raise WireError("trailing bytes in CHUNK_BATCH payload")
    return out


# ------------------------------------------------- WANT / HAS / MISSING
#
# All three are fingerprint-list frames; they differ only in frame type
# (WANT requests payloads, HAS queries presence, MISSING is HAS's reply).

def _encode_fp_list(ftype: FrameType, fps: Sequence[bytes]) -> bytes:
    out = bytearray()
    out += encode_uvarint(len(fps))
    for fp in fps:
        if len(fp) != hashing.DIGEST_SIZE:
            raise WireError(f"bad fingerprint length {len(fp)}")
        out += fp
    return encode_frame(ftype, bytes(out))


def _decode_fp_list(buf: bytes, ftype: FrameType) -> List[bytes]:
    payload = _decode_single(buf, ftype)
    off = 0
    n, off = decode_uvarint(payload, off)
    fps: List[bytes] = []
    for _ in range(n):
        fp, off = _take(payload, off, hashing.DIGEST_SIZE,
                        f"{ftype.name.lower()} fp")
        fps.append(fp)
    if off != len(payload):
        raise WireError(f"trailing bytes in {ftype.name} payload")
    return fps


def encode_want(fps: Sequence[bytes]) -> bytes:
    return _encode_fp_list(FrameType.WANT, fps)


def decode_want(buf: bytes) -> List[bytes]:
    return _decode_fp_list(buf, FrameType.WANT)


def encode_has(fps: Sequence[bytes]) -> bytes:
    return _encode_fp_list(FrameType.HAS, fps)


def decode_has(buf: bytes) -> List[bytes]:
    return _decode_fp_list(buf, FrameType.HAS)


def encode_missing(fps: Sequence[bytes]) -> bytes:
    return _encode_fp_list(FrameType.MISSING, fps)


def decode_missing(buf: bytes) -> List[bytes]:
    return _decode_fp_list(buf, FrameType.MISSING)


# ---------------------------------------------------------------- PUSH_HDR

@dataclasses.dataclass
class PushHeader:
    lineage: str
    tag: str
    root: Optional[bytes]           # client-claimed CDMT root (None: empty
    parent_version: Optional[int]   # artifact — its CDMT has no root)
    params: Optional[CDMTParams] = None   # tree params the root was built
                                          # with (travel with the claim)


def encode_push_header(h: PushHeader) -> bytes:
    lin = h.lineage.encode("utf-8")
    tag = h.tag.encode("utf-8")
    out = bytearray()
    out += encode_uvarint(len(lin))
    out += lin
    out += encode_uvarint(len(tag))
    out += tag
    if h.root is None:
        out += encode_uvarint(0)
    else:
        if len(h.root) != hashing.DIGEST_SIZE:
            raise WireError(f"bad claimed-root length {len(h.root)}")
        out += encode_uvarint(1)
        out += h.root
        p = h.params if h.params is not None else CDMTParams()
        out += encode_uvarint(p.window)
        out += encode_uvarint(p.rule_bits)
        out += encode_uvarint(p.max_fanout)
    if h.parent_version is None:
        out += encode_uvarint(0)
    else:
        out += encode_uvarint(1)
        out += encode_uvarint(h.parent_version)
    return encode_frame(FrameType.PUSH_HDR, bytes(out))


def decode_push_header(buf: bytes) -> PushHeader:
    payload = _decode_single(buf, FrameType.PUSH_HDR)
    off = 0
    lin_len, off = decode_uvarint(payload, off)
    lin, off = _take(payload, off, lin_len, "push lineage")
    tag_len, off = decode_uvarint(payload, off)
    tag, off = _take(payload, off, tag_len, "push tag")
    has_root, off = decode_uvarint(payload, off)
    root: Optional[bytes] = None
    params: Optional[CDMTParams] = None
    if has_root:
        root, off = _take(payload, off, hashing.DIGEST_SIZE, "push root")
        window, off = decode_uvarint(payload, off)
        rule_bits, off = decode_uvarint(payload, off)
        max_fanout, off = decode_uvarint(payload, off)
        if window < 1 or max_fanout < 1:
            raise WireError("invalid CDMT params in PUSH_HDR")
        params = CDMTParams(window=window, rule_bits=rule_bits,
                            max_fanout=max_fanout)
    has_parent, off = decode_uvarint(payload, off)
    parent: Optional[int] = None
    if has_parent:
        parent, off = decode_uvarint(payload, off)
    if off != len(payload):
        raise WireError("trailing bytes in PUSH_HDR payload")
    return PushHeader(lineage=lin.decode("utf-8"), tag=tag.decode("utf-8"),
                      root=root, parent_version=parent, params=params)


# ------------------------------------------------------- TAGS / TAG_LIST

def _encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return encode_uvarint(len(b)) + b


def _decode_str(payload: bytes, off: int, what: str) -> Tuple[str, int]:
    n, off = decode_uvarint(payload, off)
    raw, off = _take(payload, off, n, what)
    return raw.decode("utf-8"), off


def encode_tags_request(lineage: str) -> bytes:
    return encode_frame(FrameType.TAGS, _encode_str(lineage))


def decode_tags_request(buf: bytes) -> str:
    payload = _decode_single(buf, FrameType.TAGS)
    lineage, off = _decode_str(payload, 0, "tags lineage")
    if off != len(payload):
        raise WireError("trailing bytes in TAGS payload")
    return lineage


def encode_tag_list(tags: Sequence[str]) -> bytes:
    out = bytearray()
    out += encode_uvarint(len(tags))
    for t in tags:
        out += _encode_str(t)
    return encode_frame(FrameType.TAG_LIST, bytes(out))


def decode_tag_list(buf: bytes) -> List[str]:
    payload = _decode_single(buf, FrameType.TAG_LIST)
    off = 0
    n, off = decode_uvarint(payload, off)
    tags: List[str] = []
    for _ in range(n):
        t, off = _decode_str(payload, off, "tag name")
        tags.append(t)
    if off != len(payload):
        raise WireError("trailing bytes in TAG_LIST payload")
    return tags


# ------------------------------------------------------------------- ERROR

def encode_error(code: ErrorCode, message: str) -> bytes:
    return encode_frame(FrameType.ERROR,
                        encode_uvarint(int(code)) + _encode_str(message))


def decode_error(buf: bytes) -> Tuple[ErrorCode, str]:
    payload = _decode_single(buf, FrameType.ERROR)
    raw_code, off = decode_uvarint(payload, 0)
    try:
        code = ErrorCode(raw_code)
    except ValueError:
        code = ErrorCode.INTERNAL      # future codes degrade gracefully
    message, off = _decode_str(payload, off, "error message")
    if off != len(payload):
        raise WireError("trailing bytes in ERROR payload")
    return code, message


# ----------------------------------------------------------------- RECEIPT

def encode_receipt(r: "PushReceipt") -> bytes:
    out = bytearray()
    out += _encode_str(r.lineage)
    out += _encode_str(r.tag)
    out += encode_uvarint(r.version)
    out += encode_uvarint(r.chunks_received)
    out += encode_uvarint(r.bytes_received)
    out += encode_uvarint(r.index_bytes)
    if r.root is None:                 # empty artifact: its CDMT has no root
        out += encode_uvarint(0)
    else:
        if len(r.root) != hashing.DIGEST_SIZE:
            raise WireError(f"bad receipt root length {len(r.root)}")
        out += encode_uvarint(1)
        out += r.root
    out += encode_uvarint(r.nodes_created)
    out += encode_uvarint(r.nodes_hashed)
    out += encode_uvarint(r.hash_calls)
    out += encode_uvarint(1 if r.deduplicated else 0)
    return encode_frame(FrameType.RECEIPT, bytes(out))


def decode_receipt(buf: bytes) -> "PushReceipt":
    from repro_torch.core.registry import PushReceipt
    payload = _decode_single(buf, FrameType.RECEIPT)
    off = 0
    lineage, off = _decode_str(payload, off, "receipt lineage")
    tag, off = _decode_str(payload, off, "receipt tag")
    version, off = decode_uvarint(payload, off)
    chunks_received, off = decode_uvarint(payload, off)
    bytes_received, off = decode_uvarint(payload, off)
    index_bytes, off = decode_uvarint(payload, off)
    has_root, off = decode_uvarint(payload, off)
    root = None
    if has_root:
        root, off = _take(payload, off, hashing.DIGEST_SIZE, "receipt root")
    nodes_created, off = decode_uvarint(payload, off)
    nodes_hashed, off = decode_uvarint(payload, off)
    hash_calls, off = decode_uvarint(payload, off)
    dedup, off = decode_uvarint(payload, off)
    if off != len(payload):
        raise WireError("trailing bytes in RECEIPT payload")
    return PushReceipt(lineage=lineage, tag=tag, version=version,
                       chunks_received=chunks_received,
                       bytes_received=bytes_received,
                       index_bytes=index_bytes, root=root,
                       nodes_created=nodes_created,
                       nodes_hashed=nodes_hashed, hash_calls=hash_calls,
                       deduplicated=bool(dedup))


# -------------------------------------------------------------------- INFO

def encode_info(response_batch_chunks: int) -> bytes:
    return encode_frame(FrameType.INFO,
                        encode_uvarint(response_batch_chunks))


def decode_info(buf: bytes) -> int:
    payload = _decode_single(buf, FrameType.INFO)
    val, off = decode_uvarint(payload, 0)
    if off != len(payload):
        raise WireError("trailing bytes in INFO payload")
    return val


# ----------------------------------------------------------------- METRICS
#
# A live metrics scrape: the payload is one UTF-8 JSON document — the
# ``repro_torch.obs.MetricsSnapshot.to_json`` form (``{"v": 1, "families":
# [...]}``).  Keeping the payload opaque JSON (rather than a binary schema)
# means the metric catalog can grow without a wire version bump; the frame
# header + length still make it a normal self-delimiting frame on the
# socket, and ``Op.METRICS`` answers with exactly one of these.

def encode_metrics(snapshot_json: bytes) -> bytes:
    return encode_frame(FrameType.METRICS, snapshot_json)


def decode_metrics(buf: bytes) -> bytes:
    """The snapshot JSON bytes (decode with
    :meth:`repro_torch.obs.MetricsSnapshot.from_json`)."""
    return _decode_single(buf, FrameType.METRICS)


# ------------------------------------------- SHIP / RECORD / REPL_ACK
#
# Journal replication (standby follows primary).  A SHIP request names the
# replica, the epoch it believes the primary is in, the record offset to
# resume from, and a record budget; the answer is one REPL_ACK frame (the
# primary's epoch + log head) followed by RECORD frames, each wrapping one
# checksummed journal record verbatim.  A budget of 0 is a pure status
# probe — the freshness query replica-aware transports use for promotion.

def encode_ship(replica: str, epoch: int, start: int, limit: int) -> bytes:
    return encode_frame(FrameType.SHIP,
                        _encode_str(replica) + encode_uvarint(epoch)
                        + encode_uvarint(start) + encode_uvarint(limit))


def decode_ship(buf: bytes) -> Tuple[str, int, int, int]:
    """``(replica, epoch, start_offset, limit)``."""
    payload = _decode_single(buf, FrameType.SHIP)
    replica, off = _decode_str(payload, 0, "ship replica")
    epoch, off = decode_uvarint(payload, off)
    start, off = decode_uvarint(payload, off)
    limit, off = decode_uvarint(payload, off)
    if off != len(payload):
        raise WireError("trailing bytes in SHIP payload")
    return replica, epoch, start, limit


def encode_record_frame(raw_record: bytes) -> bytes:
    """Wrap one already-encoded checksummed record (the bytes
    :func:`encode_record` produced — what a :class:`ReplicationLog`
    stores) for transit."""
    return encode_frame(FrameType.RECORD, raw_record)


def decode_record_frame(buf: bytes) -> Tuple[int, bytes, bytes]:
    """Unwrap and **verify** one shipped record: the inner checksum must
    match and the record must fill the frame exactly.  Returns ``(rtype,
    payload, raw)`` — the arguments a standby replays plus the verified
    encoding itself, so the standby re-journals the primary's exact bytes
    without re-encoding."""
    raw = _decode_single(buf, FrameType.RECORD)
    rtype, payload, noff = decode_record(raw, 0)
    if noff != len(raw):
        raise WireError(f"{len(raw) - noff} trailing bytes after shipped "
                        f"record")
    return rtype, payload, raw


def encode_repl_ack(replica: str, epoch: int, offset: int) -> bytes:
    return encode_frame(FrameType.REPL_ACK,
                        _encode_str(replica) + encode_uvarint(epoch)
                        + encode_uvarint(offset))


def decode_repl_ack(buf: bytes) -> Tuple[str, int, int]:
    """``(replica, epoch, offset)`` — a replica's applied position (request
    direction) or the primary's log head (response direction)."""
    payload = _decode_single(buf, FrameType.REPL_ACK)
    replica, off = _decode_str(payload, 0, "repl-ack replica")
    epoch, off = decode_uvarint(payload, off)
    offset, off = decode_uvarint(payload, off)
    if off != len(payload):
        raise WireError("trailing bytes in REPL_ACK payload")
    return replica, epoch, offset


# ---------------------------------------------------------------- SNAPSHOT
#
# Snapshot bootstrap (fresh standby joins without replaying history).  A
# SNAPSHOT_SHIP request carries one SNAPSHOT frame naming the replica (epoch
# and offset are 0 — the standby knows nothing yet); the answer is one
# SNAPSHOT frame (the primary's epoch and the log-head offset the shipped
# state corresponds to) followed by RECORD frames wrapping the primary's
# collapsed state records.  After applying them, the standby resumes
# ordinary JOURNAL_SHIP from the header's offset.

def encode_snapshot(replica: str, epoch: int, offset: int) -> bytes:
    return encode_frame(FrameType.SNAPSHOT,
                        _encode_str(replica) + encode_uvarint(epoch)
                        + encode_uvarint(offset))


def decode_snapshot(buf: bytes) -> Tuple[str, int, int]:
    """``(replica, epoch, offset)`` — the requesting standby's name (request
    direction) or the primary's epoch + resume offset (response header)."""
    payload = _decode_single(buf, FrameType.SNAPSHOT)
    replica, off = _decode_str(payload, 0, "snapshot replica")
    epoch, off = decode_uvarint(payload, off)
    offset, off = decode_uvarint(payload, off)
    if off != len(payload):
        raise WireError("trailing bytes in SNAPSHOT payload")
    return replica, epoch, offset


# --------------------------------------------------------------- envelopes
#
# The socket protocol.  A request envelope routes an Op plus lineage/tag to
# a handler and carries the operation's body frames; a response envelope is
# a status byte plus a frame count, then length-prefixed frames.  The
# response *header* goes out before any frame is built, so a server streams
# a large WANT answer batch-by-batch while the client decodes in lockstep.

REQUEST_MAGIC = b"CQ"
RESPONSE_MAGIC = b"CR"
STATUS_OK = 0
STATUS_ERROR = 1

# sanity bounds a stream reader enforces before allocating: a corrupt or
# hostile length prefix must not make an endpoint buffer gigabytes
MAX_ROUTING_BYTES = 4096           # lineage / tag strings
MAX_ENVELOPE_FRAMES = 65536
MAX_FRAME_BYTES = 256 << 20        # one frame (a CHUNK_BATCH tops out far
                                   # below this at sane batch settings)


def check_request_header(hdr: bytes) -> Op:
    """Validate a 4-byte request envelope header; returns the op.  Shared
    by the buffer decoder and the socket stream reader."""
    if hdr[:2] != REQUEST_MAGIC:
        raise WireError(f"bad request magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported request version {hdr[2]}")
    try:
        return Op(hdr[3])
    except ValueError:
        raise WireError(f"unknown request op {hdr[3]}") from None


def check_response_header(hdr: bytes) -> int:
    """Validate a 4-byte response envelope header; returns the status."""
    if hdr[:2] != RESPONSE_MAGIC:
        raise WireError(f"bad response magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported response version {hdr[2]}")
    status = hdr[3]
    if status not in (STATUS_OK, STATUS_ERROR):
        raise WireError(f"unknown response status {status}")
    return status


def encode_request(op: Op, lineage: str, tag: str,
                   frames: Sequence[bytes] = ()) -> bytes:
    out = bytearray()
    out += REQUEST_MAGIC
    out.append(VERSION)
    out.append(int(op))
    out += _encode_str(lineage)
    out += _encode_str(tag)
    out += encode_uvarint(len(frames))
    for f in frames:
        out += encode_uvarint(len(f))
        out += f
    return bytes(out)


def decode_request(buf: bytes) -> Tuple[Op, str, str, List[bytes]]:
    hdr, off = _take(buf, 0, 4, "request header")
    op = check_request_header(hdr)
    lineage, off = _decode_str(buf, off, "request lineage")
    tag, off = _decode_str(buf, off, "request tag")
    n, off = decode_uvarint(buf, off)
    frames: List[bytes] = []
    for _ in range(n):
        size, off = decode_uvarint(buf, off)
        f, off = _take(buf, off, size, "request frame")
        frames.append(f)
    if off != len(buf):
        raise WireError(f"{len(buf) - off} trailing bytes after request")
    return op, lineage, tag, frames


def encode_response_header(status: int, n_frames: int) -> bytes:
    return (RESPONSE_MAGIC + bytes((VERSION, status))
            + encode_uvarint(n_frames))


def decode_response_header(buf: bytes, off: int = 0) -> Tuple[int, int, int]:
    """``(status, n_frames, new_offset)``."""
    hdr, off = _take(buf, off, 4, "response header")
    status = check_response_header(hdr)
    n, off = decode_uvarint(buf, off)
    return status, n, off


def encode_response(status: int, frames: Sequence[bytes]) -> bytes:
    """Whole response in one buffer (tests / non-streaming paths)."""
    out = bytearray(encode_response_header(status, len(frames)))
    for f in frames:
        out += encode_uvarint(len(f))
        out += f
    return bytes(out)


def decode_response(buf: bytes) -> Tuple[int, List[bytes]]:
    status, n, off = decode_response_header(buf, 0)
    frames: List[bytes] = []
    for _ in range(n):
        size, off = decode_uvarint(buf, off)
        f, off = _take(buf, off, size, "response frame")
        frames.append(f)
    if off != len(buf):
        raise WireError(f"{len(buf) - off} trailing bytes after response")
    return status, frames


# ------------------------------------------------------ multiplexed envelopes
#
# The async data plane interleaves many request/response streams over one
# TCP connection.  Each direction is a sequence of self-delimiting
# *messages* that carry a **stream id** so an endpoint can route them:
#
#   request  ``"CM" | version | op | stream_id(4) | str(lineage) | str(tag)
#             | u(n_frames) | (u(len) frame)*``
#   response ``"CS" | version | msg_type | stream_id(4) | ...`` where
#     ``msg_type == MUX_HEADER`` continues ``status(1) | u(n_frames)``
#     (commits the stream's status and total frame count, exactly like a
#     ``"CR"`` header) and ``msg_type == MUX_FRAME`` continues
#     ``u(len) | frame`` (one body frame of that stream).
#
# The stream id is a fixed-width 4-byte big-endian unsigned integer — not a
# varint — so envelope overhead is independent of the id value and a pull
# plan's byte quote stays exact without knowing which ids the transport
# will allocate.  FRAME messages of *different* streams may interleave
# freely; FRAME messages of one stream arrive in order, and the stream
# completes when ``n_frames`` of them have arrived.

MUX_REQUEST_MAGIC = b"CM"
MUX_RESPONSE_MAGIC = b"CS"
MUX_STREAM_ID_BYTES = 4
MAX_STREAM_ID = (1 << 32) - 1
_MUX_HEADER_LEN = 8        # magic(2) + version + op/msg_type + stream_id(4)

MUX_HEADER = 0             # response message types
MUX_FRAME = 1


def check_mux_request_header(hdr: bytes) -> Tuple[Op, int]:
    """Validate an 8-byte mux request header; returns ``(op, stream_id)``."""
    if hdr[:2] != MUX_REQUEST_MAGIC:
        raise WireError(f"bad mux request magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported mux request version {hdr[2]}")
    try:
        op = Op(hdr[3])
    except ValueError:
        raise WireError(f"unknown mux request op {hdr[3]}") from None
    return op, int.from_bytes(hdr[4:8], "big")


def check_mux_response_header(hdr: bytes) -> Tuple[int, int]:
    """Validate an 8-byte mux response message header; returns
    ``(msg_type, stream_id)``."""
    if hdr[:2] != MUX_RESPONSE_MAGIC:
        raise WireError(f"bad mux response magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported mux response version {hdr[2]}")
    if hdr[3] not in (MUX_HEADER, MUX_FRAME):
        raise WireError(f"unknown mux message type {hdr[3]}")
    return hdr[3], int.from_bytes(hdr[4:8], "big")


def _stream_id_bytes(stream_id: int) -> bytes:
    if not 0 <= stream_id <= MAX_STREAM_ID:
        raise WireError(f"stream id {stream_id} out of range")
    return stream_id.to_bytes(MUX_STREAM_ID_BYTES, "big")


def encode_mux_request(op: Op, stream_id: int, lineage: str, tag: str,
                       frames: Sequence[bytes] = ()) -> bytes:
    out = bytearray()
    out += MUX_REQUEST_MAGIC
    out.append(VERSION)
    out.append(int(op))
    out += _stream_id_bytes(stream_id)
    out += _encode_str(lineage)
    out += _encode_str(tag)
    out += encode_uvarint(len(frames))
    for f in frames:
        out += encode_uvarint(len(f))
        out += f
    return bytes(out)


def decode_mux_request(buf: bytes) -> Tuple[Op, int, str, str, List[bytes]]:
    hdr, off = _take(buf, 0, _MUX_HEADER_LEN, "mux request header")
    op, stream_id = check_mux_request_header(hdr)
    lineage, off = _decode_str(buf, off, "mux request lineage")
    tag, off = _decode_str(buf, off, "mux request tag")
    n, off = decode_uvarint(buf, off)
    frames: List[bytes] = []
    for _ in range(n):
        size, off = decode_uvarint(buf, off)
        f, off = _take(buf, off, size, "mux request frame")
        frames.append(f)
    if off != len(buf):
        raise WireError(f"{len(buf) - off} trailing bytes after mux request")
    return op, stream_id, lineage, tag, frames


def encode_mux_response_header(stream_id: int, status: int,
                               n_frames: int) -> bytes:
    """The HEADER message: commits a stream's status + total frame count."""
    if status not in (STATUS_OK, STATUS_ERROR):
        raise WireError(f"unknown response status {status}")
    return (MUX_RESPONSE_MAGIC + bytes((VERSION, MUX_HEADER))
            + _stream_id_bytes(stream_id) + bytes((status,))
            + encode_uvarint(n_frames))


def encode_mux_response_frame(stream_id: int, frame: bytes) -> bytes:
    """One FRAME message: a length-prefixed body frame of ``stream_id``."""
    return (MUX_RESPONSE_MAGIC + bytes((VERSION, MUX_FRAME))
            + _stream_id_bytes(stream_id) + encode_uvarint(len(frame))
            + frame)


def decode_mux_response_header(buf: bytes, off: int = 0
                               ) -> Tuple[int, int, int, int]:
    """Decode one HEADER message; ``(stream_id, status, n_frames, off)``."""
    hdr, off = _take(buf, off, _MUX_HEADER_LEN, "mux response header")
    msg_type, stream_id = check_mux_response_header(hdr)
    if msg_type != MUX_HEADER:
        raise WireError(f"expected mux HEADER message, got type {msg_type}")
    status_b, off = _take(buf, off, 1, "mux response status")
    status = status_b[0]
    if status not in (STATUS_OK, STATUS_ERROR):
        raise WireError(f"unknown response status {status}")
    n, off = decode_uvarint(buf, off)
    return stream_id, status, n, off


def decode_mux_response_frame(buf: bytes, off: int = 0
                              ) -> Tuple[int, bytes, int]:
    """Decode one FRAME message; ``(stream_id, frame, new_offset)``."""
    hdr, off = _take(buf, off, _MUX_HEADER_LEN, "mux frame header")
    msg_type, stream_id = check_mux_response_header(hdr)
    if msg_type != MUX_FRAME:
        raise WireError(f"expected mux FRAME message, got type {msg_type}")
    size, off = decode_uvarint(buf, off)
    frame, off = _take(buf, off, size, "mux frame body")
    return stream_id, frame, off


# ----------------------------------------------------------------- records
#
# Checksummed records: the same varint framing as frames, plus a trailing
# blake2b checksum over the whole record body.  A frame is self-verifying
# only when its payload is (INDEX recomputes node ids); a *record* is
# self-verifying for arbitrary payloads, which is what an append-only log
# needs to detect torn tails after a crash.  Used by the registry journal
# (:mod:`repro_torch.core.journal`).

RECORD_MAGIC = b"CL"
RECORD_CHECK_SIZE = 8


def encode_record(rtype: int, payload: bytes) -> bytes:
    """``magic | version | type | uvarint(len) | payload | blake2b-8``."""
    if not 0 <= rtype <= 255:
        raise WireError(f"record type {rtype} out of range")
    body = (RECORD_MAGIC + bytes((VERSION, rtype))
            + encode_uvarint(len(payload)) + payload)
    return body + hashing.checksum(body, RECORD_CHECK_SIZE)


def decode_record(buf: bytes, off: int = 0) -> Tuple[int, bytes, int]:
    """Decode one checksummed record at ``off``; returns ``(type, payload,
    new_offset)``.  Raises :class:`WireError` on truncation or checksum
    mismatch — for an append-only log both mean the same thing: the tail
    after ``off`` is torn and must be discarded."""
    hdr, noff = _take(buf, off, 4, "record header")
    if hdr[:2] != RECORD_MAGIC:
        raise WireError(f"bad record magic {hdr[:2]!r}")
    if hdr[2] != VERSION:
        raise WireError(f"unsupported record version {hdr[2]}")
    rtype = hdr[3]
    size, noff = decode_uvarint(buf, noff)
    payload, noff = _take(buf, noff, size, "record payload")
    check, noff = _take(buf, noff, RECORD_CHECK_SIZE, "record checksum")
    if hashing.checksum(buf[off:noff - RECORD_CHECK_SIZE],
                        RECORD_CHECK_SIZE) != check:
        raise WireError("record checksum mismatch")
    return rtype, payload, noff


# ------------------------------------------------------------------ sizing

def uvarint_len(n: int) -> int:
    """Encoded length of ``n`` as a LEB128 uvarint, without encoding it."""
    size = 1
    while n > 0x7F:
        n >>= 7
        size += 1
    return size


def _frame_len(payload_len: int) -> int:
    return _HEADER + uvarint_len(payload_len) + payload_len


def index_wire_bytes(t: CDMT) -> int:
    """Actual serialized size of the index (replaces the old estimate).
    The index is KB-sized, so encoding it to measure is cheap."""
    return len(encode_index(t))


def recipe_wire_bytes(r: Recipe) -> int:
    payload = (uvarint_len(len(r.name.encode("utf-8")))
               + len(r.name.encode("utf-8"))
               + uvarint_len(len(r.fps))
               + len(r.fps) * hashing.DIGEST_SIZE
               + sum(uvarint_len(s) for s in r.sizes))
    return _frame_len(payload)


def chunk_batch_wire_bytes(chunks: Mapping[bytes, bytes]) -> int:
    """Exact ``len(encode_chunk_batch(chunks))`` computed arithmetically —
    measurement must not copy every chunk payload into a throwaway frame."""
    payload = uvarint_len(len(chunks)) + sum(
        hashing.DIGEST_SIZE + uvarint_len(len(d)) + len(d)
        for d in chunks.values())
    return _frame_len(payload)


def chunk_batch_frame_lens(sizes: Sequence[int],
                           batch_chunks: int) -> List[int]:
    """Exact per-frame CHUNK_BATCH lengths for payloads of ``sizes`` split
    into frames of ``batch_chunks`` — from sizes alone.  The socket path
    needs the individual frame lengths (each one carries an envelope length
    prefix), not just their sum."""
    batch_chunks = max(1, batch_chunks)
    lens: List[int] = []
    for start in range(0, len(sizes), batch_chunks):
        part = sizes[start:start + batch_chunks]
        payload = uvarint_len(len(part)) + sum(
            hashing.DIGEST_SIZE + uvarint_len(s) + s for s in part)
        lens.append(_frame_len(payload))
    return lens


def chunk_batches_wire_bytes(sizes: Sequence[int], batch_chunks: int) -> int:
    """Exact CHUNK_BATCH bytes for payloads of ``sizes`` delivered in frames
    of ``batch_chunks`` — from sizes alone, so a pull *plan* can quote its
    expected wire cost before a single payload is read."""
    return sum(chunk_batch_frame_lens(sizes, batch_chunks))


def request_envelope_bytes(lineage: str, tag: str,
                           frame_lens: Sequence[int]) -> int:
    """Exact ``len(encode_request(op, lineage, tag, frames))`` from the
    body-frame lengths alone (the op byte is fixed-width)."""
    lin = len(lineage.encode("utf-8"))
    tg = len(tag.encode("utf-8"))
    return (4 + uvarint_len(lin) + lin + uvarint_len(tg) + tg
            + uvarint_len(len(frame_lens))
            + sum(uvarint_len(n) + n for n in frame_lens))


def response_envelope_bytes(frame_lens: Sequence[int]) -> int:
    """Exact ``len(encode_response(status, frames))`` from frame lengths."""
    return (4 + uvarint_len(len(frame_lens))
            + sum(uvarint_len(n) + n for n in frame_lens))


def mux_request_envelope_bytes(lineage: str, tag: str,
                               frame_lens: Sequence[int]) -> int:
    """Exact ``len(encode_mux_request(op, sid, lineage, tag, frames))`` from
    the body-frame lengths alone — the stream id is fixed-width, so the
    size is independent of which id the transport allocates."""
    lin = len(lineage.encode("utf-8"))
    tg = len(tag.encode("utf-8"))
    return (_MUX_HEADER_LEN + uvarint_len(lin) + lin + uvarint_len(tg) + tg
            + uvarint_len(len(frame_lens))
            + sum(uvarint_len(n) + n for n in frame_lens))


def mux_response_envelope_bytes(frame_lens: Sequence[int]) -> int:
    """Exact total bytes of one complete mux response stream (the HEADER
    message plus one FRAME message per body frame) from frame lengths
    alone — what a pull plan quotes for the async transport."""
    return (_MUX_HEADER_LEN + 1 + uvarint_len(len(frame_lens))
            + sum(_MUX_HEADER_LEN + uvarint_len(n) + n
                  for n in frame_lens))
