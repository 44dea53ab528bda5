"""``repro_torch.delivery`` — the measurable delivery stack on top of the
CDMT core, as in the JAX package's ``repro.delivery``.

  * :mod:`repro_torch.delivery.wire`      — varint-framed binary wire format
    for CDMT indexes, recipes, chunk batches, want-lists, and presence
    queries (round-trip, self-verifying; byte-identical to the JAX package's
    frames);
  * :mod:`repro_torch.delivery.cache`     — tiered chunk cache (in-memory LRU
    over the disk/log ``ChunkStore``) with hit/miss/eviction/warm accounting;
  * :mod:`repro_torch.delivery.server`    — concurrent registry frontend:
    many pullers, request coalescing, batched chunk responses, restart
    warm-up, exact egress/ingress meters;
  * :mod:`repro_torch.delivery.transport` — the pluggable :class:`Transport`
    protocol with in-process (``LocalTransport``) and framed
    (``WireTransport``) implementations;
  * :mod:`repro_torch.delivery.plan`      — inspectable :class:`PullPlan` and
    the unified per-source :class:`TransferReport` accounting;
  * :mod:`repro_torch.delivery.client`    — :class:`ImageClient`, the client
    API (``commit``/``plan_pull``/``execute``/``push``/``upgrade``), whose
    ``commit`` chunks on the CUDA device it is given.

The socket, async, swarm, delta and replication layers of the JAX package
are not part of this package yet.
"""

from repro_torch.core.errors import DeliveryError

from .cache import CacheStats, TieredChunkCache
from .client import ImageClient
from .plan import PullPlan, SourceLeg, TransferReport
from .server import RegistryServer, ServerStats
from .transport import (FetchResult, LocalTransport, PushOutcome, Transport,
                        TransportMeter, WireTransport)
from .wire import (ErrorCode, FrameType, Op, WireError, decode_chunk_batch,
                   decode_error, decode_frame, decode_has, decode_index,
                   decode_info, decode_metrics, decode_missing,
                   decode_receipt, decode_recipe, decode_record_frame,
                   decode_repl_ack, decode_request, decode_response,
                   decode_ship, decode_snapshot, decode_tag_list,
                   decode_tags_request, decode_want, encode_chunk_batch,
                   encode_error, encode_frame, encode_has, encode_index,
                   encode_info, encode_metrics, encode_missing,
                   encode_receipt, encode_recipe, encode_record_frame,
                   encode_repl_ack, encode_request, encode_response,
                   encode_ship, encode_snapshot, encode_tag_list,
                   encode_tags_request, encode_want)

__all__ = [
    "CacheStats", "TieredChunkCache",
    "ImageClient",
    "DeliveryError",
    "PullPlan", "SourceLeg", "TransferReport",
    "RegistryServer", "ServerStats",
    "Transport", "LocalTransport", "WireTransport",
    "FetchResult", "PushOutcome", "TransportMeter",
    "FrameType", "Op", "ErrorCode", "WireError",
    "encode_frame", "decode_frame",
    "encode_index", "decode_index",
    "encode_recipe", "decode_recipe",
    "encode_chunk_batch", "decode_chunk_batch",
    "encode_want", "decode_want",
    "encode_has", "decode_has",
    "encode_missing", "decode_missing",
    "encode_tags_request", "decode_tags_request",
    "encode_tag_list", "decode_tag_list",
    "encode_error", "decode_error",
    "encode_receipt", "decode_receipt",
    "encode_info", "decode_info",
    "encode_metrics", "decode_metrics",
    "encode_ship", "decode_ship",
    "encode_snapshot", "decode_snapshot",
    "encode_record_frame", "decode_record_frame",
    "encode_repl_ack", "decode_repl_ack",
    "encode_request", "decode_request",
    "encode_response", "decode_response",
]
