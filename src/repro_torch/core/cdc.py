"""Content-defined chunking (CDC).

Implements the paper's block-level deduplication substrate (Sec. III-A):
variable-length chunks whose boundaries are defined by the *content* (a
rolling hash over a small window matching a bit pattern), so that byte
insertions/deletions only perturb the chunks local to the edit ("byte-shift"
resistance).

Two rolling hashes are provided:

* ``gear`` (default) — FastCDC-style gear hash: ``h = (h << 1) + G[byte]``
  with a fixed random 256-entry table ``G``.  The gear hash has *bounded
  memory*: after 32 shifts a byte's contribution leaves the 32-bit register,
  which is exactly what makes it blocked-parallelizable on a device
  (see ``repro_torch.kernels.gear_cdc``).
* ``rabin`` — Rabin polynomial fingerprint over a sliding window (the paper's
  choice, Sec. VI-D), kept as the paper-faithful reference.

Both are deterministic across processes (fixed seed) — a hard requirement:
client and registry must agree on chunk boundaries byte-for-byte.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Gear table: fixed pseudo-random 256 x uint32, shared by host + CUDA kernel.
# ---------------------------------------------------------------------------

_GEAR_SEED = 0x9E3779B9


def gear_table() -> np.ndarray:
    """The 256-entry gear table (uint32), deterministic across processes."""
    rng = np.random.default_rng(_GEAR_SEED)
    return rng.integers(0, 2**32, size=256, dtype=np.uint32)


_GEAR = gear_table()

# Bits of gear-hash memory: h_i depends on at most the last 32 bytes.
GEAR_WINDOW = 32


@dataclasses.dataclass(frozen=True)
class CDCParams:
    """Chunking parameters.

    ``mask_bits`` sets the boundary rule: a boundary is declared at byte i
    when ``hash_i & ((1 << mask_bits) - 1) == 0`` — expected chunk size
    ``2**mask_bits`` bytes (the paper's "last k bits of the hash are 0").
    ``min_size``/``max_size`` bound pathological content (paper Sec. III-A
    implies bounds via the pattern; FastCDC makes them explicit).
    """

    mask_bits: int = 12               # expected chunk size 4 KiB
    min_size: int = 512
    max_size: int = 65536
    algorithm: str = "gear"           # "gear" | "rabin"

    @property
    def mask(self) -> int:
        return (1 << self.mask_bits) - 1

    @property
    def avg_size(self) -> int:
        return 1 << self.mask_bits


DEFAULT_PARAMS = CDCParams()


# ---------------------------------------------------------------------------
# Gear rolling hash — vectorised boundary scan (numpy host path).
#
# The recurrence h_i = (2*h_{i-1} + g_i) mod 2^32 unrolls to
#     h_i = sum_{j=0}^{31} 2^j * g_{i-j}          (mod 2^32)
# i.e. a convolution of the gear-mapped byte stream with [1, 2, 4, ... 2^31].
# That identity is what this host path exploits; the CUDA kernel uses the
# bounded memory it implies (an exact 32-byte warm-up per thread).
# ---------------------------------------------------------------------------


def gear_hash_stream(data: bytes | np.ndarray) -> np.ndarray:
    """Rolling gear hash h_i for every byte position (uint32 array)."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if buf.size == 0:
        return np.zeros(0, dtype=np.uint32)
    g = _GEAR[buf].astype(np.uint64)
    n = buf.size
    # Convolution with powers of two over a window of 32: do it as 32 shifted
    # adds (vectorised; 32 passes over the array, still ~GB/s on host).
    h = np.zeros(n, dtype=np.uint64)
    for j in range(min(GEAR_WINDOW, 64)):
        # contribution of byte i-j with weight 2^j
        if j == 0:
            h += g
        else:
            h[j:] += g[:-j] << np.uint64(j)
    return (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _gear_boundaries(buf: np.ndarray, params: CDCParams) -> List[int]:
    """Boundary *end offsets* (exclusive) honoring min/max size."""
    n = buf.size
    if n == 0:
        return []
    h = gear_hash_stream(buf)
    candidate = np.flatnonzero((h & np.uint32(params.mask)) == 0) + 1  # cut AFTER byte i
    ends: List[int] = []
    start = 0
    ci = 0
    m = candidate.size
    while start < n:
        lo = start + params.min_size
        hi = start + params.max_size
        # first candidate cut >= lo
        ci = int(np.searchsorted(candidate, lo, side="left"))
        if ci < m and candidate[ci] <= hi and candidate[ci] < n:
            cut = int(candidate[ci])
        else:
            cut = min(hi, n)
        ends.append(cut)
        start = cut
    return ends


# ---------------------------------------------------------------------------
# Rabin fingerprint (paper-faithful reference; slow scalar loop, numpy-rolled)
# ---------------------------------------------------------------------------

_RABIN_PRIME = np.uint64(1099511628211)     # FNV-ish multiplier
_RABIN_WINDOW = 48


def _rabin_boundaries(buf: np.ndarray, params: CDCParams) -> List[int]:
    """Rabin-style polynomial rolling hash boundaries (reference path)."""
    n = buf.size
    if n == 0:
        return []
    w = _RABIN_WINDOW
    # h_i = sum_{j<w} p^j * b_{i-j}  (mod 2^64): compute with w shifted adds.
    b = buf.astype(np.uint64)
    h = np.zeros(n, dtype=np.uint64)
    pj = np.uint64(1)
    with np.errstate(over="ignore"):
        for j in range(w):
            if j == 0:
                h += b
            else:
                h[j:] += b[:-j] * pj
            pj = pj * _RABIN_PRIME
    mask = np.uint64(params.mask)
    candidate = np.flatnonzero((h & mask) == 0) + 1
    ends: List[int] = []
    start = 0
    m = candidate.size
    while start < n:
        lo = start + params.min_size
        hi = start + params.max_size
        ci = int(np.searchsorted(candidate, lo, side="left"))
        if ci < m and candidate[ci] <= hi and candidate[ci] < n:
            cut = int(candidate[ci])
        else:
            cut = min(hi, n)
        ends.append(cut)
        start = cut
    return ends


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def chunk_boundaries(data: bytes | np.ndarray, params: CDCParams = DEFAULT_PARAMS) -> List[int]:
    """End offsets (exclusive) of every chunk in ``data``."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if params.algorithm == "gear":
        return _gear_boundaries(buf, params)
    if params.algorithm == "rabin":
        return _rabin_boundaries(buf, params)
    raise ValueError(f"unknown CDC algorithm {params.algorithm!r}")


def chunk_bytes(data: bytes, params: CDCParams = DEFAULT_PARAMS) -> Iterator[bytes]:
    """Yield the chunks of ``data`` (concatenation reproduces ``data``)."""
    start = 0
    for end in chunk_boundaries(data, params):
        yield data[start:end]
        start = end


def chunk_spans(data: bytes | np.ndarray, params: CDCParams = DEFAULT_PARAMS) -> List[tuple]:
    """(start, end) spans of every chunk."""
    ends = chunk_boundaries(data, params)
    starts = [0] + ends[:-1]
    return list(zip(starts, ends))


def boundaries_from_mask(mask: np.ndarray, params: CDCParams) -> List[int]:
    """Turn a per-byte candidate-boundary mask into min/max-size-honoring
    chunk end offsets (see :func:`boundaries_from_candidates`)."""
    return boundaries_from_candidates(np.flatnonzero(mask) + 1, mask.size,
                                      params)


def boundaries_from_candidates(candidate: np.ndarray, n: int,
                               params: CDCParams) -> List[int]:
    """Turn sorted candidate cut offsets (``i + 1`` for every byte ``i`` whose
    hash matches the boundary pattern, as the CUDA kernel emits them) into
    min/max-size-honoring chunk end offsets of an ``n``-byte stream.
    Host-side serial pass — this is the only part of CDC that is inherently
    sequential, and it operates on a sparse candidate list, not the byte
    stream."""
    ends: List[int] = []
    start = 0
    m = candidate.size
    while start < n:
        lo = start + params.min_size
        hi = start + params.max_size
        ci = int(np.searchsorted(candidate, lo, side="left"))
        if ci < m and candidate[ci] <= hi and candidate[ci] < n:
            cut = int(candidate[ci])
        else:
            cut = min(hi, n)
        ends.append(cut)
        start = cut
    return ends
