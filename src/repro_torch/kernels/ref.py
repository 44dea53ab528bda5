"""Plain PyTorch versions of the kernels — the semantics contracts.

The CPU tests compare these with the JAX package bit for bit, ``chip_smoke.py``
compares the CUDA kernels with them on the card, and the kernel wrappers use
them for tensors that lie on the CPU.

Hashes are carried as int32 bits, where shifts and adds wrap mod 2^32, and
viewed as uint32 only at the edges: ``torch.uint32`` has no CPU add.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cdc import GEAR_WINDOW, gear_table


def int32_bits(value: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    return value - (1 << 32) if value >= (1 << 31) else value


def gear_table_tensor(device: torch.device | str = "cpu") -> torch.Tensor:
    """The 256-entry gear table as int32 bits on ``device``."""
    return torch.from_numpy(gear_table().view(np.int32)).to(device)


def gear_hash_bits(data: torch.Tensor) -> torch.Tensor:
    """Rolling gear hash of a uint8 stream as int32 bits.

    ``h_i = sum_{j=0}^{31} 2^j * G[b_{i-j}]  (mod 2^32)`` with zero before the
    stream's start — the unrolled form of ``h_i = 2*h_{i-1} + G[b_i]``.
    """
    g = gear_table_tensor(data.device)[data.to(torch.int32)]
    n = g.numel()
    h = g.clone()
    for j in range(1, min(GEAR_WINDOW, n)):
        h[j:] += g[:n - j] << j
    return h


def gear_hash_ref(data: torch.Tensor) -> torch.Tensor:
    """uint8 (n,) → uint32 (n,): the rolling gear hash of every byte."""
    return gear_hash_bits(data).view(torch.uint32)


def boundary_mask_ref(data: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """Candidate-boundary mask: the hash's low ``mask_bits`` bits all zero."""
    mask = int32_bits((1 << mask_bits) - 1)
    return (gear_hash_bits(data) & mask) == 0


def boundary_candidates_ref(data: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """Sorted int64 positions ``i`` where the candidate mask is set — what
    ``np.flatnonzero`` gives for the mask."""
    return torch.nonzero(boundary_mask_ref(data, mask_bits)).flatten()
