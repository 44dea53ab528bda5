"""Public wrappers around the kernels.

Dispatch follows the tensor: a CUDA tensor goes to the CUDA kernel, a CPU
tensor to the plain PyTorch version, anything else raises.  The entry points
that take bytes take a ``device`` and default to ``"cuda"``; asking for CUDA
on a machine without a card raises.  The kernels handle ragged lengths, so
callers never see tile sizes.
"""

from __future__ import annotations

import warnings
from typing import List

import torch

from repro_torch.core import cdc
from . import gear_cdc, ref


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises unless it is the CPU or a
    CUDA device that this machine has."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} was asked for but torch.cuda.is_available() "
                f"is false; pass device='cpu' to run the plain PyTorch "
                f"version instead")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


# ---------------------------------------------------------------------------
# CDC boundary scan
# ---------------------------------------------------------------------------


#: Rolling gear hash (uint32) per byte of a uint8 stream.
gear_hash = gear_cdc.gear_hash


def gear_boundary_mask(data: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """Candidate chunk boundaries: low ``mask_bits`` of the rolling hash zero."""
    h = gear_cdc.gear_hash(data).view(torch.int32)
    return (h & ref.int32_bits((1 << mask_bits) - 1)) == 0


def bytes_tensor(data: bytes) -> torch.Tensor:
    """Zero-copy uint8 view of ``data``; nothing writes through it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.frombuffer(data, dtype=torch.uint8)


def chunk_boundaries_accelerated(data: bytes, params: cdc.CDCParams,
                                 device: torch.device | str = "cuda"
                                 ) -> List[int]:
    """Full gear CDC: the device boundary scan, then the host min/max pass.

    The scan returns only candidate positions, so the device-to-host copy is
    8 bytes per candidate, about 2 MB per GiB at 4 KiB chunks."""
    if params.algorithm != "gear":
        raise ValueError(f"the boundary-scan kernel computes the gear hash; "
                         f"got CDC algorithm {params.algorithm!r}")
    dev = resolve_device(device)
    if not data:
        return []
    arr = bytes_tensor(data).to(dev)
    ends = gear_cdc.gear_candidates(arr, params.mask_bits) + 1
    return cdc.boundaries_from_candidates(ends.cpu().numpy(), len(data),
                                          params)
