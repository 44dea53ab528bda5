"""CUDA kernel wrapper: content-defined-chunking boundary scan (gear hash).

Replaces ``src/repro/kernels/gear_cdc.py:_gear_cdc_kernel`` (the TPU kernel
behind ``gear_hash_pallas``).  The kernel is ``csrc/gear_cdc.cu``, built for
``sm_90a`` at first use by :mod:`repro_torch.kernels.build` and called over
its plain C interface with ``ctypes``.

What bounds it on an H100: HBM bytes and integer operations, about
equally.  It reads each input byte once and does about six integer
operations per byte, 0.32 ms and 0.39 ms per GiB at 3.35 TB/s and at the
card's 16.7 T INT32 operations a second.  What the design does about it: the
gear table lives in shared memory and each thread runs the serial recurrence
over its own span after an exact 32-byte warm-up (about two operations per
byte instead of the TPU kernel's 32 shifted adds); tiles are staged with
16-byte coalesced loads; and the main path asks for candidate positions
only, 8 bytes each (about 2 MB per GiB at 4 KiB chunks) instead of 4 bytes
per input byte, and the host copies back only those.

Each wrapper takes a uint8, contiguous, one-dimensional tensor.  On a CUDA
tensor it launches the kernel on the current stream and adds one to its
``launches`` count; on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.ref`; any other tensor raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_U = ctypes.c_uint


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("gear_cdc")
    lib.gear_tile_bytes.argtypes = []
    lib.gear_tile_bytes.restype = _N
    lib.gear_hash_launch.argtypes = [_P, _N, _P, _P, _P]
    lib.gear_hash_launch.restype = ctypes.c_int
    lib.gear_count_launch.argtypes = [_P, _N, _P, _U, _P, _P, _P]
    lib.gear_count_launch.restype = ctypes.c_int
    lib.gear_emit_launch.argtypes = [_P, _N, _P, _U, _P, _P, _P]
    lib.gear_emit_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _device_table(device: torch.device) -> torch.Tensor:
    return ref.gear_table_tensor(device)


def _check_input(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"gear_cdc takes a 1-D uint8 tensor, got "
                         f"{data.dtype} of shape {tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gear_cdc runs on cuda (kernel) or cpu (plain "
                         f"version), not on {data.device}")
    if data.device.type == "cuda" and not data.is_contiguous():
        raise ValueError("gear_cdc takes a contiguous tensor")


def _check_mask_bits(mask_bits: int) -> int:
    if not 0 <= mask_bits <= 32:
        raise ValueError(f"mask_bits must lie in [0, 32], got {mask_bits}")
    return (1 << mask_bits) - 1


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"gear_cdc {what} launch failed: CUDA error {rc}")


def gear_hash(data: torch.Tensor) -> torch.Tensor:
    """uint8 (n,) → uint32 (n,): the rolling gear hash of every byte."""
    _check_input(data)
    if data.device.type == "cpu":
        return ref.gear_hash_ref(data)
    n = data.numel()
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n:
        with torch.cuda.device(data.device):
            lib = _library()
            _launched(lib.gear_hash_launch(
                data.data_ptr(), n, _device_table(data.device).data_ptr(),
                out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "hash")
        gear_hash.launches += 1
    return out.view(torch.uint32)


gear_hash.launches = 0


def gear_candidates(data: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """Sorted int64 positions ``i`` whose hash has its low ``mask_bits`` bits
    zero — ``np.flatnonzero`` of the boundary mask, without the mask.

    On CUDA: a count pass with an exclusive scan of the per-tile counts, one
    8-byte read of the total by the host to size the output, then an emit
    pass that writes each tile's positions in order."""
    _check_input(data)
    mask = _check_mask_bits(mask_bits)
    if data.device.type == "cpu":
        return ref.boundary_candidates_ref(data, mask_bits)
    n = data.numel()
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        lib = _library()
        tiles = -(-n // lib.gear_tile_bytes())
        counts = torch.empty(tiles, dtype=torch.int32, device=data.device)
        offsets = torch.empty(tiles + 1, dtype=torch.int64,
                              device=data.device)
        table = _device_table(data.device).data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        _launched(lib.gear_count_launch(
            data.data_ptr(), n, table, mask, counts.data_ptr(),
            offsets.data_ptr(), stream), "count")
        out = torch.empty(int(offsets[tiles]), dtype=torch.int64,
                          device=data.device)
        _launched(lib.gear_emit_launch(
            data.data_ptr(), n, table, mask, offsets.data_ptr(),
            out.data_ptr(), stream), "emit")
    gear_candidates.launches += 1
    return out


gear_candidates.launches = 0
