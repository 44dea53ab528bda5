"""The port's gear-CDC kernel layer against the JAX package, on the CPU.

The port's plain PyTorch version (what its wrappers run for CPU tensors) must
equal, bit for bit, the JAX package's Pallas kernel in interpret mode, its
pure-jnp oracle and its host numpy hash.  All data is integer: every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cdc as jax_cdc
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import cdc
from repro_torch.delivery import ImageClient, LocalTransport
from repro_torch.core.registry import Registry
from repro_torch.kernels import gear_cdc, ops, ref

LENGTHS = [1, 31, 32, 33, 16383, 16384, 16385, 3 * 16384 + 17]
KINDS = ["random", "zero", "periodic"]


def _data(kind: str, n: int) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    if kind == "zero":
        return np.zeros(n, dtype=np.uint8)
    period = np.frombuffer(b"GET /index.html HTTP/1.1\r\n", dtype=np.uint8)
    return np.resize(period, n)


def test_gear_tables_equal():
    np.testing.assert_array_equal(cdc.gear_table(), jax_cdc.gear_table())
    assert cdc.GEAR_WINDOW == jax_cdc.GEAR_WINDOW
    assert ref.gear_table_tensor().numpy().view(np.uint32).tolist() \
        == jax_cdc.gear_table().tolist()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_gear_hash_matches_jax(n, kind):
    raw = _data(kind, n)
    port = ref.gear_hash_ref(torch.from_numpy(raw)).numpy()
    assert port.dtype == np.uint32
    pallas = np.asarray(jax_ops.gear_hash(jnp.asarray(raw), impl="interpret"))
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, np.asarray(
        jax_ref.gear_hash_ref(jnp.asarray(raw))))
    np.testing.assert_array_equal(port, jax_cdc.gear_hash_stream(raw))
    # the wrapper runs the plain version for a CPU tensor
    np.testing.assert_array_equal(
        ops.gear_hash(torch.from_numpy(raw)).numpy(), port)
    for mask_bits in (6, 12):
        want = (pallas & np.uint32((1 << mask_bits) - 1)) == 0
        np.testing.assert_array_equal(
            ref.boundary_mask_ref(torch.from_numpy(raw), mask_bits).numpy(),
            want)
        np.testing.assert_array_equal(
            ops.gear_boundary_mask(torch.from_numpy(raw), mask_bits).numpy(),
            want)
        np.testing.assert_array_equal(
            np.asarray(jax_ops.gear_boundary_mask(jnp.asarray(raw), mask_bits,
                                                  impl="interpret")), want)
        np.testing.assert_array_equal(
            gear_cdc.gear_candidates(torch.from_numpy(raw), mask_bits).numpy(),
            np.flatnonzero(want))


# (mask_bits, min_size, max_size, data): min/max edge cases included —
# shorter than min_size, exactly max_size, no candidates at all (zero bytes
# hash to a constant) so every cut is forced at max_size, min_size equal to
# max_size, and candidates denser than min_size (periodic bytes).
CHUNK_CASES = [
    (10, 128, 8192, "random", 80_000),
    (6, 64, 256, "random", 20_000),
    (12, 512, 4096, "random", 100),
    (12, 512, 4096, "random", 4096),
    (12, 512, 4096, "random", 4097),
    (8, 512, 1000, "zero", 30_000),
    (8, 333, 333, "random", 10_000),
    (6, 100, 5000, "periodic", 20_000),
    (6, 1, 64, "random", 5_000),
]


@pytest.mark.parametrize("mask_bits,min_size,max_size,kind,n", CHUNK_CASES)
def test_chunk_boundaries_match_jax(mask_bits, min_size, max_size, kind, n):
    raw = _data(kind, n).tobytes()
    port = ops.chunk_boundaries_accelerated(
        raw, cdc.CDCParams(mask_bits=mask_bits, min_size=min_size,
                           max_size=max_size), device="cpu")
    jparams = jax_cdc.CDCParams(mask_bits=mask_bits, min_size=min_size,
                                max_size=max_size)
    assert port == jax_cdc.chunk_boundaries(raw, jparams)
    assert port == jax_ops.chunk_boundaries_accelerated(raw, jparams,
                                                        impl="interpret")
    assert port[-1] == n and all(b - a <= max_size
                                 for a, b in zip([0] + port, port))


def test_empty_input():
    assert ops.chunk_boundaries_accelerated(b"", cdc.DEFAULT_PARAMS,
                                            device="cpu") == []
    empty = torch.empty(0, dtype=torch.uint8)
    assert ref.gear_hash_ref(empty).numel() == 0
    assert gear_cdc.gear_candidates(empty, 12).numel() == 0


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _data("random", 1000).tobytes()
    with pytest.raises(RuntimeError, match="cuda"):
        ops.chunk_boundaries_accelerated(raw, cdc.DEFAULT_PARAMS)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.chunk_boundaries_accelerated(raw, cdc.DEFAULT_PARAMS,
                                         device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ImageClient(LocalTransport(Registry()))       # default device


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        gear_cdc.gear_hash(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        gear_cdc.gear_candidates(torch.zeros((2, 4), dtype=torch.uint8), 6)
    with pytest.raises(ValueError, match="meta"):
        gear_cdc.gear_candidates(torch.zeros(8, dtype=torch.uint8,
                                             device="meta"), 6)
    with pytest.raises(ValueError, match="mask_bits"):
        gear_cdc.gear_candidates(torch.zeros(8, dtype=torch.uint8), 40)
    with pytest.raises(ValueError, match="gear"):
        ops.chunk_boundaries_accelerated(
            b"abc", cdc.CDCParams(algorithm="rabin"), device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.chunk_boundaries_accelerated(b"abc", cdc.DEFAULT_PARAMS,
                                         device="meta")


def test_boundaries_from_candidates_matches_mask_pass():
    raw = _data("random", 50_000)
    params = cdc.CDCParams(mask_bits=7, min_size=64, max_size=1024)
    mask = jax_cdc.gear_hash_stream(raw) & np.uint32(params.mask) == 0
    assert cdc.boundaries_from_candidates(np.flatnonzero(mask) + 1, raw.size,
                                          params) \
        == cdc.boundaries_from_mask(mask, params) \
        == jax_cdc.boundaries_from_mask(mask, jax_cdc.CDCParams(
            mask_bits=7, min_size=64, max_size=1024))
