"""The CUDA gear-CDC kernel on the card: against its plain PyTorch version
and the host hash, and through ``ImageClient``'s default device.

These tests need a CUDA card and the CUDA toolkit; without a card they skip.
On a machine with one:  python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cdc
from repro_torch.core.registry import Registry
from repro_torch.delivery import ImageClient, LocalTransport
from repro_torch.kernels import gear_cdc, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gear_cdc kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 31, 32, 33, 31743, 31744, 31745,
                               3 * 31744 + 17, 1 << 22])
def test_kernel_matches_plain_and_host(card, n):
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for data in (torch.from_numpy(raw).to(card),
                 torch.from_numpy(np.concatenate(
                     [np.array([7], dtype=np.uint8), raw])).to(card)[1:]):
        h = gear_cdc.gear_hash(data)
        assert torch.equal(h.view(torch.int32), ref.gear_hash_bits(data))
        np.testing.assert_array_equal(h.cpu().numpy(),
                                      cdc.gear_hash_stream(raw))
        for mask_bits in (0, 6, 12, 32):
            assert torch.equal(gear_cdc.gear_candidates(data, mask_bits),
                               ref.boundary_candidates_ref(data, mask_bits))


def test_launches_count_kernel_calls(card):
    data = torch.zeros(100, dtype=torch.uint8, device=card)
    before = gear_cdc.gear_candidates.launches
    gear_cdc.gear_candidates(data, 6)
    gear_cdc.gear_candidates(data[:0], 6)            # nothing to launch
    gear_cdc.gear_candidates(data.cpu(), 6)          # the plain version
    assert gear_cdc.gear_candidates.launches == before + 1


def test_commit_on_the_card_matches_the_cpu(card):
    raw = np.random.default_rng(1).integers(0, 256, 1 << 20,
                                            dtype=np.uint8).tobytes()
    params = cdc.CDCParams(mask_bits=10, min_size=256, max_size=8192)
    assert ops.chunk_boundaries_accelerated(raw, params) \
        == cdc.chunk_boundaries(raw, params)
    on_card = ImageClient(LocalTransport(Registry()), cdc_params=params)
    on_cpu = ImageClient(LocalTransport(Registry()), cdc_params=params,
                         device="cpu")
    assert on_card.device.type == "cuda"
    assert on_card.commit("a", "t", raw).fps == on_cpu.commit("a", "t", raw).fps
    assert on_card.indexes["a"].root == on_cpu.indexes["a"].root
