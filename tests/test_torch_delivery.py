"""The port's delivery slice as a whole against the JAX package, on the CPU.

The same bytes go through the JAX package's ``ImageClient`` and the port's
``ImageClient(device="cpu")``: recipes, CDMT roots, pull plans, transfer
reports, materialized bytes and wire frames must be identical.  A registry
directory written by either package opens in the other.
"""

import numpy as np
import pytest

import repro.core.cdc as jax_cdc
import repro.core.registry as jax_registry
import repro.delivery as jax_delivery
import repro.delivery.wire as jax_wire
import repro_torch.core.cdc as port_cdc
import repro_torch.core.registry as port_registry
import repro_torch.delivery as port_delivery
import repro_torch.delivery.wire as port_wire
from repro_torch.core.store import DedupStore

PARAMS = dict(mask_bits=10, min_size=256, max_size=8192)
REPORT_FIELDS = ("op", "lineage", "tag", "transport", "chunk_bytes",
                 "index_bytes", "recipe_bytes", "want_bytes", "chunks_moved",
                 "chunks_total", "raw_bytes", "comparisons", "rounds",
                 "total_wire_bytes")


def _versions(seed=7, n_versions=4, size=384 * 1024):
    """A lineage with in-place edits, inserts and deletes between versions."""
    rng = np.random.default_rng(seed)
    words = rng.integers(97, 123, size=(64, 7), dtype=np.uint8)
    text = words[rng.integers(0, 64, size=size // 7 + 1)].reshape(-1)[:size]
    data = bytearray(text.tobytes())
    data[1000:1000 + 4096] = rng.bytes(4096)
    out = [bytes(data)]
    for _ in range(n_versions - 1):
        for _ in range(3):
            pos = int(rng.integers(0, len(data) - 2048))
            size_edit = int(rng.integers(16, 2048))
            kind = rng.integers(0, 3)
            if kind == 0:
                data[pos:pos + size_edit] = rng.bytes(size_edit)
            elif kind == 1:
                data[pos:pos] = rng.bytes(size_edit)
            else:
                del data[pos:pos + size_edit]
        out.append(bytes(data))
    return out


class _Side:
    """One package's registry, publisher and puller over one transport."""

    def __init__(self, pkg, registry_mod, cdc_mod, transport, **client_kw):
        self.pkg = pkg
        self.registry = registry_mod.Registry()
        params = cdc_mod.CDCParams(**PARAMS)
        self.publisher = pkg.ImageClient(self._transport(transport),
                                         cdc_params=params, **client_kw)
        self.puller = pkg.ImageClient(self._transport(transport),
                                      cdc_params=params, **client_kw)

    def _transport(self, kind):
        if kind == "local":
            return self.pkg.LocalTransport(self.registry)
        return self.pkg.WireTransport(self.pkg.RegistryServer(self.registry))


def _report(r):
    return {f: getattr(r, f) for f in REPORT_FIELDS}


@pytest.mark.parametrize("transport", ["local", "wire"])
def test_same_bytes_same_delivery(transport):
    versions = _versions()
    jax_side = _Side(jax_delivery, jax_registry, jax_cdc, transport)
    port_side = _Side(port_delivery, port_registry, port_cdc, transport,
                      device="cpu")
    for i, data in enumerate(versions):
        tag = f"v{i}"
        rj = jax_side.publisher.commit("app", tag, data)
        rp = port_side.publisher.commit("app", tag, data)
        assert (rp.fps, rp.sizes) == (rj.fps, rj.sizes)
        assert port_side.publisher.indexes["app"].root \
            == jax_side.publisher.indexes["app"].root
        assert _report(port_side.publisher.push("app", tag)) \
            == _report(jax_side.publisher.push("app", tag))
    head = f"v{len(versions) - 1}"
    assert _report(port_side.puller.pull("app", "v0")) \
        == _report(jax_side.puller.pull("app", "v0"))
    pj = jax_side.puller.plan_pull("app", head)
    pp = port_side.puller.plan_pull("app", head)
    assert pp.missing == pj.missing and len(pp.missing) > 0
    assert (pp.expected_wire_bytes, pp.already_local, pp.comparisons) \
        == (pj.expected_wire_bytes, pj.already_local, pj.comparisons)
    assert _report(port_side.puller.upgrade("app")) \
        == _report(jax_side.puller.upgrade("app"))
    for side in (jax_side, port_side):
        assert side.puller.materialize("app", head) == versions[-1]
        assert side.puller.materialize("app", "v0") == versions[0]
    assert port_side.publisher.store.dedup_ratio() \
        == jax_side.publisher.store.dedup_ratio()


def test_wire_frames_byte_identical():
    data = _versions(seed=3, n_versions=1)[0]
    jc = jax_delivery.ImageClient(None, cdc_params=jax_cdc.CDCParams(**PARAMS))
    pc = port_delivery.ImageClient(None, cdc_params=port_cdc.CDCParams(**PARAMS),
                                   device="cpu")
    rj, rp = jc.commit("a", "t", data), pc.commit("a", "t", data)
    assert port_wire.encode_index(pc.indexes["a"]) \
        == jax_wire.encode_index(jc.indexes["a"])
    assert port_wire.encode_recipe(rp) == jax_wire.encode_recipe(rj)
    batch = {fp: pc.store.chunks.get(fp) for fp in rp.fps[:17]}
    assert port_wire.encode_chunk_batch(batch) \
        == jax_wire.encode_chunk_batch(batch)
    assert port_wire.encode_want(rp.fps[:9]) == jax_wire.encode_want(rj.fps[:9])
    # and each package decodes the other's frames
    assert port_wire.decode_index(jax_wire.encode_index(jc.indexes["a"])).root \
        == pc.indexes["a"].root
    assert jax_wire.decode_recipe(port_wire.encode_recipe(rp)).fps == rj.fps


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_directory_opens_in_the_other_package(tmp_path, writer):
    """A directory registry written by one package serves pulls from the
    other, which then pushes a new version the first package reads back."""
    versions = _versions(seed=11, n_versions=3, size=256 * 1024)
    sides = {"jax": (jax_delivery, jax_registry, jax_cdc, {}),
             "port": (port_delivery, port_registry, port_cdc,
                      {"device": "cpu"})}
    reader = "port" if writer == "jax" else "jax"

    def client(name, registry):
        pkg, _, cdc_mod, kw = sides[name]
        return pkg.ImageClient(pkg.LocalTransport(registry),
                               cdc_params=cdc_mod.CDCParams(**PARAMS), **kw)

    reg = sides[writer][1].Registry(directory=str(tmp_path))
    w = client(writer, reg)
    for i, data in enumerate(versions[:2]):
        w.commit("app", f"v{i}", data)
        w.push("app", f"v{i}")
    reg.close()

    reg = sides[reader][1].Registry(directory=str(tmp_path))
    r = client(reader, reg)
    assert reg.tags("app") == ["v0", "v1"]
    r.pull("app", "v1")
    assert r.materialize("app", "v1") == versions[1]
    r.commit("app", "v2", versions[2])
    r.push("app", "v2")
    reg.close()

    reg = sides[writer][1].Registry(directory=str(tmp_path))
    w2 = client(writer, reg)
    w2.pull("app", "v2")
    assert w2.materialize("app", "v2") == versions[2]
    assert w2.indexes["app"].root == r.indexes["app"].root
    reg.close()


def test_rabin_on_cuda_raises_and_runs_on_cpu():
    data = _versions(seed=5, n_versions=1, size=64 * 1024)[0]
    rabin = dict(mask_bits=9, min_size=128, max_size=4096, algorithm="rabin")
    with pytest.raises(ValueError, match="rabin.*no kernel"):
        DedupStore(cdc_params=port_cdc.CDCParams(**rabin)).ingest("a:t", data)
    port = DedupStore(cdc_params=port_cdc.CDCParams(**rabin), device="cpu")
    recipe = port.ingest("a:t", data)
    assert np.cumsum(recipe.sizes).tolist() == jax_cdc.chunk_boundaries(
        data, jax_cdc.CDCParams(**rabin))
    assert port.restore("a:t") == data


def test_bind_carries_device_and_store_device_must_match():
    c = port_delivery.ImageClient(None, device="cpu")
    reg = port_registry.Registry()
    bound = c.bind(port_delivery.LocalTransport(reg))
    assert bound.device.type == "cpu" and bound.store is c.store
    with pytest.raises(ValueError, match="store on cuda"):
        port_delivery.ImageClient(None, device="cpu", store=DedupStore())
