#!/usr/bin/env python3
"""Drive repro_torch's delivery main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (the CUDA
toolkit's ``nvcc`` must be on PATH or under CUDA_HOME).  Phases, one line of
output each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every kernel under ``src/repro_torch/kernels/csrc``;
2. kernel parity: each CUDA kernel against its plain PyTorch version on the
   card and against the host numpy gear hash, bit for bit;
3. the main path at a real size: one lineage of container-image versions of
   about 1.1 GB (the Table I size of nginx), committed and pushed by one
   ``ImageClient`` over ``WireTransport``, pulled and upgraded by another;
4. main-path parity: every committed version's chunk ends against the plain
   version's on the card;
5. where a commit's time goes, at 1 GiB;
6. the ``{"kernels": [...]}`` line;
7. last, ``{"ok": true, "device": {...}}``.

Any mismatch or exception exits non-zero before the last line.  Without a
CUDA card, or without the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# The scan is integer work.  The H100 SXM has 64 INT32 lanes on each of its
# 132 SMs (Hopper architecture whitepaper) at a boost clock of 1.98 GHz.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations per input byte in gear_cdc.cu's walk: byte extract,
# shift, add (hash mode), then mask, test and count (candidate mode).
HASH_OPS_PER_BYTE, CAND_OPS_PER_BYTE = 3, 6
KERNEL_SOURCES = ("gear_cdc",)
TIMED_BYTES = 1 << 30


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The image lineage: benchmarks/corpus.py's model (zipf dictionary words,
# ~20% incompressible 512-byte spans, nginx's churn profile), vectorised.
# ---------------------------------------------------------------------------

NGINX_KB, NGINX_LAYERS = 1100, 3          # Table I, scaled down x1000
NGINX_CHURN = (5, 0.25, 0.06)             # edits per patch, p_minor, churn
IMAGE_BYTES = NGINX_KB * 1024 * 1000      # v0: nginx's Table I size
VERSIONS = 4                              # nginx has 19; depth cut to 4


def _zipf_residue_cdf(a: float = 1.35, words: int = 512) -> np.ndarray:
    """CDF of ``zipf(a) % words``, the corpus's word choice."""
    k = np.arange(1, 1 << 22, dtype=np.float64)
    pmf = np.bincount((k % words).astype(np.int64), weights=k ** -a,
                      minlength=words)
    pmf += (k[-1] ** (1 - a) / (a - 1)) / words    # the tail, spread evenly
    return np.cumsum(pmf / pmf.sum())


class ImageModel:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.dictionary = np.random.default_rng(seed % 7).integers(
            97, 123, size=(512, 11), dtype=np.uint8)
        self.cdf = _zipf_residue_cdf()

    def text_block(self, n: int) -> bytes:
        rng = self.rng
        m = n // 12 + 1
        idx = np.minimum(np.searchsorted(self.cdf, rng.random(m)), 511)
        words = np.empty((m, 12), dtype=np.uint8)
        words[:, :11] = self.dictionary[idx]
        words[:, 11] = 32
        blob = words.reshape(-1)[:n].copy()
        if n >= 256:
            spans = max(1, int(n * rng.uniform(0.12, 0.32) / 512))
            step = 1 << 16
            for s in range(0, spans, step):
                k = min(step, spans - s)
                pos = rng.integers(0, max(1, n - 512), size=k)
                idx = (pos[:, None] + np.arange(512)).reshape(-1)
                idx = idx[idx < n]
                blob[idx] = rng.integers(0, 256, size=idx.size,
                                         dtype=np.uint8)
        return blob.tobytes()

    def lineage(self, versions: int, image_bytes: int):
        rng = self.rng
        edits, p_minor, churn = NGINX_CHURN
        sizes = rng.dirichlet(np.ones(NGINX_LAYERS) * 2.0) * image_bytes
        layers = [bytearray(self.text_block(max(2048, int(s))))
                  for s in sizes]
        out = [b"".join(layers)]
        for _ in range(1, versions):
            minor = rng.random() < p_minor
            n_layers = max(1, int(len(layers) * (0.5 if minor else 0.25)))
            for li in rng.choice(len(layers), size=n_layers, replace=False):
                layer = layers[li]
                for _ in range(max(1, int(edits * (2 if minor else 1)))):
                    kind = rng.random()
                    pos = int(rng.integers(0, max(1, len(layer) - 64)))
                    size = int(rng.integers(
                        16, max(32, int(len(layer) * churn / edits))))
                    patch = self.text_block(size)
                    if kind < 0.6:
                        layer[pos:pos + size] = patch[:min(size,
                                                           len(layer) - pos)]
                    elif kind < 0.85:
                        layer[pos:pos] = patch
                    else:
                        del layer[pos:pos + size]
            if minor and rng.random() < 0.7:
                size = int(np.mean([len(l) for l in layers])
                           * rng.uniform(0.3, 1.0))
                new = bytearray(self.text_block(size))
                if rng.random() < 0.5 and len(layers) > 2:
                    layers[int(rng.integers(0, len(layers)))] = new
                else:
                    layers.append(new)
            out.append(b"".join(layers))
        return out


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def bound_ms(bytes_moved: int, ops: int) -> tuple:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(torch) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = {name: build.build(name) for name in KERNEL_SOURCES}
    seconds = time.perf_counter() - t0
    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; "
          f"kernels {list(KERNEL_SOURCES)} built in {seconds:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")


def _parity_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed + n)
    yield "random", rng.integers(0, 256, n, dtype=np.uint8)
    yield "zero", np.zeros(n, dtype=np.uint8)
    yield "periodic", np.resize(np.frombuffer(
        b"GET /v2/library/nginx/blobs/sha256 HTTP/1.1\r\n", np.uint8), n)


def phase_kernel_parity(torch, seed: int) -> int:
    """Kernel == plain version == host hash at every length and mode; returns
    the largest absolute difference seen (0 when bit-equal)."""
    from repro_torch.core import cdc
    from repro_torch.kernels import gear_cdc, ref
    t0 = time.perf_counter()
    lengths = [1, 31, 32, 33, 16383, 16384, 16385, 5 * 2**20 + 12345,
               64 * 2**20]
    worst = 0
    cases = 0
    for n in lengths:
        for kind, raw in _parity_inputs(n, seed):
            data = torch.from_numpy(raw).cuda()
            views = [("", data)]
            if 1 < n < lengths[-1]:
                views.append((" unaligned", data[1:]))
            for tag, t in views:
                host = cdc.gear_hash_stream(t.cpu().numpy())
                h = gear_cdc.gear_hash(t).view(torch.int32)
                plain = ref.gear_hash_bits(t)
                torch.cuda.synchronize()
                worst = max(worst, int((h.long() - plain.long()).abs().max()),
                            int(np.abs(h.cpu().numpy().view(np.uint32)
                                       .astype(np.int64) - host).max()))
                check(torch.equal(h, plain), f"hash n={n} {kind}{tag}")
                check(np.array_equal(h.cpu().numpy().view(np.uint32), host),
                      f"hash vs host n={n} {kind}{tag}")
                for mask_bits in (6, 12):
                    c = gear_cdc.gear_candidates(t, mask_bits)
                    want = ref.boundary_candidates_ref(t, mask_bits)
                    torch.cuda.synchronize()
                    check(c.shape == want.shape and torch.equal(c, want),
                          f"candidates n={n} {kind}{tag} bits={mask_bits}")
                    check(np.array_equal(c.cpu().numpy(), np.flatnonzero(
                        (host & np.uint32((1 << mask_bits) - 1)) == 0)),
                        f"candidates vs host n={n} {kind}{tag}")
                cases += 1
    print(f"kernel parity: gear_cdc == plain version == host gear hash on "
          f"{cases} inputs (lengths {lengths}; random, zero, periodic; "
          f"aligned and unaligned), hash and candidate modes at mask_bits "
          f"6 and 12; max abs err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def _report(r) -> str:
    return (f"wire {r.total_wire_bytes} bytes (index {r.index_bytes}, "
            f"recipe {r.recipe_bytes}, want {r.want_bytes}, chunks "
            f"{r.chunk_bytes}), chunks {r.chunks_moved}/{r.chunks_total}")


def phase_main_path(torch, versions):
    """Client A commits and pushes every version over WireTransport; client
    B pulls v0, upgrades to the head and materializes both."""
    from repro_torch.core.registry import Registry
    from repro_torch.delivery import (ImageClient, RegistryServer,
                                      WireTransport)
    from repro_torch.kernels import gear_cdc
    server = RegistryServer(Registry())
    a = ImageClient(WireTransport(server))
    b = ImageClient(WireTransport(server))
    tags = [f"v{i}" for i in range(len(versions))]
    seconds = {"commit": 0.0, "push": 0.0}
    lines = []
    gear_cdc.gear_hash.launches = 0
    gear_cdc.gear_candidates.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    for tag, data in zip(tags, versions):
        t0 = time.perf_counter()
        a.commit("image", tag, data)
        t1 = time.perf_counter()
        rep = a.push("image", tag)
        t2 = time.perf_counter()
        seconds["commit"] += t1 - t0
        seconds["push"] += t2 - t1
        lines.append(f"push {tag}: {_report(rep)}; commit {t1 - t0:.3f} s, "
                     f"push {t2 - t1:.3f} s")
    for name, fn in (("pull_v0", lambda: b.pull("image", tags[0])),
                     ("materialize_v0",
                      lambda: b.materialize("image", tags[0])),
                     ("upgrade", lambda: b.upgrade("image")),
                     ("materialize_head",
                      lambda: b.materialize("image", tags[-1]))):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        if name.startswith("materialize"):
            want = versions[0] if name.endswith("v0") else versions[-1]
            check(out == want, f"{name} byte-identical")
        else:
            lines.append(f"{name}: {_report(out)}, raw {out.raw_bytes}")
    total = time.perf_counter() - t_all
    launches = gear_cdc.gear_candidates.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == len(versions),
          f"gear_cdc launches {launches} == commits {len(versions)}")
    chunks = [len(a.store.recipes[f"image:{t}"].fps) for t in tags]
    print(f"main path: {len(versions)} versions of "
          f"{[len(v) for v in versions]} bytes in {total:.3f} s; chunks "
          f"{chunks}; dedup ratio {a.store.dedup_ratio():.4f}; gear_cdc "
          f"launches {launches} for {len(versions)} commits; device peak "
          f"{peak} bytes; materialized v0 and head byte-identical; seconds "
          f"{json.dumps(seconds)}")
    for line in lines:
        print("  " + line)
    return a, tags, launches


def phase_main_path_parity(torch, client, tags, versions) -> None:
    """For every version: the kernel's candidates equal the plain mask's
    nonzero positions, and the committed chunk ends equal what the plain
    version plus ``boundaries_from_mask`` give, all on the card."""
    from repro_torch.core import cdc
    from repro_torch.kernels import gear_cdc, ref
    from repro_torch.kernels.ops import bytes_tensor
    t0 = time.perf_counter()
    params = client.store.cdc_params
    candidates = []
    for tag, data in zip(tags, versions):
        t = bytes_tensor(data).cuda()
        mask = ref.boundary_mask_ref(t, params.mask_bits).cpu().numpy()
        cand = gear_cdc.gear_candidates(t, params.mask_bits).cpu().numpy()
        check(np.array_equal(cand, np.flatnonzero(mask)),
              f"gear_cdc candidates of {tag} == plain mask's positions")
        candidates.append(cand.size)
        want = cdc.boundaries_from_mask(mask, params)
        got = np.cumsum(client.store.recipes[f"image:{tag}"].sizes).tolist()
        check(got == want, f"committed chunk ends of {tag} == plain version")
        del t, mask
    print(f"main-path parity: gear_cdc candidates ({candidates}) == plain "
          f"mask's positions, and committed chunk ends == plain version + "
          f"boundaries_from_mask, on the card for {tags} "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_timing(torch, image: bytes) -> dict:
    from repro_torch.core import cdc, hashing
    from repro_torch.core.cdmt import CDMT
    from repro_torch.kernels import gear_cdc, ref
    from repro_torch.kernels.ops import bytes_tensor
    params = cdc.DEFAULT_PARAMS
    data = image[:TIMED_BYTES]
    n = len(data)
    host = bytes_tensor(data)
    h2d_ms, t = host_ms(lambda: (host.cuda(), torch.cuda.synchronize())[0])
    cand_ms = cuda_ms(torch, lambda: gear_cdc.gear_candidates(
        t, params.mask_bits), 20)
    hash_ms = cuda_ms(torch, lambda: gear_cdc.gear_hash(t), 20)
    plain_ms = cuda_ms(torch, lambda: ref.boundary_candidates_ref(
        t, params.mask_bits), 3)
    cand = gear_cdc.gear_candidates(t, params.mask_bits)
    plain = ref.boundary_candidates_ref(t, params.mask_bits)
    check(torch.equal(cand, plain), f"gear_cdc candidates == plain at {n}")
    del plain
    d2h_ms, ends = host_ms(lambda: cand.cpu().numpy() + 1)
    minmax_ms, cuts = host_ms(lambda: cdc.boundaries_from_candidates(
        ends, n, params))

    def fingerprints():
        start, fps = 0, []
        for end in cuts:
            fps.append(hashing.chunk_fingerprint(data[start:end]))
            start = end
        return fps
    blake_ms, fps = host_ms(fingerprints)
    cdmt_ms, _ = host_ms(lambda: CDMT.build(fps))
    # least work: read every byte once, write each output once, and the
    # walk's integer operations on every byte once
    cand_bound, cand_by = bound_ms(n + 8 * cand.numel(),
                                   CAND_OPS_PER_BYTE * n)
    hash_bound, hash_by = bound_ms(n + 4 * n, HASH_OPS_PER_BYTE * n)
    out = {"n": n, "candidates": int(cand.numel()), "chunks": len(cuts),
           "cand_ms": cand_ms, "cand_bound_ms": cand_bound,
           "bound_by": cand_by, "hash_ms": hash_ms,
           "hash_bound_ms": hash_bound, "hash_bound_by": hash_by,
           "plain_ms": plain_ms,
           "h2d_ms": h2d_ms, "d2h_ms": d2h_ms, "minmax_ms": minmax_ms,
           "blake2b_ms": blake_ms, "cdmt_build_ms": cdmt_ms,
           "library_ms": None}
    print(f"where the time goes at {n} bytes (bounds at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s HBM and {INT32_OPS_PER_S / 1e12} "
          f"T INT32 op/s): {json.dumps(out)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1009,
                    help="seed of the image lineage (nginx's corpus seed)")
    args = ap.parse_args(argv)
    if not (REPO / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build(torch)
    worst = phase_kernel_parity(torch, args.seed)
    t0 = time.perf_counter()
    versions = ImageModel(args.seed).lineage(VERSIONS, IMAGE_BYTES)
    print(f"generated {len(versions)} versions from seed {args.seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    client, tags, launches = phase_main_path(torch, versions)
    phase_main_path_parity(torch, client, tags, versions)
    timing = phase_timing(torch, versions[0])
    kernels = [{
        "name": "gear_cdc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gear_cdc.cu",
        "replaces": "src/repro/kernels/gear_cdc.py:50",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["cand_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["cand_bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
