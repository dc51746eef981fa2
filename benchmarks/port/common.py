"""Shared harness of the port's figure scripts: registry-driven index
construction on ``repro_torch``, timing on the card, seeded inputs.

Counterpart of ``benchmarks/common.py``. Indexes come from
:func:`repro_torch.core.make_index` with an explicit ``device`` (default:
the card; ``"cpu"`` only when asked), so each figure script is a loop
over ``BENCH_KINDS`` x distributions with no per-family code. Queries go
through the facade's engine, so timed answers are exact by
construction, and :func:`timed`'s warm-up lets the engine converge its
buffer buckets before a timed rep.

PyTorch on the card is asynchronous: a call returns once its kernels are
queued. :func:`timed` therefore synchronises the device after the
warm-up and after every rep, so a rep times the work and not its
enqueue. Inputs are made with the port's seeded numpy generators
(:mod:`repro_torch.data.points`; the reference's ``jax.random`` streams
give other numbers for the same seed) and moved to the device once,
before any timing.

Port-only: every figure's ``run(..., details=dict)`` fills ``details``
with what a check needs and the timings do not say -- live sizes after
each update sequence against the size the sequence implies, kernel
launches by op (:func:`tally`), and the answers of each figure's last
timed query call on up to :data:`N_SAMPLE` sampled queries, with the
slice of the generator's points that was live (:func:`knn_detail`,
:func:`range_detail`).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import make_index
from repro_torch.core.queries import gather_points
from repro_torch.data import points as gen
from repro_torch.device import resolve_device
from repro_torch.serving.driver import KERNELS

HI = gen.DEFAULT_HI
CARD_N = 10_000_000       # the figures' size on one card
QUICK_N = 1_000_000
N_SAMPLE = 256            # queries whose answers go into ``details``
N_LISTED = 32             # of them, range lists whose points go there too
RESULTS = "results/port"

# every registered backend the figure grids sweep (cpam-* are the
# total-order ablation; spac-m is a spac-z alias and would be redundant)
BENCH_KINDS = ("porth", "spac-h", "spac-z", "cpam-h", "cpam-z", "zd", "kd")

# the spac family quantizes the generators' 20-bit coordinates (zd's
# default already does): the reference's default 30 bits put 10^7
# points on 4,096 Hilbert codes, and inserts into them overflow
COORD_BITS = (HI - 1).bit_length()
KIND_PARAMS = {kind: dict(coord_bits=COORD_BITS)
               for kind in ("spac-h", "spac-z", "cpam-h", "cpam-z")}

# warm-up calls and timed reps of :func:`timed` (``run --reps`` cuts them)
TIMING = {"warmup": 1, "reps": 3}


def build_index(kind: str, pts, *, phi: int = 32,
                capacity_points: int | None = None, device=None, **params):
    """Build one benchmark index on ``device``; capacity sized for the
    max points ever present (``capacity_points``) by the facade's shared
    heuristic. The spac family quantizes at the data's 20 bits unless
    ``params`` says otherwise."""
    kw = {**KIND_PARAMS.get(kind, {}), **params}
    return make_index(kind, pts, phi=phi, capacity_points=capacity_points,
                      device=device, **kw)


def release() -> None:
    """Hand the memory of dropped indexes back to the card between
    kinds (no-op without CUDA)."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def sync() -> None:
    """Wait for the card's queued work (no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int | None = None, reps: int | None = None,
          **kw):
    """Median wall time of ``fn(*args, **kw)`` with the device
    synchronised after the warm-up and after each rep; returns
    (seconds, the last rep's output)."""
    warmup = TIMING["warmup"] if warmup is None else warmup
    reps = TIMING["reps"] if reps is None else reps
    for _ in range(warmup):
        out = fn(*args, **kw)
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], out


def timed_once(fn, *args, **kw):
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    return time.perf_counter() - t0, out


@functools.lru_cache(maxsize=None)
def _cached_points(dist: str, n: int, seed: int, dim: int = 2):
    return gen.GENERATORS[dist](seed, n, dim)


def points_for(dist: str, n: int, seed: int = 0, dim: int = 2):
    """``n`` points of ``dist`` (host numpy, cached: do not write)."""
    return _cached_points(dist, n, seed, dim)


def knn_queries(dist: str, nq: int, seed: int = 9, dim: int = 2):
    """InD queries: drawn from the same distribution; OOD: uniform."""
    ind = gen.GENERATORS[dist](seed, nq, dim)
    ood = gen.uniform(seed + 1, nq, dim)
    return ind, ood


def on_device(x, device):
    """Host arrays to ``device`` once, before any timing (a copy from
    pageable memory inside a timed call would synchronise it)."""
    return torch.as_tensor(np.ascontiguousarray(x),
                           device=resolve_device(device))


def launch_counts() -> dict:
    return {name: mod.launch_count() for name, mod in KERNELS.items()}


@contextlib.contextmanager
def tally(into: dict | None, op: str):
    """Add the kernel launches made inside the block to ``into[op]``
    (no-op when ``into`` is None)."""
    if into is None:
        yield
        return
    before = launch_counts()
    try:
        yield
    finally:
        now = launch_counts()
        acc = into.setdefault(op, dict.fromkeys(KERNELS, 0))
        for name in KERNELS:
            acc[name] += now[name] - before[name]


def sample_rows(nq: int, n_sample: int = N_SAMPLE, seed: int = 11):
    """Sorted query rows whose answers go into ``details``."""
    if nq <= n_sample:
        return np.arange(nq)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(nq, size=n_sample, replace=False))


def live_spec(dist: str, n: int, stop: int, dim: int = 2,
              seed: int = 0) -> dict:
    """The live points, as a slice of ``points_for(dist, n, seed, dim)``."""
    return {"dist": dist, "n": int(n), "dim": int(dim), "seed": int(seed),
            "stop": int(stop)}


def knn_detail(qs, out, k: int, live: dict) -> dict:
    """The sampled queries' kNN answers ``out = (d2, ids)``."""
    qs = np.asarray(qs)
    rows = sample_rows(qs.shape[0])
    sel = torch.as_tensor(rows, device=out[0].device)
    return {"k": int(k), "live": live, "rows": rows.tolist(),
            "queries": qs[rows].tolist(),
            "d2": out[0][sel].cpu().tolist(),
            "ids": out[1][sel].cpu().tolist()}


def range_detail(idx, lo, hi, counts, live: dict, ids=None) -> dict:
    """The sampled boxes' counts and, for a range list, the listed
    points of the first :data:`N_LISTED` of them, sorted by their
    ``(x, y[, z])`` key."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    rows = sample_rows(lo.shape[0])
    sel = torch.as_tensor(rows, device=counts.device)
    out = {"live": live, "rows": rows.tolist(), "lo": lo[rows].tolist(),
           "hi": hi[rows].tolist(), "counts": counts[sel].cpu().tolist()}
    if ids is not None:
        listed = []
        first = sel[:N_LISTED]
        pts = gather_points(idx.view(), ids[first]).cpu().numpy()
        for p, i in zip(pts, ids[first].cpu().numpy()):
            keep = p[i >= 0].astype(np.int64)
            listed.append(keep[np.lexsort(keep.T[::-1])].tolist())
        out["listed"] = listed
    return out


def size_detail(idx, expected: int, before=None, deleted=None) -> list:
    """[live size, the size the update sequence implies] (one read);
    when they differ and the live points were ``before`` less
    ``deleted``, a third entry audits the difference
    (:func:`delete_audit`)."""
    got = int(idx.size)
    if got == expected or before is None:
        return [got, int(expected)]
    return [got, int(expected), delete_audit(idx, before, deleted)]


def _keys(p):
    """One int64 key a point (20 bits a coordinate)."""
    p = p.long()
    key = p[:, 0]
    for d in range(1, p.shape[1]):
        key = (key << COORD_BITS) | p[:, d]
    return key


def delete_audit(idx, before, deleted) -> dict:
    """The live multiset against ``before`` less ``deleted``: points left
    over (``extra``) and points gone that should not be (``missing``).
    The reference's spac delete leaves points behind at scale (ROADMAP
    queue 3); a lost point would be a fault of another kind."""
    tree = idx.tree
    live = _keys(tree.pts[tree.valid & tree.active[:, None]])
    b, d = _keys(before), _keys(deleted)
    keys = torch.cat([b, d, live])
    weight = torch.cat([torch.ones_like(b), -torch.ones_like(d),
                        -torch.ones_like(live)])
    uniq, inv = torch.unique(keys, return_inverse=True)
    net = torch.zeros(uniq.shape[0], dtype=torch.long,
                      device=keys.device).index_add_(0, inv, weight)
    return {"extra": int((-net).clamp(min=0).sum()),
            "missing": int(net.clamp(min=0).sum())}


def peak_bytes(reset: bool = False) -> int | None:
    """The allocator's peak since the last reset (None without CUDA)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    peak = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return int(peak)


def write_json(path: str, payload: dict, what: str) -> None:
    """One baseline-writing recipe for every ``--json`` flag, so the
    payloads under ``results/port/`` share a stable shape."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    print(f"wrote {what} -> {path}")


def device_name(device) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def fmt_row(name, cells, w=9):
    return name.ljust(10) + " ".join(
        (f"{c:{w}.3f}" if isinstance(c, float) else str(c).rjust(w))
        for c in cells)
