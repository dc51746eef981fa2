"""Port parity: ``repro_torch.core.distributed`` and the
``DistributedIndex`` facade against ``repro.core.distributed`` on a
simulated 8-lane mesh.

One reference child process (``helpers.run_on_simulated_mesh``, 8 forced
host devices) runs the whole lifecycle for spac-h, spac-z and porth on
numpy inputs from a seed in the tie-free window (integer coordinates
below 2^10, no distance tie among any query's k+1 nearest) and writes
an ``.npz``: splitters, per-shard tree arrays, ``dropped`` and shard
sizes after a build (ragged and masked), an insert, a delete and an
insert whose routing slab overflows; kNN distances and points on the
reference's frontier and flat routes; range counts. The port on
``simulate_mesh(8, device="cpu")`` must equal all of it bit for bit.

The port-only cases follow ``tests/test_distributed.py``: the lifecycle
against brute force and an int64 count, shard balance, and a sweepline
batch whose tight routing slab reports drops. Then the facade (kinds,
errors, re-shard and slack recovery), the collectives, the plan
counters, and a sync-free dispatch-only insert.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import run_on_simulated_mesh
from repro_torch import obs
from repro_torch.configs import platform
from repro_torch.core import distributed as D
from repro_torch.core import engine, make_index
from repro_torch.core.index import DistributedIndex
from repro_torch.data import points as gen

torch.set_num_threads(1)

LANES = 8
PHI = 8
N, M, Q, K, B = 1020, 250, 16, 5, 8     # ragged: N and M pad to 8 lanes
COORD_HI = 1 << 10
KINDS = {"spac-h": dict(kind="spac", curve="hilbert", coord_bits=10),
         "spac-z": dict(kind="spac", curve="morton", coord_bits=10),
         "porth": dict(kind="porth", root_lo=(0, 0),
                       root_hi=(COORD_HI, COORD_HI))}
STAGES = ("build", "insert", "delete", "tight")


def _tie_free_inputs() -> dict:
    """Points and queries with no tie among any query's K+1 nearest
    squared distances, so the merged answers are unique."""
    for seed in range(64):
        rng = np.random.default_rng(seed)
        pts = rng.integers(0, COORD_HI, (N, 2)).astype(np.int32)
        newp = rng.integers(0, COORD_HI, (M, 2)).astype(np.int32)
        qs = rng.integers(0, COORD_HI, (Q, 2)).astype(np.int32)
        live = np.concatenate([pts[M:N - 20], newp]).astype(np.int64)
        d2 = np.sort(((live[None] - qs[:, None].astype(np.int64)) ** 2
                      ).sum(-1), 1)[:, :K + 1]
        if (np.diff(d2, axis=1) > 0).all():
            lo = rng.integers(0, COORD_HI - 200, (B, 2)).astype(np.int32)
            # a skewed batch: one corner, so one shard takes all of it
            skew = rng.integers(0, 64, (M, 2)).astype(np.int32)
            mask = np.ones(N, bool)
            mask[N - 20:] = False
            return dict(pts=pts, mask=mask, newp=newp, qs=qs, lo=lo,
                        hi=lo + 160, skew=skew)
    raise AssertionError("no tie-free seed found")


INPUTS = _tie_free_inputs()

REF_SCRIPT = r"""
import jax.numpy as jnp, numpy as np
from repro.core import distributed as D
inp = dict(np.load({inp!r}))
KINDS = {kinds!r}
out = {{}}
for name, kw in KINDS.items():
    idx = D.build(jnp.asarray(inp["pts"]), mesh, jnp.asarray(inp["mask"]),
                  phi={phi}, **kw)
    ins = D.insert(idx, jnp.asarray(inp["newp"]), mesh)
    dele = D.delete(ins, jnp.asarray(inp["pts"][:{m}]), mesh)
    tight = D.insert(idx, jnp.asarray(inp["skew"]), mesh, slack=0.25)
    for st, ix in (("build", idx), ("insert", ins), ("delete", dele),
                   ("tight", tight)):
        for f, a in vars(ix.tree).items():
            if hasattr(a, "shape"):
                out[f"{{name}}/{{st}}/tree/{{f}}"] = np.asarray(a)
        out[f"{{name}}/{{st}}/splitters"] = np.asarray(ix.splitters)
        out[f"{{name}}/{{st}}/dropped"] = np.asarray(ix.dropped)
        out[f"{{name}}/{{st}}/shard_sizes"] = np.asarray(D.shard_sizes(ix))
    for impl in ("frontier", "flat"):
        d2, bp, ok = D.knn(dele, jnp.asarray(inp["qs"]), {k}, mesh,
                           impl=impl, kernel="ref")
        out[f"{{name}}/knn/{{impl}}/d2"] = np.asarray(d2)
        out[f"{{name}}/knn/{{impl}}/pts"] = np.asarray(bp)
        out[f"{{name}}/knn/{{impl}}/ok"] = np.asarray(ok)
    cnt, trunc = D.range_count(dele, jnp.asarray(inp["lo"]),
                               jnp.asarray(inp["hi"]), mesh, max_rows=256)
    out[f"{{name}}/range/count"] = np.asarray(cnt)
    out[f"{{name}}/range/trunc"] = np.asarray(trunc)
np.savez({out!r}, **out)
print("REF_DIST_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers on the simulated 8-device mesh (one child
    process for the whole file)."""
    tmp = tmp_path_factory.mktemp("dist")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **INPUTS)
    run_on_simulated_mesh(REF_SCRIPT.format(inp=inp, out=out, kinds=KINDS,
                                            phi=PHI, m=M, k=K), LANES,
                          timeout_base_s=300, expect="REF_DIST_OK")
    return dict(np.load(out))


@pytest.fixture(scope="module")
def mesh():
    return platform.simulate_mesh(LANES, device="cpu")


@pytest.fixture(scope="module")
def port(mesh):
    """The port's indexes for each kind and stage."""
    t = {k: torch.as_tensor(v) for k, v in INPUTS.items()}
    out = {}
    for name, kw in KINDS.items():
        idx = D.build(t["pts"], mesh, t["mask"], phi=PHI, **kw)
        ins = D.insert(idx, t["newp"], mesh)
        dele = D.delete(ins, t["pts"][:M], mesh)
        tight = D.insert(idx, t["skew"], mesh, slack=0.25)
        out[name] = dict(build=idx, insert=ins, delete=dele, tight=tight)
    return out


def _equal(got, want, what: str):
    got = np.asarray(got)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_shards_bit_equal_to_the_reference(ref, port, kind, stage):
    ix = port[kind][stage]
    pre = f"{kind}/{stage}"
    fields = [t.to_numpy() for t in ix.tree]
    for f in fields[0]:
        _equal(np.stack([lane[f] for lane in fields]),
               ref[f"{pre}/tree/{f}"], f"{pre} {f}")
    _equal(ix.splitters, ref[f"{pre}/splitters"], f"{pre} splitters")
    _equal(ix.dropped, ref[f"{pre}/dropped"], f"{pre} dropped")
    _equal(D.shard_sizes(ix), ref[f"{pre}/shard_sizes"], f"{pre} sizes")
    sizes = ref[f"{pre}/shard_sizes"]
    assert (sizes > 0).all() or stage == "tight", sizes
    if stage == "tight":
        assert int(ix.dropped) > 0      # the tight slab reports drops


@pytest.mark.parametrize("route,ref_route", [
    ("frontier", "frontier"), ("frontier-kernel", "frontier"),
    ("flat", "flat")])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_knn_bit_equal_to_the_reference(ref, port, kind, route, ref_route):
    d2, pts, ok = D.knn(port[kind]["delete"], torch.as_tensor(INPUTS["qs"]),
                        K, None, impl=route, kernel="plain")
    for name, got in (("d2", d2), ("pts", pts), ("ok", ok)):
        _equal(got, ref[f"{kind}/knn/{ref_route}/{name}"],
               f"{kind} {route} {name}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_range_count_bit_equal_to_the_reference(ref, port, kind):
    cnt, trunc = D.range_count(port[kind]["delete"],
                               torch.as_tensor(INPUTS["lo"]),
                               torch.as_tensor(INPUTS["hi"]), None, 256)
    _equal(cnt, ref[f"{kind}/range/count"], f"{kind} counts")
    _equal(trunc, ref[f"{kind}/range/trunc"], f"{kind} truncated")
    live = np.concatenate([INPUTS["pts"][M:N - 20], INPUTS["newp"]])
    inside = ((live[None] >= INPUTS["lo"][:, None])
              & (live[None] <= INPUTS["hi"][:, None])).all(-1)
    np.testing.assert_array_equal(cnt.numpy(), inside.sum(-1))


# ------------------------------------------------- port-only: the lifecycle

def _brute_d2(live, qs, k):
    diff = torch.as_tensor(live).float()[None] - \
        torch.as_tensor(qs).float()[:, None]
    return torch.sort((diff * diff).sum(-1), dim=1).values[:, :k]


def _int64_count(live, lo, hi):
    live = live.astype(np.int64)
    return ((live[None] >= lo[:, None]) & (live[None] <= hi[:, None])
            ).all(-1).sum(-1)


def test_lifecycle_against_brute_force(mesh):
    pts = gen.uniform(0, 4096, 2)
    idx = D.build(torch.as_tensor(pts), mesh, phi=8)
    assert int(idx.dropped) == 0 and int(D.size(idx)) == 4096
    newp = gen.uniform(1, 1024, 2)
    idx = D.insert(idx, torch.as_tensor(newp), mesh)
    assert int(idx.dropped) == 0 and int(D.size(idx)) == 5120
    idx2 = D.delete(idx, torch.as_tensor(pts[:1024]), mesh)
    assert int(D.size(idx2)) == 4096

    allp = np.concatenate([pts, newp])
    qs = gen.uniform(2, 24, 2)
    d2, bp, ok = D.knn(idx, torch.as_tensor(qs), 5, mesh)
    assert torch.equal(d2, _brute_d2(allp, qs, 5)) and bool(ok.all())
    lo, hi = gen.query_boxes(3, 8, 2, gen.DEFAULT_HI // 8)
    cnt, trunc = D.range_count(idx, torch.as_tensor(lo), torch.as_tensor(hi),
                               mesh, 2048)
    assert not bool(trunc.any())
    np.testing.assert_array_equal(cnt.numpy(), _int64_count(allp, lo, hi))

    # uniform data spreads over every shard (the quantile sample is not
    # polluted by pad sentinels)
    sizes = D.shard_sizes(idx)
    assert int(sizes.min()) > 0 and int(sizes.sum()) == int(D.size(idx))

    # skewed routing (sweepline): slab overflow is detected, and a
    # larger slack absorbs it
    sw = torch.as_tensor(gen.sweepline(4, 4096, 2))
    idx3 = D.build(sw, mesh, phi=8, slack=8.0)
    assert int(idx3.dropped) == 0
    batch = sw[:512]
    assert int(D.insert(idx3, batch, mesh, slack=8.0).dropped) == 0
    assert int(D.insert(idx3, batch, mesh, slack=0.25).dropped) > 0


# ------------------------------------------------------- port-only: facade

@pytest.mark.parametrize("kind", ["spac-h", "spac-z", "spac-m", "porth"])
def test_facade_answers_equal_a_local_index(mesh, kind):
    pts = gen.uniform(5, 3000, 2)
    idx = make_index(kind, pts, mesh=mesh, phi=8)
    assert isinstance(idx, DistributedIndex)
    assert len(idx) == 3000 and int(idx.dropped) == 0
    assert len(idx.tree) == LANES
    local = make_index(kind, pts, phi=8, device="cpu")
    qs = gen.uniform(6, 32, 2)
    want, _ = local.knn(qs, 10)
    for impl in ("auto", "frontier", "plain-frontier", "plain"):
        d2, nbrs, ok = idx.knn(qs, 10, impl=impl)
        assert torch.equal(d2, want), impl
        re = ((nbrs.float() - torch.as_tensor(qs).float()[:, None]) ** 2
              ).sum(-1)
        assert torch.equal(re, d2), impl
    lo, hi = gen.query_boxes(7, 16, 2, gen.DEFAULT_HI // 8)
    assert torch.equal(idx.range_count(lo, hi).long(),
                       local.range_count(lo, hi).long())
    idx = idx.insert(gen.uniform(8, 500, 2)).delete(pts[:700])
    assert len(idx) == 2800
    got, ok = idx.extract_points()
    assert int(ok.sum()) == 2800
    assert idx.nbytes > 0 and idx.device == torch.device("cpu")


def test_facade_errors(mesh):
    pts = gen.uniform(0, 256, 2)
    for kind in ("cpam-h", "cpam-z", "kd", "zd"):
        with pytest.raises(ValueError, match="mesh-capable"):
            make_index(kind, pts, mesh=mesh)
    with pytest.raises(ValueError, match="donate"):
        make_index("spac-h", pts, mesh=mesh, donate=True)
    with pytest.raises(TypeError, match="unknown params"):
        make_index("spac-h", pts, mesh=mesh, lam=3)
    with pytest.raises(TypeError, match="unknown params"):
        make_index("porth", pts, mesh=mesh, curve="hilbert")


def test_facade_recovers_overflow_and_routing_drops(mesh):
    pts = gen.uniform(0, 1024, 2)
    # tight per-shard rows: the checked insert re-shards at doubled
    # capacity and keeps every point
    idx = make_index("spac-h", pts, mesh=mesh, phi=8, capacity_rows=24)
    rows = idx.tree[0].pts.shape[0]
    big = gen.uniform(1, 2048, 2)
    idx = idx.insert(big)
    assert len(idx) == 3072 and idx.tree[0].pts.shape[0] > rows
    assert not bool(idx.overflowed.any())
    # a skewed batch at a tight slack: the checked insert and delete
    # escalate slack until nothing is dropped
    sw = gen.sweepline(2, 4096, 2)
    idx = make_index("spac-h", sw, mesh=mesh, phi=8, slack=8.0)
    idx.slack = 0.25
    grown = idx.insert(sw[:512])
    assert len(grown) == 4608 and int(grown.dropped) == 0
    assert grown.slack > 0.25
    shrunk = grown.delete(sw[:512])
    assert len(shrunk) == 4096 and int(shrunk.dropped) == 0


def test_porth_float_domain(mesh):
    pts = (gen.uniform(0, 2048, 2) / gen.DEFAULT_HI).astype(np.float32)
    idx = make_index("porth", pts, mesh=mesh, phi=8)
    assert len(idx) == 2048 and idx.tree[0].pts.dtype == torch.float32
    local = make_index("porth", pts, phi=8, device="cpu")
    qs = (gen.uniform(1, 16, 2) / gen.DEFAULT_HI).astype(np.float32)
    assert torch.equal(idx.knn(qs, 5)[0], local.knn(qs, 5)[0])


# -------------------------------------------------- mesh and collectives

def test_mesh_and_no_fallback(monkeypatch):
    m = platform.simulate_mesh(3, device="cpu")
    assert m.shape == {"data": 3} and m.size == 3
    assert m.devices == (torch.device("cpu"),) * 3
    assert platform.make_mesh(["cpu", "cpu"]).shape == {"data": 2}
    with pytest.raises(ValueError):
        platform.simulate_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform.simulate_mesh(2)


def test_collectives(mesh):
    S = LANES
    blocks = [torch.arange(S * 3).view(S, 3) + 100 * src for src in range(S)]
    recv = D.all_to_all(blocks, mesh)
    for dst in range(S):
        want = torch.cat([blocks[src][dst] for src in range(S)])
        assert torch.equal(recv[dst], want)     # source lane, then slot
    got = D.all_gather([torch.tensor([i, -i]) for i in range(S)], mesh)
    assert len(got) == S and all(torch.equal(g, got[0]) for g in got)
    assert got[0].tolist() == [v for i in range(S) for v in (i, -i)]
    s = D.psum([torch.tensor(i, dtype=torch.int32) for i in range(S)])
    assert int(s) == S * (S - 1) // 2 and s.dtype == torch.int32


def test_pack_drops_past_capacity():
    pts = torch.arange(20, dtype=torch.int32).view(10, 2)
    mask = torch.ones(10, dtype=torch.bool)
    mask[3] = False
    bucket = torch.tensor([1, 0, 1, 1, 1, 2, 0, 1, 2, 2], dtype=torch.int32)
    send, ok, dropped = D._pack(pts, mask, bucket, 3, 2)
    assert int(dropped) == 3    # buckets 1 and 2 hold 4 and 3 live rows
    assert ok.tolist() == [True, True, True, True, True, True]
    assert send.tolist() == [[2, 3], [12, 13], [0, 1], [4, 5],
                             [10, 11], [16, 17]]


def test_plan_counters_and_trace_bound(mesh):
    pts = torch.as_tensor(gen.uniform(0, 1024, 2))
    with obs.recording(obs.Recorder()) as rec:
        idx = D.build(pts, mesh, phi=8, slack=3.0)
        b = torch.as_tensor(gen.uniform(1, 128, 2))
        idx = D.insert(idx, b, mesh, slack=3.0)
        first = dict(rec.counters)
        idx = D.insert(idx, torch.as_tensor(gen.uniform(2, 128, 2)), mesh,
                       slack=3.0)
        assert rec.counters == first    # same plan, same signature
        engine.reset_trace_count()
        D.knn(idx, pts[:8], 3, mesh)
        D.knn(idx, pts[8:16], 3, mesh)
        assert engine.trace_count() == 1
    assert first["dist.plan_miss"] >= 2
    assert first["dist.update_trace"] >= 2


@pytest.mark.parametrize("kind", ["spac-h", "porth"])
def test_insert_unchecked_reads_nothing_back(mesh, kind, monkeypatch):
    idx = make_index(kind, gen.uniform(0, 2048, 2), mesh=mesh, phi=8)
    batch = torch.as_tensor(gen.uniform(1, 256, 2))
    idx.insert_unchecked(batch)          # plans and root corners made

    def refuse(*args, **kw):
        raise AssertionError("host read on the dispatch path")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = idx.insert_unchecked(batch)
    monkeypatch.undo()
    assert len(out) == 2048 + 256
