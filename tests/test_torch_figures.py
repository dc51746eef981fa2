"""``benchmarks.port`` (the figure scripts on ``repro_torch``) against
``benchmarks`` (the reference's, on ``repro``): both packages' point,
query and box sources are monkeypatched to return one set of numpy
arrays, both figures run, and the port's ``details`` (live sizes after
each update sequence, kNN ``(d2, ids)``, range counts and listed points)
must equal the reference facade's answers on the same arrays, captured
from the reference's own timed calls. Coordinates lie below 2^10 (the
exact-arithmetic window of ``tests/test_queries_parity.py``): distances
are bit-equal everywhere, ids on every query without a distance tie at
its k-th neighbour."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import fig3_grid as jfig3
from benchmarks import fig4_knn as jfig4
from benchmarks import fig5_range as jfig5
from benchmarks import fig9_3d as jfig9
from benchmarks import fig10_batch as jfig10
from benchmarks.port import common, fig3_grid, fig4_knn, fig5_range, fig9_3d
from benchmarks.port import fig10_batch
from repro_torch.data import points as gen

torch.set_num_threads(1)

COORD_HI = 1 << 10
N, NQ = 600, 12
DEV = "cpu"


def _arrays(dim: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, COORD_HI, size=(N, dim)).astype(np.int32)
    extra = rng.integers(0, COORD_HI, size=(N, dim)).astype(np.int32)
    ind = rng.integers(0, COORD_HI, size=(NQ, dim)).astype(np.int32)
    ood = rng.integers(0, COORD_HI, size=(NQ, dim)).astype(np.int32)
    lo = rng.integers(0, COORD_HI - 300, size=(NQ, dim)).astype(np.int32)
    hi = lo + rng.integers(0, 300, size=(NQ, dim)).astype(np.int32)
    return {"pts": pts, "extra": extra, "ind": ind, "ood": ood,
            "lo": lo, "hi": hi}


class Sources:
    """One set of arrays behind both packages' sources, and the
    reference's timed outputs and built indexes in call order."""

    def __init__(self, monkeypatch, dim: int = 2, seed: int = 0):
        self.a = _arrays(dim, seed)
        self.ref_out: list = []
        self.ref_idx: list = []

        def points_for(dist, n, seed=0, dim=dim):
            src = self.a["extra"] if seed == 5 or seed == 3 else self.a["pts"]
            assert n <= src.shape[0]
            return src[:n]

        def knn_queries(dist, nq, seed=9, dim=dim):
            return self.a["ind"][:nq], self.a["ood"][:nq]

        def boxes(*args, **kw):
            return self.a["lo"], self.a["hi"]

        def ref_timed(fn, *args, warmup=1, reps=3, **kw):
            out = fn(*args, **kw)
            self.ref_out.append(out)
            return 1e-3, out

        def ref_timed_once(fn, *args, **kw):
            out = fn(*args, **kw)
            self.ref_out.append(out)
            return 1e-3, out

        ref_build = jcommon.build_index

        def ref_build_index(kind, pts, **kw):
            # the port's figures build the spac family at 20 bits
            idx = ref_build(kind, pts, **{**common.KIND_PARAMS.get(kind, {}),
                                          **kw})
            self.ref_idx.append(idx)
            return idx

        for mod in (jcommon, common):
            monkeypatch.setattr(mod, "points_for", points_for)
            monkeypatch.setattr(mod, "knn_queries", knn_queries)
        for mod in (jfig3, jfig5, fig3_grid, fig5_range):
            monkeypatch.setattr(mod, "query_boxes", boxes)
        monkeypatch.setattr(jcommon, "timed", ref_timed)
        monkeypatch.setattr(jcommon, "timed_once", ref_timed_once)
        monkeypatch.setattr(jcommon, "build_index", ref_build_index)
        monkeypatch.setitem(common.TIMING, "warmup", 0)
        monkeypatch.setitem(common.TIMING, "reps", 1)


def _tie_free(live: np.ndarray, qs: np.ndarray, k: int) -> np.ndarray:
    d2 = np.sort(((live[None].astype(np.int64)
                   - np.asarray(qs)[:, None].astype(np.int64)) ** 2).sum(-1),
                 axis=1)
    if k >= d2.shape[1]:
        return np.ones(len(qs), bool)
    return d2[:, k - 1] != d2[:, k]


def _assert_knn(detail: dict, ref, live: np.ndarray):
    rows = np.asarray(detail["rows"])
    want_d2 = np.asarray(ref[0])[rows]
    want_ids = np.asarray(ref[1])[rows]
    np.testing.assert_array_equal(np.asarray(detail["d2"], np.float32),
                                  want_d2)
    ok = _tie_free(live, np.asarray(detail["queries"]), detail["k"])
    assert ok.any()
    np.testing.assert_array_equal(np.asarray(detail["ids"])[ok],
                                  want_ids[ok])


def _live(detail: dict, a: dict) -> np.ndarray:
    return a["pts"][: detail["live"]["stop"]]


def test_varden_is_the_sequential_walk():
    """The port's varden sums each walk segment at once and walks only
    the tails that reach an edge: the points equal a point-by-point walk
    (small domains force many clipped tails)."""
    for seed, n, dim, hi, restart_p in [(0, 3000, 2, 150, 0.01),
                                        (1, 2000, 3, 400, 0.02),
                                        (2, 5000, 2, gen.DEFAULT_HI, 0.01),
                                        (3, 500, 2, 100, 0.0),
                                        (4, 1, 3, 100, 0.01)]:
        rng = np.random.default_rng(seed)
        steps = rng.integers(-50, 51, size=(n, dim), dtype=np.int64)
        restarts = rng.random(n) < restart_p
        restart_pos = rng.integers(0, hi, size=(n, dim), dtype=np.int64)
        want = np.empty((n, dim), np.int32)
        cur = restart_pos[0]
        for i in range(n):
            cur = restart_pos[i] if restarts[i] else \
                np.clip(cur + steps[i], 0, hi - 1)
            want[i] = cur
        got = gen.varden(seed, n, dim, hi, restart_p=restart_p)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_fig4_matches_the_reference(monkeypatch):
    src = Sources(monkeypatch)
    kinds = ["spac-h", "porth"]
    details: dict = {}
    ref = jfig4.run(n=N, nq=NQ, indexes=kinds, verbose=False,
                    impls=jfig4.IMPLS)
    out = fig4_knn.run(n=N, nq=NQ, indexes=kinds, verbose=False,
                       impls=fig4_knn.IMPLS, device=DEV, details=details)
    assert out.keys() == ref.keys()
    # the reference times its kNN calls only (its inserts are untimed)
    outs = iter(src.ref_out)
    m = max(int(N * 0.01), 64)
    for kind in kinds:
        assert out[kind].keys() == ref[kind].keys()
        det = details[kind]
        assert det["sizes"] == {"grown": [N // 2 + (N // 2) // m * m] * 2}
        for impl in fig4_knn.IMPLS:
            tag = "" if impl == "auto" else f"{impl}_"
            for k in fig4_knn.KS:
                for side in ("ind", "ood"):
                    d = det["knn"][f"{tag}{side}_k{k}"]
                    _assert_knn(d, next(outs), _live(d, src.a))
    assert next(outs, None) is None


def test_fig5_matches_the_reference(monkeypatch):
    src = Sources(monkeypatch)
    kinds = ["spac-h", "porth", "zd"]
    details: dict = {}
    ref = jfig5.run(n=N, nq=NQ, indexes=kinds, verbose=False)
    out = fig5_range.run(n=N, nq=NQ, indexes=kinds, verbose=False,
                         device=DEV, details=details)
    outs = iter(src.ref_out)
    for kind, idx in zip(kinds, src.ref_idx):
        assert out[kind].keys() == ref[kind].keys()
        for side in fig5_range.SIDES:
            # out_<side>: the mean output size, equal exactly
            assert out[kind][f"out_{side}"] == ref[kind][f"out_{side}"]
            ids, cnt = next(outs)
            d = details[kind]["range_list"][f"side_{side}"]
            np.testing.assert_array_equal(d["counts"], np.asarray(cnt))
            flat, _ = idx.extract_points()
            flat = np.asarray(flat)
            for i, row in enumerate(d["rows"][: common.N_LISTED]):
                hit = np.asarray(ids)[row]
                p = flat[hit[hit >= 0]].astype(np.int64)
                want = p[np.lexsort(p.T[::-1])].tolist()
                assert d["listed"][i] == want
        assert details[kind]["sizes"] == {"build": [len(idx), N]}


def test_fig10_matches_the_reference(monkeypatch):
    src = Sources(monkeypatch)
    kinds = ["spac-h", "porth"]
    details: dict = {}
    ref = jfig10.run(n=N, indexes=kinds, verbose=False)
    out = fig10_batch.run(n=N, indexes=kinds, verbose=False, device=DEV,
                          details=details)
    outs = iter(src.ref_out)
    for kind in kinds:
        assert out[kind].keys() == ref[kind].keys()
        sizes = details[kind]["sizes"]
        for r in fig10_batch.RATIOS:
            ins, dele = next(outs), next(outs)
            assert sizes[f"ins_{r}"] == [len(ins)] * 2
            assert sizes[f"del_{r}"] == [len(dele)] * 2


def test_fig3_matches_the_reference(monkeypatch):
    src = Sources(monkeypatch)
    kinds = ["spac-h", "porth", "cpam-h"]
    details: dict = {}
    ref = jfig3.run(n=N, nq=NQ, indexes=kinds, verbose=False)
    out = fig3_grid.run(n=N, nq=NQ, indexes=kinds, verbose=False,
                        device=DEV, details=details)
    assert out.keys() == ref.keys()
    outs = iter(src.ref_out)
    ratios = (0.1, 0.01)
    for dist, kind in ref:
        assert out[(dist, kind)].keys() == ref[(dist, kind)].keys()
        det = details[f"{dist}/{kind}"]
        next(outs)                       # the timed build
        for r in ratios:
            m = max(int(N * r), 64)
            steps = max((N // 2) // m, 1)
            next(outs)                   # the warm insert
            for _ in range(steps):
                last = next(outs)
            assert det["sizes"][f"inc_ins_{r}"] == [len(last)] * 2
            if r == ratios[-1]:
                for side in ("ind", "ood"):
                    d = det["knn"][f"knn_{side}"]
                    _assert_knn(d, next(outs), _live(d, src.a))
                d = det["range_count"]["range_cnt"]
                np.testing.assert_array_equal(
                    d["counts"], np.asarray(next(outs))[d["rows"]])
            for _ in range(min(steps, 4)):
                last = next(outs)
            assert det["sizes"][f"inc_del_{r}"] == [len(last)] * 2


def test_fig9_matches_the_reference_in_3d(monkeypatch):
    src = Sources(monkeypatch, dim=3, seed=1)
    assert fig9_3d.KINDS_3D == jfig9.KINDS_3D
    details: dict = {}
    ref = jfig9.run(n=N, nq=NQ, verbose=False)
    out = fig9_3d.run(n=N, nq=NQ, verbose=False, dists=("uniform",),
                      device=DEV, details=details)
    outs = iter(src.ref_out)
    for dist, kind in ref:
        if dist != "uniform":
            continue
        assert out[(dist, kind)].keys() == ref[(dist, kind)].keys()
        det = details[f"{dist}/{kind}"]
        next(outs)                       # the build
        ins, dele = next(outs), next(outs)
        assert det["sizes"] == {"ins": [len(ins)] * 2,
                                "del": [len(dele)] * 2}
        d = det["knn"]["knn"]
        assert d["live"]["dim"] == 3
        _assert_knn(d, next(outs), _live(d, src.a))


def _synthetic_fig3():
    rng = np.random.default_rng(5)
    out = {}
    for dist in fig3_grid.DISTS:
        for kind in common.BENCH_KINDS:
            out[(dist, kind)] = {
                key: float(rng.uniform(0.01, 2.0)) for key in (
                    "build", "inc_ins_0.1", "inc_ins_0.01", "inc_del_0.1",
                    "inc_del_0.01", "knn_ind", "knn_ood", "range_cnt")}
    return out


def _synthetic(keys):
    rng = np.random.default_rng(7)
    return {kind: {key: float(rng.uniform(0.01, 2.0)) for key in keys}
            for kind in ("porth", "spac-h", "zd")}


@pytest.mark.parametrize("case", ["fig3-validate", "fig4-qps", "fig5-qps",
                                  "fig10-throughput"])
def test_paper_records_equal_the_reference(case):
    if case == "fig3-validate":
        out = _synthetic_fig3()
        assert fig3_grid.validate(out) == jfig3.validate(out)
        assert len(fig3_grid.validate(out)) == 9
    elif case == "fig4-qps":
        out = _synthetic([f"{tag}{side}_k{k}" for tag in ("", "frontier_",
                                                          "flat_")
                          for side in ("ind", "ood") for k in fig4_knn.KS])
        assert fig4_knn.qps_records(out, 500) == jfig4.qps_records(out, 500)
    elif case == "fig5-qps":
        out = _synthetic([f"{p}_{s}" for p in ("side", "out")
                          for s in fig5_range.SIDES])
        assert fig5_range.qps_records(out, 200) == \
            jfig5.qps_records(out, 200)
    else:
        out = _synthetic([f"{op}_{r}" for op in ("ins", "del")
                          for r in fig10_batch.RATIOS])
        assert fig10_batch.throughput_records(out, 10_000) == \
            jfig10.throughput_records(out, 10_000)


def test_validate_skips_distributions_that_did_not_run():
    """fig3 over one distribution (as chip_smoke runs it) validates that
    distribution's claims alone (the reference needs all three)."""
    out = {key: rec for key, rec in _synthetic_fig3().items()
           if key[0] == "uniform"}
    full = jfig3.validate(_synthetic_fig3())
    assert fig3_grid.validate(out) == [c for c in full
                                       if c[0].startswith("uniform:")]


def test_delete_audit_counts_left_over_and_lost_points():
    """``common.size_detail`` audits a size that differs from the one the
    updates imply: the reference's spac delete anomaly (600 points on
    4,096 Hilbert codes at ``coord_bits=30``, ROADMAP queue 3) leaves
    deleted points behind and loses none; an exact delete is not
    audited."""
    pts = gen.uniform(0, 600)
    idx = common.build_index("spac-z", pts, phi=8, device=DEV,
                             coord_bits=30)
    for seed in (1, 2, 3):
        idx = idx.insert(gen.uniform(seed, 1500))
    live = np.concatenate([pts] + [gen.uniform(s, 1500) for s in (1, 2, 3)])
    got = common.size_detail(idx.delete(live[:100]), len(live) - 100,
                             torch.as_tensor(live),
                             torch.as_tensor(live[:100]))
    assert got[0] > got[1]
    assert got[2] == {"extra": got[0] - got[1], "missing": 0}
    exact = common.build_index("spac-h", pts, device=DEV).delete(pts[:50])
    assert common.size_detail(exact, 550, torch.as_tensor(pts),
                              torch.as_tensor(pts[:50])) == [550, 550]
    # against the wrong expectation (pts[:60] live) the audit finds the
    # 540 points past it left over and the 50 deleted ones lost
    assert common.delete_audit(exact, torch.as_tensor(pts[:60]),
                               torch.as_tensor(pts[:0])) == \
        {"extra": 540, "missing": 50}
