"""``benchmarks.port.roofline`` against ``benchmarks.roofline``: the same
useful-work models and table on a parameter grid and a fixed payload;
the port's sweep on the CPU carries each cell's captured plan (the
frontier kernel's route on the ``auto`` kNN), and its tile sweep gives
every tile the default tile's answers bit for bit."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from benchmarks import roofline as jroof
from benchmarks.port import roofline
from repro_torch.kernels.frontier import kernel as frontier_kernel

torch.set_num_threads(1)


@pytest.mark.parametrize("n,nq,k,dim,batch", list(itertools.product(
    (1, 20_000, 10_000_000), (1, 256, 4096), (1, 10, 100), (2, 3),
    (64, 100_000))))
def test_kernel_models_equal_the_reference(n, nq, k, dim, batch):
    assert roofline.kernel_models(n, nq, k, dim, batch) == \
        jroof.kernel_models(n, nq, k, dim, batch)


def _payload():
    rng = np.random.default_rng(3)
    cell = lambda: {"time_s": float(rng.uniform(1e-4, 1.0)),  # noqa: E731
                    "achieved_gflops_s": float(rng.uniform(0, 500)),
                    "achieved_gbytes_s": float(rng.uniform(0, 3000)),
                    "intensity_flop_per_byte": float(rng.uniform(0, 200))}
    return {"results": {kind: {kern: cell() for kern in (
        "knn", "knn_chunked", "range_count", "insert")}
        for kind in ("porth", "spac-h")}}


def test_spatial_table_equals_the_reference():
    payload = _payload()
    assert roofline.spatial_table(payload) == jroof.spatial_table(payload)


def test_spatial_sweep_captures_each_cells_plan():
    payload = roofline.spatial_sweep(n=4000, nq=32, verbose=False,
                                     device="cpu")
    assert set(payload["results"]) == set(roofline.SPATIAL_KINDS)
    for kind, row in payload["results"].items():
        assert set(row) == {"knn", "knn_chunked", "range_count", "insert"}
        assert "pallas-frontier" in row["knn"]["plan_sig"]
        assert row["knn_chunked"]["plan_sig"].startswith("knn.")
        assert "frontier-" in row["knn_chunked"]["plan_sig"]
        assert row["insert"]["plan_sig"].startswith(f"update.{kind}.insert")
        for c in row.values():
            assert c["plan_device_us"] > 0 and c["plan_launches"] > 0
            assert c["peak_share_bytes"] == pytest.approx(
                c["achieved_gbytes_s"] * 1e9 / roofline.HBM_BYTES_PER_S)
    assert "plan.cost.captured" in payload["obs"]["counters"]
    table = roofline.share_table(payload)
    assert "pallas-frontier" in table


def test_block_sweep_tiles_give_the_default_tiles_answers():
    sweep = roofline.block_sweep(n=3000, nq=40, verbose=False,
                                 device="cpu", repeats=1)
    assert sweep["all_bit_equal"]
    tiles = {key.split(".", 1)[1] for key in sweep["cells"]}
    assert tiles == {f"bq{q}.bp{p}" for q in roofline.FRONTIER_BLOCK_QS
                     for p in roofline.FRONTIER_BLOCK_PS
                     if p <= frontier_kernel.MAX_GROUP}
    assert set(sweep["refused"]) == {f"bq{q}.bp1024"
                                     for q in roofline.FRONTIER_BLOCK_QS}
    chosen = sweep["chosen"]
    assert {"block_q", "block_p", "adopt", "default"} <= set(chosen)
    assert max(roofline.FRONTIER_BLOCK_QS) <= frontier_kernel.MAX_BLOCK_Q
    assert "bq32.bp512" in roofline.sweep_table(sweep)
