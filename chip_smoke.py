"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line (``"phase": ...``):

1. env    -- torch/CUDA versions; the card's name and power limit (the raw
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed
             on its own line too).
2. build  -- compiles every CUDA kernel from ``src/repro_torch/csrc`` with
             nvcc, one process per source, all started together; prints
             ptxas's registers and spill bytes for each flash-attention
             kernel and the ``HMMA`` (tensor-core) instructions of each in
             ``cuobjdump -sass``: every tc instantiation must hold some.
3. lm     -- the LM serving path at full width and depth: qwen1.5-0.5b
             (24 layers, d_model 1024, 16 heads of 64, vocab 151,936),
             bf16 weights from a seeded generator, through
             ``ServeEngine.generate``: 1 warm-up and 3 measured generates
             of 8 prompts of 2048 tokens and 128 greedy new tokens
             (max_len 2176), each under sync debug mode "error". Every
             forward must launch the flash-attention kernel once a layer
             (24 a forward, 24 x 128 a generate): every prefill its tc
             variant 24 times, every decode step its decode variant 24
             times. Prefill ms, decode ms
             a token (p50, p99), tokens/s, peak memory; an f32 rerun of
             the same weights (B=2, P=256, 32 new tokens) must agree with
             the argmax of the teacher-forced forward at >= 99% of
             positions (``examples/serve_lm.py``'s bar) and take only
             the simt (prefill) and decode variants; one prefill and one
             decode step under ``torch.profiler``.
4. main   -- the serving loop at a deployment's size: ``SpatialServer``
             over a SPaC-tree (``spac-h``, phi=32, version window 4) of
             10^7 uniform 2D int32 points in [0, 2^20), then 1 warm-up
             and 4 measured steps of the uniform stream in the
             sliding-window shape (each step: snapshot; delete 10^5;
             insert 10^5 under sync debug mode "error"; 4096 kNN (k=10)
             and 4096 range-count requests through the ``MicroBatcher``
             against the snapshot; commit). ``impl="auto"`` must route
             kNN to the frontier kernel, and it and the row-bbox kernel
             (on the deletes) must launch.
5. check  -- for 256 sampled queries of the last step, kNN distances
             equal a brute-force direct-form f32 scan over the
             snapshot's live points bit for bit, and range counts equal
             an int64 brute-force count. Then ``knn-breakdown-main``: the
             last batch's frontier prep and kernel timed apart, with the
             groups each query block's walk claimed (so too for porth,
             kd and zd).
6. porth  -- the same loop, trace and traffic over a P-Orth tree
             (``porth``, phi=32, lam=3, 5 rounds, window 4): the sieve
             kernel must launch on the build and on the inserts, the
             row-bbox kernel on the deletes, the frontier kernel on kNN;
             checked as in 5.
7. kd     -- the same loop, trace and traffic over the kd-tree baseline
             (``kd``, phi=32, max_depth=24): every update is a full
             rebuild checked on the host, so its inserts do not run under
             sync debug mode "error"; the frontier kernel must launch on
             kNN; checked as in 5.
8. zd     -- the same over the Zd-tree baseline (``zd``, phi=32, bits=15,
             coord_bits=20, lam=3): the Morton kernel must launch on the
             build and on every delete and insert (each a rebuild), the
             frontier kernel on kNN; checked as in 5. Then one zd build
             and one porth build of the bootstrap at the same row
             capacity, timed side by side (the paper's encode-and-sort
             against the sieve), with one porth insert of 10^5 points
             into the built tree timed and profiled.
9. flat   -- a small index (n = 2048, so R*C <= 2^15) through the same
             server pattern, where ``auto`` takes the flat kernel; it must
             launch, and its answers are checked the same way.
10. spac-z -- one ``spac-z`` build of 10^6 points and one insert (under
             sync debug mode "error"): the Morton kernel must launch on
             both.
11. kernels -- each kernel at the shapes its path gave it, against its
             plain PyTorch version on the same inputs (bit-equal), with
             its time, the plain version's time and its bound: the flat
             kernel on the flat phase's batch (also against its split
             mirror, with its grid), the
             frontier kernel on main's last batch and on 4 query blocks
             of porth's (``(d2, ids)`` bit-equal, the bound from the
             plain walk's steps, both walks' step counts printed),
             row-bbox on the porth and main trees, the sieve round's
             five kernels on porth's first build round against the plain
             mirror of the round (intermediates included), each kernel's
             device time, the round as ``segmented_partition`` runs it,
             and every round of one 10^7-point porth build (chunks in
             use, active points, ms, each bit-equal), the Morton kernel on zd's
             build input and on spac-z's, the flash-attention kernel on
             the lm phase's own layer-0 inputs (one prefill, and the
             decode step at 2175 kv slots through the cache's prefix
             view) and on yi-9b's GQA and h2o-danube-1.8b's window shapes,
             each in bf16 (the path's type; 1e-2 relative, about one bf16
             ulp, and 1e-4 absolute) and on f32 copies of the same inputs
             (2e-5), the variant the wrapper takes (tc or decode) timed
             in turns with the simt variant on the same bf16 inputs, and
             ``scaled_dot_product_attention`` timed beside them as the
             library yardstick.
12. sync -- every dynamic kind's ``server.insert`` above ran under
             ``torch.cuda.set_sync_debug_mode("error")``.
13. driver -- after the runs above are dropped: one ``server.insert`` of
             10^5 points into a 10^7-point spac-h and porth server (the
             driver's build), under ``torch.profiler`` with an obs
             recorder installed, must make no blocking CUDA runtime call
             (stream, device or event synchronize, ``cudaMemcpy``, a
             copy to or from pageable memory) and no ``.item()``; then
             the workload driver's CLI (``python -m
             repro_torch.serving.driver``) at this configuration (10^7
             points, sliding window, 10^5 a batch, 4096 kNN (k=10) and
             range requests a step, window 4, 1 warm-up and 8 measured
             steps) for spac-h and porth with ``--obs-trace``, the
             viewer (``python -m repro_torch.obs.view --by-name``) on
             that trace, and ``--attributed`` for spac-h, each in a
             subprocess that must exit 0. Checks: every measured step
             answered 4096 kNN and 4096 range requests; the trace holds
             one ``serving.commit`` span per replayed step and, in each
             step, a ``batcher.flush`` span of each op; the frontier and
             row-bbox kernels (and porth's sieve) launched. One line per
             kind: per-op p50/p99, rates, bytes, final and expected
             size, obs counters, launches, the insert profile and, for
             spac-h, the attributed kNN split and obs-off vs obs-on p50.
14. figures -- the paper's figures on the port: ``python -m
             benchmarks.port.run`` at 10^7 points in a subprocess that
             must exit 0 (fig3 over the uniform distribution and all
             seven kinds, fig4, fig5, fig10, fig9 in 3D, the spatial
             roofline and the frontier kernel's tile sweep at 256
             queries; one timed rep each). Its details are held against
             brute force on the live points each figure's updates imply
             (regenerated from the generators' seeds): kNN distances bit
             for bit (k = 1, 10 and 100, InD and OOD, 2D and 3D), range
             counts and listed points exactly, and every live size (the
             spac family's deletes may leave deleted points behind, as
             the reference's do at scale, but lose none). The
             frontier kernel must launch on every figure's kNN, the sieve
             on every porth build, Morton on every zd, spac-z and cpam-z
             build, row-bbox on the dynamic kinds' deletes; every tile of
             the sweep must give the default tile's answers bit for bit.
             Then fig3's paper claims as one line (a FAIL is a finding,
             not an error), one spac-h kNN batch under
             ``Recorder(capture_costs=True)`` (its plan must carry device
             time and the frontier kernel), and the regression gate
             (``python -m repro_torch.obs.regress``) three times:
             ``--update`` into a temporary file, the gate against it (exit
             0), and a replay of its snapshot with every time metric
             degraded 2x (must fail). The phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without the last line. Without CUDA it exits
with code 2 before printing anything to standard output.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs, obs  # noqa: E402
from repro_torch.core import (baselines, make_index, porth,  # noqa: E402
                              queries)
from repro_torch.data import points as gen  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bbox import kernel as bk  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as fak  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_plain  # noqa: E402
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402
from repro_torch.kernels.frontier import prep, tuning  # noqa: E402
from repro_torch.kernels.knn import kernel as kk  # noqa: E402
from repro_torch.kernels.knn import ref as kref  # noqa: E402
from repro_torch.kernels.morton import kernel as mk  # noqa: E402
from repro_torch.kernels.sieve import kernel as sk  # noqa: E402
from repro_torch.kernels.sieve import ops as sieve_ops  # noqa: E402
from repro_torch.kernels.sieve import ref as sieve_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serving import (LatencyRecorder, MicroBatcher,  # noqa: E402
                                 SpatialServer, driver)

SEED = 0
N_MAIN = 10_000_000
BATCH = 100_000
STEPS, WARMUP = 5, 1
N_FLAT = 2048
N_SPACZ = 1_000_000
QUERIES, K = 4096, 10
PHI, WINDOW = 32, 4
BOX_SIDE = gen.DEFAULT_HI // 64
N_CHECK = 256
# query blocks of porth's last kNN batch that hold the frontier kernel
# against its plain version (the plain walk is one step per group)
FRONTIER_PORTH_BLOCKS = 4

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32
# outside the tensor cores; the bound is the larger of bytes / rate and
# operations / rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per (query, point) pair the direct form costs D subtractions, D
# multiplies, D - 1 adds and one compare against the running k-th best
OPS_PER_PAIR_PER_DIM = 3
# per point, level and dimension the sieve takes a midpoint (subtract,
# halve, add) and a compare
SIEVE_OPS_PER_LEVEL_DIM = 4
# per point and dimension the Morton encode takes the quantizing shift, a
# mask, four rounds of shift, or and and, and the combining shift and or
MORTON_OPS_PER_DIM = 16
# the LM path: qwen1.5-0.5b at full width and depth, 8 prompts of 2048
# tokens and 128 greedy new tokens (a ~1.7 GB bf16 KV cache)
LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 2048, 128
LM_MAX_LEN = LM_PROMPT + LM_NEW
LM_WARMUP, LM_REPS = 1, 3
# the f32 rerun of the same weights, held to examples/serve_lm.py's bar
LM_F32_BATCH, LM_F32_PROMPT, LM_F32_NEW = 2, 256, 32
LM_AGREE = 0.99
# the bf16 tensor-core peak (dense), the rate attention's products need
BF16_TC_OPS_PER_S = 989e12
# the kernel's other features at their archs' widths (B, Hq, Hkv, S, d,
# window): yi-9b's grouped-query heads, h2o-danube-1.8b's sliding window
ATTN_EXTRA = {"at_yi_gqa": (1, 32, 4, 4096, 128, None),
              "at_danube_window": (1, 32, 8, 8192, 80, 4096)}
# kernel against plain version: both compute in f32 and round once to the
# output's type, so in bf16 they differ by at most one bf16 ulp (2^-7 of
# the value at most); |out| is ~0.03 at the path's shapes, so a bar near
# that size would pass a wrong kernel
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=1e-4, rtol=1e-2)}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


KERNELS = {**driver.KERNELS, "flash_attn": fak}


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.reset_launch_count()


def counts() -> dict:
    return {name: mod.launch_count() for name, mod in KERNELS.items()}


def delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in counts().items()}


def free() -> None:
    """Return the memory of everything dropped so far to the card."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def sync_debug_error():
    """Raise on any host-device synchronisation inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------

def run_server(name: str, kind: str, n: int, batch: int, steps: int,
               warmup: int, dev, sync_free: bool = True, **build_kw) -> dict:
    """Build a ``kind`` server over a sliding-window trace and run the
    pipelined pattern; returns timings, kernel launches (by the op that
    made them, and by step for the updates) and what the check phase
    needs. ``sync_free`` runs every insert under sync debug mode
    "error" (the dynamic kinds; a rebuild kind's insert reads the
    rebuilt size)."""
    trace = gen.make_trace("sliding-window", seed=SEED, n=n, batch=batch,
                           steps=steps)
    # set-up: the trace goes to the card in bulk
    boot = torch.as_tensor(trace.bootstrap, device=dev)
    dels = [torch.as_tensor(s.delete, device=dev) for s in trace.steps]
    inss = [torch.as_tensor(s.insert, device=dev) for s in trace.steps]
    rng = np.random.default_rng(SEED + 7)
    stream = [(gen.uniform(rng, QUERIES), *gen.query_boxes(
        rng, QUERIES, 2, BOX_SIDE)) for _ in range(steps)]
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    t0 = time.perf_counter()
    srv = SpatialServer.build(kind, boot, phi=PHI, window=WINDOW,
                              capacity_points=trace.max_live, device=dev,
                              **build_kw)
    sync()
    build_s = time.perf_counter() - t0
    by_op = {"build": counts()}
    for op in ("delete", "insert", "query", "commit"):
        by_op[op] = dict.fromkeys(KERNELS, 0)

    def tally(op: str, before: dict) -> None:
        for k, v in delta(before).items():
            by_op[op][k] += v
    batcher = MicroBatcher(max_batch=QUERIES, max_delay_s=1e9)
    rec = LatencyRecorder()
    measured_updates = 0
    by_step = []
    for s in range(steps):
        if s == warmup:
            rec.reset()          # drop the warm-up: bucket escalations
        snap = srv.snapshot()
        batcher.target = snap
        before = counts()
        with rec.timer("delete", batch):
            srv.delete(dels[s])
        step = {"delete": delta(before)}
        tally("delete", before)
        before = counts()
        guard = sync_debug_error() if sync_free else contextlib.nullcontext()
        with guard, rec.timer("insert", batch):
            srv.insert(inss[s])
        step["insert"] = delta(before)
        by_step.append(step)
        tally("insert", before)
        before = counts()
        qpts, lo, hi = stream[s]
        t1 = time.perf_counter()
        knn_t = [batcher.submit_knn(qpts[i], K) for i in range(QUERIES)]
        knn = [t.result() for t in knn_t]
        sync()
        rec.record("knn", time.perf_counter() - t1, QUERIES)
        t1 = time.perf_counter()
        rng_t = [batcher.submit_range_count(lo[i], hi[i])
                 for i in range(QUERIES)]
        cnt = [t.result() for t in rng_t]
        sync()
        rec.record("range", time.perf_counter() - t1, QUERIES)
        tally("query", before)
        before = counts()
        with rec.timer("commit"):
            srv.commit()
        tally("commit", before)
        if s >= warmup:
            measured_updates += 2 * batch
    wall = rec.wall_s
    launches = counts()
    lat = rec.latency_summary()
    final = len(srv.head_index)
    out = {
        "phase": name, "kind": kind, "n": n, "phi": PHI,
        "build_params": {k: v for k, v in build_kw.items()},
        "window": WINDOW, "steps": steps, "warmup": warmup,
        "delete_per_step": batch, "insert_per_step": batch,
        "queries_per_step": {"knn": QUERIES, "range_count": QUERIES},
        "k": K, "build_s": build_s,
        "latency_ms": {op: {p: lat[op][p] for p in
                            ("p50_ms", "p99_ms", "count")}
                       for op in lat},
        "query_per_s": (rec.count("knn") + rec.count("range")) / wall,
        "update_pts_per_s": measured_updates / wall,
        "final_size": final, "expected_size": trace.final_size,
        "capacity_rows": srv.head_index.capacity_rows,
        "version_bytes": srv.head_index.nbytes,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "routes": dict(srv.head_index.engine.route_counts),
        "launches": launches, "launches_by_op": by_op,
        "recoveries": srv.stats["recoveries"],
        "inserts_under_sync_debug_error": steps if sync_free else 0,
    }
    check(final == trace.final_size,
          f"{name}: final size {final} != trace count {trace.final_size}")
    knn_d2 = torch.cat([a[0] for a in knn])
    knn_ids = torch.cat([a[1] for a in knn])
    counts_last = torch.cat(cnt)
    check(knn_d2.shape == (QUERIES, K) and bool(torch.isfinite(
        knn_d2).all()), f"{name}: kNN d2 not finite of shape (Q, k)")
    return dict(summary=out, by_step=by_step, snap=snap, boot=boot,
                qpts=stream[-1][0],
                lo=stream[-1][1], hi=stream[-1][2], knn_d2=knn_d2,
                knn_ids=knn_ids, counts=counts_last)


def brute_check(name: str, run: dict, n_check: int, dev) -> dict:
    """kNN d2 against a direct-form f32 scan over the snapshot's live
    points (bit for bit); range counts against an int64 count."""
    pts, ok = queries.flatten_view(run["snap"].index.view())
    live = pts[ok].float()                                   # (n, 2)
    live64 = pts[ok].long()
    rng = np.random.default_rng(SEED + 11)
    sel = np.sort(rng.choice(QUERIES, size=n_check, replace=False))
    q = torch.as_tensor(run["qpts"][sel], device=dev).float()
    want = []
    for a in range(0, n_check, 8):
        qq = q[a: a + 8]
        d0 = qq[:, None, 0] - live[None, :, 0]
        d1 = qq[:, None, 1] - live[None, :, 1]
        d2 = d0 * d0 + d1 * d1
        want.append(torch.topk(d2, K, dim=1, largest=False).values)
    want = torch.cat(want)
    got = run["knn_d2"][torch.as_tensor(sel, device=dev)]
    knn_equal = bool(torch.equal(got, want))
    lo = torch.as_tensor(run["lo"][sel], device=dev).long()
    hi = torch.as_tensor(run["hi"][sel], device=dev).long()
    brute = torch.stack([((live64 >= lo[i]) & (live64 <= hi[i])).all(-1)
                         .sum() for i in range(n_check)])
    counts_equal = bool(torch.equal(
        run["counts"][torch.as_tensor(sel, device=dev)].long(), brute))
    out = {"phase": f"check-{name}", "queries": n_check,
           "live_points": int(live.shape[0]),
           "knn_d2_bit_equal": knn_equal,
           "range_count_equal": counts_equal,
           "mean_range_count": float(brute.float().mean())}
    emit(out)
    check(knn_equal, f"{name}: kNN d2 differs from the brute-force scan")
    check(counts_equal, f"{name}: range counts differ from brute force")
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions, with bounds
# ---------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S,
          ops_kind: str = "fp32") -> tuple[float, str, dict]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    how = {"bytes": bytes_moved, "ops": ops,
           "formula": f"max(bytes / 3.35e12 B/s, ops / {ops_per_s:.4g} "
                      f"{ops_kind} op/s)"}
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), how


def flat_kernel_row(run: dict, launches: int, dev) -> dict:
    """The flat kernel on the flat phase's last snapshot and query batch
    against its plain version and the split mirror at the kernel's own
    plan, with the grid that plan gives."""
    view = run["snap"].index.view()
    pts, ok = queries.flatten_view(view)
    q = torch.as_tensor(run["qpts"], device=dev)
    Q, D = q.shape
    N = pts.shape[0]
    threads, splits, per = kk.split_plan(
        Q, N, K, torch.cuda.get_device_properties(dev).multi_processor_count)
    got = kk.knn_flat(q, pts, ok, k=K)
    want = kk.knn_flat_plain(q, pts, ok, k=K)
    split = kref.knn_flat_split_plain(q, pts, ok, k=K, splits=splits)
    sync()
    equal = all(bool(torch.equal(a, b)) and bool(torch.equal(a, c))
                for a, b, c in zip(got, want, split))
    err = float((got[0] - want[0]).abs().max())
    by_kernel = kernel_ms_by(lambda: kk.knn_flat(q, pts, ok, k=K),
                             "knn_flat", FLAT_KERNELS, reps=20)
    ms = sum(by_kernel.values())
    events_ms = time_ms(lambda: kk.knn_flat(q, pts, ok, k=K), reps=20)
    plain_ms = time_ms(lambda: kk.knn_flat_plain(q, pts, ok, k=K), reps=5)
    n_ok = int(ok.sum())
    bytes_moved = Q * D * 4 + N * D * 4 + N + Q * K * 8
    ops = Q * n_ok * OPS_PER_PAIR_PER_DIM * D
    b_ms, by, how = bound(bytes_moved, ops)
    check(equal, "knn_flat: kernel differs from its plain version")
    q_tiles = -(-Q // threads)
    return {"name": "knn_flat", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_flat.cu",
            "replaces": "src/repro/kernels/knn/kernel.py:57",
            "launches": launches, "max_abs_err": err, "bit_equal": equal,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None,
            "timed": "ms: the two kernels' device time (torch.profiler); "
                     "events_ms: knn_flat back to back by CUDA events",
            "kernel_ms": by_kernel, "events_ms": events_ms,
            "shape": {"Q": Q, "N": N, "valid": n_ok, "D": D, "k": K},
            "grid": {"query_tiles": q_tiles, "splits": splits,
                     "slots_per_split": per, "threads": threads,
                     "ctas": q_tiles * splits, "merge_warps": Q},
            "bound_terms": how}


def timed_once(fn):
    """``fn()``'s result and its device time in ms, by CUDA events."""
    sync()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def frontier_kernel_row(run: dict, launches, dev,
                        n_blocks: int | None = None) -> dict:
    """The frontier kernel on the run's last snapshot and query batch,
    prepared as the engine prepares it, against its plain version.
    ``n_blocks`` keeps that many query blocks, evenly spaced in block
    order (the plain walk syncs once per group step, too slow for every
    block of a deep walk); kernel, plain and bound are then all taken on
    those blocks. The bound counts the groups the plain walk visited:
    each distinct group's flag and active bytes once, the coordinates of
    its live slots only, and the pairs of queries and live points scored.
    The kernel's own step counts (its walk's reach, parallel claims
    included) are reported beside them."""
    view = run["snap"].index.view()
    pts, valid, active, lo, hi = view
    q = torch.as_tensor(run["qpts"], device=dev)
    bq, bp = tuning.tiles("cuda")
    pr = prep.prepare(pts, valid, active, lo, hi, q, block_q=bq,
                      block_p=bp)
    R, C, D = pts.shape
    nqb_all = pr.order.shape[0]
    if n_blocks is not None:
        sel = torch.linspace(0, nqb_all - 1, n_blocks, device=dev).long()
        pr = pr._replace(
            qs=pr.qs.reshape(nqb_all, bq, D)[sel].reshape(-1, D),
            order=pr.order[sel], glb=pr.glb[sel],
            inv=torch.arange(n_blocks * bq, device=dev))
    got = fk.knn_frontier(pr, pts, valid, active, k=K)
    want, plain_ms = timed_once(
        lambda: fk.knn_frontier_plain(pr, pts, valid, active, k=K))
    sync()
    # (d2, ids) bit for bit; the kernel's steps are its walk's reach, at
    # least the plain prefix
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got[:2], want[:2]))
    reach_ok = bool((got[2] >= want[2]).all())
    err = float((got[0] - want[0]).abs().max())
    ms = time_ms(lambda: fk.knn_frontier(pr, pts, valid, active, k=K),
                 reps=10 if n_blocks is None else 5)
    # what this run's data needs: the groups the plain walk visited
    nqb, G = pr.order.shape
    br, P = pr.block_r, pr.points_per_group
    steps = want[2].long()
    reach = got[2].long()
    ok = valid & active[:, None]
    pad = G * br - R
    if pad:
        ok = torch.cat([ok, ok.new_zeros((pad, C))])
    per_group = ok.reshape(G, P).sum(1)                          # (G,)
    visited = torch.arange(G, device=dev)[None, :] < steps[:, None]
    groups = torch.where(visited, pr.order.long(), G)
    union = torch.zeros(G + 1, dtype=torch.bool, device=dev)
    union[groups.reshape(-1)] = True
    n_union = int(union[:G].sum())
    live_in_union = int(per_group[union[:G]].sum())
    pair_slots = int((per_group[pr.order.long()] * visited).sum())
    del visited, groups
    Qp = pr.qs.shape[0]
    # each distinct visited group's flags and active bytes, and the
    # coordinates of its live slots only (the kernel copies no others)
    bytes_moved = (Qp * D * 4 + int(steps.sum()) * 8
                   + n_union * (P + br) + live_in_union * D * 4
                   + Qp * K * 8 + nqb * 4)
    ops = bq * pair_slots * OPS_PER_PAIR_PER_DIM * D
    b_ms, by, how = bound(bytes_moved, ops)
    check(equal, "knn_frontier: kernel differs from its plain version")
    check(reach_ok, "knn_frontier: the kernel's walk stopped short of the "
          "plain prefix")
    return {"name": "knn_frontier", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_frontier.cu",
            "replaces": "src/repro/kernels/frontier/kernel.py:86",
            "launches": launches, "max_abs_err": err, "bit_equal": equal,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None,
            "shape": {"Qp": Qp, "R": R, "C": C, "D": D, "k": K,
                      "block_q": bq, "block_r": br, "groups": G,
                      "query_blocks": nqb, "of_query_blocks": nqb_all,
                      "mean_groups_visited": float(steps.float().mean()),
                      "max_groups_visited": int(steps.max()),
                      "distinct_groups_visited": n_union,
                      "live_slots_in_them": live_in_union},
            "steps": {"kernel_mean": float(reach.float().mean()),
                      "kernel_max": int(reach.max()),
                      "overshoot_mean": float((reach - steps).float()
                                              .mean()),
                      "overshoot_max": int((reach - steps).max())},
            "bound_terms": how}


def frontier_breakdown(name: str, run: dict, dev) -> dict:
    """Where a kNN batch's time goes on the run's last snapshot: the
    prep (group boxes, query sort, per-block visit order) and the
    frontier kernel alone, with the groups each query block's walk
    claimed (the kernel's steps: the plain prefix plus parallel claims).
    These launches come after the path's counts were read."""
    pts, valid, active, lo, hi = run["snap"].index.view()
    q = torch.as_tensor(run["qpts"], device=dev)
    bq, bp = tuning.tiles("cuda")

    def prepare():
        return prep.prepare(pts, valid, active, lo, hi, q, block_q=bq,
                            block_p=bp)

    prep_ms = time_ms(prepare, reps=2)
    pr = prepare()
    out, kernel_ms = timed_once(
        lambda: fk.knn_frontier(pr, pts, valid, active, k=K))
    steps = out[2].float()
    out = {"phase": f"knn-breakdown-{name}", "prep_ms": prep_ms,
           "kernel_ms": kernel_ms, "groups": pr.order.shape[1],
           "points_per_group": pr.points_per_group,
           "active_rows": int(active.sum()),
           "mean_groups_claimed": float(steps.mean()),
           "max_groups_claimed": int(steps.max())}
    emit(out)
    return out


def round_equal(got, want) -> bool:
    """Two ``SieveRound``s, cut to the chunks in use, field for field
    (intermediates included: the chunk lists and counts, the multi
    chunks' histograms and their scan)."""
    got, want = sieve_ref.in_use(got), sieve_ref.in_use(want)
    return all(bool(torch.equal(getattr(got, f), getattr(want, f)))
               for f in got._fields)


SIEVE_KERNELS = ("chunks", "single", "hist", "scan", "rank")
FLAT_KERNELS = ("split", "merge")


def kernel_ms_by(fn, prefix: str, names, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` of each kernel ``<prefix>_<name>_kernel``
    it launches, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        m = re.search(prefix + r"_(\w+?)_kernel", e.key)
        if m and e.device_type == DeviceType.CUDA and m.group(1) in out:
            out[m.group(1)] += e.self_device_time_total / 1e3 / reps
    return out


def host_ms(fn, reps: int = 10) -> float:
    """Host ms to enqueue one call of ``fn`` (no sync inside the loop)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    sync()
    return (t1 - t0) * 1e3 / reps


def sieve_build_rounds(boot, capacity_rows: int, lam: int, rounds: int,
                       dev) -> dict:
    """One porth build of the bootstrap with every sieve round timed by
    CUDA events where the build calls it (no sync inside the build), its
    chunks in use and active points read after, and each round held
    against the plain mirror on the same inputs."""
    log = []

    def timed(pts, lo, hi, seg, act, *, lam, n_chunks,
              block_n=sieve_ops.BLOCK_N):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        r = sk.sieve_round(pts, lo, hi, seg, act, lam=lam, block_n=block_n)
        b.record()
        log.append((a, b, r, [t.clone() for t in (pts, lo, hi, seg, act)]))
        return r.dest, r.bucket, r.lo, r.hi

    D = boot.shape[1]
    root_lo = torch.zeros(D, dtype=boot.dtype, device=dev)
    root_hi = torch.full((D,), gen.DEFAULT_HI, dtype=boot.dtype, device=dev)
    with patched(porth.sieve_ops, "segmented_partition", timed):
        tree = porth.build(boot, root_lo, root_hi, phi=PHI, lam=lam,
                           rounds=rounds, capacity_rows=capacity_rows)
        sync()
    del tree
    out, equal = [], True
    for a, b, r, args in log:
        ok = round_equal(r, sieve_ref.sieve_round_plain(
            *args, lam=lam, block_n=sieve_ops.BLOCK_N))
        ns, nm = r.counts.tolist()
        out.append({"ms": a.elapsed_time(b), "single_segments": ns,
                    "multi_chunks": nm, "chunks_in_use": ns + nm,
                    "active_points": int(args[4].sum()), "bit_equal": ok})
        equal = equal and ok
    del log
    free()
    return {"rounds": out, "sum_ms": sum(r["ms"] for r in out),
            "bit_equal": equal}


def sieve_kernel_row(run: dict, launches: dict, dev) -> dict:
    """The sieve round's five kernels at the porth build's first round
    (every point of the bootstrap in one segment of the root cell)
    against the plain mirror (bit-equal, intermediates included), each
    kernel's device time, the round as ``segmented_partition`` runs it,
    every round of one 10^7-point build, and float32 [0, 1) and 3D cases
    over random segments."""
    pts = run["boot"]
    n, D = pts.shape
    lam = run["summary"]["lam"]
    lo = torch.zeros_like(pts)
    hi = torch.full_like(pts, gen.DEFAULT_HI)
    seg = torch.zeros(n, dtype=torch.int32, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    B = sieve_ops.BLOCK_N

    def kernels():
        return sk.sieve_round(pts, lo, hi, seg, act, lam=lam, block_n=B)

    def plain():
        return sieve_ref.sieve_round_plain(pts, lo, hi, seg, act, lam=lam,
                                           block_n=B)
    got, want = kernels(), plain()
    sync()
    equal = round_equal(got, want)
    err = float((got.dest - want.dest).abs().max())
    used = sieve_ref.in_use(got)
    n_single, n_multi = used.counts.tolist()
    del got, want, used
    events_ms = time_ms(kernels, reps=10)
    plain_ms = time_ms(plain, reps=3)
    round_ms = time_ms(lambda: sieve_ops.segmented_partition(
        pts, lo, hi, seg, act, lam=lam, n_chunks=sieve_ops.max_chunks(
            n, PHI)), reps=10)
    by_kernel = kernel_ms_by(kernels, "sieve", SIEVE_KERNELS)
    ms = sum(by_kernel.values())
    enqueue_ms = host_ms(kernels)
    tree = run["snap"].index.tree
    build_rounds = sieve_build_rounds(pts, tree.capacity_rows, tree.lam,
                                      tree.rounds, dev)
    equal = equal and build_rounds["bit_equal"]
    extra = []
    rng = np.random.default_rng(SEED + 13)
    for dtype, dim, lam_x in ((torch.float32, 2, 3), (torch.int32, 3, 2)):
        nx = 200_000
        if dtype == torch.float32:
            xp = torch.as_tensor(rng.random((nx, dim), dtype=np.float32),
                                 device=dev)
            xlo, xhi = torch.zeros_like(xp), torch.ones_like(xp)
        else:
            xp = torch.as_tensor(gen.uniform(rng, nx, dim), device=dev)
            xlo = torch.zeros_like(xp)
            xhi = torch.full_like(xp, gen.DEFAULT_HI)
        starts = np.unique(np.concatenate([[0], rng.integers(0, nx, 500)]))
        which = np.searchsorted(starts, np.arange(nx), side="right") - 1
        xseg = torch.as_tensor(starts[which].astype(np.int32), device=dev)
        xact = torch.as_tensor((rng.random(starts.shape[0]) < 0.7)[which],
                               device=dev)
        xr = sk.sieve_round(xp, xlo, xhi, xseg, xact, lam=lam_x, block_n=B)
        ok = round_equal(xr, sieve_ref.sieve_round_plain(
            xp, xlo, xhi, xseg, xact, lam=lam_x, block_n=B))
        extra.append({"dtype": str(dtype), "n": nx, "D": dim, "lam": lam_x,
                      "segments": int(starts.shape[0]),
                      "chunks_in_use": xr.counts.tolist(), "bit_equal": ok})
        equal = equal and ok
    K = 1 << (lam * D)
    used_chunks = n_single + n_multi
    # points and their cells, segment starts and activity in; the chunk
    # table in use (a start and a length a chunk); dest, bucket and child
    # cells out
    bytes_moved = (3 * n * D * 4 + n * 4 + n + 2 * used_chunks * 4
                   + 2 * n * 4 + 2 * n * D * 4)
    ops = n * lam * D * SIEVE_OPS_PER_LEVEL_DIM
    b_ms, by, how = bound(bytes_moved, ops)
    check(equal, "sieve: kernel differs from its plain version")
    return {"name": "sieve", "route": "cuda",
            "source": "src/repro_torch/csrc/sieve.cu",
            "replaces": "src/repro/kernels/sieve/kernel.py:55",
            "launches": launches["porth"], "launches_by_path": launches,
            "max_abs_err": err, "bit_equal": equal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "shape": {"N": n, "D": D, "lam": lam, "buckets": K,
                      "block_n": B, "single_segments": n_single,
                      "multi_chunks": n_multi, "dtype": str(pts.dtype)},
            "timed": "ms: the five kernels' device time (torch.profiler); "
                     "events_ms: sieve_round back to back by CUDA events; "
                     "with_offsets_scan_ms: segmented_partition likewise",
            "kernel_ms": by_kernel, "events_ms": events_ms,
            "host_enqueue_ms": enqueue_ms,
            "with_offsets_scan_ms": round_ms,
            "build_rounds": build_rounds,
            "plain": "ref.sieve_round_plain (the decomposition in torch)",
            "extra_cases": extra, "bound_terms": how}


def row_bbox_at(tree) -> dict:
    """The row-bbox kernel over every row of ``tree`` with validity
    ``valid & active`` (what a delete gives it) against its plain version;
    ``library_ms`` times ``amin`` + ``amax`` over the masked points (the
    masking itself not timed)."""
    pts = tree.pts
    valid = tree.valid & tree.active[:, None]
    got = bk.row_bbox(pts, valid)
    want = bk.row_bbox_plain(pts, valid)
    sync()
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = float(max((a.long() - b.long()).abs().max()
                    for a, b in zip(got, want)))
    ms = time_ms(lambda: bk.row_bbox(pts, valid), reps=10)
    plain_ms = time_ms(lambda: bk.row_bbox_plain(pts, valid), reps=3)
    big = torch.iinfo(pts.dtype).max
    m = valid[..., None]
    lo_in, hi_in = torch.where(m, pts, big), torch.where(m, pts, -big)
    library_ms = time_ms(lambda: (lo_in.amin(dim=1), hi_in.amax(dim=1)),
                         reps=3)
    del lo_in, hi_in
    R, C, D = pts.shape
    n_valid = int(valid.sum())
    # what this run's data needs: every flag, the coordinates of the
    # valid slots, the two (R, D) outputs
    bytes_moved = R * C + n_valid * D * 4 + 2 * R * D * 4
    ops = 2 * n_valid * D
    b_ms, by, how = bound(bytes_moved, ops)
    check(equal, "row_bbox: kernel differs from its plain version")
    return {"max_abs_err": err, "bit_equal": equal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms,
            "shape": {"R": R, "C": C, "D": D, "dtype": str(pts.dtype),
                      "valid_slots": n_valid,
                      "active_rows": int(tree.active.sum())},
            "bound_terms": how}


def row_bbox_kernel_row(porth_run: dict, main_run: dict,
                        launches: dict) -> dict:
    """The row-bbox kernel at the porth delete's shapes, and again at the
    spac-h (main) delete's."""
    at_porth = row_bbox_at(porth_run["snap"].index.tree)
    at_main = row_bbox_at(main_run["snap"].index.tree)
    return {"name": "row_bbox", "route": "cuda",
            "source": "src/repro_torch/csrc/row_bbox.cu",
            "replaces": "src/repro/kernels/bbox/kernel.py:24",
            "launches": launches["porth"], "launches_by_path": launches,
            **at_porth,
            "library_call": "amin + amax over the masked (R, C, D) points",
            "bit_equal": at_porth["bit_equal"] and at_main["bit_equal"],
            "at_main": at_main}


def morton_at(pts, bits: int, coord_bits: int) -> dict:
    """The Morton kernel on ``pts`` against its plain version; no single
    PyTorch call computes the interleave, so there is no library time."""
    got = mk.morton_encode(pts, bits=bits, coord_bits=coord_bits)
    want = mk.morton_encode_plain(pts, bits=bits, coord_bits=coord_bits)
    sync()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    ms = time_ms(lambda: mk.morton_encode(pts, bits=bits,
                                          coord_bits=coord_bits), reps=20)
    plain_ms = time_ms(lambda: mk.morton_encode_plain(
        pts, bits=bits, coord_bits=coord_bits), reps=5)
    n, D = pts.shape
    # each coordinate read once, each int64 code written once
    bytes_moved = n * D * 4 + n * 8
    ops = n * D * MORTON_OPS_PER_DIM
    b_ms, by, how = bound(bytes_moved, ops)
    return {"max_abs_err": err, "bit_equal": equal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "shape": {"N": n, "D": D, "bits": bits, "coord_bits": coord_bits,
                      "dtype": str(pts.dtype)},
            "bound_terms": how}


def morton_kernel_row(zd_boot, spacz_pts, launches: dict) -> dict:
    """The Morton kernel at zd's build input (bits 15, coord_bits 20) and
    at spac-z's (bits 16, coord_bits 20)."""
    at_zd = morton_at(zd_boot, 15, 20)
    at_spacz = morton_at(spacz_pts, 16, 20)
    equal = at_zd["bit_equal"] and at_spacz["bit_equal"]
    check(equal, "morton: kernel differs from its plain version")
    return {"name": "morton", "route": "cuda",
            "source": "src/repro_torch/csrc/morton.cu",
            "replaces": "src/repro/kernels/morton/kernel.py:47",
            "launches": launches["zd"], "launches_by_path": launches,
            **at_zd, "bit_equal": equal, "at_spac_z": at_spacz}


# ---------------------------------------------------------------------------
# the kd and Zd baselines, and the Morton kernel on spac-z
# ---------------------------------------------------------------------------

def run_baseline(name: str, dev, **build_kw) -> dict:
    """The serving loop over a rebuild baseline, checked as main is; the
    snapshot is dropped once the checks have read it."""
    run = run_server(name, name, N_MAIN, BATCH, STEPS, WARMUP, dev,
                     sync_free=False, **build_kw)
    emit(run["summary"])
    ops = run["summary"]["launches_by_op"]
    check(set(run["summary"]["routes"]) == {"frontier-kernel:cuda"},
          f"{name}: auto took {run['summary']['routes']}")
    check(ops["query"]["knn_frontier"] > 0,
          f"{name}: the frontier kernel never launched")
    brute_check(name, run, N_CHECK, dev)
    frontier_breakdown(name, run, dev)
    run["capacity_rows"] = run["snap"].index.capacity_rows
    del run["snap"]
    free()
    return run


def device_ops(fn, top: int = 6) -> dict:
    """``fn()`` once under ``torch.profiler``: the device time of its
    kernels, the kernels that took the most of it and the torch ops that
    launched the most (self device time, summed over calls). The
    profiler's "Command Buffer Full" records (the host waiting for room
    in the launch queue) are not device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    del out
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0
              and "Command Buffer Full" not in e.key]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU]

    def head(rows):
        rows = sorted(rows, key=lambda e: e.self_device_time_total,
                      reverse=True)
        return [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in rows[:top]]
    return {"kernel_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3,
            "kernels": head(kernels), "ops": head(ops)}


def build_compare(kd_run: dict, zd_run: dict, porth_run: dict,
                  dev) -> dict:
    """One zd build and one porth build of the bootstrap at zd's final
    row capacity -- Morton encode and a full sort against the sieve (the
    paper's Sec. 3 claim) -- and one kd build at kd's, each timed alone
    by CUDA events and then run once more under the profiler."""
    boot, rows = zd_run["boot"], zd_run["capacity_rows"]
    ptree = porth_run["snap"].index.tree
    D = boot.shape[1]
    lo = torch.zeros(D, dtype=boot.dtype, device=dev)
    hi = torch.full((D,), gen.DEFAULT_HI, dtype=boot.dtype, device=dev)
    builds = {
        "zd": lambda: baselines.zd_build(
            boot, phi=PHI, capacity_rows=rows,
            **zd_run["summary"]["build_params"]),
        "porth": lambda: porth.build(
            boot, lo, hi, phi=PHI, lam=ptree.lam, rounds=ptree.rounds,
            capacity_rows=rows),
        "kd": lambda: baselines.kd_build(
            boot, phi=PHI, capacity_rows=kd_run["capacity_rows"],
            **kd_run["summary"]["build_params"])}
    out = {"phase": "build-compare", "n": int(boot.shape[0]),
           "capacity_rows": {"zd": rows, "porth": rows,
                             "kd": kd_run["capacity_rows"]},
           "facade_build_s": {name: r["summary"]["build_s"] for name, r in
                              (("zd", zd_run), ("porth", porth_run),
                               ("kd", kd_run))}}
    for name, fn in builds.items():
        tree, ms = timed_once(fn)
        size = int(tree.size)
        if name == "porth":
            out["porth_insert"] = porth_insert_profile(tree, dev)
        del tree
        free()
        out[name] = {"build_ms": ms, "size": size, "profile": device_ops(fn)}
        free()
        check(size == boot.shape[0], f"build-compare: the {name} build "
              f"holds {size} of {boot.shape[0]} points")
    emit(out)
    return out


def porth_insert_profile(tree, dev) -> dict:
    """One insert of a batch of fresh uniform points into a porth tree:
    its time on the host clock (to a sync), its device time by CUDA
    events, and where the device time goes (``torch.profiler``)."""
    rng = np.random.default_rng(SEED + 23)
    new = torch.as_tensor(gen.uniform(rng, BATCH), device=dev)

    def insert():
        return porth.insert(tree, new)
    insert()
    sync()
    t0 = time.perf_counter()
    _, device_ms = timed_once(insert)
    host_ms = (time.perf_counter() - t0) * 1e3
    free()
    return {"points": BATCH, "host_ms": host_ms, "device_ms": device_ms,
            "profile": device_ops(insert)}


def spacz_morton(dev) -> tuple:
    """A spac-z server over 10^6 uniform points and one insert under sync
    debug mode "error": the Morton kernel must launch on both."""
    rng = np.random.default_rng(SEED + 17)
    pts = torch.as_tensor(gen.uniform(rng, N_SPACZ), device=dev)
    new = torch.as_tensor(gen.uniform(rng, BATCH), device=dev)
    sync()
    reset_counts()
    srv = SpatialServer.build("spac-z", pts, phi=PHI, window=WINDOW,
                              capacity_points=N_SPACZ + BATCH,
                              coord_bits=20, device=dev)
    sync()
    built = counts()
    with sync_debug_error():
        srv.insert(new)
    srv.commit()
    inserted = delta(built)
    size = len(srv.head_index)
    out = {"phase": "spac-z", "n": N_SPACZ, "insert": BATCH,
           "final_size": size, "launches": counts(),
           "morton_launches": {"build": built["morton"],
                               "insert": inserted["morton"]}}
    emit(out)
    check(built["morton"] > 0, "spac-z: the Morton kernel never launched "
          "on the build")
    check(inserted["morton"] > 0, "spac-z: the Morton kernel never "
          "launched on the insert")
    check(size == N_SPACZ + BATCH, f"spac-z: size {size}")
    return pts, out


# ---------------------------------------------------------------------------
# the workload driver and obs
# ---------------------------------------------------------------------------

# CUDA runtime calls that block the host (a copy to or from pageable host
# memory also waits: its device-side record says "Pageable")
BLOCKING_RUNTIME = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaEventSynchronize", "cudaMemcpy")
DRIVER_KINDS = ("spac-h", "porth")
DRIVER_SCENARIO = "sliding-window"
DRIVER_WARMUP, DRIVER_STEPS = 1, 8
DRIVER_OPS = ("insert", "delete", "knn", "knn_dispatch", "knn_wait",
              "range", "range_dispatch", "range_wait", "commit")


def insert_syncs(kind: str, dev) -> dict:
    """One ``server.insert`` of 10^5 points into a 10^7-point ``kind``
    server built as the driver builds it, under
    ``torch.profiler`` with a recorder installed: the CUDA runtime calls
    made inside the insert, and those that block the host (must be 0).
    Independent of ``torch.cuda.set_sync_debug_mode``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    trace = gen.make_trace(DRIVER_SCENARIO, seed=SEED, n=N_MAIN,
                           batch=BATCH, steps=2)
    boot = torch.as_tensor(trace.bootstrap, device=dev)
    (d0, i0), (d1, i1) = [(torch.as_tensor(s.delete, device=dev),
                           torch.as_tensor(s.insert, device=dev))
                          for s in trace.steps]
    srv = SpatialServer.build(kind, boot, phi=PHI, window=WINDOW,
                              capacity_points=trace.max_live, device=dev,
                              **driver.build_params(kind))
    srv.delete(d0)
    srv.insert(i0)         # the first insert: caches and plans warm
    srv.commit()
    srv.delete(d1)
    sync()
    with obs.recording(obs.Recorder()) as rec, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.insert"):
            srv.insert(i1)
        sync()
    srv.commit()
    events = prof.events()
    span = next(e for e in events if e.name == "chip_smoke.insert")
    t0, t1 = span.time_range.start, span.time_range.end
    inside = [e for e in events if t0 <= e.time_range.start <= t1
              and e is not span]
    runtime: dict[str, int] = {}
    blocking: dict[str, int] = {}
    for e in inside:
        if e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
        if e.name in BLOCKING_RUNTIME or e.name == "aten::_local_scalar_dense":
            blocking[e.name] = blocking.get(e.name, 0) + 1
    for e in events:      # device-side copy records lie after the span
        if e.name.startswith("Memcpy") and "Pageable" in e.name:
            blocking[e.name] = blocking.get(e.name, 0) + 1
    out = {"kind": kind, "points": BATCH, "runtime_calls": runtime,
           "blocking_calls": sum(blocking.values()), "blocking": blocking,
           "obs_spans": sorted({ev["name"] for ev in rec.events})}
    check(any(n.startswith("cudaLaunch") for n in runtime),
          f"{kind}: the profiler saw no kernel launch inside the insert")
    check("serving.insert" in out["obs_spans"],
          f"{kind}: no serving.insert span was recorded")
    check(not blocking, f"{kind}: the insert made blocking CUDA calls "
          f"{blocking}")
    return out


def run_cli(args: list, timeout: int,
            ok: bool = True) -> subprocess.CompletedProcess:
    """``python -m <args>`` with ``src`` on the path; its output goes to
    this script's standard error. It must exit 0 (``ok``) or, with
    ``ok=False``, with another code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    print(out.stdout, out.stderr, sep="\n", file=sys.stderr, flush=True)
    check((out.returncode == 0) == ok, f"{args[0]} exited {out.returncode}")
    return out


def flush_ms(trace: dict, kinds: int, replayed: int) -> list:
    """Per kind (in run order, each kind's spans lie up to its last
    commit), the ``batcher.flush`` spans by op: count, rows, and p50 and
    total of their host time in ms (each flush answers its coalesced
    batch through the engine)."""
    xs = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"),
                key=lambda e: e["ts"])
    ends = [c["ts"] + c["dur"] for c in xs if c["name"] == "serving.commit"]
    out, lo = [], -1.0
    for i in range(kinds):
        hi = ends[(i + 1) * replayed - 1]
        by_op: dict[str, list] = {}
        for e in xs:
            if e["name"] == "batcher.flush" and lo < e["ts"] <= hi:
                by_op.setdefault(e["args"]["op"], []).append(e)
        out.append({op: {"count": len(es),
                         "rows": sorted({e["args"]["rows"] for e in es}),
                         "p50_ms": float(np.median([e["dur"] for e in es]))
                         / 1e3,
                         "total_ms": sum(e["dur"] for e in es) / 1e3}
                    for op, es in by_op.items()})
        lo = hi
    return out


def trace_checks(trace: dict, steps: int) -> dict:
    """The obs trace holds one ``serving.commit`` span per replayed step
    of every kind and, between consecutive commits, a ``batcher.flush``
    span of each op."""
    xs = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"),
                key=lambda e: e["ts"])
    commits = [e for e in xs if e["name"] == "serving.commit"]
    check(len(commits) == steps, f"driver: {len(commits)} serving.commit "
          f"spans for {steps} steps")
    prev = -1.0
    for i, c in enumerate(commits):
        ops = {e.get("args", {}).get("op") for e in xs
               if e["name"] == "batcher.flush" and prev < e["ts"] < c["ts"]}
        check({"knn", "range_count"} <= ops,
              f"driver: step {i} flushed only {ops}")
        prev = c["ts"] + c["dur"]
    spans: dict[str, int] = {}
    for e in xs:
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    return spans


def driver_phase(dev) -> dict:
    """The workload driver's CLI at chip_smoke's spatial configuration
    (10^7 points, sliding window, batches of 10^5, 4096 kNN and range
    requests a step, window 4; 1 warm-up and 8 measured steps) for
    spac-h and porth with an obs trace, the viewer on that trace, and
    ``--attributed`` for spac-h; then one line per kind. Returns the
    kernel launches of each kind's driver run."""
    syncs = {}
    for kind in DRIVER_KINDS:
        syncs[kind] = insert_syncs(kind, dev)
        emit({"phase": "driver-insert-syncs", **syncs[kind]})
        free()
    parent_bytes = torch.cuda.memory_allocated()
    size = ["--scenarios", DRIVER_SCENARIO, "--n", str(N_MAIN), "--batch",
            str(BATCH), "--queries", str(QUERIES), "--k", str(K),
            "--window", str(WINDOW), "--warmup", str(DRIVER_WARMUP),
            "--steps", str(DRIVER_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        latency, trace_path = f"{tmp}/serve_latency.json", \
            f"{tmp}/obs_trace.json"
        attributed = f"{tmp}/serve_trace.json"
        t0 = time.perf_counter()
        run_cli(["repro_torch.serving.driver", "--kinds",
                 ",".join(DRIVER_KINDS), *size, "--json", latency,
                 "--obs-trace", trace_path], timeout=600)
        run_s = time.perf_counter() - t0
        run_cli(["repro_torch.obs.view", trace_path, "--by-name"],
                timeout=120)
        t0 = time.perf_counter()
        run_cli(["repro_torch.serving.driver", "--kinds", "spac-h", *size,
                 "--attributed", attributed], timeout=300)
        attributed_s = time.perf_counter() - t0
        payload = json.loads(pathlib.Path(latency).read_text())
        trace = json.loads(pathlib.Path(trace_path).read_text())
        attr = json.loads(pathlib.Path(attributed).read_text())
    replayed = DRIVER_WARMUP + DRIVER_STEPS
    spans = trace_checks(trace, replayed * len(DRIVER_KINDS))
    flushes = flush_ms(trace, len(DRIVER_KINDS), replayed)
    launches = {}
    for kind, flush in zip(DRIVER_KINDS, flushes):
        res = payload["results"][kind][DRIVER_SCENARIO]
        det = payload["details"][kind][DRIVER_SCENARIO]
        for op in ("knn", "range"):
            check(det["units"][op] == QUERIES * DRIVER_STEPS,
                  f"driver {kind}: {det['units'][op]} {op} requests, not "
                  f"{QUERIES} x {DRIVER_STEPS}")
        launches[kind] = det["launches"]
        check(det["launches"]["knn_frontier"] > 0,
              f"driver {kind}: the frontier kernel never launched")
        check(det["launches"]["row_bbox"] > 0,
              f"driver {kind}: the row-bbox kernel never launched")
        if kind == "porth":
            check(det["launches"]["sieve"] > 0,
                  "driver porth: the sieve kernel never launched")
        lat = res["latency_ms"]
        counters = {k: v for k, v in det["counters"].items()
                    if k in ("engine.plan_request", "engine.plan_miss")
                    or k.startswith(("engine.route.", "batcher.flush."))}
        line = {
            "phase": "driver", "kind": kind, "scenario": DRIVER_SCENARIO,
            "n": N_MAIN, "batch": BATCH, "queries": QUERIES, "k": K,
            "window": WINDOW, "warmup": DRIVER_WARMUP,
            "steps": DRIVER_STEPS,
            "latency_ms": {op: {p: lat[op][p] for p in
                                ("p50_ms", "p99_ms", "count")}
                           for op in DRIVER_OPS if op in lat},
            "query_per_s": res["throughput"]["query_per_s"],
            "update_pts_per_s": res["throughput"]["update_pts_per_s"],
            "wall_s": res["throughput"]["wall_s"],
            "steady_bytes": res["memory"]["steady_bytes"],
            "peak_window_bytes": res["memory"]["peak_window_bytes"],
            "build_s": res["build_s"],
            "final_size": res["final_size"],
            "expected_size": det["expected_size"],
            "requests": {"knn": det["units"]["knn"],
                         "range": det["units"]["range"]},
            "counters": counters, "launches": det["launches"],
            "insert_profile": syncs[kind],
            "cli_s": {"run_both_kinds": run_s},
            "parent_allocated_bytes": parent_bytes,
            "batcher_flush": flush, "trace_spans": spans}
        if kind == "spac-h":
            a = attr["results"]["spac-h"]
            line["attributed"] = {
                "knn_attribution_ms": a["knn_attribution_ms"],
                "knn_p50_ms": a["knn_p50_ms"],
                "plan_cache": a["plan_cache"],
                "escalation": a["escalation"],
                "batcher": a["batcher"]}
            line["cli_s"]["attributed"] = attributed_s
        emit(line)
    return launches


# ---------------------------------------------------------------------------
# the paper's figures, the roofline and the regression gate
# ---------------------------------------------------------------------------

# fig3 over one distribution here (the three-distribution grid is a run
# of its own); every section at N_MAIN points with one timed rep; the
# tile sweep at the roofline's query count (the prep's per-block group
# bounds are query blocks x groups: 4096 queries in blocks of 8 over
# porth's 5M groups of 128 points would take 30 GB)
FIG_DISTS = "uniform"
FIG_REPS = 1
SWEEP_NQ = 256
# brute-force checks take this many sampled queries a call
BRUTE_CHUNK = 32
# kinds whose deletes run the row-bbox kernel (kd and zd rebuild)
DYNAMIC_KINDS = ("porth", "spac-h", "spac-z", "cpam-h", "cpam-z")
MORTON_KINDS = ("zd", "spac-z", "cpam-z")
# The spac family's incremental deletes leave deleted points behind at
# scale, as the reference's do (ROADMAP queue 3, root cause open): the
# points each such delete leaves, as the card left them on these seeds
# at N_MAIN points on an H100 (none missing). The JAX reference
# leaves the same count as the port on the same arrays at 4 x 10^6
# varden points (tests/spac_delete_shortfall.py). Any other count, or a
# difference in another kind, fails.
SPAC_LEFTOVERS = {
    "fig3 uniform/spac-h inc_del_0.01": 61,
    "fig3 uniform/spac-z inc_del_0.01": 53,
    "fig3 uniform/cpam-h inc_del_0.01": 61,
    "fig3 uniform/cpam-z inc_del_0.01": 53,
    "fig3 varden/spac-h inc_del_0.01": 403,
    "fig3 varden/spac-z inc_del_0.01": 211,
    "fig3 varden/cpam-h inc_del_0.01": 403,
    "fig3 varden/cpam-z inc_del_0.01": 211,
    "fig9 varden/spac-h del": 14,
    "fig9 varden/spac-z del": 76,
}


def _live_points(spec: dict, cache: dict, dev):
    """The live points a figure's detail names: a slice of the
    generator's points (regenerated from its seed), on the card."""
    from benchmarks.port import common as bench
    key = (spec["dist"], spec["n"], spec["seed"], spec["dim"])
    if key not in cache:
        cache.clear()
        cache[key] = torch.as_tensor(
            bench.points_for(spec["dist"], spec["n"], spec["seed"],
                             spec["dim"]), device=dev)
    return cache[key][: spec["stop"]]


def brute_knn(live, qs, k: int):
    """The k smallest direct-form f32 distances of each query (the
    kernels' arithmetic: per-dimension difference, square, summed in
    dimension order)."""
    pf = live.float()
    out = []
    for a in range(0, qs.shape[0], BRUTE_CHUNK):
        q = qs[a: a + BRUTE_CHUNK]
        acc = None
        for d in range(pf.shape[1]):
            dd = q[:, None, d] - pf[None, :, d]
            acc = dd * dd if acc is None else acc + dd * dd
        out.append(torch.topk(acc, k, dim=1, largest=False).values)
    return torch.cat(out)


def brute_range(live, lo, hi):
    """Per box: the int64 count of live points inside and the inside
    mask's points."""
    p = live.long()
    counts = []
    for a in range(0, lo.shape[0], BRUTE_CHUNK):
        inside = ((p[None] >= lo[a: a + BRUTE_CHUNK, None])
                  & (p[None] <= hi[a: a + BRUTE_CHUNK, None])).all(-1)
        counts.append(inside.sum(1))
    return torch.cat(counts)


def listed_points(live, lo, hi) -> list:
    p = live.long()
    inside = ((p >= lo) & (p <= hi)).all(-1)
    pts = p[inside].cpu().numpy()
    return pts[np.lexsort(pts.T[::-1])].tolist()


def figure_checks(details: dict, dev) -> dict:
    """Every figure's details against brute force on the live points its
    trace implies: kNN distances bit-equal, range counts and listed
    points equal, live sizes as the update sequences imply."""
    cache: dict = {}
    out = {"knn": 0, "knn_queries": 0, "range": 0, "range_boxes": 0,
           "listed_boxes": 0, "sizes": 0, "ks": set(), "dims": set(),
           "spac_leftovers": {}}
    for fig in ("fig3", "fig4", "fig5", "fig10", "fig9"):
        for key, det in details.get(fig, {}).items():
            if key.startswith("_"):
                continue
            for name, (got, want, *audit) in det.get("sizes", {}).items():
                out["sizes"] += 1
                if got != want:
                    out["spac_leftovers"][f"{fig} {key} {name}"] = {
                        "got": got, "want": want,
                        **(audit[0] if audit else {})}
            for name, kd in det.get("knn", {}).items():
                live = _live_points(kd["live"], cache, dev)
                qs = torch.tensor(kd["queries"], dtype=torch.float32,
                                  device=dev)
                want = brute_knn(live, qs, kd["k"])
                got = torch.tensor(kd["d2"], dtype=torch.float32,
                                   device=dev)
                check(torch.equal(got, want), f"{fig} {key} {name}: kNN "
                      f"d2 differs from the brute-force scan")
                out["knn"] += 1
                out["knn_queries"] += qs.shape[0]
                out["ks"].add(kd["k"])
                out["dims"].add(kd["live"]["dim"])
            for group in ("range_count", "range_list"):
                for name, rd in det.get(group, {}).items():
                    live = _live_points(rd["live"], cache, dev)
                    lo = torch.tensor(rd["lo"], device=dev).long()
                    hi = torch.tensor(rd["hi"], device=dev).long()
                    want = brute_range(live, lo, hi)
                    check(torch.equal(torch.tensor(rd["counts"],
                                                   device=dev).long(), want),
                          f"{fig} {key} {name}: range counts differ from "
                          f"an int64 brute-force count")
                    for i, pts in enumerate(rd.get("listed", [])):
                        check(pts == listed_points(live, lo[i], hi[i]),
                              f"{fig} {key} {name}: box {i} listed other "
                              f"points than brute force finds")
                        out["listed_boxes"] += 1
                    out["range"] += 1
                    out["range_boxes"] += lo.shape[0]
    del cache
    # every size as the updates imply, except the pinned spac leftovers
    # (listed all at once, so one run reports every count)
    odd = {label: a for label, a in out["spac_leftovers"].items()
           if not (a.get("missing") == 0
                   and a.get("extra") == a["got"] - a["want"]
                   == SPAC_LEFTOVERS.get(label))}
    check(not odd, f"figures: live sizes other than the updates imply "
          f"and the pinned leftovers: {odd}")
    out["ks"], out["dims"] = sorted(out["ks"]), sorted(out["dims"])
    check({1, 10, 100} <= set(out["ks"]) and {2, 3} <= set(out["dims"]),
          f"figures: kNN checked at k {out['ks']}, dims {out['dims']}")
    return out


def figure_launches(details: dict) -> dict:
    """Every figure's kNN ran the frontier kernel, every porth build the
    sieve, every zd, spac-z and cpam-z build Morton, every dynamic
    kind's delete row-bbox; returns the launches summed by kernel."""
    total = dict.fromkeys(KERNELS, 0)
    for fig in ("fig3", "fig4", "fig5", "fig10", "fig9"):
        for key, det in details.get(fig, {}).items():
            if key.startswith("_"):
                continue
            kind = key.split("/")[-1]
            ops = det["launches"]
            for op, by in ops.items():
                for name, n in by.items():
                    total[name] += n
            if "knn" in ops:
                check(ops["knn"]["knn_frontier"] > 0,
                      f"{fig} {key}: the frontier kernel never launched")
            if fig == "fig4":
                check(ops.get("knn_flat", {}).get("knn_flat", 0) > 0,
                      f"fig4 {key}: the forced flat route never launched "
                      f"the flat kernel")
            if kind == "porth":
                check(ops["build"]["sieve"] > 0,
                      f"{fig} {key}: the sieve never launched on a build")
            if kind in MORTON_KINDS:
                check(ops["build"]["morton"] > 0,
                      f"{fig} {key}: Morton never launched on a build")
            if kind in DYNAMIC_KINDS and "delete" in ops:
                check(ops["delete"]["row_bbox"] > 0,
                      f"{fig} {key}: row-bbox never launched on a delete")
    return total


def plan_cost_check(dev) -> dict:
    """One spac-h kNN batch (main's configuration) under
    ``Recorder(capture_costs=True)``: a ``plan.cost.knn.*`` signature
    with device time and the frontier kernel among its launches."""
    pts = gen.uniform(SEED, N_MAIN)
    idx = make_index("spac-h", pts, phi=PHI, device=dev, coord_bits=20)
    q = torch.as_tensor(gen.uniform(SEED + 7, QUERIES), device=dev)
    with obs.recording(obs.Recorder(capture_costs=True)) as rec:
        idx.knn(q, K)
        sync()
    costs = obs.costs.plan_costs(rec.counters)
    knn = {s: c for s, c in costs.items() if s.startswith("knn.")}
    check(knn, f"costs: no kNN plan captured ({sorted(costs)})")
    sig = max(knn, key=lambda s: knn[s]["device_us"])
    kernels = rec.cost_kernels[sig]
    check(knn[sig]["device_us"] > 0, f"costs: {sig} has no device time")
    check(any("frontier_walk" in name for name in kernels),
          f"costs: {sig} launched {sorted(kernels)}, not the frontier "
          f"kernel")
    return {"sig": sig, **knn[sig], "kernels": kernels}


def regress_gate(tmp: str) -> dict:
    """The regression gate three times: ``--update`` into ``tmp``, the
    gate against it (exit 0), and a replay of the gate's snapshot with
    every time metric degraded 2x (must fail)."""
    base, snap = f"{tmp}/regress_smoke.json", f"{tmp}/BENCH_1.json"
    t0 = time.perf_counter()
    run_cli(["repro_torch.obs.regress", "--update", "--baseline", base,
             "--quiet"], timeout=600)
    run_cli(["repro_torch.obs.regress", "--baseline", base, "--snapshot",
             snap], timeout=600)
    gate = json.loads(pathlib.Path(snap).read_text())
    run_cli(["repro_torch.obs.regress", "--replay", snap, "--baseline",
             base, "--inject-scale", "2", "--tol", "0.5", "--no-snapshot",
             "--quiet"], timeout=120, ok=False)
    return {"metrics": len(gate["metrics"]), "regressed": gate["regressed"],
            "baseline_problems": gate["baseline_problems"],
            "seconds": time.perf_counter() - t0}


def figures_phase(dev) -> dict:
    """``python -m benchmarks.port.run`` at N_MAIN points (fig3 over the
    uniform distribution, one timed rep, fig4's forced routes as its
    ``--json`` sweeps them, the frontier tile sweep), its details held
    against brute force, fig3's claims, a plan-cost capture and the
    regression gate; returns the launches by kernel."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        details_path = f"{tmp}/details.json"
        run_cli(["benchmarks.port.run", "--n", str(N_MAIN), "--dists",
                 FIG_DISTS, "--reps", str(FIG_REPS), "--block-sweep",
                 "--sweep-nq", str(SWEEP_NQ), "--json", f"{tmp}/payloads",
                 "--details", details_path], timeout=900)
        details = json.loads(pathlib.Path(details_path).read_text())
        run_s = time.perf_counter() - t0
        routes = {name.split("_")[0] for det in details["fig4"].values()
                  for name in det["knn"]}
        check(routes == {"flat", "frontier", "ind", "ood"},
              f"fig4 ran the kNN routes {sorted(routes)}")
        checks = figure_checks(details, dev)
        free()
        launches = figure_launches(details)
        sweep = details["block_sweep"]
        check(sweep["all_bit_equal"], "block sweep: a tile's answers "
              "differ from the default tile's")
        emit({"phase": "figures-claims", "dists": FIG_DISTS,
              "claims": details["fig3"]["_validate"]})
        emit({"phase": "figures-block-sweep", "n": N_MAIN,
              "queries": SWEEP_NQ, **sweep})
        costs = plan_cost_check(dev)
        free()
        gate = regress_gate(tmp)
    emit({"phase": "figures", "n": N_MAIN,
          # the cuts against the full grid: reps, fig3's distributions
          "reduced": {"reps": FIG_REPS, "of_reps": 3,
                      "fig3_dists": FIG_DISTS},
          "sections_s": details["sections_s"], "run_s": run_s,
          "checks": checks, "launches": launches,
          "peak_bytes": {fig: {key: det.get("peak_bytes")
                               for key, det in details[fig].items()
                               if not key.startswith("_")}
                         for fig in ("fig3", "fig4", "fig5", "fig10",
                                     "fig9")},
          "roofline_plans": details["roofline"], "plan_cost": costs,
          "regress": gate, "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# the LM serving path and the flash-attention kernel
# ---------------------------------------------------------------------------

def kernel_label(mangled: str) -> str:
    """``flash_tc_kernel<128>`` from the mangled name of a template
    instantiation of this repo's kernels."""
    m = re.search(r"\d+(flash_\w+?_kernel)I(.+?)EEv", mangled)
    if m is None:
        return mangled
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"Li(\d+)E", r"\1,", args)
    args = re.sub(r"^f", "f32,", args)
    return f"{m.group(1)}<{args.rstrip(',')}>"


def flash_attn_build(ptxas: str) -> dict:
    """Registers and spill bytes of every flash-attention kernel from
    ``ptxas -v``, and the ``HMMA`` (tensor-core) instructions of each in
    the library's SASS (``cuobjdump -sass``); every tc instantiation
    must hold some."""
    kernels, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
            kernels[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels[name]["spill_store_bytes"] = int(m.group(1))
            kernels[name]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.lib_path("flash_attn"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            kernels.setdefault(name, {})["hmma"] = 0
        elif name and "HMMA" in line:
            kernels[name]["hmma"] += 1
    tc = {k: v for k, v in kernels.items() if k.startswith("flash_tc_")}
    check(len(tc) == len(fak.TC_DIMS) and all(v.get("hmma", 0) > 0
                                              for v in tc.values()),
          f"build: tc kernels without HMMA instructions: {tc}")
    check(all("registers" in v for v in kernels.values()),
          f"build: ptxas reported no registers for some kernels: {kernels}")
    return kernels


@contextlib.contextmanager
def patched(obj, name: str, fn):
    """``obj.name = fn`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def variant_counts() -> dict:
    """Flash-attention wrapper calls by variant since the last reset."""
    return {v: fak.launch_count(v) for v in fak.VARIANTS}


class LMProbe:
    """Wraps ``transformer.prefill`` and ``transformer.decode_step`` where
    the engine calls them: CUDA events around each call (no host read),
    the flash-attention launches of each forward, and, for the last
    generate, the inputs of layer 0's attention in the prefill and in the
    decode step that starts at cache length ``capture_len``."""

    def __init__(self, capture_len: int):
        self.events = {"prefill": [], "decode": []}
        self.launches = {"prefill": [], "decode": []}
        self.variants = {"prefill": [], "decode": []}
        self.capture = False
        self.capture_len = capture_len
        self.captured = {}
        self._slot = None

    def attention(self, orig):
        def run(q, k, v, **kw):
            if self._slot is not None:
                self.captured[self._slot] = (q, k, v, kw)
                self._slot = None
            return orig(q, k, v, **kw)
        return run

    def forward(self, orig, phase: str):
        def run(model, *args):
            if self.capture and (phase == "prefill"
                                 or args[0]["len"] == self.capture_len):
                self._slot = phase
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = fak.launch_count()
            by_before = variant_counts()
            start.record()
            out = orig(model, *args)
            end.record()
            self.events[phase].append((start, end))
            self.launches[phase].append(fak.launch_count() - before)
            self.variants[phase].append(
                {k: n - by_before[k] for k, n in variant_counts().items()})
            return out
        return run


def lm_phase(dev) -> tuple[dict, dict]:
    """qwen1.5-0.5b at full width and depth, bf16, seeded random weights,
    through ``ServeEngine.generate``: 1 warm-up and 3 measured generates
    of 8 x 2048 prompt tokens and 128 greedy new tokens, each under sync
    debug mode "error". Every forward must launch the flash-attention
    kernel once a layer. Then an f32 rerun of the same weights must meet
    ``examples/serve_lm.py``'s bar (greedy decode agrees with the argmax
    of the teacher-forced forward at >= 99% of positions), and one
    prefill and one decode step are profiled. Returns the phase's line
    and the kernel's row."""
    cfg = configs.ARCHS[LM_ARCH]
    L = cfg.n_layers
    # f32 products in full f32 (PyTorch's default, stated for the rerun)
    torch.backends.cuda.matmul.allow_tf32 = False
    free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = transformer.DecoderLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED))
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 19)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH,
                                                          LM_PROMPT)),
                              device=dev)
    sync()
    engine = ServeEngine(cfg, model, LM_MAX_LEN)
    probe = LMProbe(LM_PROMPT + LM_NEW - 2)
    runs = LM_WARMUP + LM_REPS
    outs, gen_s = [], []
    reset_counts()
    with patched(transformer, "prefill",
                 probe.forward(transformer.prefill, "prefill")), \
            patched(transformer, "decode_step",
                    probe.forward(transformer.decode_step, "decode")), \
            patched(fak, "flash_attention",
                    probe.attention(fak.flash_attention)):
        for r in range(runs):
            probe.capture = r == runs - 1
            sync()
            t1 = time.perf_counter()
            with sync_debug_error():
                out = engine.generate(prompts, LM_NEW)
            sync()
            if r >= LM_WARMUP:
                gen_s.append(time.perf_counter() - t1)
                outs.append(out)
    launches = counts()
    by_variant = variant_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = LM_NEW - 1
    prefill_ms = [a.elapsed_time(b) for a, b in
                  probe.events["prefill"][LM_WARMUP:]]
    decode_ms = np.array([a.elapsed_time(b) for a, b in
                          probe.events["decode"][LM_WARMUP * steps:]])
    per_fwd = probe.launches["prefill"] + probe.launches["decode"]
    check(len(probe.launches["prefill"]) == runs
          and len(probe.launches["decode"]) == runs * steps,
          "lm: the engine did not run one prefill and n_new - 1 decode "
          "steps a generate")
    check(all(n == L for n in per_fwd), f"lm: a forward launched the "
          f"flash-attention kernel {sorted(set(per_fwd))} times, not {L}")
    check(launches["flash_attn"] == runs * LM_NEW * L,
          f"lm: {launches['flash_attn']} flash-attention launches, not "
          f"{runs * LM_NEW * L}")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attn"),
          f"lm: other kernels launched: {launches}")
    only = {"prefill": {"tc": L, "decode": 0, "simt": 0},
            "decode": {"tc": 0, "decode": L, "simt": 0}}
    for phase, want in only.items():
        got = [c for c in probe.variants[phase] if c != want]
        check(not got, f"lm: a bf16 {phase} forward took flash-attention "
              f"variants {got[:1]}, not {want}")
    last = outs[-1]
    check(last.shape == (LM_BATCH, LM_NEW) and last.dtype == torch.int32
          and bool(((last >= 0) & (last < cfg.vocab)).all()),
          "lm: generated tokens out of shape or vocabulary")

    # the f32 rerun of the same weights
    cfg32 = cfg.with_(act_dtype="float32")
    m32 = transformer.DecoderLM(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    p32 = prompts[:LM_F32_BATCH, :LM_F32_PROMPT]
    reset_counts()
    out32 = ServeEngine(cfg32, m32, LM_F32_PROMPT + LM_F32_NEW).generate(
        p32, LM_F32_NEW)
    f32_launches = counts()["flash_attn"]
    f32_variants = variant_counts()
    with torch.inference_mode():
        logits = transformer.forward(m32, torch.cat([p32, out32.long()], 1))
    ref = logits[:, LM_F32_PROMPT - 1:-1].argmax(-1)
    agree = float((ref == out32).float().mean())
    check(bool(torch.isfinite(logits).all()), "lm: f32 logits not finite")
    del m32, logits
    check(f32_launches == LM_F32_NEW * L, f"lm: the f32 rerun launched the "
          f"kernel {f32_launches} times")
    check(f32_variants == {"tc": 0, "decode": (LM_F32_NEW - 1) * L,
                           "simt": L},
          f"lm: the f32 rerun took flash-attention variants {f32_variants}")
    check(agree >= LM_AGREE, f"lm: f32 greedy decode agrees with the "
          f"teacher-forced forward at {agree:.4f} of positions")

    # one prefill and one decode step under the profiler (not counted)
    with torch.inference_mode():
        prof_prefill = device_ops(
            lambda: transformer.prefill(model, prompts, LM_MAX_LEN), top=8)
        lg, cache = transformer.prefill(model, prompts, LM_MAX_LEN)
        check(bool(torch.isfinite(lg).all()), "lm: prefill logits not finite")
        tok = lg[:, -1].argmax(-1, keepdim=True)
        prof_decode = device_ops(
            lambda: transformer.decode_step(model, cache, tok), top=8)
    del cache, lg
    kv_bytes = 2 * L * LM_BATCH * cfg.n_kv_heads * LM_MAX_LEN * cfg.hd * 2
    out = {"phase": "lm", "arch": LM_ARCH, "dtype": cfg.act_dtype,
           "params": transformer.param_count(model),
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
           "max_len": LM_MAX_LEN, "warmup": LM_WARMUP, "reps": LM_REPS,
           "init_s": init_s,
           "prefill_ms": float(np.mean(prefill_ms)),
           "prefill_ms_each": prefill_ms,
           "decode_ms_per_token": {
               "p50": float(np.percentile(decode_ms, 50)),
               "p99": float(np.percentile(decode_ms, 99)),
               "mean": float(decode_ms.mean()), "count": int(decode_ms.size)},
           "generate_s_each": gen_s,
           "tokens_per_s": LM_BATCH * LM_NEW / float(np.mean(gen_s)),
           "peak_allocated_bytes": peak, "allocated_before_bytes": base,
           "kv_cache_bytes": kv_bytes,
           "flash_attn_launches": {
               "per_generate": {"prefill": L, "decode": steps * L},
               "total": launches["flash_attn"], "runs": runs,
               "by_variant": by_variant},
           "launches": launches,
           "repeat_tokens_equal": all(bool(torch.equal(o, last))
                                      for o in outs),
           "generates_under_sync_debug_error": runs,
           "f32_rerun": {"batch": LM_F32_BATCH, "prompt": LM_F32_PROMPT,
                         "new": LM_F32_NEW, "agreement": agree,
                         "bar": LM_AGREE, "launches": f32_launches,
                         "launches_by_variant": f32_variants},
           "profile_prefill": prof_prefill, "profile_decode": prof_decode}
    row = flash_attn_kernel_row(probe.captured, {
        "lm": launches["flash_attn"],
        "lm_prefill": sum(probe.launches["prefill"]),
        "lm_decode": sum(probe.launches["decode"]),
        "lm_f32_rerun": f32_launches}, {
        "lm": by_variant, "lm_f32_rerun": f32_variants}, dev)
    del probe, model, engine, outs
    free()
    return out, row


def attn_pairs(Sq: int, Skv: int, causal: bool, window, q_offset: int) -> int:
    """(query, kv) pairs the masks leave visible, with kv at positions
    0..Skv-1 and queries at q_offset..q_offset+Sq-1."""
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv - 1, qp) if causal else np.full(Sq, Skv - 1)
    lo = (np.maximum(0, qp - window + 1) if window is not None
          else np.zeros(Sq, np.int64))
    return int(np.maximum(0, hi - lo + 1).sum())


def attn_compare(q, k, v, kw: dict, variant: str | None = None) -> dict:
    """A flash-attention variant (the one the wrapper picks, or the one
    named) against the plain version on (q, k, v) at the tolerance of
    their dtype: the largest error, the largest share of the allowed
    error (<= 1 passes) and the mean |output|."""
    used = variant or fak.variant_for(q, k, v)
    got = fak._launch(used, q, k, v, **kw).float()
    want = attention_plain(q, k, v, **kw).float()
    tol = ATTN_TOL[q.dtype]
    diff = (got - want).abs()
    share = float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())
    return {"variant": used, "max_abs_err": float(diff.max()),
            "tolerance_share": share, "all_close": share <= 1.0,
            "tolerance": tol, "mean_abs_out": float(want.abs().mean())}


def f32_copy(t):
    """``t`` in f32 with ``t``'s own strides (a prefix view stays one)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=torch.float32,
                               device=t.device).copy_(t)


def attn_at(q, k, v, kw: dict, library) -> dict:
    """The flash-attention kernel on (q, k, v) against its plain version,
    in their dtype and on f32 copies of them (``attn_compare``);
    ``library`` is one ``scaled_dot_product_attention`` call of the same
    function, timed beside it. The bound counts q, k, v read once and the
    output written once over 3.35 TB/s, and 4 d operations per visible
    (query, kv) pair over the bf16 tensor-core peak. The variant the
    wrapper picks is timed beside ``simt`` on the same inputs, in turns
    (plain, variant, simt, variant), and both are checked; one call of
    it runs under the profiler (its kernels' device time: decode's split
    and merge launches apart)."""
    cmp = attn_compare(q, k, v, kw)
    cmp_simt = attn_compare(q, k, v, kw, "simt")
    cmp32 = attn_compare(f32_copy(q), f32_copy(k), f32_copy(v), kw)
    want = attention_plain(q, k, v, **kw)
    lib_err = float((library().float() - want.float()).abs().max())
    del want
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    variant = cmp["variant"]
    plain_ms = time_ms(lambda: attention_plain(q, k, v, **kw), reps=2)
    turns = [time_ms(lambda: fak._launch(variant, q, k, v, **kw), reps=10)]
    cmp_simt["ms"] = time_ms(lambda: fak._launch("simt", q, k, v, **kw),
                             reps=3)
    turns.append(time_ms(lambda: fak._launch(variant, q, k, v, **kw),
                         reps=10))
    ms = float(np.mean(turns))
    library_ms = time_ms(library, reps=10)
    device = device_ops(lambda: fak._launch(variant, q, k, v, **kw), top=3)
    pairs = attn_pairs(Sq, Skv, kw["causal"], kw.get("window"),
                       kw["q_offset"])
    bytes_moved = (2 * B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * \
        q.element_size()
    ops = 4 * B * Hq * d * pairs
    b_ms, by, how = bound(bytes_moved, ops, BF16_TC_OPS_PER_S,
                          "bf16 tensor-core")
    return {**cmp, "all_close": (cmp["all_close"] and cmp32["all_close"]
                                 and cmp_simt["all_close"]),
            "f32_copy": cmp32, "simt": cmp_simt, "ms": ms, "ms_turns": turns,
            "simt_ms": cmp_simt["ms"], "device_profile": device,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms,
            "library_max_abs_err": lib_err,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Skv": Skv,
                      "d": d, "dtype": str(q.dtype),
                      "causal": kw["causal"], "window": kw.get("window"),
                      "q_offset": kw["q_offset"], "visible_pairs": pairs,
                      "q_contiguous": q.is_contiguous(),
                      "k_contiguous": k.is_contiguous()},
            "bound_terms": how}


def window_mask(S: int, window: int, dev):
    pos = torch.arange(S, device=dev)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] >
                                             pos[:, None] - window)


def flash_attn_kernel_row(captured: dict, launches: dict, by_variant: dict,
                          dev) -> dict:
    """The kernel at the LM path's own inputs (layer 0 of one prefill,
    and of the decode step at Skv = 2175 through the cache's prefix
    view), and at yi-9b's GQA and h2o-danube-1.8b's window shapes on
    seeded inputs: each case names the variant the wrapper took."""
    check(set(captured) == {"prefill", "decode"},
          f"lm: captured attention inputs {sorted(captured)}")
    q, k, v, kw = captured["prefill"]
    at_prefill = attn_at(q, k, v, kw, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    q, k, v, kw = captured["decode"]
    check(k.shape[2] == LM_MAX_LEN - 1 and not k.is_contiguous(),
          f"lm: decode attention got kv {tuple(k.shape)}, contiguous "
          f"{k.is_contiguous()}")
    at_decode = attn_at(q, k, v, kw, lambda: F.scaled_dot_product_attention(
        q, k, v))
    del q, k, v, captured["prefill"], captured["decode"]
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    extra = {}
    for name, (B, Hq, Hkv, S, d, window) in ATTN_EXTRA.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((B, Hq, S, d), (B, Hkv, S, d),
                                          (B, Hkv, S, d)))
        kw = dict(causal=True, window=window, q_offset=0, k_pos=None)
        mask = None if window is None else window_mask(S, window, dev)
        extra[name] = attn_at(q, k, v, kw, lambda: (
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            if mask is None else F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)))
        del q, k, v, mask
    cases = [at_prefill, at_decode, *extra.values()]
    ok = all(c["all_close"] for c in cases)
    check(ok, "flash_attn: kernel differs from its plain version beyond "
          "the tolerance (share of the allowed error, bf16 variant / bf16 "
          "simt / f32): " + ", ".join(
              f"{c['variant']} {c['tolerance_share']:.3g} / "
              f"{c['simt']['tolerance_share']:.3g} / "
              f"{c['f32_copy']['tolerance_share']:.3g}" for c in cases))
    check([c["variant"] for c in cases] == ["tc", "decode", "tc", "tc"],
          f"flash_attn: the cases took {[c['variant'] for c in cases]}")
    return {"name": "flash_attn", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/kernel.py:83",
            "launches": launches["lm"], "launches_by_path": launches,
            "launches_by_variant": by_variant,
            **at_prefill,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "f32_max_abs_err": max(c["f32_copy"]["max_abs_err"]
                                   for c in cases),
            "all_close": ok,
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            " (timed here only; the port never calls it)",
            "at_decode": at_decode, **extra}


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script drives the port on an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    report = build.build()
    build_s = time.perf_counter() - t0
    if "flash_attn" not in report:  # a library left by an earlier run
        report.update(build.build(["flash_attn"], force=True))
    flash_build = flash_attn_build(report["flash_attn"]["ptxas"])
    emit({"phase": "build", "seconds": build_s,
          "kernels": {k: v["seconds"] for k, v in report.items()},
          "flash_attn": flash_build})

    lm, flash_row = lm_phase(dev)
    emit(lm)

    main_run = run_server("main", "spac-h", N_MAIN, BATCH, STEPS, WARMUP,
                          dev, coord_bits=20)
    emit(main_run["summary"])
    main_launches = main_run["summary"]["launches"]
    check(set(main_run["summary"]["routes"]) == {"frontier-kernel:cuda"},
          f"main: auto took {main_run['summary']['routes']}")
    check(main_launches["knn_frontier"] > 0,
          "main: the frontier kernel never launched")
    check(main_run["summary"]["launches_by_op"]["delete"]["row_bbox"] > 0,
          "main: the row-bbox kernel never launched on a delete")
    brute_check("main", main_run, N_CHECK, dev)
    frontier_breakdown("main", main_run, dev)

    porth_run = run_server("porth", "porth", N_MAIN, BATCH, STEPS, WARMUP,
                           dev)
    porth_run["summary"]["lam"] = porth_run["snap"].index.tree.lam
    emit(porth_run["summary"])
    porth_ops = porth_run["summary"]["launches_by_op"]
    check(set(porth_run["summary"]["routes"]) == {"frontier-kernel:cuda"},
          f"porth: auto took {porth_run['summary']['routes']}")
    check(porth_ops["build"]["sieve"] > 0,
          "porth: the sieve kernel never launched on the build")
    check(porth_ops["insert"]["sieve"] > 0,
          "porth: the sieve kernel never launched on an insert")
    check(porth_ops["delete"]["row_bbox"] > 0,
          "porth: the row-bbox kernel never launched on a delete")
    check(porth_ops["query"]["knn_frontier"] > 0,
          "porth: the frontier kernel never launched")
    brute_check("porth", porth_run, N_CHECK, dev)
    frontier_breakdown("porth", porth_run, dev)
    free()

    kd_run = run_baseline("kd", dev, max_depth=24)
    zd_run = run_baseline("zd", dev, bits=15, coord_bits=20, lam=3)
    zd_ops = zd_run["summary"]["launches_by_op"]
    check(zd_ops["build"]["morton"] > 0,
          "zd: the Morton kernel never launched on the build")
    for s, step in enumerate(zd_run["by_step"]):
        for op in ("delete", "insert"):
            check(step[op]["morton"] > 0, f"zd: the Morton kernel never "
                  f"launched on step {s}'s {op}")
    build_compare(kd_run, zd_run, porth_run, dev)

    flat_run = run_server("flat", "spac-h", N_FLAT, 256, 2, 1, dev,
                          coord_bits=20)
    emit(flat_run["summary"])
    flat_launches = flat_run["summary"]["launches"]
    check(set(flat_run["summary"]["routes"]) == {"flat:cuda"},
          f"flat: auto took {flat_run['summary']['routes']}")
    check(flat_launches["knn_flat"] > 0, "flat: the flat kernel never "
          "launched")
    brute_check("flat", flat_run, QUERIES, dev)
    spacz_pts, spacz = spacz_morton(dev)
    emit({"phase": "sync", "inserts_under_sync_debug_error":
          2 * STEPS + 2 + 1, "raised": False})

    def by_path(name):
        out = {p: r["summary"]["launches"][name] for p, r in
               (("main", main_run), ("porth", porth_run), ("kd", kd_run),
                ("zd", zd_run), ("flat", flat_run))}
        out["spac-z"] = spacz["launches"][name]
        return out

    frontier = frontier_kernel_row(main_run, main_launches["knn_frontier"],
                                   dev)
    at_porth = frontier_kernel_row(porth_run, porth_ops["query"][
        "knn_frontier"], dev, n_blocks=FRONTIER_PORTH_BLOCKS)
    frontier["bit_equal"] = frontier["bit_equal"] and at_porth["bit_equal"]
    frontier["at_porth"] = {k: v for k, v in at_porth.items()
                            if k not in ("name", "route", "source",
                                         "replaces")}
    frontier["launches_by_path"] = by_path("knn_frontier")
    rows = [flat_kernel_row(flat_run, flat_launches["knn_flat"], dev),
            frontier,
            row_bbox_kernel_row(porth_run, main_run, by_path("row_bbox")),
            sieve_kernel_row(porth_run, by_path("sieve"), dev),
            morton_kernel_row(zd_run["boot"], spacz_pts, by_path("morton")),
            flash_row]
    del main_run, porth_run, kd_run, zd_run, flat_run, spacz_pts, spacz
    free()
    driver_launches = driver_phase(dev)
    free()
    fig_launches = figures_phase(dev)
    for r in rows:
        for kind, launches in driver_launches.items():
            if r["name"] in launches:
                r.setdefault("launches_by_path", {})[f"driver-{kind}"] = \
                    launches[r["name"]]
        if r["name"] in fig_launches:
            r.setdefault("launches_by_path", {})["figures"] = \
                fig_launches[r["name"]]
        emit({"phase": "kernel", **r})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
