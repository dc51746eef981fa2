"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line (``"phase": ...``):

1. env    -- torch/CUDA versions; the card's name and power limit (the raw
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed
             on its own line too).
2. build  -- compiles every CUDA kernel from ``src/repro_torch/csrc`` with
             nvcc, one process per source, all started together; prints
             ptxas's registers and spill bytes for each flash-attention
             kernel, forward and backward, and the ``HMMA`` (tensor-core)
             instructions of each in ``cuobjdump -sass``: every tc
             instantiation must hold some.
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
3b. train -- the LM training path at full width and depth: qwen1.5-0.5b
             in its own bf16 (remat "dots"), seeded weights, ``lm_batch``
             at 4 x 2048 tokens, 1 warm-up and 8 measured steps of
             ``make_train_step``. Every loss must be finite; every step
             must launch the flash-attention kernel's tc variant twice a
             layer (the forward and remat's recompute) and each of the
             three backward kernels (``csrc/flash_attn_bwd.cu``: delta,
             dkdv, dq) once a layer; no index kernel. Step ms p50/p99,
             tokens/s, peak allocated bytes, launches by kernel and
             variant, one step's device profile. Then 2 layers of the
             full width at f32 (batch 2 x 512): gradients through the
             kernels against ``attention_plain`` under autograd (each
             leaf within 1e-4 of its largest); then the reference's
             launcher (``repro_torch.launch.train --arch qwen1.5-0.5b
             --steps 20 --batch 4 --seq 2048 --ckpt-dir <tmp>``, f32 as
             the launcher forces it) in-process, whose own loss-decrease
             check must hold, and its ``--resume``, whose losses must
             equal the first run's after the checkpoint bit for bit.
             The backward kernels' row: against their plain version on
             one layer's inputs of a measured step (bf16, and f32 copies)
             and at a GQA and window shape, within ``BWD_TOL``; the
             forward's o and lse against ``attention_lse_plain`` (within
             ``ATTN_TOL`` and ``LSE_TOL``) and the kernel chain's
             gradients against the plain chain's (within ``CHAIN_TOL``);
             tc against its mirror ``attention_bwd_tc_plain`` (within
             one bf16 ulp + ``TC_MIRROR_TOL``); its time by events and
             each kernel's (delta, tc's wgmma dkdv and dq) by the
             profiler, it and the library's backward queued behind a
             spin kernel (device-bound, by events), the tc kernels'
             ptxas registers and spills, their HGMMA (and no HMMA) in
             the SASS, the source's build seconds, and the backward's
             share of the profiled step's device time.
3c. mixers -- the MoE, Mamba and RWKV6 mixers (bf16, seeded weights):
             (a) phi3.5-moe at full width (d_model 4096, 32 heads over 8
             kv heads of 128, 16 experts top-2 of d_ff 6,400, vocab
             32,064) and 12 of its 32 layers (32 need ~84 GB of bf16
             weights; 12 keep the script within its time limit), 1
             warm-up and 2 measured generates of 8 x 2,048 prompt tokens
             and 32 greedy new tokens under sync debug mode "error":
             every prefill launches flash attention's tc 12 times, every
             decode step its decode variant 12 times, no
             other kernel; logits finite; then 2 layers of the full width
             in f32 with capacity E / K (no token can drop): greedy
             decode agrees with the teacher-forced argmax at >= 99% of
             32 new tokens after 2 x 256. (b) rwkv6-3b at full width and
             depth (32 layers, d_model 2560, 40 heads of 64), the lm
             phase's shape: wkv6 (``csrc/wkv6.cu``) 32 times a forward and
             nothing else; the f32 rerun of the same weights at >= 99%.
             (c) jamba-1.5-large's Mamba layer at full width (d_inner
             16,384, d_state 16), alone: a prefill of 8 x 2,048 through
             ``mamba_block`` and 32 decode steps through its cache, one
             selective-scan launch (``csrc/selective_scan.cu``) a call;
             an f32 copy's step-by-step decode against its teacher-forced
             pass (1e-4 of the scale); then jamba's whole pattern at the
             smoke width (f32): decode against the card's forward and
             that forward against the CPU's, each within 1e-4 of the
             scale. Prefill ms, decode ms a token p50/p99, tokens/s, peak
             bytes, launches by kernel and variant, one profiled prefill
             and decode step. The rows: wkv6 on layer 0 of (b)'s measured
             prefill and selective_scan on (c)'s, each in bf16 and on f32
             copies against its plain version (within ``REC_TOL`` of the
             largest value), by events and the profiler, with the bound
             and "library: none", each kernel's MUFU, F2F, FP32 and LDS
             counts from its SASS and its device time at a quarter, a
             half and all of the path's heads or channels (its grid
             sweep); wkv6's device time a call in the profiled decode
             step; selective_scan's exponentials on the SFU (16 a clock
             an SM at the card's top SM clock, ``sfu_ms``, beside the
             bound); flash attention's tc and decode on
             phi's layer-0 inputs (d=128, GQA) beside
             ``scaled_dot_product_attention``.
3d. multimodal -- (a) seamless-m4t-large-v2, the encoder-decoder, at
             full width and depth (24 + 24 layers, d_model 1024, 16 heads
             of 64, vocab 256,206) and (b) internvl2-26b, the vision
             frontend stub, at full width and depth (48 layers, d_model
             6144, 48 heads over 8 kv heads of 128, vocab 92,553), bf16,
             seeded weights (the parameter counts must equal the
             reference's), after phi's memory is returned: 1 warm-up and
             2 measured greedy generates, each under sync debug mode
             "error", through ``encdec.prefill`` + ``decode_step`` (8
             requests of 1,024 frame embeddings, a 16-token prompt, 128
             new tokens) and ``transformer.prefill(..., prefix_embed=)``
             + ``decode_step`` (4 requests of 256 patch embeddings and
             1,024 tokens, 32 new). Every seamless prefill launches
             flash attention's tc 72 times (encoder, decoder self and
             cross attention) and every decode step its decode variant
             48 times; internvl2's 48 and 48; no other kernel. Encode ms
             (seamless), prefill ms, decode ms a token p50/p99,
             tokens/s, peak bytes, launches, one profiled prefill and
             decode step. Then each arch's weights cut to 2 (+ 2) layers
             of the full width in f32: greedy decode agrees with the
             teacher-forced forward's argmax at >= 99% of positions and
             every step's logits lie within 1e-4 of the forward's scale.
             The kernel at the new shapes (tc at seamless's encoder and
             cross attention, decode at its cross attention, tc and
             decode at internvl2's layer 0), each against its plain
             version as in 11, by events, queued (device-bound) and in a
             profile, beside ``scaled_dot_product_attention``.
3e. train-mixers -- rwkv6-3b uncut and jamba's "ma" pair trained in
             bf16 through the recurrence kernels' backward (their rows),
             the smoke configs' f32 gradients on the card against the
             CPU, and the launcher at rwkv6's smoke config with its
             resume.
3f. train-multimodal -- seamless-m4t-large-v2 uncut (24 + 24 layers)
             and internvl2-26b at full width cut to 8 of 48 layers
             (listed under ``reduced``: AdamW's f32 moments of 19.3 B
             parameters do not fit one card), bf16, remat "dots" (the
             encoder-decoder's layers recomputed whole), the launcher's
             batches at 4 x 2,048 tokens (seamless over 1,024 seeded
             frame embeddings, internvl2 after 256 seeded patches): 1
             warm-up and 4 measured ``make_train_step`` steps. Every
             measured step launches flash attention's tc twice and the
             backward's three kernels once (tc) for each attention call
             (seamless: its encoder's, decoder's and cross attention,
             72; internvl2: 8), no other kernel; every loss finite, and
             the warm-up batch's loss after the steps below its first.
             Step ms p50/p99, tokens/s, peak bytes, one profiled step's
             device ms, launches and busy share. The backward kernels on
             the kept inputs of seamless's cross attention (Sq 2,048
             over Skv 1,024) and encoder and of internvl2's layer, and on
             seeded inputs of the cross shape, as in the train phase's
             row (the mirror's atol grown with its sums' length; the
             chain held to its bar on the seeded inputs, and on the
             path's to its bar plus the exact move that the forward's o
             makes through D). Then 2 (+ 2) layers of each at f32:
             the kernels' gradients against ``attention_plain``'s (each
             leaf within 1e-4 of its largest); and the launcher at each
             smoke config (f32: simt forward and backward) with its
             ``--resume``, bit for bit.
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
14. dist   -- the mesh-sharded index: ``simulate_mesh(8)``, 8 lanes of
             the card, each holding one key-range shard. Per kind
             (spac-h at coord_bits=20, porth) the serving loop of phase 4 at
             10^7 points (1 warm-up and 2 measured steps, inserts under
             sync debug mode "error"): every shard's kNN must take the
             frontier kernel, porth's build and inserts the sieve, the
             deletes row-bbox; the last step's sampled answers are
             checked as in 5 and all its answers against a single-device
             index built over the same live points (d2 bit for bit,
             counts equal). Then a small mesh (N_FLAT points over 8
             lanes, R*C <= 2^15 a shard) through the flat kernel,
             checked the same way, and the driver's CLI with ``--mesh 8``
             at the driver phase's size (spac-h and porth): one line per
             kind with per-op p50/p99, rates, peak allocated bytes,
             recoveries by step, the shard sizes and the launches.
             Per kind, ``profile-dist-*``: one insert and one delete of
             10^5 points and one kNN call of 4096 queries on the last
             step's index, beside the single-device index over the same
             points: host time to return, time to a sync, kernels'
             device time and launches (``torch.profiler``), the routing
             exchange apart from the shard-local updates, the frontier
             calls apart from the merge.
15. figures -- the paper's figures on the port: ``python -m
             benchmarks.port.run`` at 10^7 points in a subprocess that
             must exit 0 (fig3 over the uniform distribution and all
             seven kinds, fig4 with its forced chunked-frontier and
             flat routes (``--json``), fig5, fig10, fig9 in 3D, the
             spatial roofline and the frontier kernel's tile sweep at 64
             queries; one timed rep each). Its details are held against
             brute force on the live points each figure's updates imply
             (regenerated from the generators' seeds): kNN distances bit
             for bit (k = 1, 10 and 100, InD and OOD, 2D and 3D), range
             counts and listed points exactly, and every live size (the
             spac family's deletes may leave deleted points behind, as
             the reference's do at scale, but lose none). The
             frontier kernel must launch on every figure's kNN, the sieve
             on every porth build, Morton on every zd, spac-z and cpam-z
             build, row-bbox on the dynamic kinds' deletes, the flat
             kernel on fig4's forced flat route; every tile of
             the sweep must give the default tile's answers bit for bit.
             Then fig3's paper claims as one line (a FAIL is a finding,
             not an error), one spac-h kNN batch under
             ``Recorder(capture_costs=True)`` (its plan must carry device
             time and the frontier kernel), and the regression gate
             (``python -m repro_torch.obs.regress``) three times:
             ``--update`` into a temporary file (the smoke tier, its
             ``dist`` suite included), the gate collecting the smoke tier
             anew against it (exit 0), and a replay of the gate's
             snapshot with every time metric degraded 2x (must fail).
             The phase prints its seconds.

Before the kernels' line, ``{"phase": "seconds", ...}`` gives each
phase's wall seconds and the total. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without the last line. Without CUDA it exits
with code 2 before printing anything to standard output.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.configs import platform  # noqa: E402
from repro_torch.core import (baselines, distributed,  # noqa: E402
                              make_index, porth, queries, spac)
from repro_torch.core.index import DistributedIndex  # noqa: E402
from repro_torch.data import points as gen  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bbox import kernel as bk  # noqa: E402
from repro_torch.data.tokens import embedding_batch, lm_batch  # noqa: E402
from repro_torch.kernels.flash_attn import backward as fab  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as fak  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    attention_bwd_plain, attention_bwd_tc_plain, attention_lse_plain,
    attention_plain)
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402
from repro_torch.kernels.frontier import ops as frontier_ops  # noqa: E402
from repro_torch.kernels.frontier import prep, tuning  # noqa: E402
from repro_torch.kernels.knn import kernel as kk  # noqa: E402
from repro_torch.kernels.knn import ref as kref  # noqa: E402
from repro_torch.kernels.morton import kernel as mk  # noqa: E402
from repro_torch.kernels.selective_scan import kernel as ssk  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_bwd_plain, selective_scan_plain)
from repro_torch.kernels.sieve import kernel as sk  # noqa: E402
from repro_torch.kernels.sieve import ops as sieve_ops  # noqa: E402
from repro_torch.kernels.sieve import ref as sieve_ref  # noqa: E402
from repro_torch.kernels.wkv import kernel as wk  # noqa: E402
from repro_torch.kernels.wkv.ref import (  # noqa: E402
    wkv6_bwd_plain, wkv6_plain)
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import encdec, ssm, transformer  # noqa: E402
from repro_torch.optim.adamw import OptCfg  # noqa: E402
from repro_torch.train import step as train_lib  # noqa: E402
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


# the training path: qwen1.5-0.5b at full width and depth in bf16 (remat
# "dots"), 4 x 2048 tokens a step, 1 warm-up and 8 measured steps
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 1, 8
# the model-level gradient check: 2 layers of the full width, f32
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 512
# each gradient leaf within this share of its largest magnitude (f32 sums
# in another order through 2 layers of products)
TRAIN_CHECK_REL = 1e-4
# the reference's launcher at the full config (it forces f32)
TRAIN_CLI_STEPS = 20
# the backward kernel's other features (B, Hq, Hkv, S, d, window): GQA
# and a window, at yi-9b's head width
BWD_EXTRA = {"gqa_window": (2, 32, 4, 1024, 128, 256)}
# the backward's kernels as torch.profiler names them (flash_bwd_<name>_kernel)
BWD_KERNELS = ("delta", "dkdv_wgmma", "dq_wgmma")
# tc's backward against its mirror (attention_bwd_tc_plain, the same
# arithmetic), each of dq, dk, dv: |got - want| <= one bf16 ulp of
# max(|got|, |want|) + this share of the largest |want| of the three (both
# round f32 sums once to bf16; the sums differ by wgmma's summation order
# and 2^x on the SFU); tests/test_torch_cuda.py holds the same bar
TC_MIRROR_TOL = 5e-6
# backward kernel against plain version, each of dq, dk, dv: |got - want|
# <= rtol |want| + atol_rel (the largest |want| of the three). Both
# compute in f32 from the same inputs and round once to the inputs' type,
# so bf16 gradients differ by at most one bf16 ulp (2^-7 of the value,
# under 1e-2); atol_rel covers f32 sums taken in another order
BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
# the training form's forward row log-sum-exp against attention_lse_plain's:
# |got - want| <= atol + rtol |want|. Both sum the same f32 scores in
# another order, so they differ by a few f32 ulps of the row's scores
LSE_TOL = (1e-5, 2e-6)
# the chain (the forward kernel's o and lse, then the backward kernels)
# against the plain chain (attention_lse_plain's o and lse, then
# attention_bwd_plain), in BWD_TOL's form. In bf16 the two sides round o
# apart (an element of o may differ by one ulp: fwd_compare reports how
# many do), and o enters every gradient through D = rowsum(dO o): the
# bar doubles BWD_TOL's rtol and allows 0.2% of the largest gradient.
# f32 keeps BWD_TOL's
CHAIN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-3)}


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


class KernelCount:
    """One kernel of a module that counts several, read as ``KERNELS``
    reads a module (``launch_count()``, ``reset_launch_count()``)."""

    def __init__(self, mod, kernel: str):
        self.mod, self.kernel = mod, kernel

    def launch_count(self) -> int:
        return self.mod.launch_count(self.kernel)

    def reset_launch_count(self) -> None:
        self.mod.reset_launch_count()


KERNELS = {**driver.KERNELS, "flash_attn": fak, "flash_attn_bwd": fab,
           "wkv6": wk, "selective_scan": ssk,
           "wkv6_bwd": KernelCount(wk, "bwd"),
           "wkv6_bwd_local": KernelCount(wk, "bwd_local"),
           "wkv6_bwd_carry": KernelCount(wk, "bwd_carry"),
           "selective_scan_bwd": KernelCount(ssk, "bwd"),
           "selective_scan_bwd_ckpt": KernelCount(ssk, "bwd_ckpt"),
           "selective_scan_bwd_reduce": KernelCount(ssk, "bwd_reduce")}


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


def capacity_rows(index):
    """Row capacity of a local head; of each shard on a distributed one."""
    if isinstance(index, DistributedIndex):
        return [t.pts.shape[0] for t in index.tree]
    return index.capacity_rows


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
        "build_params": {k: v for k, v in build_kw.items() if k != "mesh"},
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
        "capacity_rows": capacity_rows(srv.head_index),
        "version_bytes": srv.head_index.nbytes,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "routes": dict(srv.head_index.engine.route_counts),
        "launches": launches, "launches_by_op": by_op,
        "recoveries": srv.stats["recoveries"],
        "inserts_under_sync_debug_error": steps if sync_free else 0,
    }
    if isinstance(srv.head_index, DistributedIndex):
        out["lanes"] = srv.head_index.mesh.size
        out["shard_points"] = srv.head_index.shard_sizes().tolist()
        out["dropped"] = int(srv.head_index.dropped)
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
    pts, ok = run["snap"].index.extract_points()
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
    recorded = {}
    by_kernel = kernel_ms_by(lambda: kk.knn_flat(q, pts, ok, k=K),
                             "knn_flat", FLAT_KERNELS, reps=20,
                             records=recorded)
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
            "timed": "ms: the two kernels' device time (torch.profiler, "
                     "the mean over the launches it recorded); "
                     "events_ms: knn_flat back to back by CUDA events",
            "kernel_ms": by_kernel, "device_launches_recorded": recorded,
            "events_ms": events_ms,
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


def kernel_ms_by(fn, prefix: str, names, reps: int = 5,
                 records: dict | None = None) -> dict:
    """Device ms a launch of each kernel ``<prefix>_<name>_kernel`` that
    ``fn`` launches (its ms a call where ``fn`` launches it once), by
    ``torch.profiler`` with CPU and CUDA activity: the mean over the
    launches the profile recorded. Profiles of a few milliseconds in this
    script have dropped some of a call's kernel records (more often with
    CUDA activity alone), so a total over ``reps`` would undercount.
    ``records`` gets the launches of each name that the profile recorded
    (``reps`` each when none was dropped); a name with none recorded
    reads 0.0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total, seen = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        m = re.search(prefix + r"_(\w+?)_kernel", e.key)
        if m and e.device_type == DeviceType.CUDA and m.group(1) in total:
            total[m.group(1)] += e.self_device_time_total / 1e3
            seen[m.group(1)] += e.count
    if records is not None:
        records.update(seen)
    return {n: total[n] / seen[n] if seen[n] else 0.0 for n in names}


def queued_ms(fn, reps: int = 10) -> float:
    """Device-bound ms a call of ``fn`` by CUDA events: a spin kernel
    (``torch.cuda._sleep``, ~0.1 s) holds the stream while the host
    queues all ``reps`` calls, so the host's dispatch leaves no gap
    between them (the profiler's device time without its dropped
    records)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


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
    recorded = {}
    by_kernel = kernel_ms_by(kernels, "sieve", SIEVE_KERNELS,
                             records=recorded)
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
            "timed": "ms: the five kernels' device time (torch.profiler, "
                     "the mean over the launches it recorded); "
                     "events_ms: sieve_round back to back by CUDA events; "
                     "with_offsets_scan_ms: segmented_partition likewise",
            "kernel_ms": by_kernel, "device_launches_recorded": recorded,
            "events_ms": events_ms, "host_enqueue_ms": enqueue_ms,
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


def device_ops(fn, top: int = 6, keep=()) -> dict:
    """``fn()`` once under ``torch.profiler``: the device time of its
    kernels, the kernels that took the most of it and the torch ops that
    launched the most (self device time, summed over calls), and under
    ``kept`` every kernel whose name holds one of ``keep``. The
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
            "kernel_launches": sum(e.count for e in kernels),
            "kernels": head(kernels), "ops": head(ops),
            "kept": [{"name": e.key, "ms": e.self_device_time_total / 1e3,
                      "calls": e.count} for e in kernels
                     if any(k in e.key for k in keep)]}


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
# the mesh-sharded index and distributed serving
# ---------------------------------------------------------------------------

DIST_LANES = 8
DIST_STEPS = 2            # measured steps of the in-process loop


def one_device_index(kind: str, run: dict, dev, **build_kw):
    """A single-device index over the live points of the last step's
    distributed snapshot."""
    pts, ok = run["snap"].index.extract_points()
    return make_index(kind, pts[ok], phi=PHI, device=dev, **build_kw)


def same_as_one_device(name: str, kind: str, run: dict, local,
                       dev) -> dict:
    """The distributed answers of the last step (kNN d2 and range counts
    of every request) equal a single-device index's over the same live
    points."""
    d2, _ = local.knn(torch.as_tensor(run["qpts"], device=dev), K)
    cnt = local.range_count(torch.as_tensor(run["lo"], device=dev),
                            torch.as_tensor(run["hi"], device=dev))
    out = {"phase": f"single-device-{name}", "kind": kind,
           "live_points": len(local), "queries": int(d2.shape[0]),
           "knn_d2_bit_equal": bool(torch.equal(d2, run["knn_d2"])),
           "range_count_equal": bool(torch.equal(cnt.long(),
                                                 run["counts"].long()))}
    emit(out)
    check(out["knn_d2_bit_equal"], f"{name}: distributed kNN d2 differ "
          "from a single-device index's")
    check(out["range_count_equal"], f"{name}: distributed range counts "
          "differ from a single-device index's")
    return out


def _subtree(event):
    """A profiler event and every event under it (host side)."""
    yield event
    for child in event.cpu_children:
        yield from _subtree(child)


def profile_calls(calls: dict, ranges: dict) -> dict:
    """Each of ``calls`` (label: fn) after a warm-up: its host time to
    return (nothing waits for the card unless ``fn`` does) and its time
    to a sync; then all of them once more in one ``torch.profiler``
    session, each in a range of its label: its kernels' device time and
    launch count. Each entry of ``ranges`` (label: (module, function
    name)) wraps that function in a range of its own: by call, its host
    time in the timed run (summed over its calls) and the device time
    of the kernels launched inside it in the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    host = {}
    current = [None]

    def ranged(label, orig):
        def run(*args, **kw):
            t = time.perf_counter()
            with record_function(label):
                res = orig(*args, **kw)
            key = (current[0], label)
            host[key] = host.get(key, 0.0) + time.perf_counter() - t
            return res
        return run
    res = {}
    with contextlib.ExitStack() as stack:
        for label, (obj, name) in ranges.items():
            stack.enter_context(patched(obj, name,
                                        ranged(label, getattr(obj, name))))
        for call, fn in calls.items():
            current[0] = None
            out = fn()
            sync()
            del out
            current[0] = call
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            del out
            res[call] = {"host_ms": (t1 - t0) * 1e3,
                         "wall_ms": (t2 - t0) * 1e3}
            for label in ranges:
                if (call, label) in host:
                    res[call][label] = {"host_ms": host[call, label] * 1e3}
        current[0] = None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for call, fn in calls.items():
                with record_function(call):
                    out = fn()
                    sync()
                del out
    for event in prof.events():
        if event.name not in calls or event.device_type != DeviceType.CPU:
            continue
        sub = list(_subtree(event))
        row = res[event.name]
        row["kernel_ms"] = event.device_time_total / 1e3
        row["launches"] = sum(len(e.kernels) for e in sub)
        for label in ranges:
            inner = [e for e in sub if e.name == label]
            if inner:
                row[label].update(calls=len(inner), device_ms=sum(
                    e.device_time_total for e in inner) / 1e3)
    free()
    return res


def dist_profile(name: str, kind: str, dix, local, qpts, dev) -> dict:
    """Where one distributed insert, delete (BATCH points each) and kNN
    call (QUERIES queries, the engine without the batcher) spend their
    time, beside the single-device index over the same points: host
    time to return, time to a sync, kernels' device time and launches;
    the routing exchange (codes, searchsorted, pack, all-to-all) apart
    from the shard-local updates, and the frontier calls (prep and
    walk) apart from the rest of the kNN (canonical order, point
    gather, the merge)."""
    mod = porth if kind == "porth" else spac
    rng = np.random.default_rng(SEED + 29)
    new = torch.as_tensor(gen.uniform(rng, BATCH), device=dev)
    pts, ok = dix.extract_points()
    live = pts[ok]
    old = live[torch.as_tensor(rng.choice(live.shape[0], BATCH,
                                          replace=False), device=dev)]
    del pts, ok, live
    q = torch.as_tensor(qpts, device=dev)
    res = profile_calls(
        {"insert.lanes": lambda: dix.insert_unchecked(new),
         "insert.one_device": lambda: local.insert_unchecked(new),
         "delete.lanes": lambda: dix.delete_unchecked(old),
         "delete.one_device": lambda: local.delete(old),
         "knn.lanes": lambda: dix.knn(q, K),
         "knn.one_device": lambda: local.knn(q, K)},
        {"route": (distributed, "_route_exchange"),
         "shard_insert": (mod, "insert"), "shard_delete": (mod, "delete"),
         "frontier": (frontier_ops, "knn_frontier_impl")})
    out = {"phase": f"profile-{name}", "kind": kind,
           "lanes": dix.mesh.size, "points": BATCH, "queries": QUERIES,
           "k": K, **res}
    emit(out)
    return out


def dist_phase(dev) -> dict:
    """The mesh-sharded index on ``simulate_mesh(8)`` (8 lanes on this
    card): per kind (spac-h, porth) the serving loop at 10^7 points (the
    build, 1 warm-up and DIST_STEPS measured steps, inserts under sync
    debug mode "error"), whose last step is held against brute force and
    against a single-device index over the same points; a small mesh
    (N_FLAT points) through the flat kernel; then the workload driver's
    CLI with ``--mesh 8`` at the driver phase's size. Returns the
    launches by path."""
    t0 = time.perf_counter()
    mesh = platform.simulate_mesh(DIST_LANES, device=dev)
    launches = {}
    for kind in DRIVER_KINDS:
        name = f"dist-{kind}"
        build_kw = driver.build_params(kind)
        run = run_server(name, kind, N_MAIN, BATCH, DIST_STEPS + WARMUP,
                         WARMUP, dev, mesh=mesh, **build_kw)
        summary = run["summary"]
        emit(summary)
        ops = summary["launches_by_op"]
        check(set(summary["routes"]) == {"frontier-kernel:cuda"},
              f"{name}: auto took {summary['routes']}")
        check(len(summary["shard_points"]) == DIST_LANES
              and sum(summary["shard_points"]) == summary["final_size"],
              f"{name}: shard sizes {summary['shard_points']}")
        check(ops["query"]["knn_frontier"] > 0,
              f"{name}: the frontier kernel never launched")
        check(ops["delete"]["row_bbox"] > 0,
              f"{name}: the row-bbox kernel never launched on a delete")
        if kind == "porth":
            check(ops["build"]["sieve"] > 0 and ops["insert"]["sieve"] > 0,
                  f"{name}: the sieve kernel never launched on the build "
                  "and the inserts")
        launches[name] = summary["launches"]
        brute_check(name, run, N_CHECK, dev)
        local = one_device_index(kind, run, dev, **build_kw)
        same_as_one_device(name, kind, run, local, dev)
        dist_profile(name, kind, run["snap"].index, local, run["qpts"],
                     dev)
        del run, local
        free()
    flat = run_server("dist-flat", "spac-h", N_FLAT, 256, 2, 1, dev,
                      mesh=mesh, coord_bits=20)
    emit(flat["summary"])
    check(set(flat["summary"]["routes"]) == {"flat:cuda"},
          f"dist-flat: auto took {flat['summary']['routes']}")
    check(flat["summary"]["launches"]["knn_flat"] > 0,
          "dist-flat: the flat kernel never launched")
    launches["dist-flat"] = flat["summary"]["launches"]
    brute_check("dist-flat", flat, QUERIES, dev)
    del flat
    free()
    in_process_s = time.perf_counter() - t0

    size = ["--scenarios", DRIVER_SCENARIO, "--n", str(N_MAIN), "--batch",
            str(BATCH), "--queries", str(QUERIES), "--k", str(K),
            "--window", str(WINDOW), "--warmup", str(DRIVER_WARMUP),
            "--steps", str(DRIVER_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        run_cli(["repro_torch.serving.driver", "--mesh", str(DIST_LANES),
                 "--kinds", ",".join(DRIVER_KINDS), *size, "--json",
                 f"{tmp}/dist.json"], timeout=900)
        cli_s = time.perf_counter() - t1
        payload = json.loads(pathlib.Path(f"{tmp}/dist.json").read_text())
    for kind in DRIVER_KINDS:
        res = payload["results"][kind][DRIVER_SCENARIO]
        det = payload["details"][kind][DRIVER_SCENARIO]
        dist = res["distributed"]
        for op in ("knn", "range"):
            check(det["units"][op] == QUERIES * DRIVER_STEPS,
                  f"dist driver {kind}: {det['units'][op]} {op} requests")
        check(dist["n_shards"] == DIST_LANES
              and sum(dist["shard_points"]) == res["final_size"]
              == det["expected_size"],
              f"dist driver {kind}: shards {dist}, final size "
              f"{res['final_size']}, expected {det['expected_size']}")
        check(det["launches"]["knn_frontier"] > 0,
              f"dist driver {kind}: the frontier kernel never launched")
        launches[f"dist-driver-{kind}"] = det["launches"]
        lat = res["latency_ms"]
        emit({"phase": "dist", "kind": kind, "lanes": DIST_LANES,
              "scenario": DRIVER_SCENARIO, "n": N_MAIN, "batch": BATCH,
              "queries": QUERIES, "k": K, "window": WINDOW,
              "warmup": DRIVER_WARMUP, "steps": DRIVER_STEPS,
              "latency_ms": {op: {p: lat[op][p] for p in
                                  ("p50_ms", "p99_ms", "count")}
                             for op in DRIVER_OPS if op in lat},
              "query_per_s": res["throughput"]["query_per_s"],
              "update_pts_per_s": res["throughput"]["update_pts_per_s"],
              "build_s": res["build_s"],
              "steady_bytes": res["memory"]["steady_bytes"],
              "peak_window_bytes": res["memory"]["peak_window_bytes"],
              "peak_allocated_bytes": det["peak_allocated_bytes"],
              "recoveries": res["recoveries"],
              "recoveries_by_step": det["recoveries_by_step"],
              "final_size": res["final_size"],
              "expected_size": det["expected_size"],
              "distributed": dist, "launches": det["launches"],
              "cli_s": cli_s})
    emit({"phase": "dist-seconds", "in_process": in_process_s,
          "cli": cli_s, "total": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# the paper's figures, the roofline and the regression gate
# ---------------------------------------------------------------------------

# fig3 over one distribution here (the three-distribution grid is a run
# of its own); every section at N_MAIN points with one timed rep; the
# tile sweep at the roofline's default query count (the prep's per-block
# group bounds are query blocks x groups: 4096 queries in blocks of 8
# over porth's 5M groups of 128 points would take 30 GB)
FIG_DISTS = "uniform"
FIG_REPS = 1
SWEEP_NQ = 64
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
          # the cuts against the full grid: reps, fig3's distributions,
          # the tile sweep's queries
          "reduced": {"reps": FIG_REPS, "of_reps": 3,
                      "fig3_dists": FIG_DISTS, "sweep_queries": SWEEP_NQ,
                      "of_sweep_queries": 256},
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


def ptxas_usage(ptxas: str, label=str) -> dict:
    """Registers and spill bytes of each kernel in a ``ptxas -v`` report,
    keyed by ``label`` of its mangled name."""
    kernels, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = label(m.group(1))
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
    return kernels


def flash_attn_build(ptxas: str, lib: str = "flash_attn",
                     tc_kernels=("flash_tc_",), op: str = "hmma") -> dict:
    """Registers and spill bytes of every kernel of the attention library
    ``lib`` from ``ptxas -v``, and the tensor-core instructions of each in
    the library's SASS (``cuobjdump -sass``): ``HMMA`` (``mma.sync``) and
    ``HGMMA`` (``wgmma``). Every tc instantiation (one a tc head width of
    each kernel whose name starts with one of ``tc_kernels``) must hold
    some of ``op``'s; with ``op="hgmma"`` none may hold an ``HMMA``."""
    kernels = ptxas_usage(ptxas, kernel_label)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            kernels.setdefault(name, {}).update(hmma=0, hgmma=0)
        elif name and re.search(r"\bHMMA\b", line):
            kernels[name]["hmma"] += 1
        elif name and re.search(r"\bHGMMA\b", line):
            kernels[name]["hgmma"] += 1
    tc = {k: v for k, v in kernels.items() if k.startswith(tc_kernels)}
    check(len(tc) == len(fak.TC_DIMS) * len(tc_kernels)
          and all(v.get(op, 0) > 0 for v in tc.values())
          and (op != "hgmma" or not any(v["hmma"] for v in tc.values())),
          f"build: {lib}: tc kernels without {op.upper()} instructions "
          f"(or, for wgmma kernels, with mma.sync's HMMA): {tc}")
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


def bwd_variants() -> dict:
    """Backward wrapper calls by variant since the last reset."""
    return {f"bwd_{v}": fab.launch_count(v) for v in fab.VARIANTS}


def fwd_compare(q, k, v, o, lse, kw: dict) -> dict:
    """The training form's forward output ``o`` (at ``ATTN_TOL``) and row
    log-sum-exp ``lse`` (at ``LSE_TOL``) against ``attention_lse_plain``
    on the same inputs (queries at ``q_offset`` 0, as the training forms
    place them): the largest errors and shares of the allowed error (<= 1
    passes); ``want`` holds the plain version's (o, lse)."""
    want_o, want_lse = attention_lse_plain(q, k, v, q_offset=0, **kw)
    tol = ATTN_TOL[q.dtype]
    diff = (o.float() - want_o.float()).abs()
    o_share = float((diff / (tol["atol"] + tol["rtol"] * want_o.float()
                             .abs())).max())
    o_err = float(diff.max())
    o_differs = float((diff > 0).float().mean())
    del diff
    check(bool(torch.isfinite(want_lse).all()),
          "train: a training-form row sees no slot")
    lse_diff = (lse - want_lse).abs()
    lse_share = float((lse_diff / (LSE_TOL[0] + LSE_TOL[1]
                                   * want_lse.abs())).max())
    share = max(o_share, lse_share)
    return {"o_max_abs_err": o_err, "o_tolerance_share": o_share,
            "o_elements_differing": o_differs,
            "lse_max_abs_err": float(lse_diff.max()),
            "lse_tolerance_share": lse_share,
            "lse_range": [float(want_lse.min()), float(want_lse.max())],
            "tolerance_share": share, "all_close": share <= 1.0,
            "tolerance": {"o": tol, "lse_atol_rtol": LSE_TOL},
            "want": (want_o, want_lse)}


def grad_compare(got, want, tol: tuple, slack=None) -> dict:
    """dq, dk, dv against ``want`` at ``tol`` = (rtol, atol as a share of
    the largest |want| of the three), plus ``slack`` (one tensor a
    gradient, added to the bar element by element) where given: the
    largest error and the largest share of the allowed error (<= 1
    passes)."""
    rtol, arel = tol
    top = max(float(w.float().abs().max()) for w in want)
    out = {}
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        g, w = g.float(), w.float()
        bar = rtol * w.abs() + arel * top
        if slack is not None:
            bar = bar + slack[i]
        diff = (g - w).abs()
        out[name] = {"max_abs_err": float(diff.max()),
                     "tolerance_share": float((diff / bar).max()),
                     "max_abs": float(w.abs().max())}
    share = max(c["tolerance_share"] for c in out.values())
    return {**out, "max_abs_err": max(c["max_abs_err"]
                                      for c in out.values()),
            "tolerance_share": share, "all_close": share <= 1.0,
            "tolerance": {"rtol": rtol, "atol_of_max": arel}}


def mirror_compare(got, want, atol: float = TC_MIRROR_TOL) -> dict:
    """tc's dq, dk, dv against its mirror's ``want``: the largest share of
    the bar (one bf16 ulp of max(|got|, |want|) + ``atol`` of the largest
    |want|, ``TC_MIRROR_TOL`` unless named), the atol the one-ulp term
    alone leaves uncovered (a share of the largest |want|), and the share
    of elements that differ."""
    top = max(float(w.float().abs().max()) for w in want)
    bar = atol
    share = need = differs = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        diff = (g - w).abs()
        share = max(share, float((diff / (ulp + bar * top)).max()))
        need = max(need, float((diff - ulp).clamp_min(0).max()) / top)
        differs = max(differs, float((diff > 0).float().mean()))
    return {"tolerance_share": share, "atol_needed_of_max": need,
            "elements_differing": differs, "all_close": share <= 1.0,
            "tolerance": {"ulp_bf16": 1, "atol_of_max": bar}}


def bwd_compare(q, k, v, o, lse, do, kw: dict, variant: str | None = None,
                fwd: dict | None = None, o_shift: bool = False) -> dict:
    """A backward variant (the one the wrapper picks, or the one named)
    against ``attention_bwd_plain`` on the same inputs at ``BWD_TOL`` of
    the inputs' dtype (queries at ``q_offset`` 0). With ``fwd``
    (``fwd_compare`` of the forward that gave o and lse), also the chain:
    the same gradients against ``attention_bwd_plain`` on the plain
    forward's o and lse, at ``CHAIN_TOL``, so that a wrong o or lse cannot
    go into both sides. ``o_shift`` adds to the chain's bar, element by
    element, the exact move that the forward's o makes in the plain
    gradients (``attention_bwd_plain`` on the kernel's o and the plain
    lse, less the plain chain): o enters them only through D = rowsum(dO
    o), and where dS = P (dP - D) cancels almost wholly (keys and values
    of a near rank-one sequence, as a deep random-weight model makes) an
    o within ``fwd_compare``'s bar moves dq and dk by a large share of
    their size. o itself is held by ``fwd_compare``, lse by the chain;
    the chain's share without the shift is reported beside it."""
    used = variant or fab.variant_for(q, k, v, o, do)
    got = fab.attention_bwd(q, k, v, o, lse, do, variant=used, **kw)
    out = {**grad_compare(got, attention_bwd_plain(
        q, k, v, o, lse, do, q_offset=0, **kw), BWD_TOL[q.dtype]),
           "variant": used}
    if fwd is not None:
        want_o, want_lse = fwd.pop("want")
        want = attention_bwd_plain(q, k, v, want_o, want_lse, do,
                                   q_offset=0, **kw)
        chain = grad_compare(got, want, CHAIN_TOL[q.dtype])
        held = chain["all_close"]
        if o_shift:
            moved = attention_bwd_plain(q, k, v, o, want_lse, do,
                                        q_offset=0, **kw)
            slack = [(a.float() - b.float()).abs()
                     for a, b in zip(moved, want)]
            top = max(float(w.float().abs().max()) for w in want)
            chain["o_shift"] = {
                **grad_compare(got, want, CHAIN_TOL[q.dtype], slack),
                "shift_max_share_of_max": max(float(t.max())
                                              for t in slack) / top}
            held = chain["o_shift"]["all_close"]
            del moved, slack
        del want
        out.update(forward=fwd, chain=chain, all_close=(
            out["all_close"] and fwd["all_close"] and held))
    return out


def bwd_at(q, k, v, o, lse, do, kw: dict, mirror_atol: float = TC_MIRROR_TOL,
           o_shift: bool = False) -> dict:
    """The backward kernels at one shape: the variant the wrapper picks
    and ``simt`` against the plain version in the inputs' dtype, and on
    f32 copies (whose own forward gives o and lse); the forward's o and
    lse and the forward-and-backward chain held against the plain
    versions in both (``bwd_compare`` with ``fwd``); tc against its
    mirror ``attention_bwd_tc_plain`` (``mirror_compare``); their time
    (the three launches of one call; the picked variant in turns with
    simt), the host's enqueue time of a call, the plain version's time,
    and the backward of ``scaled_dot_product_attention`` on the same
    inputs (one ``torch.autograd.grad`` over a retained forward: its
    backward alone) as the library yardstick: by events back to back
    (``library_ms``, its host dispatch included), queued behind a spin
    kernel (``library_queued_ms``, device-bound; the kernels'
    ``queued_ms`` beside it) and its kernels in one profiled call. The
    bound counts q, k, v, o, do and lse read once and dq, dk, dv written
    once over 3.35 TB/s, and 10 d operations a visible pair (the products
    S and dP recomputed, dV, dK and dQ) over the peak of the inputs'
    type. Cross attention (Sq != Skv) counts every (query, slot) pair;
    ``mirror_atol`` goes to ``mirror_compare``, ``o_shift`` to both
    dtypes' ``bwd_compare``."""
    cmp = bwd_compare(q, k, v, o, lse, do, kw,
                      fwd=fwd_compare(q, k, v, o, lse, kw),
                      o_shift=o_shift)
    cmp_simt = bwd_compare(q, k, v, o, lse, do, kw, "simt")
    q32, k32, v32, do32 = (f32_copy(t) for t in (q, k, v, do))
    o32, lse32 = fak.flash_attention_lse(q32, k32, v32, **kw)
    cmp32 = bwd_compare(q32, k32, v32, o32, lse32, do32, kw,
                        fwd=fwd_compare(q32, k32, v32, o32, lse32, kw),
                        o_shift=o_shift)
    del q32, k32, v32, do32, o32, lse32
    mirror = mirror_compare(fab.attention_bwd(q, k, v, o, lse, do, **kw),
                            attention_bwd_tc_plain(q, k, v, o, lse, do, **kw),
                            mirror_atol)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]

    def kernel():
        return fab.attention_bwd(q, k, v, o, lse, do, **kw)

    def plain():
        return attention_bwd_plain(q, k, v, o, lse, do, q_offset=0, **kw)

    turns = [time_ms(kernel, reps=5)]
    kernel_queued = queued_ms(kernel)
    recorded = {}
    by_kernel = kernel_ms_by(kernel, "flash_bwd", BWD_KERNELS,
                             records=recorded)
    enqueue_ms = host_ms(kernel)
    plain_ms = time_ms(plain, reps=2)
    cmp_simt["ms"] = time_ms(lambda: fab.attention_bwd(
        q, k, v, o, lse, do, variant="simt", **kw), reps=3)
    turns.append(time_ms(kernel, reps=5))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mask = None
    if kw.get("window") is not None:
        mask = window_mask(Sq, kw["window"], q.device)
    ref_out = (F.scaled_dot_product_attention(*leaves,
                                              is_causal=kw["causal"],
                                              enable_gqa=Hkv != Hq)
               if mask is None else F.scaled_dot_product_attention(
                   *leaves, attn_mask=mask, enable_gqa=Hkv != Hq))
    def library():
        return torch.autograd.grad(ref_out, leaves, do, retain_graph=True)

    library_ms = time_ms(library, reps=5)
    library_queued = queued_ms(library)
    lib_kernels = device_ops(library)["kernels"]
    del ref_out, leaves, mask
    pairs = attn_pairs(Sq, Skv, kw["causal"], kw.get("window"), 0)
    elt = q.element_size()
    bytes_moved = (elt * 4 * (B * Hq * Sq * d + B * Hkv * Skv * d)
                   + 4 * B * Hq * Sq)
    ops = 10 * B * Hq * d * pairs
    rate, kind = ((BF16_TC_OPS_PER_S, "bf16 tensor-core")
                  if q.dtype == torch.bfloat16 else (FP32_OPS_PER_S, "fp32"))
    b_ms, by, how = bound(bytes_moved, ops, rate, kind)
    return {**cmp, "all_close": (cmp["all_close"] and cmp32["all_close"]
                                 and cmp_simt["all_close"]
                                 and mirror["all_close"]),
            "f32_copy": cmp32, "simt": cmp_simt, "simt_ms": cmp_simt["ms"],
            "mirror": mirror,
            "ms": float(np.mean(turns)), "ms_turns": turns,
            "queued_ms": kernel_queued,
            "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel,
            "device_launches_recorded": recorded,
            "host_enqueue_ms": enqueue_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_queued_ms": library_queued,
            "library_kernels": lib_kernels,
            "bound_ms": b_ms, "bound_by": by, "bound_terms": how,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": Sq, "Skv": Skv,
                      "d": d, "dtype": str(q.dtype), "causal": kw["causal"],
                      "window": kw.get("window"), "visible_pairs": pairs,
                      "q_contiguous": q.is_contiguous()}}


def flash_attn_bwd_row(captured: tuple, launches: dict, by_variant: dict,
                       dev) -> dict:
    """The backward kernels at the train phase's own inputs (one layer's
    q, k, v, o, lse and do of a bf16 step) and at ``BWD_EXTRA``'s GQA and
    window shape on seeded inputs (their o and lse from the forward
    kernel)."""
    q, k, v, o, lse, do = (t.detach() for t in captured[:6])
    kw = captured[6]
    cfg = configs.ARCHS[LM_ARCH]
    check(q.shape == (TRAIN_BATCH, cfg.n_heads, TRAIN_SEQ, cfg.hd)
          and q.dtype == torch.bfloat16 and kw == {"causal": True,
                                                   "window": cfg.window},
          f"train: captured backward inputs {tuple(q.shape)} {q.dtype} {kw}")
    at_train = bwd_at(q, k, v, o, lse, do, kw)
    del q, k, v, o, lse, do
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    extra = {}
    for name, (B, Hq, Hkv, S, d, window) in BWD_EXTRA.items():
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((B, Hq, S, d), (B, Hkv, S, d),
                                          (B, Hkv, S, d), (B, Hq, S, d)))
        ekw = {"causal": True, "window": window}
        o, lse = fak.flash_attention_lse(q, k, v, **ekw)
        extra[name] = bwd_at(q, k, v, o, lse, do, ekw)
        del q, k, v, do, o, lse
    cases = [at_train, *extra.values()]
    ok = all(c["all_close"] for c in cases)
    check(ok, "flash_attn_bwd: kernel differs from its plain version beyond "
          "the bar (share of the allowed error, bf16 variant / bf16 simt / "
          "f32; forward o and lse, bf16 / f32; chain, bf16 / f32; tc's "
          "mirror): "
          + ", ".join(
              f"{c['variant']} {c['tolerance_share']:.3g} / "
              f"{c['simt']['tolerance_share']:.3g} / "
              f"{c['f32_copy']['tolerance_share']:.3g}; "
              f"{c['forward']['tolerance_share']:.3g} / "
              f"{c['f32_copy']['forward']['tolerance_share']:.3g}; "
              f"{c['chain']['tolerance_share']:.3g} / "
              f"{c['f32_copy']['chain']['tolerance_share']:.3g}; "
              f"{c['mirror']['tolerance_share']:.3g}"
              for c in cases))
    check([c["variant"] for c in cases] == ["tc"] * len(cases),
          f"flash_attn_bwd: the cases took {[c['variant'] for c in cases]}")
    return {"name": "flash_attn_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
            "replaces": "src/repro/models/layers.py:41 (XLA's autodiff of "
                        "_chunk_attention, the jnp twin of "
                        "src/repro/kernels/flash_attn/kernel.py:83)",
            "launches": launches["train"], "launches_by_path": launches,
            "launches_by_variant": by_variant, **at_train,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "f32_max_abs_err": max(c["f32_copy"]["max_abs_err"]
                                   for c in cases),
            "all_close": ok,
            "library_call": "torch.autograd.grad of "
                            "torch.nn.functional.scaled_dot_product_"
                            "attention (its backward; timed here only, the "
                            "port never calls it)", **extra}


def train_host_split(model, opt, batch, cfg, tcfg) -> dict:
    """Where a bf16 step's wall time goes, on the host's clock (a sync
    before and after each part): the loss and gradients, the AdamW
    update alone, and whole steps with remat "none" (no selective
    checkpointing: no recompute and no per-op policy calls). Run after
    the measured steps; the counts are not read again."""
    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    (_, grads), grad_ms = wall(lambda: train_lib._value_and_grad(model,
                                                                 batch))
    params = dict(model.named_parameters())
    _, adamw_ms = wall(lambda: train_lib.adamw_update(grads, opt, params,
                                                      tcfg.opt))
    del grads
    none_cfg = cfg.with_(remat="none")
    model.cfg = none_cfg
    step_none = train_lib.make_train_step(none_cfg, tcfg)
    none_ms = [wall(lambda: step_none(model, opt, batch))[1]
               for _ in range(3)]
    model.cfg = cfg
    return {"loss_and_grads_ms": grad_ms, "adamw_ms": adamw_ms,
            "step_ms_remat_none": none_ms,
            "peak_allocated_bytes_so_far": torch.cuda.max_memory_allocated()}


def train_grad_check(cfg, dev) -> dict:
    """2 layers of the full width at f32: loss and gradients through the
    kernels (simt forward, backward kernels) against the same model with
    ``attention_plain`` under autograd in the attention's place, on the
    same weights and batch."""
    small = cfg.with_(n_layers=TRAIN_CHECK_LAYERS, act_dtype="float32")
    model = transformer.DecoderLM(small, device=dev, train=True,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(SEED + 31))
    toks, labels = lm_batch(SEED + 31, 0, TRAIN_CHECK_BATCH,
                            TRAIN_CHECK_SEQ, small.vocab, device=dev)
    params = list(model.parameters())

    def grads():
        loss = transformer.loss_fn(model, toks, labels)
        return loss.detach(), torch.autograd.grad(loss, params)

    before = (fak.launch_count("simt"), fab.launch_count(),
              fab.launch_count("simt"))
    loss_k, g_k = grads()
    launched = (fak.launch_count("simt") - before[0],
                fab.launch_count() - before[1],
                fab.launch_count("simt") - before[2])

    def plain(q, k, v, *, causal, window):
        return attention_plain(q, k, v, causal=causal, window=window)

    with patched(fab, "flash_attention_train", plain):
        loss_p, g_p = grads()
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(g_k, g_p))
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(launched == (2 * TRAIN_CHECK_LAYERS, 3 * TRAIN_CHECK_LAYERS,
                       TRAIN_CHECK_LAYERS),
          f"train: the gradient check launched (simt, backward, backward "
          f"simt) {launched}")
    check(worst <= TRAIN_CHECK_REL and loss_rel <= 1e-5,
          f"train: kernel-route gradients differ from attention_plain's by "
          f"{worst:.3g} of a leaf's largest (bar {TRAIN_CHECK_REL}), loss "
          f"by {loss_rel:.3g}")
    return {"layers": TRAIN_CHECK_LAYERS, "batch": TRAIN_CHECK_BATCH,
            "seq": TRAIN_CHECK_SEQ, "dtype": "float32",
            "loss": float(loss_k), "loss_rel_err": loss_rel,
            "grad_worst_share_of_leaf_max": worst, "bar": TRAIN_CHECK_REL,
            "launches_simt_bwd_bwdsimt": launched}


def train_cli(tmp: str) -> dict:
    """The reference's launcher at the full config (it forces f32, so the
    simt forward and the f32 backward): ``--steps 20 --batch 4 --seq
    2048 --ckpt-dir tmp``, whose own check asserts the loss fell; then
    ``--resume`` from its newest checkpoint (after step 10, holding 11
    steps) must give the first run's losses of steps 11-19 bit for bit.
    The first run's steps are timed (a sync before and after each, where
    the loop reads the loss anyway), with its peak allocated bytes."""
    args = ["--arch", LM_ARCH, "--steps", str(TRAIN_CLI_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", tmp]
    step_ms = []

    def timed_step(cfg, tcfg):
        fn = train_lib.make_train_step(cfg, tcfg)

        def run(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(train_launcher, "make_train_step", timed_step):
        first = train_launcher.main(args)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = counts()
    by_variant = {**variant_counts(), **bwd_variants()}
    free()
    t0 = time.perf_counter()
    second = train_launcher.main(args + ["--resume"])
    second_s = time.perf_counter() - t0
    resumed = TRAIN_CLI_STEPS - len(second)
    check(len(first) == TRAIN_CLI_STEPS and resumed == 11,
          f"train cli: {len(first)} steps, resumed at {resumed}")
    check(second == first[resumed:], f"train cli: the resumed losses "
          f"{second} are not the first run's {first[resumed:]}")
    L = configs.ARCHS[LM_ARCH].n_layers
    check(by_variant == {"tc": 0, "decode": 0,
                         "simt": 2 * L * TRAIN_CLI_STEPS, "bwd_tc": 0,
                         "bwd_simt": L * TRAIN_CLI_STEPS}
          and launches["flash_attn_bwd"] == 3 * L * TRAIN_CLI_STEPS,
          f"train cli: launches {launches}, variants {by_variant}")
    ms = np.array(step_ms)
    return {"args": args, "losses": first, "resumed_losses": second,
            "resumed_at": resumed, "dtype": "float32",
            "step_ms": {"p50": float(np.percentile(ms, 50)),
                        "p99": float(np.percentile(ms, 99)),
                        "mean": float(ms.mean()), "each": ms.tolist()},
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(ms.mean()) * 1e3,
            "peak_allocated_bytes": peak, "seconds": first_s,
            "resume_seconds": second_s, "launches": launches,
            "flash_attn_by_variant": by_variant,
            "ckpt_steps": sorted(os.listdir(tmp))}


def train_phase(dev) -> tuple[dict, dict]:
    """qwen1.5-0.5b at full width and depth in its own bf16 (remat
    "dots"), seeded weights, ``lm_batch`` at 4 x 2048 tokens: 1 warm-up
    and 8 measured ``make_train_step`` steps. Every step's loss is
    finite; every forward and recompute launches tc once a layer and the
    backward kernels once a layer each; no index kernel launches. Then
    the model-level gradient check, the reference's launcher at the full
    config with its resume, one profiled step, and the backward kernels'
    row. Returns the phase's line and the row."""
    cfg = configs.ARCHS[LM_ARCH]
    L = cfg.n_layers
    free()
    torch.cuda.reset_peak_memory_stats()
    tcfg = train_lib.TrainCfg()
    model, opt = train_lib.init_train_state(SEED, cfg, tcfg, device=dev)
    step_fn = train_lib.make_train_step(cfg, tcfg)
    batches = []
    for s in range(TRAIN_WARMUP + TRAIN_STEPS):
        toks, labels = lm_batch(SEED, s, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
                                device=dev)
        batches.append({"tokens": toks, "labels": labels})
    losses, step_s, per_step = [], [], []
    captured = []

    def capture(orig):
        def run(q, k, v, o, lse, do, causal, window, variant=None):
            if not captured:
                captured.append((q, k, v, o, lse, do,
                                 {"causal": causal, "window": window}))
            return orig(q, k, v, o, lse, do, causal, window, variant)
        return run

    for b in batches[:TRAIN_WARMUP]:
        model, opt, m = step_fn(model, opt, b)
        losses.append(float(m["loss"]))
    sync()
    reset_counts()
    with patched(fab, "_backward", capture(fab._backward)):
        for i, b in enumerate(batches[TRAIN_WARMUP:]):
            before = {**counts(), **variant_counts(), **bwd_variants()}
            sync()
            t0 = time.perf_counter()
            model, opt, m = step_fn(model, opt, b)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
            after = {**counts(), **variant_counts(), **bwd_variants()}
            per_step.append({k: after[k] - before[k] for k in after})
            if i < TRAIN_STEPS - 1:
                captured.clear()
    launches = counts()
    by_variant = {**variant_counts(), **bwd_variants()}
    by_kernel = {name: fab.launch_count(name) for name in fab.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(x) for x in losses),
          f"train: a loss is not finite: {losses}")
    want_step = {"tc": 2 * L, "simt": 0, "decode": 0,
                 "flash_attn_bwd": 3 * L, "bwd_tc": L, "bwd_simt": 0}
    bad = [p for p in per_step if any(p[k] != n for k, n in
                                      want_step.items())]
    check(not bad, f"train: a step launched {bad[:1]}, not {want_step}")
    check(by_kernel == dict.fromkeys(fab.KERNELS, L * TRAIN_STEPS),
          f"train: backward kernels launched {by_kernel}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("flash_attn", "flash_attn_bwd")),
          f"train: index kernels launched: {launches}")
    prof = device_ops(lambda: step_fn(model, opt, batches[-1]), top=16,
                      keep=("flash_bwd_",))
    bwd_ms = {re.sub(r".*::(flash_bwd_\w+?)_kernel.*", r"\1", k["name"]):
              k["ms"] / k["calls"] for k in prof["kept"]}
    bwd_step = {"ms": sum(k["ms"] for k in prof["kept"]),
                "launches": sum(k["calls"] for k in prof["kept"]),
                "step_device_ms": prof["kernel_ms"]}
    bwd_step["share"] = bwd_step["ms"] / prof["kernel_ms"]
    host = train_host_split(model, opt, batches[-1], cfg, tcfg)
    params = transformer.param_count(model)
    del model, opt, batches
    free()
    grad_check = train_grad_check(cfg, dev)
    free()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cli = train_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    ms = np.array(step_s) * 1e3
    out = {"phase": "train", "arch": LM_ARCH, "dtype": cfg.act_dtype,
           "remat": cfg.remat, "params": params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "losses": losses,
           "step_ms": {"p50": float(np.percentile(ms, 50)),
                       "p99": float(np.percentile(ms, 99)),
                       "mean": float(ms.mean()), "each": ms.tolist()},
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(ms.mean()) * 1e3,
           "peak_allocated_bytes": peak,
           "device_ms_of_profiled_step": prof.get("kernel_ms"),
           "device_share_of_p50": (prof.get("kernel_ms", 0.0)
                                   / float(np.percentile(ms, 50))),
           "launches": launches, "flash_attn_by_variant": by_variant,
           "flash_attn_bwd_by_kernel": by_kernel,
           "launches_per_step": want_step,
           "profile_step": prof, "host_split": host,
           "grad_check": grad_check, "cli": cli}
    row = flash_attn_bwd_row(captured[0], {
        "train": launches["flash_attn_bwd"],
        "train_grad_check": grad_check["launches_simt_bwd_bwdsimt"][1],
        "train_cli": cli["launches"]["flash_attn_bwd"]}, {
        "train": {k: by_variant[k] for k in ("bwd_tc", "bwd_simt")},
        "train_cli": {k: cli["flash_attn_by_variant"][k]
                      for k in ("bwd_tc", "bwd_simt")}}, dev)
    row["kernel_ms_in_step"] = bwd_ms
    row["in_step"] = bwd_step
    out["flash_attn_launches"] = {"train": launches["flash_attn"],
                                  "train_cli": cli["launches"]["flash_attn"]}
    return out, row


# ---------------------------------------------------------------------------
# the mixers: MoE, Mamba and RWKV6 serving, and the recurrence kernels
# ---------------------------------------------------------------------------

# phi3.5-moe at full width, 12 of its 32 layers (32 would need ~84 GB of
# bf16 weights on the 80 GB card), 32 new tokens: cut from 24 layers and
# 64 new tokens to keep the whole script within its time limit with the
# multimodal archs' training phase (12 take ~32 GB)
MIX_PHI = "phi3.5-moe-42b-a6.6b"
MIX_PHI_LAYERS = 12
MIX_PHI_BATCH, MIX_PHI_PROMPT, MIX_PHI_NEW = 8, 2048, 32
# rwkv6-3b at full width and depth, the lm phase's shape
MIX_RWKV = "rwkv6-3b"
MIX_RWKV_BATCH, MIX_RWKV_PROMPT, MIX_RWKV_NEW = 8, 2048, 128
MIX_WARMUP, MIX_REPS = 1, 2
# the f32 agreement checks: B, P, new tokens; phi at 2 layers of its full
# width, with capacity E / K so that no token can drop
MIX_F32_BATCH, MIX_F32_PROMPT, MIX_F32_NEW = 2, 256, 32
MIX_F32_PHI_LAYERS = 2
# jamba-1.5-large's Mamba layer at full width, alone: a prefill of B x S
# and decode steps through its cache; its f32 check (B, prompt, steps)
MIX_JAMBA = "jamba-1.5-large-398b"
MIX_MAMBA_BATCH, MIX_MAMBA_PROMPT, MIX_MAMBA_STEPS = 8, 2048, 32
MIX_MAMBA_F32 = (2, 256, 32)
# step-by-step decode against the teacher-forced pass: within this share
# of the outputs' largest magnitude (tests/test_models.py's bar; f32
# products of other shapes sum in another order)
MIX_DECODE_REL = 1e-4
# the recurrence kernels (wkv6, selective scan) against their plain
# versions: the same f32 arithmetic a token (bf16 inputs rounded the same
# way, the scan's db in bf16 in both), only the order of the f32 sums over
# the head's keys or the states and the exponential's last bits differ, so
# outputs and states lie within a few f32 ulps of the largest |value| of
# their kind; 2e-5 of it is ~170 ulps. A wrong rounding of db (~2^-9 a
# term) or a wrong index shows at 1e-3 and above
REC_TOL = 2e-5


class MixerProbe(LMProbe):
    """:class:`LMProbe` that also keeps every kernel's launches of each
    forward, and captures clones of a recurrence wrapper's inputs (its
    state is updated in place after the call)."""

    def __init__(self, capture_len: int):
        super().__init__(capture_len)
        self.counts = {"prefill": [], "decode": []}

    def forward(self, orig, phase: str):
        inner = super().forward(orig, phase)

        def run(model, *args):
            before = counts()
            out = inner(model, *args)
            self.counts[phase].append(delta(before))
            return out
        return run

    def kernel(self, orig):
        def run(*args, **kw):
            if self._slot is not None:
                self.captured[self._slot] = tuple(a.clone() for a in args)
                self._slot = None
            return orig(*args, **kw)
        return run


def mixer_serve(cfg, model, prompts, n_new: int, probe: MixerProbe,
                patches) -> dict:
    """``MIX_WARMUP`` + ``MIX_REPS`` greedy generates of ``prompts`` through
    ``ServeEngine`` under sync debug mode "error", with ``probe`` around
    each forward and ``patches`` ((obj, name, fn) triples) in place.
    Returns the timings and the launches."""
    P = prompts.shape[1]
    engine = ServeEngine(cfg, model, P + n_new)
    runs = MIX_WARMUP + MIX_REPS
    outs, gen_s = [], []
    reset_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(transformer, "prefill", probe.forward(
            transformer.prefill, "prefill")))
        stack.enter_context(patched(transformer, "decode_step",
                                    probe.forward(transformer.decode_step,
                                                  "decode")))
        for obj, name, fn in patches:
            stack.enter_context(patched(obj, name, fn))
        for r in range(runs):
            probe.capture = r == runs - 1
            sync()
            t1 = time.perf_counter()
            with sync_debug_error():
                out = engine.generate(prompts, n_new)
            sync()
            if r >= MIX_WARMUP:
                gen_s.append(time.perf_counter() - t1)
                outs.append(out)
    steps = n_new - 1
    check(len(probe.counts["prefill"]) == runs
          and len(probe.counts["decode"]) == runs * steps,
          f"mixers: {cfg.name}: the engine did not run one prefill and "
          f"n_new - 1 decode steps a generate")
    prefill_ms = [a.elapsed_time(b) for a, b in
                  probe.events["prefill"][MIX_WARMUP:]]
    decode_ms = np.array([a.elapsed_time(b) for a, b in
                          probe.events["decode"][MIX_WARMUP * steps:]])
    last = outs[-1]
    B = prompts.shape[0]
    check(last.shape == (B, n_new)
          and bool(((last >= 0) & (last < cfg.vocab)).all()),
          f"mixers: {cfg.name}: generated tokens out of shape or vocabulary")
    return {"batch": B, "prompt": P, "new": n_new, "warmup": MIX_WARMUP,
            "reps": MIX_REPS, "prefill_ms": float(np.mean(prefill_ms)),
            "prefill_ms_each": prefill_ms,
            "decode_ms_per_token": {
                "p50": float(np.percentile(decode_ms, 50)),
                "p99": float(np.percentile(decode_ms, 99)),
                "mean": float(decode_ms.mean()),
                "count": int(decode_ms.size)},
            "generate_s_each": gen_s,
            "tokens_per_s": B * n_new / float(np.mean(gen_s)),
            "launches": counts(), "launches_by_variant": variant_counts(),
            "repeat_tokens_equal": all(bool(torch.equal(o, last))
                                       for o in outs),
            "generates_under_sync_debug_error": runs}


def mixer_profiles(model, prompts, max_len: int, name: str) -> dict:
    """One prefill and one decode step under the profiler (not counted);
    every logit of a prefill and a decode step finite."""
    with torch.inference_mode():
        prof_prefill = device_ops(
            lambda: transformer.prefill(model, prompts, max_len), top=16,
            keep=REC_KEEP)
        lg, cache = transformer.prefill(model, prompts, max_len)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        lg2, cache = transformer.decode_step(model, cache, tok)
        check(bool(torch.isfinite(lg).all())
              and bool(torch.isfinite(lg2).all()),
              f"mixers: {name}: logits not finite")
        tok = lg2[:, -1].argmax(-1, keepdim=True)
        prof_decode = device_ops(
            lambda: transformer.decode_step(model, cache, tok), top=16,
            keep=REC_KEEP)
    return {"profile_prefill": prof_prefill, "profile_decode": prof_decode}


def f32_agreement(cfg32, model32, prompts, name: str) -> dict:
    """Greedy decode of ``MIX_F32_NEW`` tokens against the argmax of the
    teacher-forced forward of the prompt and those tokens: the share of
    positions that agree must reach ``LM_AGREE``."""
    reset_counts()
    out = ServeEngine(cfg32, model32, prompts.shape[1] + MIX_F32_NEW
                      ).generate(prompts, MIX_F32_NEW)
    launches = counts()
    variants = variant_counts()
    with torch.inference_mode():
        logits = transformer.forward(model32, torch.cat([prompts,
                                                         out.long()], 1))
    check(bool(torch.isfinite(logits).all()),
          f"mixers: {name}: f32 logits not finite")
    ref = logits[:, prompts.shape[1] - 1:-1].argmax(-1)
    agree = float((ref == out).float().mean())
    check(agree >= LM_AGREE, f"mixers: {name}: f32 greedy decode agrees with "
          f"the teacher-forced forward at {agree:.4f} of positions")
    return {"batch": prompts.shape[0], "prompt": prompts.shape[1],
            "new": MIX_F32_NEW, "agreement": agree, "bar": LM_AGREE,
            "launches": launches, "launches_by_variant": variants}


def rec_compare(fn, plain, args) -> dict:
    """A recurrence kernel's (output, state) against its plain version's
    on ``args``: each within ``REC_TOL`` of the largest |value| of its
    kind; the share of that bar used (<= 1 passes)."""
    got, want = fn(*args), plain(*args)
    sync()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    tops = [float(w.abs().max()) for w in want]
    share = max(e / (REC_TOL * max(t, 1e-30)) for e, t in zip(errs, tops))
    return {"max_abs_err": max(errs), "max_abs_err_by_output": errs,
            "max_abs_value_by_output": tops, "tolerance_share": share,
            "all_close": share <= 1.0, "bar_rel": REC_TOL}


# the recurrence kernels, kept whole in the mixers' profiles (a short
# kernel can fall out of the top kernels)
REC_KEEP = ("wkv6_kernel", "selective_scan_kernel")


def path_kernel_ms(profile: dict, names, calls: int) -> dict:
    """Device ms a wrapper call from the profile of the path's own forward
    (``device_ops``): the kernels whose names hold one of ``names``,
    summed, over the ``calls`` wrapper calls the forward made. (Profiles
    of lone ctypes launches late in this script have been seen to record
    no device time; a forward's profile records them.)"""
    hit = {k["name"]: k["ms"] for k in profile["kept"] or profile["kernels"]
           if any(n in k["name"] for n in names)}
    return {"ms": sum(hit.values()) / calls, "calls": calls,
            "kernels_ms": hit}


REC_SASS_OPS = ("MUFU", "F2F", "FFMA", "FMUL", "FADD", "HMUL2", "HFMA2",
                "LDS", "STS", "SHFL", "LDGSTS", "STL", "LDL")


def rec_label(mangled: str) -> str:
    """``wkv6_kernel<bf16,64>``, ``selective_scan_kernel<bf16,full>`` or
    ``wkv6_bwd_carry_kernel<64>`` from the mangled name of a recurrence
    kernel (forward or backward) or of its instantiation."""
    m = re.search(r"\d+((?:wkv6|selective_scan)\w*?_kernel\w*?)I(.+?)EEv",
                  mangled)
    if m is None:
        m = re.search(r"\d+((?:wkv6|selective_scan)\w*?_kernel)E", mangled)
        return mangled if m is None else m.group(1)
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"Li(\d+)E", r"\1,", args)
    args = args.replace("Lb1E", "full,").replace("Lb0E", "any,")
    args = re.sub(r"^f", "f32,", args)
    return f"{m.group(1)}<{args.rstrip(',')}>"


def recurrence_sass(lib: str) -> dict:
    """Each kernel of library ``lib``: its count of each of
    ``REC_SASS_OPS`` (MUFU, conversions, FP32, packed bf16, shared-memory
    and shuffle instructions, spills) and of all instructions in its SASS
    (``cuobjdump -sass``), keyed by :func:`rec_label`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = rec_label(m.group(1))
            out[name] = dict.fromkeys(REC_SASS_OPS, 0) | {"total": 0}
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            out[name]["total"] += 1
            if m.group(1) in out[name]:
                out[name][m.group(1)] += 1
    check(out and all(v["total"] > 0 for v in out.values()),
          f"build: no SASS read for {lib}: {sorted(out)}")
    return out


def grid_sweep(make_args, fn, sizes) -> list:
    """A recurrence wrapper's device-bound ms a call (:func:`queued_ms`)
    on seeded random inputs at each of ``sizes`` (``make_args(size)``
    builds them): how its time grows with the work the card holds at once
    (time flat in the size is a latency-bound warp, time in proportion a
    throughput-bound card). Short profiles late in this script drop
    kernel records, so events time it."""
    out = []
    for size in sizes:
        args = make_args(size)
        out.append({"size": size, "queued_ms": queued_ms(
            lambda: fn(*args), reps=5)})
        del args
        free()
    return out


def recurrence_row(name: str, fn, plain, args, bytes_moved: float,
                   ops: float, device: dict) -> dict:
    """The kernel on ``args`` (the path's own inputs) and on f32 copies of
    them against its plain version; its time by events and, in
    ``device``, by the profiler (:func:`path_kernel_ms`); the plain
    version's time and the bound (bytes over 3.35 TB/s, operations over
    the fp32 rate)."""
    cmp = rec_compare(fn, plain, args)
    cmp32 = rec_compare(fn, plain, tuple(a.float() for a in args))
    ms = time_ms(lambda: fn(*args), reps=5)
    plain_ms = time_ms(lambda: plain(*args), reps=1)
    b_ms, by, how = bound(bytes_moved, ops)
    ok = cmp["all_close"] and cmp32["all_close"]
    check(ok, f"{name}: kernel differs from its plain version beyond "
          f"{REC_TOL} of the largest value (share of the bar, "
          f"{args[0].dtype} / f32): {cmp['tolerance_share']:.3g} / "
          f"{cmp32['tolerance_share']:.3g}")
    return {**cmp, "all_close": ok, "f32_copy": cmp32, "ms": ms,
            "device_ms": device["ms"], "device_in_path": device,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "timed": "ms: back-to-back calls by CUDA events; device_ms: "
                     "a call's kernel time in the profile of the path's "
                     "own prefill (torch.profiler)",
            "bound_terms": how}


def wkv6_row(captured: dict, launches: dict, device: dict,
             decode_device: dict) -> dict:
    """wkv6 on layer 0 of rwkv6-3b's measured prefill (and of one decode
    step, with the step's device time a call in ``decode_device``),
    against ``wkv6_plain``; its SASS counts and its device time at a
    quarter, a half and all of the prefill's heads."""
    r, k, v, w, u, state = captured["prefill"]
    B, S, H, hd = r.shape
    bytes_moved = 3 * r.numel() * r.element_size() + 4 * (
        w.numel() + u.numel() + 2 * state.numel() + r.numel())
    # the function's least work: the bonus term factors as
    # v_v sum_k r_k u_k k_k, so a (token, key, value) triple needs r s,
    # the sum, k v, w s and the add; a (token, head) adds the bonus sum
    # (r u, times k, the add) a key and v times it plus the add a value
    ops = 5 * B * S * H * hd * hd + 5 * B * S * H * hd
    row = recurrence_row("wkv6", wk.wkv6, wkv6_plain, captured["prefill"],
                         bytes_moved, ops, device)
    at_decode = rec_compare(wk.wkv6, wkv6_plain, captured["decode"])
    check(at_decode["all_close"], f"wkv6: the decode step's call differs "
          f"from its plain version ({at_decode['tolerance_share']:.3g} of "
          f"the bar)")
    at_decode["device_in_step"] = decode_device
    g = torch.Generator(device=r.device).manual_seed(SEED + 59)

    def sweep_args(heads):
        rnd = [torch.randn((B, S, heads, hd), generator=g, device=r.device)
               for _ in range(4)]
        return (*(a.to(r.dtype) for a in rnd[:3]),
                torch.exp(-torch.exp(rnd[3] - 1)), u[:heads].clone(),
                torch.zeros((B, heads, hd, hd), device=r.device))
    sweep = grid_sweep(sweep_args, wk.wkv6, (H // 4, H // 2, H))
    for e in sweep:
        e["heads"] = e.pop("size")
        e["ctas"] = B * e["heads"] * hd // 32
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/models/rwkv.py:69 (no TPU kernel: the "
                        "lax.scan of time_mix's step, rwkv.py:58-69)",
            "launches": launches["mixers-rwkv"],
            "launches_by_path": launches, **row,
            "shape": {"B": B, "S": S, "H": H, "hd": hd,
                      "dtype": str(r.dtype)},
            "at_decode": at_decode, "sass": recurrence_sass("wkv6"),
            "grid_sweep": sweep}


def selective_scan_row(captured: tuple, launches: dict,
                       device: dict) -> dict:
    """selective_scan on jamba's Mamba layer's prefill, against
    ``selective_scan_plain``."""
    dt, xc, A, Bm, Cm, D_skip, h0 = captured
    B, S, di = dt.shape
    ds = A.shape[1]
    bytes_moved = (2 * dt.numel() + 2 * Bm.numel()) * dt.element_size() + \
        4 * (A.numel() + D_skip.numel() + 2 * h0.numel() + dt.numel())
    # a (token, channel, state): dt A, its exp, dt B, times x, da h, + db,
    # h C, the sum; a (token, channel): x D, + it
    ops = B * S * di * (8 * ds + 2)
    row = recurrence_row("selective_scan", ssk.selective_scan,
                         selective_scan_plain, captured, bytes_moved, ops,
                         device)
    # the exponentials alone on the SFU: 16 results a clock an SM (the
    # throughput table NVIDIA gives for compute capability 9.0) at the
    # card's highest SM clock; beside the bound, not in it
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dt.device).multi_processor_count
    row["bound_terms"]["sfu_ms"] = B * S * di * ds / (16 * sms * mhz * 1e6) \
        * 1e3
    row["bound_terms"]["sfu_terms"] = {"exponentials": B * S * di * ds,
                                       "per_sm_per_clock": 16, "sms": sms,
                                       "clocks_max_sm_mhz": mhz}
    g = torch.Generator(device=dt.device).manual_seed(SEED + 61)

    def sweep_args(width):
        rnd = [torch.randn(shape, generator=g, device=dt.device) for shape in
               ((B, S, width), (B, S, width), (B, S, ds), (B, S, ds))]
        return (F.softplus(rnd[0] - 2).to(dt.dtype), rnd[1].to(dt.dtype),
                A[:width].clone(), rnd[2].to(dt.dtype), rnd[3].to(dt.dtype),
                D_skip[:width].clone(),
                torch.zeros((B, width, ds), device=dt.device))
    sweep = grid_sweep(sweep_args, ssk.selective_scan,
                       (di // 4, di // 2, di))
    for e in sweep:
        e["d_inner"] = e.pop("size")
        e["ctas"] = B * -(-e["d_inner"] // 128)
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan.cu",
            "replaces": "src/repro/models/ssm.py:21 (no TPU kernel: "
                        "_selective_scan's associative scan and the C "
                        "contraction of mamba_block, ssm.py:21-87)",
            "launches": launches["mixers-jamba-layer"],
            "launches_by_path": launches, **row,
            "shape": {"B": B, "S": S, "d_inner": di, "d_state": ds,
                      "dtype": str(dt.dtype)},
            "sass": recurrence_sass("selective_scan"), "grid_sweep": sweep}


def phi_part(dev) -> tuple[dict, dict]:
    """(a): phi3.5-moe at full width and ``MIX_PHI_LAYERS`` layers in bf16,
    served; ``tc`` and ``decode`` on its layer-0 inputs; then the f32
    agreement check at 2 layers of the full width."""
    cfg = configs.ARCHS[MIX_PHI].with_(n_layers=MIX_PHI_LAYERS)
    L = cfg.n_layers
    free()
    torch.cuda.reset_peak_memory_stats()
    free_before, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    model = transformer.DecoderLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 31))
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 37)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (
        MIX_PHI_BATCH, MIX_PHI_PROMPT)), device=dev)
    max_len = MIX_PHI_PROMPT + MIX_PHI_NEW
    probe = MixerProbe(max_len - 2)
    serve = mixer_serve(cfg, model, prompts, MIX_PHI_NEW, probe, [
        (fak, "flash_attention", probe.attention(fak.flash_attention))])
    peak = torch.cuda.max_memory_allocated()
    only = {"prefill": {"tc": L, "decode": 0, "simt": 0},
            "decode": {"tc": 0, "decode": L, "simt": 0}}
    for phase, want in only.items():
        got = [c for c in probe.variants[phase] if c != want]
        check(not got, f"mixers: phi: a bf16 {phase} forward took "
              f"flash-attention variants {got[:1]}, not {want}")
    others = [c for ph in ("prefill", "decode") for c in probe.counts[ph]
              if any(n for k, n in c.items() if k != "flash_attn")]
    check(not others, f"mixers: phi: other kernels launched: {others[:1]}")
    profiles = mixer_profiles(model, prompts, max_len, "phi")
    params = transformer.param_count(model)
    captured = probe.captured
    del model, probe
    free()
    check(set(captured) == {"prefill", "decode"},
          f"mixers: phi: captured attention inputs {sorted(captured)}")
    q, k, v, kw = captured["prefill"]
    at_prefill = attn_at(q, k, v, kw, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    q, k, v, kw = captured["decode"]
    at_decode = attn_at(q, k, v, kw, lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True))
    at_prefill["device_in_path"] = path_kernel_ms(
        profiles["profile_prefill"], ("flash_tc",), L)
    at_decode["device_in_path"] = path_kernel_ms(
        profiles["profile_decode"], ("flash_decode",), L)
    cases = {"at_phi_prefill": at_prefill, "at_phi_decode": at_decode}
    del q, k, v, captured
    free()
    check(all(c["all_close"] for c in cases.values())
          and [c["variant"] for c in cases.values()] == ["tc", "decode"],
          "flash_attn: at phi's layer 0 the kernel differs from its plain "
          "version or took another variant: " + ", ".join(
              f"{c['variant']} {c['tolerance_share']:.3g}"
              for c in cases.values()))

    E, K = cfg.moe.n_experts, cfg.moe.top_k
    cfg32 = cfg.with_(n_layers=MIX_F32_PHI_LAYERS, act_dtype="float32",
                      moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=E / K))
    m32 = transformer.DecoderLM(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 41))
    agree = f32_agreement(cfg32, m32, prompts[:MIX_F32_BATCH,
                                              :MIX_F32_PROMPT], "phi")
    check(agree["launches_by_variant"] == {
        "tc": 0, "decode": (MIX_F32_NEW - 1) * MIX_F32_PHI_LAYERS,
        "simt": MIX_F32_PHI_LAYERS}, f"mixers: phi: the f32 check took "
        f"variants {agree['launches_by_variant']}")
    del m32
    free()
    out = {"arch": MIX_PHI, "dtype": cfg.act_dtype, "layers": L,
           "layers_published": configs.ARCHS[MIX_PHI].n_layers,
           "params": params, "init_s": init_s,
           "free_bytes_before": free_before, "total_bytes": total,
           "peak_allocated_bytes": peak, **serve, **profiles,
           "attention_launches_per_generate": {
               "prefill_tc": L, "decode": (MIX_PHI_NEW - 1) * L},
           "f32_check": {"layers": MIX_F32_PHI_LAYERS,
                         "capacity_factor": E / K, **agree}}
    return out, cases


def rwkv_part(dev) -> tuple[dict, dict]:
    """(b): rwkv6-3b at full width and depth in bf16, served; its f32
    agreement check on the same weights; the wkv6 row on its layer-0
    inputs."""
    cfg = configs.ARCHS[MIX_RWKV]
    L = cfg.n_layers
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.DecoderLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 43))
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 47)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (
        MIX_RWKV_BATCH, MIX_RWKV_PROMPT)), device=dev)
    max_len = MIX_RWKV_PROMPT + MIX_RWKV_NEW
    probe = MixerProbe(max_len - 2)
    serve = mixer_serve(cfg, model, prompts, MIX_RWKV_NEW, probe, [
        (wk, "wkv6", probe.kernel(wk.wkv6))])
    peak = torch.cuda.max_memory_allocated()
    want = {name: (L if name == "wkv6" else 0) for name in KERNELS}
    bad = [c for ph in ("prefill", "decode") for c in probe.counts[ph]
           if c != want]
    check(not bad, f"mixers: rwkv: a forward launched {bad[:1]}, not wkv6 "
          f"{L} times and nothing else")
    profiles = mixer_profiles(model, prompts, max_len, "rwkv")
    captured = probe.captured
    check(set(captured) == {"prefill", "decode"},
          f"mixers: rwkv: captured wkv6 inputs {sorted(captured)}")
    cfg32 = cfg.with_(act_dtype="float32")
    m32 = transformer.DecoderLM(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 43))
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    params = transformer.param_count(model)
    del model, probe
    free()
    agree = f32_agreement(cfg32, m32, prompts[:MIX_F32_BATCH,
                                              :MIX_F32_PROMPT], "rwkv")
    del m32
    free()
    launches = {"mixers-rwkv": serve["launches"]["wkv6"],
                "mixers-rwkv-f32": agree["launches"]["wkv6"]}
    row = wkv6_row(captured, launches, path_kernel_ms(
        profiles["profile_prefill"], ("wkv6_kernel",), L), path_kernel_ms(
        profiles["profile_decode"], ("wkv6_kernel",), L))
    del captured
    free()
    out = {"arch": MIX_RWKV, "dtype": cfg.act_dtype, "layers": L,
           "params": params, "init_s": init_s,
           "peak_allocated_bytes": peak, **serve, **profiles,
           "wkv6_launches_per_forward": L, "f32_check": agree}
    return out, row


def mamba_part(dev) -> tuple[dict, dict]:
    """(c): jamba-1.5-large's Mamba layer at full width, alone, in bf16: a
    prefill of ``MIX_MAMBA_BATCH`` x ``MIX_MAMBA_PROMPT`` through
    ``mamba_block`` with a cache, then ``MIX_MAMBA_STEPS`` decode steps,
    one selective-scan launch a call. Then an f32 copy of the layer:
    step-by-step decode against its teacher-forced pass. Then jamba's
    whole pattern at the smoke width (:func:`jamba_smoke`)."""
    cfg = configs.ARCHS[MIX_JAMBA]
    D, di = cfg.d_model, cfg.ssm.expand * cfg.d_model
    ds, Kc = cfg.ssm.d_state, cfg.ssm.d_conv
    free()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    p = ssm.init_mamba(g, cfg, torch.bfloat16, dev)
    B, S = MIX_MAMBA_BATCH, MIX_MAMBA_PROMPT
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    steps_x = torch.randn((MIX_MAMBA_STEPS, B, 1, D), generator=g,
                          device=dev).to(torch.bfloat16)
    cache = {"conv": torch.zeros((B, di, Kc - 1), dtype=torch.bfloat16,
                                 device=dev),
             "h": torch.zeros((B, di, ds), dtype=torch.float32, device=dev)}
    probe = MixerProbe(0)
    probe._slot = "prefill"
    reset_counts()
    with torch.inference_mode(), patched(ssk, "selective_scan", probe.kernel(
            ssk.selective_scan)):
        (y, _), prefill_ms = timed_once(lambda: ssm.mamba_block(x, p, cfg,
                                                                cache))
        check(ssk.launch_count() == 1, f"mixers: the Mamba prefill launched "
              f"selective_scan {ssk.launch_count()} times")
        finite = bool(torch.isfinite(y).all())
        step_ms = []
        for t in range(MIX_MAMBA_STEPS):
            (yt, _), ms = timed_once(lambda: ssm.mamba_block(
                steps_x[t], p, cfg, cache))
            step_ms.append(ms)
            finite = finite and bool(torch.isfinite(yt).all())
    launches = counts()
    check(launches["selective_scan"] == 1 + MIX_MAMBA_STEPS
          and all(n == 0 for k, n in launches.items()
                  if k != "selective_scan"),
          f"mixers: the Mamba layer launched {launches}")
    check(finite, "mixers: the Mamba layer's outputs are not finite")
    peak = torch.cuda.max_memory_allocated()
    for t in cache.values():
        t.zero_()
    with torch.inference_mode():
        profile = device_ops(lambda: ssm.mamba_block(x, p, cfg, cache),
                             top=16, keep=REC_KEEP)
    captured = probe.captured["prefill"]
    del y, yt, cache, steps_x, probe
    free()

    # an f32 copy of the layer: decode against the teacher-forced pass
    fb, fp, fs = MIX_MAMBA_F32
    p32 = {k: v.float() for k, v in p.items()}
    x32 = x[:fb, :fp + fs].float()
    del p, x
    with torch.inference_mode():
        whole, _ = ssm.mamba_block(x32, p32, cfg)
        c32 = {"conv": torch.zeros((fb, di, Kc - 1), device=dev),
               "h": torch.zeros((fb, di, ds), device=dev)}
        parts = [ssm.mamba_block(x32[:, :fp], p32, cfg, c32)[0]]
        for t in range(fp, fp + fs):
            parts.append(ssm.mamba_block(x32[:, t:t + 1], p32, cfg, c32)[0])
        scale = float(whole.abs().max())
        err = float((torch.cat(parts, 1) - whole).abs().max())
    check(err <= MIX_DECODE_REL * scale, f"mixers: the Mamba layer's f32 "
          f"decode differs from its teacher-forced pass by {err:.3g} "
          f"(scale {scale:.3g})")
    del p32, x32, whole, parts, c32
    free()
    row = selective_scan_row(captured, {
        "mixers-jamba-layer": launches["selective_scan"]}, path_kernel_ms(
            profile, ("selective_scan_kernel",), 1))
    del captured
    free()
    smoke = jamba_smoke(dev)
    row["launches_by_path"]["mixers-jamba-smoke"] = smoke["launches"][
        "selective_scan"]
    dm = np.array(step_ms)
    return {"arch": MIX_JAMBA, "layer": "mamba", "d_model": D,
            "d_inner": di, "d_state": ds, "d_conv": Kc,
            "dt_rank": cfg.ssm.dt_rank or max(1, D // 16),
            "batch": B, "prompt": S, "decode_steps": MIX_MAMBA_STEPS,
            "prefill_ms": prefill_ms,
            "decode_ms_per_step": {"p50": float(np.percentile(dm, 50)),
                                   "p99": float(np.percentile(dm, 99))},
            "peak_allocated_bytes": peak, "launches": launches,
            "profile_prefill": profile,
            "f32_decode_check": {"batch": fb, "prompt": fp, "steps": fs,
                                 "max_abs_err": err, "scale": scale,
                                 "bar_rel": MIX_DECODE_REL,
                                 "share": err / (MIX_DECODE_REL * scale)},
            "smoke_pattern": smoke}, row


def jamba_smoke(dev) -> dict:
    """jamba's whole pattern (``mmmammmm``: Mamba, attention and MoE) at
    the smoke width, f32 and capacity 4.0, on the card: prefill plus
    decode against the card's teacher-forced forward, and that forward
    against the same weights on the CPU (plain versions), each within
    ``MIX_DECODE_REL`` of the logits' scale."""
    cfg = configs.smoke(MIX_JAMBA).with_(act_dtype="float32")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    cpu = transformer.DecoderLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(
                                    SEED + 59))
    gpu = transformer.DecoderLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 59))
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(SEED + 61).integers(0, cfg.vocab, (2, 40))
    reset_counts()
    with torch.inference_mode():
        got = transformer.forward(gpu, torch.as_tensor(toks, device=dev))
        launches = counts()
        want = transformer.forward(cpu, torch.as_tensor(toks))
        scale = float(want.abs().max())
        cpu_err = float((got.cpu() - want).abs().max())
        P = 34
        lg, cache = transformer.prefill(gpu, torch.as_tensor(
            toks[:, :P], device=dev), 40)
        errs = [float((lg[:, 0] - got[:, P - 1]).abs().max())]
        for i in range(P, 39):
            lg, cache = transformer.decode_step(gpu, cache, torch.as_tensor(
                toks[:, i:i + 1], device=dev))
            errs.append(float((lg[:, 0] - got[:, i]).abs().max()))
    G = cfg.n_groups
    want_launches = {"selective_scan": G * cfg.pattern.count("m"),
                     "flash_attn": G * cfg.pattern.count("a")}
    check(all(launches[k] == n for k, n in want_launches.items())
          and all(n == 0 for k, n in launches.items()
                  if k not in want_launches),
          f"mixers: jamba smoke forward launched {launches}")
    check(cpu_err <= MIX_DECODE_REL * scale, f"mixers: jamba smoke on the "
          f"card differs from the CPU by {cpu_err:.3g} (scale {scale:.3g})")
    check(max(errs) <= MIX_DECODE_REL * scale, f"mixers: jamba smoke "
          f"decode differs from the teacher-forced forward by {max(errs):.3g}"
          f" (scale {scale:.3g})")
    return {"pattern": cfg.pattern, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "launches": launches,
            "cpu_max_abs_err": cpu_err, "decode_max_abs_err": max(errs),
            "scale": scale, "bar_rel": MIX_DECODE_REL}


def mixers_phase(dev) -> tuple[dict, list, dict]:
    """The MoE, Mamba and RWKV6 mixers served on the card: (a) phi3.5-moe,
    (b) rwkv6-3b, (c) jamba's Mamba layer and its smoke pattern. Returns
    the phase's line, the wkv6 and selective-scan rows, and the
    flash-attention cases at phi's layer 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phi, attn_cases = phi_part(dev)
    rwkv, wkv_row = rwkv_part(dev)
    mamba, scan_row = mamba_part(dev)
    out = {"phase": "mixers", "seconds": time.perf_counter() - t0,
           "phi": phi, "rwkv": rwkv, "mamba": mamba}
    return out, [wkv_row, scan_row], attn_cases


# ---------------------------------------------------------------------------
# the multimodal archs: seamless-m4t-large-v2 (encoder-decoder) and
# internvl2-26b (vision frontend stub), served through flash attention
# ---------------------------------------------------------------------------

# seamless-m4t-large-v2 at full width and depth (24 + 24 layers, 1.77 B
# parameters): 8 requests of 1,024 frame embeddings, a 16-token decoder
# prompt, 128 greedy new tokens. internvl2-26b at full width and depth (48
# layers, 19.31 B parameters, 38.6 GB of bf16 weights): 4 requests of 256
# patch embeddings and 1,024 prompt tokens, 32 new tokens
MM_SEAMLESS = "seamless-m4t-large-v2"
MM_SEAMLESS_BATCH, MM_SEAMLESS_FRAMES = 8, 1024
MM_SEAMLESS_PROMPT, MM_SEAMLESS_NEW = 16, 128
MM_INTERNVL = "internvl2-26b"
MM_INTERNVL_BATCH, MM_INTERNVL_PROMPT, MM_INTERNVL_NEW = 4, 1024, 32
MM_WARMUP, MM_REPS = 1, 2
# jax.eval_shape of the reference's init_params (tests/test_torch_encdec.py)
MM_PARAMS = {MM_SEAMLESS: 1_773_478_912, MM_INTERNVL: 19_312_281_600}
# the f32 checks: the same weights cut to 2 layers (2 + 2 for seamless) of
# the full width; B, frames (seamless), prompt tokens, new tokens
MM_F32_LAYERS = 2
MM_F32_BATCH, MM_F32_FRAMES, MM_F32_PROMPT, MM_F32_NEW = 2, 256, 16, 32


class MultimodalProbe(MixerProbe):
    """:class:`MixerProbe` that, in the captured prefill and decode step,
    keeps the first flash-attention call of each kind: ``encoder``
    (non-causal over its own sequence), ``self`` (causal) and ``cross``
    (non-causal over the encoder memory), keyed ``<phase>_<kind>``."""

    def forward(self, orig, phase: str):
        inner = super().forward(orig, phase)

        def run(model, *args):
            out = inner(model, *args)
            self._slot = None
            return out
        return run

    def attention(self, orig):
        def run(q, k, v, **kw):
            if self._slot is not None:
                kind = "self" if kw["causal"] else (
                    "encoder" if self._slot == "prefill"
                    and q.shape[2] == k.shape[2] else "cross")
                self.captured.setdefault(f"{self._slot}_{kind}",
                                         (q, k, v, kw))
            return orig(q, k, v, **kw)
        return run


def mm_fns(cfg) -> tuple:
    """(build, prefill, decode, forward) of an encoder-decoder (``ctx``:
    its frame embeddings) or of a frontend arch (``ctx``: the patch
    embeddings before the prompt); ``forward`` gives the tokens' logits."""
    if cfg.kind == "encdec":
        return (encdec.EncDecLM, encdec.prefill, encdec.decode_step,
                encdec.forward)
    return (transformer.DecoderLM,
            lambda m, ctx, toks, n: transformer.prefill(m, toks, n, ctx),
            transformer.decode_step,
            lambda m, ctx, toks: transformer.forward(m, toks, ctx)[
                :, ctx.shape[1]:])


@torch.inference_mode()
def mm_generate(prefill, decode, model, ctx, prompts, max_len: int,
                n_new: int, keep_logits: bool = False):
    """Greedy decode of ``n_new`` tokens: one prefill, then ``n_new - 1``
    decode steps; nothing read back. Returns the tokens (B, n_new) int32
    and, with ``keep_logits``, each new token's logits (B, n_new, V)."""
    logits, cache = prefill(model, ctx, prompts, max_len)
    out, kept = [], []
    for i in range(n_new):
        last = logits[:, -1]
        kept.append(last)
        tok = last.argmax(-1, keepdim=True)
        out.append(tok)
        if i + 1 < n_new:
            logits, cache = decode(model, cache, tok)
    return (torch.cat(out, 1).to(torch.int32),
            torch.stack(kept, 1) if keep_logits else None)


def mm_f32_check(cfg, model, fns, ctx, prompts, dev, seed: int) -> dict:
    """The weights of ``model`` cut to ``MM_F32_LAYERS`` layers (and
    encoder layers) of the full width, in f32: greedy decode of
    ``MM_F32_NEW`` tokens must agree with the argmax of the teacher-forced
    forward at >= ``LM_AGREE`` of positions, and every prefill and decode
    step's logits lie within ``MIX_DECODE_REL`` of the forward's largest
    logit (``tests/test_models.py::test_encdec_decode_matches_forward``'s
    bar)."""
    build, prefill, decode, forward = fns
    cuts = {"n_layers": MM_F32_LAYERS}
    if cfg.kind == "encdec":
        cuts["encoder_layers"] = MM_F32_LAYERS
    cfg32 = cfg.with_(act_dtype="float32", **cuts)
    m32 = build(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    sd = model.state_dict()
    m32.load_state_dict({k: sd[k].float() for k in m32.state_dict()})
    pre = 0 if cfg.kind == "encdec" else ctx.shape[1]
    P = prompts.shape[1]
    reset_counts()
    out, steps = mm_generate(prefill, decode, m32, ctx, prompts,
                             pre + P + MM_F32_NEW, MM_F32_NEW,
                             keep_logits=True)
    launches, variants = counts(), variant_counts()
    with torch.inference_mode():
        ref = forward(m32, ctx, torch.cat([prompts, out.long()], 1))[
            :, P - 1:-1]
    check(bool(torch.isfinite(ref).all()) and bool(
        torch.isfinite(steps).all()), f"multimodal: {cfg.name}: f32 logits "
        f"not finite")
    agree = float((ref.argmax(-1) == out).float().mean())
    scale = float(ref.abs().max())
    rel = float((steps - ref).abs().max()) / scale
    del m32, ref, steps
    check(agree >= LM_AGREE, f"multimodal: {cfg.name}: f32 greedy decode "
          f"agrees with the teacher-forced forward at {agree:.4f}")
    check(rel < MIX_DECODE_REL, f"multimodal: {cfg.name}: f32 prefill and "
          f"decode logits differ from the forward's by {rel:.3g} of its "
          f"scale {scale:.4g}")
    return {"layers": MM_F32_LAYERS, "batch": prompts.shape[0],
            "context": ctx.shape[1], "prompt": P, "new": MM_F32_NEW,
            "agreement": agree, "bar": LM_AGREE, "logits_rel_err": rel,
            "scale": scale, "bar_rel": MIX_DECODE_REL, "launches": launches,
            "launches_by_variant": variants}


def mm_part(arch: str, batch: int, ctx_len: int, prompt: int, n_new: int,
            dev, seed: int) -> tuple[dict, dict]:
    """One multimodal arch at full width and depth in bf16 (seeded
    weights): ``MM_WARMUP`` + ``MM_REPS`` greedy generates under sync
    debug mode "error", each forward's flash-attention launches checked
    (every prefill its tc variant once an attention, every decode step its
    decode variant, no other kernel), one profiled prefill and decode
    step, the f32 check; returns the part's line and the captured
    attention inputs."""
    cfg = configs.ARCHS[arch]
    fns = build, prefill, decode, _ = mm_fns(cfg)
    enc = cfg.kind == "encdec"
    n_tc = cfg.encoder_layers + 2 * cfg.n_layers if enc else cfg.n_layers
    n_decode = 2 * cfg.n_layers if enc else cfg.n_layers
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    sync()
    init_s = time.perf_counter() - t0
    params = transformer.param_count(model)
    check(params == MM_PARAMS[arch], f"multimodal: {arch} has {params} "
          f"parameters, the reference {MM_PARAMS[arch]}")
    # uploaded before the loop: a copy from pageable memory synchronises
    ctx = embedding_batch(seed, 0, batch, ctx_len, cfg.frontend_dim,
                          device=dev)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt)), device=dev)
    pre = 0 if enc else ctx_len
    max_len = pre + prompt + n_new
    probe = MultimodalProbe(max_len - 2)
    runs = MM_WARMUP + MM_REPS
    outs, gen_s = [], []
    pf, dc = probe.forward(prefill, "prefill"), probe.forward(decode,
                                                               "decode")
    reset_counts()
    with patched(fak, "flash_attention", probe.attention(fak.flash_attention)):
        for r in range(runs):
            probe.capture = r == runs - 1
            sync()
            t1 = time.perf_counter()
            with sync_debug_error():
                out, _ = mm_generate(pf, dc, model, ctx, prompts, max_len,
                                     n_new)
            sync()
            if r >= MM_WARMUP:
                gen_s.append(time.perf_counter() - t1)
                outs.append(out)
    launches, by_variant = counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = n_new - 1
    check(len(probe.counts["prefill"]) == runs
          and len(probe.counts["decode"]) == runs * steps,
          f"multimodal: {arch}: not one prefill and n_new - 1 decode steps "
          f"a generate")
    only = {"prefill": {"tc": n_tc, "decode": 0, "simt": 0},
            "decode": {"tc": 0, "decode": n_decode, "simt": 0}}
    for phase, want in only.items():
        got = [c for c in probe.variants[phase] if c != want]
        check(not got, f"multimodal: {arch}: a bf16 {phase} forward took "
              f"flash-attention variants {got[:1]}, not {want}")
    others = [c for ph in ("prefill", "decode") for c in probe.counts[ph]
              if any(n for k, n in c.items() if k != "flash_attn")]
    check(not others, f"multimodal: {arch}: other kernels launched: "
          f"{others[:1]}")
    last = outs[-1]
    check(last.shape == (batch, n_new)
          and bool(((last >= 0) & (last < cfg.vocab)).all()),
          f"multimodal: {arch}: generated tokens out of shape or vocabulary")
    prefill_ms = [a.elapsed_time(b) for a, b in
                  probe.events["prefill"][MM_WARMUP:]]
    decode_ms = np.array([a.elapsed_time(b) for a, b in
                          probe.events["decode"][MM_WARMUP * steps:]])
    keep = ("flash_",)
    in_path = {}
    with torch.inference_mode():
        encode_ms = None
        if enc:
            encode_ms = time_ms(lambda: encdec.encode(model, ctx), reps=3)
            # the encoder's tc calls alone (the prefill's d = 64 tc calls
            # share one kernel name over three shapes)
            in_path["encode"] = path_kernel_ms(device_ops(
                lambda: encdec.encode(model, ctx), top=8, keep=keep),
                ("flash_tc",), cfg.encoder_layers)
        prof_prefill = device_ops(
            lambda: prefill(model, ctx, prompts, max_len), top=8, keep=keep)
        lg, cache = prefill(model, ctx, prompts, max_len)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        check(bool(torch.isfinite(lg).all()),
              f"multimodal: {arch}: prefill logits not finite")
        prof_decode = device_ops(lambda: decode(model, cache, tok), top=8,
                                 keep=keep)
    del lg, cache
    f32 = mm_f32_check(cfg, model, fns, ctx[:MM_F32_BATCH, :MM_F32_FRAMES]
                       if enc else ctx[:MM_F32_BATCH],
                       prompts[:MM_F32_BATCH, :MM_F32_PROMPT], dev, seed + 1)
    del model, probe.events
    free()
    out = {"arch": arch, "dtype": cfg.act_dtype, "params": params,
           "layers": {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
           if enc else cfg.n_layers, "init_s": init_s, "batch": batch,
           ("frames" if enc else "prefix_patches"): ctx_len,
           "prompt": prompt, "new": n_new, "max_len": max_len,
           "warmup": MM_WARMUP, "reps": MM_REPS, "encode_ms": encode_ms,
           "prefill_ms": float(np.mean(prefill_ms)),
           "prefill_ms_each": prefill_ms,
           "decode_ms_per_token": {
               "p50": float(np.percentile(decode_ms, 50)),
               "p99": float(np.percentile(decode_ms, 99)),
               "mean": float(decode_ms.mean()), "count": int(decode_ms.size)},
           "generate_s_each": gen_s,
           "tokens_per_s": batch * n_new / float(np.mean(gen_s)),
           "peak_allocated_bytes": peak, "launches": launches,
           "launches_by_variant": by_variant,
           "attention_launches_per_forward": {"prefill_tc": n_tc,
                                              "decode": n_decode},
           "repeat_tokens_equal": all(bool(torch.equal(o, last))
                                      for o in outs),
           "generates_under_sync_debug_error": runs,
           "flash_in_path": {
               **in_path,
               "prefill": path_kernel_ms(prof_prefill, ("flash_tc",), n_tc),
               "decode": path_kernel_ms(prof_decode, ("flash_decode",),
                                        n_decode)},
           "profile_prefill": prof_prefill, "profile_decode": prof_decode,
           "f32_check": f32}
    return out, probe.captured


def mm_attn_cases(captured: dict, want: dict) -> dict:
    """The flash-attention kernel on the captured inputs named in ``want``
    (captured key -> (case name, the variant the wrapper must take)),
    each through :func:`attn_at` beside ``scaled_dot_product_attention``,
    with the kernel's and the library's device-bound ms (queued). (A
    profile of lone launches this late in the script records no kernel:
    the device time a call in the profile comes from the path's own
    forwards, ``mm_part``'s ``flash_in_path``.)"""
    cases = {}
    for key, (name, variant) in want.items():
        q, k, v, kw = captured.pop(key)
        causal = kw["causal"] and q.shape[2] > 1

        def lib(q=q, k=k, v=v, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        c = attn_at(q, k, v, kw, lib)

        def run(q=q, k=k, v=v, variant=c["variant"]):
            return fak._launch(variant, q, k, v, **kw)
        c["queued_ms"] = queued_ms(run)
        c["library_queued_ms"] = queued_ms(lib)
        check(c["all_close"] and c["variant"] == variant,
              f"flash_attn: at {name} the kernel took {c['variant']} (not "
              f"{variant}) or differs from its plain version (share "
              f"{c['tolerance_share']:.3g}, simt "
              f"{c['simt']['tolerance_share']:.3g}, f32 "
              f"{c['f32_copy']['tolerance_share']:.3g})")
        cases[name] = c
        del q, k, v, c
    captured.clear()
    free()
    return cases


def multimodal_phase(dev) -> tuple[dict, dict]:
    """(a) seamless-m4t-large-v2 and (b) internvl2-26b served at full
    width and depth; the flash-attention cases at their new shapes
    (seamless's encoder, its cross attention in a prefill and a decode
    step, internvl2's layer 0 in a prefill and a decode step). Returns the
    phase's line and the cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seamless, captured = mm_part(MM_SEAMLESS, MM_SEAMLESS_BATCH,
                                 MM_SEAMLESS_FRAMES, MM_SEAMLESS_PROMPT,
                                 MM_SEAMLESS_NEW, dev, SEED + 61)
    cases = mm_attn_cases(captured, {
        "prefill_encoder": ("at_seamless_encoder", "tc"),
        "prefill_cross": ("at_seamless_cross", "tc"),
        "decode_cross": ("at_seamless_cross_decode", "decode")})
    internvl, captured = mm_part(MM_INTERNVL, MM_INTERNVL_BATCH,
                                 configs.ARCHS[MM_INTERNVL].frontend_seq,
                                 MM_INTERNVL_PROMPT, MM_INTERNVL_NEW, dev,
                                 SEED + 67)
    cases.update(mm_attn_cases(captured, {
        "prefill_self": ("at_internvl2_prefill", "tc"),
        "decode_self": ("at_internvl2_decode", "decode")}))
    # device ms a call in the path's own profiled forwards, where the
    # path's calls of that kernel all have the case's shape
    for case, (part, fwd) in {
            "at_seamless_encoder": (seamless, "encode"),
            "at_internvl2_prefill": (internvl, "prefill"),
            "at_internvl2_decode": (internvl, "decode")}.items():
        cases[case]["device_in_path"] = part["flash_in_path"][fwd]
    out = {"phase": "multimodal", "seconds": time.perf_counter() - t0,
           "seamless": seamless, "internvl2": internvl}
    return out, cases


# ---------------------------------------------------------------------------
# the mixers' training: rwkv6-3b and jamba's Mamba layer through the
# recurrence kernels' backward
# ---------------------------------------------------------------------------

# rwkv6-3b at full width and depth, and jamba-1.5-large at full width cut
# to one Mamba and one attention layer ("ma", each with its dense SwiGLU
# FFN: the whole model is 398 B parameters, and 16 experts of d_ff 24,576
# do not fit one card): bf16, remat "dots", the train phase's 4 x 2048
# tokens a step, 1 warm-up and 4 measured steps
TM_RWKV = "rwkv6-3b"
TM_JAMBA = "jamba-1.5-large-398b"
TM_JAMBA_CUTS = {"pattern": "ma", "n_layers": 2, "moe": None}
TM_WARMUP, TM_STEPS = 1, 4
# a backward kernel against its plain backward, each output: |got - want|
# <= ulp |want| + REC_TOL (largest |want|), ulp 0 for f32 outputs. Both
# compute in f32 from the same inputs (the kernel's exponentials on the
# SFU, its sums in another order); a bf16 output is that f32 value rounded
# once on each side, so the two may round one bf16 ulp apart (2^-7 of the
# value at most)
TM_BF16_ULP = 2.0 ** -7
# the backward's least work a (token, key, value) of wkv6: the recompute of
# the state (k v, w s, +), dr's r... product and sum, dw's, dk's and dv's
# products and sums, G's update (w G, r dy, +): 14 operations
WKV_BWD_OPS = 14
# a (token, channel, state) of the selective scan's backward: dt A, its
# exponential, db's two products, a h + db (2) to recompute h; g = dy C +
# a g (3); dlog a = g a h (2); its A term, g B and dt x terms of ddt, dA
# and dB (2 each); dC's product and sum (2): 20 operations
SCAN_BWD_OPS = 20
# the launcher at the smoke config (it forces f32): 20 steps then a
# --resume; lr 3e-3 as the README's CPU line (uniform random tokens make
# the launcher's loss-decrease check a coin flip at the default lr)
TM_CLI = ["--arch", TM_RWKV, "--smoke", "--steps", "20", "--batch", "4",
          "--seq", "64", "--lr", "3e-3"]
# the smoke gradient checks on the card against the CPU, as the train
# phase's: the loss to 1e-5 and each leaf to TRAIN_CHECK_REL of its largest
TM_SMOKE_B, TM_SMOKE_S = 2, 48


def rec_bwd_compare(fn, plain, args) -> dict:
    """A recurrence backward's gradients against its plain backward's on
    ``args``: each output within ``TM_BF16_ULP`` (bf16 outputs) of its
    value plus ``REC_TOL`` of its largest |value|; the share of that bar
    used (<= 1 passes). A second call must give the first's bits."""
    got, want = fn(*args), plain(*args)
    again = fn(*args)
    sync()
    per = []
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        top = float(w32.abs().max())
        ulp = TM_BF16_ULP if w.dtype == torch.bfloat16 else 0.0
        excess = float(((g32 - w32).abs() - ulp * w32.abs()).max())
        per.append({"max_abs_err": float((g32 - w32).abs().max()),
                    "max_abs_value": top, "dtype": str(w.dtype),
                    "share": max(excess, 0.0) / (REC_TOL * max(top, 1e-30))})
    share = max(p["share"] for p in per)
    return {"max_abs_err": max(p["max_abs_err"] for p in per),
            "by_output": per, "tolerance_share": share,
            "all_close": share <= 1.0,
            "repeat_bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, again)),
            "bar": {"rel_of_largest": REC_TOL, "bf16_ulp_of_value":
                    TM_BF16_ULP}}


def rec_bwd_row(name: str, fn, plain, args, names, bytes_moved: float,
                ops: float, launches: dict, device: dict, lib: str,
                ptxas: str) -> dict:
    """A backward kernel's row on ``args`` (layer 0's inputs and output
    gradient from a measured training step): against its plain backward
    in the path's types and on f32 copies, bit-equal repeats, its time by
    events and device-bound by ``queued_ms``, its device time in the
    profiled step (``device``), the plain backward's time, the bound, its
    registers and spills and its SASS counts. ``launches`` holds each of
    its kernels' launches on the main path, the backward's first."""
    cmp = rec_bwd_compare(fn, plain, args)
    args32 = tuple(a.float() for a in args)
    cmp32 = rec_bwd_compare(fn, plain, args32)
    del args32
    free()
    for c in (cmp, cmp32):
        c["by_output"] = dict(zip(names, c["by_output"]))
    ok = (cmp["all_close"] and cmp32["all_close"] and cmp["repeat_bit_equal"]
          and cmp32["repeat_bit_equal"])
    check(ok, f"{name}: kernel differs from its plain backward beyond the "
          f"bar (share, {args[0].dtype} / f32): "
          f"{cmp['tolerance_share']:.3g} / {cmp32['tolerance_share']:.3g}, "
          f"or a repeat gave other bits ({cmp['repeat_bit_equal']} / "
          f"{cmp32['repeat_bit_equal']})")
    ms = time_ms(lambda: fn(*args), reps=3)
    q_ms = queued_ms(lambda: fn(*args), reps=3)
    plain_ms = time_ms(lambda: plain(*args), reps=1, warmup=0)
    b_ms, by, how = bound(bytes_moved, ops)
    return {**cmp, "all_close": ok, "f32_copy": cmp32, "ms": ms,
            "queued_ms": q_ms, "device_in_step": device["all"],
            "device_in_step_by_kernel": {
                k: v["ms"] for k, v in device.items() if k != "all"},
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "bound_terms": how, "bound_share": b_ms / q_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "timed": "ms: back-to-back calls by CUDA events; queued_ms: "
                     "calls queued behind a spin kernel (device-bound); "
                     "device_in_step: the profiled training step's kernel "
                     "time a call (torch.profiler)",
            "launches": next(iter(launches.values())),
            "launches_by_kernel": launches,
            "ptxas": ptxas_usage(ptxas, rec_label),
            "sass": recurrence_sass(lib)}


def wkv6_bwd_row(captured: tuple, launches: dict, device: dict,
                 ptxas: str) -> dict:
    r, k, v, w, u, state, dy = captured
    B, S, H, hd = r.shape
    N, es = r.numel(), r.element_size()
    # in: r, k, v, w, u, state, dy; out: dr, dk, dv, dw, du, dstate
    bytes_moved = 6 * N * es + 4 * (3 * N + 2 * u.numel()
                                    + 2 * state.numel())
    ops = WKV_BWD_OPS * B * S * H * hd * hd
    row = rec_bwd_row("wkv6_bwd", wk.wkv6_bwd, wkv6_bwd_plain, captured,
                      ("dr", "dk", "dv", "dw", "du", "dstate"), bytes_moved,
                      ops, launches, device, "wkv6_bwd", ptxas)
    # the launch's plan (segments, grids, resident CTAs an SM by the
    # occupancy calculator); the card tests' multi-segment, ragged and
    # underflowing shapes at the same bar, repeats bit-equal
    row["plan"] = wk.bwd_plan(r.dtype, B, S, H, hd, r.device)
    row["at_test_shapes"] = rec_bwd_shapes(
        "wkv6_bwd", wk.wkv6_bwd, wkv6_bwd_plain, wkv_bwd_cases(r.device))
    return {"name": "wkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6_bwd.cu",
            "replaces": "src/repro/models/rwkv.py:69 (no TPU kernel: XLA's "
                        "autodiff of the lax.scan of time_mix's step, "
                        "rwkv.py:58-69)",
            **row, "shape": {"B": B, "S": S, "H": H, "hd": hd,
                             "dtype": str(r.dtype)}}


def selective_scan_bwd_row(captured: tuple, launches: dict, device: dict,
                           ptxas: str) -> dict:
    dt, xc, A, Bm, Cm, D_skip, h0, dy = captured
    B, S, di = dt.shape
    ds = A.shape[1]
    es = dt.element_size()
    # in: dt, xc, Bm, Cm, A, D, h0, dy; out: the gradients of each
    bytes_moved = 2 * es * (2 * dt.numel() + 2 * Bm.numel()) + 4 * (
        2 * (A.numel() + D_skip.numel() + h0.numel()) + dy.numel())
    ops = SCAN_BWD_OPS * B * S * di * ds
    row = rec_bwd_row("selective_scan_bwd", ssk.selective_scan_bwd,
                      selective_scan_bwd_plain, captured,
                      ("ddt", "dxc", "dA", "dBm", "dCm", "dD", "dh0"),
                      bytes_moved, ops, launches, device,
                      "selective_scan_bwd", ptxas)
    # the function's exponentials alone on the SFU (one a (token, channel,
    # state)): 16 results a clock an SM at the card's highest SM clock;
    # beside the bound, not in it
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dt.device).multi_processor_count
    row["bound_terms"]["sfu_ms"] = B * S * di * ds / (16 * sms * mhz * 1e6) \
        * 1e3
    row["bound_terms"]["sfu_terms"] = {"exponentials": B * S * di * ds,
                                       "per_sm_per_clock": 16, "sms": sms,
                                       "clocks_max_sm_mhz": mhz}
    row["plan"] = ssk.bwd_plan(dt.dtype, B, S, di, dt.device)
    row["at_test_shapes"] = rec_bwd_shapes(
        "selective_scan_bwd", ssk.selective_scan_bwd,
        selective_scan_bwd_plain, scan_bwd_cases(dt.device))
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:21 (no TPU kernel: XLA's "
                        "autodiff of _selective_scan and the C contraction "
                        "of mamba_block, ssm.py:21-89)",
            **row, "shape": {"B": B, "S": S, "d_inner": di, "d_state": ds,
                             "dtype": str(dt.dtype)}}


# the figures of the backward kernels' first design (each one kernel of
# two passes, the first writing the checkpoints, and a reduction kernel),
# quoted from PERF.md's rows 10-11 (chip_smoke on an NVIDIA H100 80GB
# HBM3 at 700.00 W): the train-mixers line prints them under
# "quoted_not_measured", apart from this run's kernel rows
BWD_FIRST_DESIGN = {
    "wkv6_bwd": {"queued_ms": 3.6396, "device_in_step_ms": 3.5009,
                 "device_in_step_by_kernel": {"wkv6_bwd_kernel": 3.129,
                                              "wkv6_bwd_reduce_kernel": 0.372},
                 "bound_share": 0.077, "registers": 95,
                 "resident_ctas_per_sm": 5, "grid": [80, 4],
                 "launches_per_step": 32},
    "selective_scan_bwd": {
        "queued_ms": 5.4190, "device_in_step_ms": 6.5052,
        "device_in_step_by_kernel": {
            "selective_scan_bwd_kernel": 6.377,
            "selective_scan_bwd_reduce_kernel": 0.129},
        "bound_share": 0.118, "registers": 250, "resident_ctas_per_sm": 4,
        "grid": [256, 4], "chunk": 8, "launches_per_step": 1}}


def wkv_bwd_cases(dev) -> dict:
    """The card tests' multi-segment, ragged and underflowing wkv6 shapes:
    the inputs and an f32 output gradient, seeded, on ``dev``."""
    out = {}
    for name, (B, S, H, dtype, w_lo) in {
            "segments_ragged": (1, 1000, 2, torch.bfloat16, None),
            "underflow": (2, 1000, 2, torch.float32, 1e-30)}.items():
        g = torch.Generator(device=dev).manual_seed(SEED + S)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        r, k, v = (rnd(B, S, H, 64).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(rnd(B, S, H, 64) - 1))
        if w_lo is not None:
            lo = torch.rand(w.shape, generator=g, device=dev) < 0.5
            w = torch.where(lo, torch.full_like(w, w_lo),
                            torch.full_like(w, 1 - w_lo))
        out[name] = (r, k, v, w, rnd(H, 64) * 0.1, rnd(B, H, 64, 64),
                     rnd(B, S, H, 64))
    return out


def scan_bwd_cases(dev) -> dict:
    """The card tests' long, ragged and underflowing scan shapes."""
    out = {}
    for name, (B, S, di, dtype, scale) in {
            "long_ragged": (1, 1001, 300, torch.bfloat16, 1.0),
            "underflow": (2, 29, 96, torch.float32, 400.0)}.items():
        g = torch.Generator(device=dev).manual_seed(SEED + S)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        dt = (F.softplus(rnd(B, S, di) - 2) * scale).to(dtype)
        A = -torch.arange(1, 17, device=dev).float().expand(di, 16) * (
            1 + 0.5 * torch.rand((di, 16), generator=g, device=dev))
        out[name] = (dt, rnd(B, S, di).to(dtype), A.contiguous(),
                     rnd(B, S, 16).to(dtype), rnd(B, S, 16).to(dtype),
                     rnd(di), rnd(B, di, 16), rnd(B, S, di))
    return out


def rec_bwd_shapes(name: str, fn, plain, cases: dict) -> dict:
    """:func:`rec_bwd_compare` at each case; fails on a miss of the bar
    or a repeat with other bits."""
    out = {}
    for case, args in cases.items():
        c = rec_bwd_compare(fn, plain, args)
        check(c["all_close"] and c["repeat_bit_equal"],
              f"{name} at {case}: share of the bar "
              f"{c['tolerance_share']:.3g}, repeat bit-equal "
              f"{c['repeat_bit_equal']}")
        out[case] = {"shape": list(args[0].shape),
                     "dtype": str(args[0].dtype),
                     "tolerance_share": c["tolerance_share"],
                     "repeat_bit_equal": c["repeat_bit_equal"]}
    free()
    return out


def train_mixer_run(name: str, cfg, dev, mod, want: dict,
                    keep: tuple) -> tuple[dict, tuple]:
    """``TM_WARMUP`` + ``TM_STEPS`` bf16 ``make_train_step`` steps of
    ``cfg`` at 4 x 2048 tokens: every loss finite, every measured step's
    launches (``counts``, flash-attention variants) equal to ``want`` and
    0 elsewhere. Then one step with ``mod._backward``'s inputs kept (the
    last call of a step: layer 0's) and one profiled step. Returns the
    run's line and the kept inputs."""
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tcfg = train_lib.TrainCfg()
    model, opt = train_lib.init_train_state(SEED, cfg, tcfg, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    step_fn = train_lib.make_train_step(cfg, tcfg)
    batches = []
    for s in range(TM_WARMUP + TM_STEPS):
        toks, labels = lm_batch(SEED, s, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
                                device=dev)
        batches.append({"tokens": toks, "labels": labels})
    losses, step_s, per_step = [], [], []
    for b in batches[:TM_WARMUP]:
        model, opt, m = step_fn(model, opt, b)
        losses.append(float(m["loss"]))
    sync()
    reset_counts()

    def now():
        return {**counts(), **variant_counts(), **bwd_variants()}
    for b in batches[TM_WARMUP:]:
        before = now()
        sync()
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, b)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        after = now()
        per_step.append({k: after[k] - before[k] for k in after})
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(x) for x in losses),
          f"train-mixers: {name}: a loss is not finite: {losses}")
    bad = [p for p in per_step if any(n != want.get(k, 0)
                                      for k, n in p.items())]
    check(not bad, f"train-mixers: {name}: a step launched "
          f"{ {k: n for k, n in bad[0].items() if n} if bad else {} }, "
          f"not {want}")
    captured = []

    def capture(orig):
        def run(*args):
            captured[:] = [tuple(a.detach() for a in args)]
            return orig(*args)
        return run
    with patched(mod, "_backward", capture(mod._backward)):
        step_fn(model, opt, batches[-1])
    sync()
    prof = device_ops(lambda: step_fn(model, opt, batches[-1]), top=16,
                      keep=keep)
    params = transformer.param_count(model)
    del model, opt, batches
    free()
    ms = np.array(step_s) * 1e3
    p50 = float(np.percentile(ms, 50))
    return {"arch": name, "dtype": cfg.act_dtype, "remat": cfg.remat,
            "layers": cfg.n_layers, "pattern": cfg.pattern,
            "params": params, "init_s": init_s, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "warmup": TM_WARMUP, "steps": TM_STEPS,
            "losses": losses,
            "step_ms": {"p50": p50, "p99": float(np.percentile(ms, 99)),
                        "mean": float(ms.mean()), "each": ms.tolist()},
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(ms.mean()) * 1e3,
            "peak_allocated_bytes": peak, "launches": launches,
            "launches_per_step": want,
            "device_ms_of_profiled_step": prof["kernel_ms"],
            "device_busy_share_of_p50": prof["kernel_ms"] / p50,
            "profile_step": prof}, captured[0]


def per_call_ms(prof: dict, names, calls: int) -> dict:
    """Device ms a call of the kept kernels whose names hold one of
    ``names``, from a profiled step that made ``calls`` calls."""
    hit = {k["name"][:90]: k["ms"] for k in prof["kept"]
           if any(n in k["name"] for n in names)}
    return {"ms": sum(hit.values()) / calls, "calls": calls,
            "kernels_ms": hit}


def train_mixers_grad_check(arch: str, dev) -> dict:
    """The smoke config of ``arch`` (its whole pattern; MoE capacity 4.0)
    at f32 on the card (the recurrence kernels forward and backward, the
    attention's simt forward and backward) against the same weights and
    batch on the CPU (plain versions): the loss to 1e-5 and each gradient
    leaf to ``TRAIN_CHECK_REL`` of its largest."""
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=4.0))
    cpu = transformer.DecoderLM(cfg, device="cpu", train=True,
                                generator=torch.Generator().manual_seed(
                                    SEED + 67))
    gpu = transformer.DecoderLM(cfg, device=dev, train=True,
                                generator=torch.Generator(
                                    device=dev).manual_seed(SEED + 67))
    with torch.no_grad():
        for a, b in zip(gpu.parameters(), cpu.parameters()):
            a.copy_(b)
    rng = np.random.default_rng(SEED + 71)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (TM_SMOKE_B,
                                                       TM_SMOKE_S)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (TM_SMOKE_B,
                                                         TM_SMOKE_S)))
    reset_counts()
    loss_g = transformer.loss_fn(gpu, toks.to(dev), labels.to(dev))
    grads_g = torch.autograd.grad(loss_g, list(gpu.parameters()))
    launches = counts()
    loss_c = transformer.loss_fn(cpu, toks, labels)
    grads_c = torch.autograd.grad(loss_c, list(cpu.parameters()))
    worst = max(float((a.cpu() - b).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads_g, grads_c))
    loss_g, loss_c = float(loss_g.detach()), float(loss_c.detach())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    G = cfg.n_groups
    n = {kind: G * cfg.pattern.count(kind) for kind in "amr"}
    want = {"wkv6": 2 * n["r"], "wkv6_bwd": n["r"],
            "wkv6_bwd_local": n["r"], "wkv6_bwd_carry": n["r"],
            "selective_scan": 2 * n["m"],
            "selective_scan_bwd": n["m"], "selective_scan_bwd_ckpt": n["m"],
            "selective_scan_bwd_reduce": n["m"],
            "flash_attn": 2 * n["a"], "flash_attn_bwd": 3 * n["a"]}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"train-mixers: {arch} smoke gradients launched {launches}, not "
          f"{want}")
    check(worst <= TRAIN_CHECK_REL and loss_rel <= 1e-5,
          f"train-mixers: {arch} smoke gradients on the card differ from "
          f"the CPU's by {worst:.3g} of a leaf's largest (bar "
          f"{TRAIN_CHECK_REL}), the loss by {loss_rel:.3g}")
    return {"pattern": cfg.pattern, "layers": cfg.n_layers,
            "batch": TM_SMOKE_B, "seq": TM_SMOKE_S, "dtype": "float32",
            "loss": loss_g, "loss_rel_err": loss_rel,
            "grad_worst_share_of_leaf_max": worst, "bar": TRAIN_CHECK_REL,
            "launches": {k: v for k, v in launches.items() if v}}


def train_mixers_cli(tmp: str) -> dict:
    """``python -m repro_torch.launch.train`` with ``TM_CLI`` (rwkv6-3b's
    smoke config, f32, on the card) and ``--ckpt-dir tmp``, whose own
    check asserts the loss fell; then ``--resume`` from its newest
    checkpoint (after step 10, holding 11 steps) must repeat the first
    run's losses of steps 11-19 bit for bit."""
    args = TM_CLI + ["--ckpt-dir", tmp]
    reset_counts()
    t0 = time.perf_counter()
    first = train_launcher.main(args)
    first_s = time.perf_counter() - t0
    launches = counts()
    free()
    second = train_launcher.main(args + ["--resume"])
    resumed = len(first) - len(second)
    check(len(first) == 20 and resumed == 11,
          f"train-mixers cli: {len(first)} steps, resumed at {resumed}")
    check(second == first[resumed:], f"train-mixers cli: the resumed "
          f"losses {second} are not the first run's {first[resumed:]}")
    L = configs.smoke(TM_RWKV).n_layers
    check(launches["wkv6"] == 2 * L * 20 and launches["wkv6_bwd"] == L * 20,
          f"train-mixers cli: launches {launches}")
    return {"args": args, "losses": first, "resumed_losses": second,
            "resumed_at": resumed, "dtype": "float32", "seconds": first_s,
            "launches": {k: v for k, v in launches.items() if v},
            "ckpt_steps": sorted(os.listdir(tmp))}


def train_mixers_phase(dev, report: dict) -> tuple[dict, list, dict]:
    """(a) rwkv6-3b at full width and depth and (b) jamba's "ma" pair at
    full width trained in bf16 through the recurrence kernels' backward;
    the two backward kernels' rows on layer 0's inputs; (c) f32 checks:
    the smoke configs' gradients on the card against the CPU, and the
    launcher's rwkv6 run with its resume. Returns the phase's line, the
    rows and the attention's training numbers at d = 128 (jamba)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = configs.ARCHS[TM_RWKV]
    L = cfg.n_layers
    rwkv, wkv_in = train_mixer_run(
        TM_RWKV, cfg, dev, wk, {"wkv6": 2 * L, "wkv6_bwd": L,
                                "wkv6_bwd_local": L, "wkv6_bwd_carry": L},
        ("wkv6",))
    wkv_launches = {f"{k}_kernel": rwkv["launches"][k]
                    for k in ("wkv6_bwd", "wkv6_bwd_local",
                              "wkv6_bwd_carry")}
    wkv_row = wkv6_bwd_row(wkv_in, wkv_launches, {
        "all": per_call_ms(rwkv["profile_step"], ("wkv6_bwd",), L),
        **{k: per_call_ms(rwkv["profile_step"], (k,), L)
           for k in wkv_launches}}, report["wkv6_bwd"]["ptxas"])
    rwkv["wkv6_fwd_in_step"] = per_call_ms(rwkv["profile_step"],
                                           ("wkv6_kernel",), 2 * L)
    del wkv_in
    free()

    jcfg = configs.ARCHS[TM_JAMBA].with_(**TM_JAMBA_CUTS)
    want = {"selective_scan": 2, "selective_scan_bwd": 1,
            "selective_scan_bwd_ckpt": 1, "selective_scan_bwd_reduce": 1,
            "flash_attn": 2,
            "flash_attn_bwd": 3, "tc": 2, "bwd_tc": 1}
    jamba, scan_in = train_mixer_run(TM_JAMBA, jcfg, dev, ssk, want,
                                     ("selective_scan", "flash_"))
    jamba["cuts"] = {"layers": f"2 of {configs.ARCHS[TM_JAMBA].n_layers} "
                               f"(the whole model is 398 B parameters)",
                     "pattern": f"'ma' of "
                                f"'{configs.ARCHS[TM_JAMBA].pattern}'",
                     "moe": "off: 16 experts of d_ff 24,576 do not fit one "
                            "card; each layer keeps its dense SwiGLU FFN"}
    scan_launches = {f"{k}_kernel": jamba["launches"][k]
                     for k in ("selective_scan_bwd", "selective_scan_bwd_ckpt",
                               "selective_scan_bwd_reduce")}
    scan_row = selective_scan_bwd_row(scan_in, scan_launches, {
        "all": per_call_ms(jamba["profile_step"], ("selective_scan_bwd",), 1),
        **{k: per_call_ms(jamba["profile_step"], (k,), 1)
           for k in scan_launches}}, report["selective_scan_bwd"]["ptxas"])
    jamba["selective_scan_fwd_in_step"] = per_call_ms(
        jamba["profile_step"], ("selective_scan_kernel",), 2)
    del scan_in
    free()
    attn = {"shape": {"B": TRAIN_BATCH, "S": TRAIN_SEQ,
                      "Hq": jcfg.n_heads, "Hkv": jcfg.n_kv_heads,
                      "d": jcfg.hd, "dtype": jcfg.act_dtype},
            "forward_tc_in_step": per_call_ms(jamba["profile_step"],
                                              ("flash_tc",), 2),
            "backward_in_step": {
                k: per_call_ms(jamba["profile_step"], (f"flash_bwd_{k}",), 1)
                for k in BWD_KERNELS},
            "launches": {"flash_attn": jamba["launches"]["flash_attn"],
                         "flash_attn_bwd":
                             jamba["launches"]["flash_attn_bwd"]}}

    checks = {arch: train_mixers_grad_check(arch, dev)
              for arch in (TM_RWKV, TM_JAMBA)}
    free()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mixers_")
    try:
        cli = train_mixers_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    wkv_row["launches_by_path"] = {
        "train-mixers-rwkv": wkv_row["launches"],
        "train-mixers-smoke": checks[TM_RWKV]["launches"]["wkv6_bwd"],
        "train-mixers-cli": cli["launches"]["wkv6_bwd"]}
    scan_row["launches_by_path"] = {
        "train-mixers-jamba": scan_row["launches"],
        "train-mixers-smoke": checks[TM_JAMBA]["launches"][
            "selective_scan_bwd"]}
    out = {"phase": "train-mixers", "rwkv": rwkv, "jamba": jamba,
           "attention_d128": attn, "f32_checks": checks, "cli": cli,
           "quoted_not_measured": {
               "first_design": BWD_FIRST_DESIGN,
               "from": "PERF.md section 6 rows 10-11, an earlier "
                       "chip_smoke run; not measured in this run"},
           "seconds": time.perf_counter() - t0}
    return out, [wkv_row, scan_row], attn


# ---------------------------------------------------------------------------
# the multimodal archs' training: seamless-m4t-large-v2 and internvl2-26b
# through the attention backward kernels (cross attention at Sq != Skv)
# ---------------------------------------------------------------------------

# seamless-m4t-large-v2 uncut (24 + 24 layers, 1.77 B parameters: ~21 GB of
# bf16 weights and gradients and f32 moments); internvl2-26b at full width
# cut to 8 of its 48 layers (19.3 B parameters with AdamW's f32 moments do
# not fit one card; 8 layers and the tied embedding are 3.71 B, ~44.5 GB
# at 12 bytes a parameter). bf16, remat "dots" (the encoder-decoder
# recomputes each layer whole, as the reference's jax.checkpoint), the
# launcher's batches at 4 x 2,048 tokens: seamless over 1,024 seeded frame
# embeddings (seq // 2), internvl2 after its 256 seeded patch embeddings;
# 1 warm-up and 4 measured steps at lr 3e-4 after one warm-up step
TMM_INTERNVL_LAYERS = 8
TMM_WARMUP, TMM_STEPS = 1, 4
TMM_OPT = {"lr": 3e-4, "warmup_steps": 1,
           "total_steps": TMM_WARMUP + TMM_STEPS}
# the f32 checks: 2 (+ 2 encoder) layers of the full width, 2 x 512 tokens
TMM_F32_LAYERS, TMM_F32_BATCH, TMM_F32_SEQ = 2, 2, 512
# the launcher at each smoke config (f32), 20 steps and a --resume; lr
# 3e-3 as the train-mixers phase's
TMM_CLI = ["--smoke", "--steps", "20", "--batch", "4", "--seq", "64",
           "--lr", "3e-3"]
# tc's mirror at the new shapes: TC_MIRROR_TOL holds f32 sums of up to
# 2,048 terms (the train layer's); the sums here run over more (dK, dV
# over G x Sq query rows: 13,824 at internvl2's layer), and their
# rounding grows with their length: the atol grows by terms / 2,048
TMM_MIRROR_TERMS = 2048
# seeded inputs at seamless's cross shape (B, H, Sq, Skv, d), where the
# bf16 chain is held to its bar
TMM_CROSS_SEEDED = (4, 16, 2048, 1024, 64)


def tmm_kind(q, k, causal: bool) -> str:
    """An attention call's kind: ``cross`` (Sq != Skv), ``encoder``
    (non-causal over its own sequence) or ``self``."""
    if q.shape[2] != k.shape[2]:
        return "cross"
    return "self" if causal else "encoder"


def tmm_model(arch: str):
    """The arch's training config: seamless uncut, internvl2 cut to
    ``TMM_INTERNVL_LAYERS`` layers."""
    cfg = configs.ARCHS[arch]
    if arch == MM_INTERNVL:
        cfg = cfg.with_(n_layers=TMM_INTERNVL_LAYERS)
    return cfg


def tmm_want(cfg) -> dict:
    """Launches a bf16 step must make: each attention call's forward twice
    (remat's recompute) on tc, its backward once (three launches) on tc."""
    calls = cfg.n_layers
    if cfg.kind == "encdec":
        calls = cfg.encoder_layers + 2 * cfg.n_layers
    return {"flash_attn": 2 * calls, "tc": 2 * calls,
            "flash_attn_bwd": 3 * calls, "bwd_tc": calls}


def tmm_run(arch: str, dev) -> tuple[dict, dict]:
    """One arch's training: ``TMM_WARMUP`` warm-up and ``TMM_STEPS``
    measured bf16 ``make_train_step`` steps on ``make_batches``' batches
    (a sync on each side of a step), every loss finite, every measured step's
    launches exactly :func:`tmm_want`'s and 0 elsewhere; the loss of the
    warm-up batch after the steps (``make_eval_step``) below its loss in
    the warm-up step; one step with the first backward call of each kind
    kept; one profiled step. Returns the run's line and the kept
    inputs."""
    cfg = tmm_model(arch)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tcfg = train_lib.TrainCfg(opt=OptCfg(**TMM_OPT))
    model, opt = train_lib.init_train_state(SEED, cfg, tcfg, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    step_fn = train_lib.make_train_step(cfg, tcfg)
    batches = [b for _, b in train_launcher.make_batches(
        cfg, SEED, TMM_WARMUP + TMM_STEPS, TRAIN_BATCH, TRAIN_SEQ,
        device=dev)]
    want = tmm_want(cfg)
    losses, step_s, per_step = [], [], []

    def now():
        return {**counts(), **variant_counts(), **bwd_variants()}
    for i, b in enumerate(batches):
        if i == TMM_WARMUP:
            reset_counts()
        before = now()
        sync()
        t1 = time.perf_counter()
        model, opt, m = step_fn(model, opt, b)
        losses.append(float(m["loss"]))
        if i >= TMM_WARMUP:
            step_s.append(time.perf_counter() - t1)
            after = now()
            per_step.append({k: after[k] - before[k] for k in after})
    launches = counts()
    by_variant = {**variant_counts(), **bwd_variants()}
    check(all(np.isfinite(x) for x in losses),
          f"train-multimodal: {arch}: a loss is not finite: {losses}")
    bad = [p for p in per_step if any(n != want.get(k, 0)
                                      for k, n in p.items())]
    check(not bad, f"train-multimodal: {arch}: a step launched "
          f"{ {k: n for k, n in bad[0].items() if n} if bad else {} }, "
          f"not {want}")
    eval_loss = float(train_lib.make_eval_step(cfg)(model, batches[0]))
    check(eval_loss < losses[0], f"train-multimodal: {arch}: the warm-up "
          f"batch's loss did not fall over the steps ({losses[0]} -> "
          f"{eval_loss})")
    peak = torch.cuda.max_memory_allocated()
    captured = {}

    def capture(orig):
        def run(q, k, v, o, lse, do, causal, window, variant=None):
            captured.setdefault(tmm_kind(q, k, causal), (
                *(t.detach() for t in (q, k, v, o, lse, do)),
                {"causal": causal, "window": window}))
            return orig(q, k, v, o, lse, do, causal, window, variant)
        return run
    with patched(fab, "_backward", capture(fab._backward)):
        step_fn(model, opt, batches[-1])
    sync()
    prof = device_ops(lambda: step_fn(model, opt, batches[-1]), top=16,
                      keep=("flash_",))
    params = transformer.param_count(model)
    del model, opt, batches
    free()
    ms = np.array(step_s) * 1e3
    p50 = float(np.percentile(ms, 50))
    calls = want["bwd_tc"]
    flash = {"forward_tc": per_call_ms(prof, ("flash_tc",), 2 * calls),
             **{k: per_call_ms(prof, (f"flash_bwd_{k}",), calls)
                for k in BWD_KERNELS}}
    full = configs.ARCHS[arch]
    out = {"arch": arch, "dtype": cfg.act_dtype, "remat": cfg.remat,
           "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "params": params, "init_s": init_s, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "prefix_len": (TRAIN_SEQ // 2
                                            if cfg.kind == "encdec"
                                            else cfg.frontend_seq),
           "warmup": TMM_WARMUP, "steps": TMM_STEPS, "opt": TMM_OPT,
           "losses": losses, "eval_loss_of_warmup_batch": eval_loss,
           "step_ms": {"p50": p50, "p99": float(np.percentile(ms, 99)),
                       "mean": float(ms.mean()), "each": ms.tolist()},
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(ms.mean()) * 1e3,
           "peak_allocated_bytes": peak, "launches": launches,
           "launches_by_variant": by_variant, "launches_per_step": want,
           "device_ms_of_profiled_step": prof["kernel_ms"],
           "device_busy_share_of_p50": prof["kernel_ms"] / p50,
           "flash_in_step": flash, "profile_step": prof,
           "backward_calls_kept": sorted(captured)}
    if cfg.n_layers != full.n_layers:
        out["reduced"] = {"layers": f"{cfg.n_layers} of {full.n_layers} "
                                    f"(AdamW's f32 moments of 19.3 B "
                                    f"parameters do not fit one card)"}
    return out, captured


def tmm_grad_check(arch: str, dev) -> dict:
    """2 (+ 2 encoder) layers of the arch's full width at f32 with its
    batch's prefix: the loss and gradients through the kernels (simt
    forward and backward, cross attention at Sq = 2 Skv for seamless)
    against the same model with ``attention_plain`` under autograd in the
    attention's place, on the same weights and batch: the loss to 1e-5,
    each leaf to ``TRAIN_CHECK_REL`` of its largest (the train phase's
    bar)."""
    cfg = tmm_model(arch).with_(n_layers=TMM_F32_LAYERS,
                                act_dtype="float32")
    if cfg.kind == "encdec":
        cfg = cfg.with_(encoder_layers=TMM_F32_LAYERS)
    build_model = encdec.EncDecLM if cfg.kind == "encdec" else \
        transformer.DecoderLM
    model = build_model(cfg, device=dev, train=True, generator=torch.Generator(
        device=dev).manual_seed(SEED + 73))
    _, batch = next(train_launcher.make_batches(
        cfg, SEED + 73, 1, TMM_F32_BATCH, TMM_F32_SEQ, device=dev))
    loss_fn = train_lib._model_loss(cfg)
    params = list(model.parameters())

    def grads():
        loss = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    reset_counts()
    loss_k, g_k = grads()
    launched = (fak.launch_count("simt"), fab.launch_count(),
                fab.launch_count("simt"))

    def plain(q, k, v, *, causal, window):
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=0)

    with patched(fab, "flash_attention_train", plain):
        loss_p, g_p = grads()
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(g_k, g_p))
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    calls = tmm_want(cfg)["bwd_tc"]
    check(launched == (2 * calls, 3 * calls, calls),
          f"train-multimodal: {arch}'s gradient check launched (simt, "
          f"backward, backward simt) {launched}")
    check(worst <= TRAIN_CHECK_REL and loss_rel <= 1e-5,
          f"train-multimodal: {arch}'s kernel-route gradients differ from "
          f"attention_plain's by {worst:.3g} of a leaf's largest (bar "
          f"{TRAIN_CHECK_REL}), the loss by {loss_rel:.3g}")
    del model, params, g_k, g_p
    free()
    return {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "batch": TMM_F32_BATCH, "seq": TMM_F32_SEQ, "dtype": "float32",
            "loss": float(loss_k), "loss_rel_err": loss_rel,
            "grad_worst_share_of_leaf_max": worst, "bar": TRAIN_CHECK_REL,
            "launches_simt_bwd_bwdsimt": launched}


def tmm_cli(arch: str, tmp: str) -> dict:
    """``python -m repro_torch.launch.train --arch <arch>`` with
    ``TMM_CLI`` (the smoke config at f32 on the card: simt forward and
    backward, seamless's cross attention at Sq = 2 Skv), whose own check
    asserts the loss fell; then ``--resume`` from its newest checkpoint
    (after step 10, holding 11 steps) must repeat the first run's losses
    of steps 11-19 bit for bit."""
    args = ["--arch", arch, *TMM_CLI, "--ckpt-dir", tmp]
    reset_counts()
    t0 = time.perf_counter()
    first = train_launcher.main(args)
    first_s = time.perf_counter() - t0
    launches = counts()
    by_variant = {**variant_counts(), **bwd_variants()}
    second = train_launcher.main(args + ["--resume"])
    resumed = len(first) - len(second)
    check(len(first) == 20 and resumed == 11,
          f"train-multimodal cli: {arch}: {len(first)} steps, resumed at "
          f"{resumed}")
    check(second == first[resumed:], f"train-multimodal cli: {arch}: the "
          f"resumed losses {second} are not the first run's "
          f"{first[resumed:]}")
    calls = tmm_want(configs.smoke(arch))["bwd_tc"]
    check(by_variant["simt"] == 2 * calls * 20
          and by_variant["bwd_simt"] == calls * 20
          and launches["flash_attn_bwd"] == 3 * calls * 20,
          f"train-multimodal cli: {arch}: launches {launches}, variants "
          f"{by_variant}")
    return {"args": args, "losses": first, "resumed_losses": second,
            "resumed_at": resumed, "dtype": "float32", "seconds": first_s,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_by_variant": by_variant,
            "ckpt_steps": sorted(os.listdir(tmp))}


def tmm_attn_case(captured: tuple, name: str, o_shift: bool,
                  device_in_step: dict) -> dict:
    """The backward kernels on a call's inputs through ``bwd_at`` (the
    chain's bar grown by the forward's o shift where ``o_shift``), the
    mirror's atol grown with the length of its sums."""
    q, k, v, o, lse, do, kw = captured
    G = q.shape[1] // k.shape[1]
    terms = max(G * q.shape[2], k.shape[2])
    atol = TC_MIRROR_TOL * max(1.0, terms / TMM_MIRROR_TERMS)
    case = bwd_at(q, k, v, o, lse, do, kw, mirror_atol=atol, o_shift=o_shift)
    case["mirror"]["sum_terms"] = terms
    case["device_in_step"] = device_in_step

    def chain(c):
        share = c["chain"]["tolerance_share"]
        if "o_shift" not in c["chain"]:
            return f"{share:.3g}"
        return (f"{share:.3g} (with the o shift "
                f"{c['chain']['o_shift']['tolerance_share']:.3g})")
    check(case["all_close"] and case["variant"] == "tc",
          f"flash_attn_bwd: at {name} the kernels took {case['variant']} or "
          f"differ from the plain version (shares: tc "
          f"{case['tolerance_share']:.3g}, simt "
          f"{case['simt']['tolerance_share']:.3g}, f32 "
          f"{case['f32_copy']['tolerance_share']:.3g}, mirror "
          f"{case['mirror']['tolerance_share']:.3g}; forward o and lse "
          f"{case['forward']['tolerance_share']:.3g} / f32 "
          f"{case['f32_copy']['forward']['tolerance_share']:.3g}; chain "
          f"{chain(case)} / f32 {chain(case['f32_copy'])})")
    return case


def train_multimodal_phase(dev) -> tuple[dict, dict]:
    """(a) seamless-m4t-large-v2 uncut and (b) internvl2-26b at full width
    (8 layers) trained in bf16 through the attention backward kernels;
    the kernels at the kept calls' shapes (seamless's cross attention at
    Sq 2,048 over Skv 1,024 and its encoder's, internvl2's layer) against
    their plain version, mirror and library; (c) the f32 gradient checks
    and the launcher at each smoke config with its resume. Returns the
    phase's line and the row-7 cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seamless, kept = tmm_run(MM_SEAMLESS, dev)
    check(set(kept) == {"cross", "encoder", "self"},
          f"train-multimodal: seamless kept backward calls {sorted(kept)}")
    # the path's own inputs: the chain's bar grows by the move that the
    # forward's o makes through D (bwd_compare's o_shift): the random
    # weights' deep layers make keys and values of a near rank-one
    # sequence (the encoder's memory most of all), where dS cancels
    # almost wholly. Seeded inputs of the cross shape hold the chain to
    # its bar alone (cross_seeded)
    cases = {"at_seamless_cross": tmm_attn_case(
        kept.pop("cross"), "at_seamless_cross", True,
        seamless["flash_in_step"]),
             "at_seamless_encoder": tmm_attn_case(
        kept.pop("encoder"), "at_seamless_encoder", True,
        seamless["flash_in_step"])}
    kept.clear()
    free()
    g = torch.Generator(device=dev).manual_seed(SEED + 79)
    B, H, Sq, Skv, d = TMM_CROSS_SEEDED
    q, do = (torch.randn((B, H, Sq, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, H, Skv, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    o, lse = fak.flash_attention_lse(q, k, v, causal=False)
    cases["cross_seeded"] = tmm_attn_case(
        (q, k, v, o, lse, do, {"causal": False, "window": None}),
        "cross_seeded", False, {})
    del q, k, v, o, lse, do
    free()
    internvl, kept = tmm_run(MM_INTERNVL, dev)
    check(set(kept) == {"self"},
          f"train-multimodal: internvl2 kept backward calls {sorted(kept)}")
    cases["at_internvl2_layer"] = tmm_attn_case(
        kept.pop("self"), "at_internvl2_layer", True,
        internvl["flash_in_step"])
    free()
    checks = {arch: tmm_grad_check(arch, dev)
              for arch in (MM_SEAMLESS, MM_INTERNVL)}
    cli = {}
    for arch in (MM_SEAMLESS, MM_INTERNVL):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mm_")
        try:
            cli[arch] = tmm_cli(arch, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    free()
    out = {"phase": "train-multimodal", "seamless": seamless,
           "internvl2": internvl, "f32_checks": checks, "cli": cli,
           "seconds": time.perf_counter() - t0}
    return out, cases


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script drives the port on an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    stale = [k for k in ("flash_attn", "flash_attn_bwd", "wkv6",
                         "selective_scan", "wkv6_bwd", "selective_scan_bwd")
             if k not in report]
    if stale:  # libraries left by an earlier run: their ptxas reports
        report.update(build.build(stale, force=True))
    flash_build = flash_attn_build(report["flash_attn"]["ptxas"])
    bwd_build = flash_attn_build(
        report["flash_attn_bwd"]["ptxas"], "flash_attn_bwd",
        ("flash_bwd_dkdv_wgmma_", "flash_bwd_dq_wgmma_"), op="hgmma")
    emit({"phase": "build", "seconds": build_s,
          "kernels": {k: v["seconds"] for k, v in report.items()},
          "flash_attn": flash_build, "flash_attn_bwd": bwd_build,
          **{k: ptxas_usage(report[k]["ptxas"], rec_label)
             for k in ("wkv6", "selective_scan", "wkv6_bwd",
                       "selective_scan_bwd")}})

    seconds = {"env+build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    lm, flash_row = lm_phase(dev)
    emit(lm)
    seconds["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, bwd_row = train_phase(dev)
    bwd_row["build"] = {
        "seconds": report["flash_attn_bwd"]["seconds"],
        "all_sources_seconds": build_s,
        "tc_kernels": {k: v for k, v in bwd_build.items()
                       if "wgmma" in k}}
    emit(train)
    seconds["train"] = time.perf_counter() - t0
    flash_row["launches_by_path"].update(train["flash_attn_launches"])
    t0 = time.perf_counter()
    mixers, mixer_rows, phi_attn = mixers_phase(dev)
    emit(mixers)
    flash_row.update(phi_attn)
    flash_row["launches_by_path"]["mixers-phi"] = \
        mixers["phi"]["launches"]["flash_attn"]
    flash_row["launches_by_variant"]["mixers-phi"] = \
        mixers["phi"]["launches_by_variant"]
    free()
    seconds["mixers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multimodal, mm_cases = multimodal_phase(dev)
    emit(multimodal)
    flash_row.update(mm_cases)
    for part in ("seamless", "internvl2"):
        flash_row["launches_by_path"][f"multimodal-{part}"] = \
            multimodal[part]["launches"]["flash_attn"]
        flash_row["launches_by_variant"][f"multimodal-{part}"] = \
            multimodal[part]["launches_by_variant"]
    free()
    seconds["multimodal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_mixers, tm_rows, tm_attn = train_mixers_phase(dev, report)
    emit(train_mixers)
    flash_row["launches_by_path"]["train-mixers-jamba"] = \
        tm_attn["launches"]["flash_attn"]
    flash_row["train_d128"] = {"shape": tm_attn["shape"],
                               "in_step": tm_attn["forward_tc_in_step"]}
    bwd_row["launches_by_path"]["train-mixers-jamba"] = \
        tm_attn["launches"]["flash_attn_bwd"]
    bwd_row["train_d128"] = {"shape": tm_attn["shape"],
                             "in_step": tm_attn["backward_in_step"]}
    free()
    seconds["train-mixers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_mm, tmm_cases = train_multimodal_phase(dev)
    emit(train_mm)
    # row 7's new cases now as well as in the kernels' line: a failure in
    # a later phase would leave them unprinted
    emit({"phase": "train-multimodal-attention", **tmm_cases})
    bwd_row.update(tmm_cases)
    for part in ("seamless", "internvl2"):
        run = train_mm[part]
        flash_row["launches_by_path"][f"train-multimodal-{part}"] = \
            run["launches"]["flash_attn"]
        bwd_row["launches_by_path"][f"train-multimodal-{part}"] = \
            run["launches"]["flash_attn_bwd"]
        bwd_row["launches_by_variant"][f"train-multimodal-{part}"] = {
            k: run["launches_by_variant"][k] for k in ("bwd_tc", "bwd_simt")}
    bwd_row["launches_by_path"]["train-multimodal-f32"] = sum(
        c["launches_simt_bwd_bwdsimt"][1]
        for c in train_mm["f32_checks"].values())
    bwd_row["launches_by_path"]["train-multimodal-cli"] = sum(
        c["launches"]["flash_attn_bwd"] for c in train_mm["cli"].values())
    free()
    seconds["train-multimodal"] = time.perf_counter() - t0
    t0 = time.perf_counter()

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
            flash_row, bwd_row, *mixer_rows, *tm_rows]
    del main_run, porth_run, kd_run, zd_run, flat_run, spacz_pts, spacz
    free()
    seconds["index+kernel rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    driver_launches = driver_phase(dev)
    free()
    seconds["driver"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_launches = dist_phase(dev)
    free()
    seconds["dist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fig_launches = figures_phase(dev)
    seconds["figures"] = time.perf_counter() - t0
    for r in rows:
        for kind, launches in driver_launches.items():
            if r["name"] in launches:
                r.setdefault("launches_by_path", {})[f"driver-{kind}"] = \
                    launches[r["name"]]
        for path, launches in dist_launches.items():
            if r["name"] in launches:
                r.setdefault("launches_by_path", {})[path] = \
                    launches[r["name"]]
        if r["name"] in fig_launches:
            r.setdefault("launches_by_path", {})["figures"] = \
                fig_launches[r["name"]]
        emit({"phase": "kernel", **r})
    seconds["total"] = time.perf_counter() - t_start
    emit({"phase": "seconds", **seconds})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
