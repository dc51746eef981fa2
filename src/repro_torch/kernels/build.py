"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library, then loaded with ``ctypes`` -- no PyTorch headers,
so a build takes seconds. Libraries are built at first use (or all at
once, in parallel, by :func:`build`) into ``build/repro_torch_kernels/``
at the repository root; the file name carries a hash of the source, so
an edited kernel is never served from a stale library.

Nothing here runs at import time: the CPU-only test host has no
``nvcc``, and only a launch on a CUDA tensor reaches :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

SOURCES = {"knn_flat": "knn_flat.cu", "knn_frontier": "knn_frontier.cu",
           "morton": "morton.cu", "row_bbox": "row_bbox.cu",
           "sieve": "sieve.cu", "flash_attn": "flash_attn.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "selective_scan": "selective_scan.cu", "wkv6": "wkv6.cu",
           "selective_scan_bwd": "selective_scan_bwd.cu",
           "wkv6_bwd": "wkv6_bwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def lib_path(name: str) -> pathlib.Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build(names=None, force: bool = False) -> dict:
    """Compile every named kernel (default: all) whose library is
    missing (every named one with ``force``), one ``nvcc`` per source,
    all started together. Returns
    ``{name: {"seconds": s, "ptxas": text}}`` for the sources built;
    raises ``RuntimeError`` with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": log.strip()}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
