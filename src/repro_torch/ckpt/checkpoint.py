"""Checkpointing with atomic saves and placement on restore, the
counterpart of ``repro/ckpt/checkpoint.py``, in the reference's on-disk
layout: ``<dir>/step_<k:08d>/manifest.json`` and one ``.npy`` per leaf,
keyed by the leaf's path in the tree (``params/groups/pos0/mixer/wq``;
the file name has ``__`` for ``/``). A checkpoint that either package
writes restores in the other.

Resuming across packages: a launcher starts at the newest checkpoint's
label. The reference's fault-tolerant loop labels the checkpoint taken
after step ``s`` with ``s``, the port's with ``s + 1``
(``repro_torch.ft.runtime``). So from a checkpoint that the reference
wrote, either launcher starts at ``s`` and runs batch ``s`` a second
time, as the reference's own resume does; from one that the port wrote,
either starts at ``s + 1`` and goes on where the run stopped
(``tests/test_torch_ckpt_ft.py``, the launchers' resume test).

A tree is nested dicts of tensors or numpy arrays;
:func:`repro_torch.train.step.state_tree` gives the training state as
the reference's ``{"params": ..., "opt": ...}`` tree. bf16 leaves are
written as the reference writes them (2-byte records, manifest dtype
``bfloat16``) and read back as bf16.

:func:`async_save` copies every leaf to pinned host memory on the
current stream and records an event: the only work on the caller's
thread. A daemon thread waits on the event and writes the files, so
training goes on while the bytes reach the disk, and the next step's
in-place updates, queued behind the copies, cannot reach them.
:func:`wait_pending` joins the writers (call before exit or before
reading the checkpoint back).

Fault-tolerance contract (``tests/test_torch_ckpt_ft.py``):
  * a save is atomic: files land in ``step_<k>.tmp``, renamed on
    completion, so a job killed mid-save never corrupts the newest
    checkpoint;
  * ``restore(step=None)`` picks the newest *complete* checkpoint;
  * the data pipeline is ``(seed, step)``-deterministic, so restore and
    replay reproduce the batch stream (no data-loader state on disk).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

_PENDING: list[threading.Thread] = []
_BF16 = np.dtype("V2")


def _flatten(tree, prefix=()) -> dict:
    items = {}
    for key, leaf in tree.items():
        path = prefix + (str(key),)
        if isinstance(leaf, dict):
            items.update(_flatten(leaf, path))
        else:
            items["/".join(path)] = leaf
    return items


def _unflatten(template, leaves: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    return leaves["/".join(prefix)]


def _numpy(leaf) -> tuple:
    """(array, manifest dtype) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16), "bfloat16"
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(tree, directory: str, step: int):
    """Synchronous atomic save."""
    _write({k: _numpy(v) for k, v in _flatten(tree).items()}, directory,
           step)


def async_save(tree, directory: str, step: int):
    """Copy to the host now (pinned memory, on the stream); write on a
    background thread."""
    host, event = {}, None
    for k, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            buf.copy_(leaf.detach(), non_blocking=True)
            host[k] = buf
            if event is None:
                event = torch.cuda.Event()
        elif isinstance(leaf, torch.Tensor):
            host[k] = leaf.detach().clone()  # the state changes in place
        else:
            host[k] = np.array(leaf)
    if event is not None:
        event.record()

    def write():
        if event is not None:
            event.synchronize()
        _write({k: _numpy(v) for k, v in host.items()}, directory, step)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    while _PENDING:
        _PENDING.pop().join()


def _write(host: dict, directory: str, step: int):
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for k, (v, dtype) in host.items():
        fname = k.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), v)
        manifest[k] = {"file": fname, "shape": list(v.shape),
                       "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def load_manifest(directory: str, step: int | None = None):
    """Newest complete checkpoint (or a specific step)."""
    if step is None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(directory, d, "manifest.json")))
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
        step = steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def _tensor(arr, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(template, directory: str, step: int | None = None,
            devices=None):
    """Restore into the structure of ``template`` (a tree of tensors or
    arrays; only its leaves' shapes are read). Each leaf keeps the file's
    dtype and lands on ``devices``' matching leaf (a tree of torch
    devices: placement on the job's current devices), else on the
    template leaf's device (the CPU for a numpy leaf). Returns ``(tree,
    step)``."""
    path, manifest = load_manifest(directory, step)
    items = _flatten(template)
    placed = _flatten(devices) if devices is not None else {}
    leaves = {}
    for k, tmpl in items.items():
        meta = manifest["leaves"][k]
        arr = np.load(os.path.join(path, meta["file"]))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{k}: checkpoint {arr.shape} vs template "
                             f"{tuple(tmpl.shape)}")
        dev = placed.get(k, getattr(tmpl, "device", "cpu"))
        leaves[k] = _tensor(arr, meta["dtype"]).to(dev)
    return _unflatten(template, leaves), manifest["step"]
