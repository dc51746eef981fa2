"""The port's launchers and LM examples run end to end on the CPU when
asked (``--device cpu``, smoke configs) and exit 0: the training
launcher (its own loss-decrease check at 20 steps, checkpoints after
steps 0 and 10), the serving launcher's index and LM services, both
launchers on the smoke rwkv6 and jamba (RWKV6, Mamba, attention and MoE
through the plain versions; 3 training steps, under the loss check), the
training launcher on the smoke seamless-m4t (encoder-decoder) and
internvl2 (vision prefix) at the qwen case's size (its loss check and
checkpoints; in process, ``--resume`` repeating the uninterrupted run's
losses bit for bit), and
``examples/port/{train_lm,serve_lm}.py`` (each asserts its own answers:
a second phase resumed from the first's newest checkpoint, holding 11
steps; greedy decode against the teacher-forced forward). The example's
first phase runs 14 steps, so the loss check (>= 20 steps) is the
launcher case's."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher

REPO = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "train": ["-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
              "--steps", "20", "--batch", "8", "--seq", "64",
              "--ckpt-dir", "{tmp}/ck"],
    "serve_index": ["-m", "repro_torch.launch.serve", "--device", "cpu",
                    "--n", "3000", "--batches", "2", "--queries", "16"],
    "serve_lm": ["-m", "repro_torch.launch.serve", "--service", "lm",
                 "--device", "cpu", "--batch", "2", "--prompt", "8",
                 "--new", "4"],
    "example_train_lm": ["examples/port/train_lm.py", "--device", "cpu",
                         "--steps", "24", "--batch", "8", "--seq", "32"],
    "example_serve_lm": ["examples/port/serve_lm.py", "--device", "cpu"],
    "serve_lm_rwkv6": ["-m", "repro_torch.launch.serve", "--service", "lm",
                       "--arch", "rwkv6-3b", "--device", "cpu",
                       "--batch", "2", "--prompt", "8", "--new", "4"],
    "serve_lm_jamba": ["-m", "repro_torch.launch.serve", "--service", "lm",
                       "--arch", "jamba-1.5-large-398b", "--device", "cpu",
                       "--batch", "2", "--prompt", "8", "--new", "4"],
    "serve_lm_phi_moe": ["-m", "repro_torch.launch.serve", "--service",
                         "lm", "--arch", "phi3.5-moe-42b-a6.6b", "--device",
                         "cpu", "--batch", "2", "--prompt", "8", "--new", "4"],
    "serve_lm_qwen3_moe": ["-m", "repro_torch.launch.serve", "--service",
                           "lm", "--arch", "qwen3-moe-235b-a22b", "--device",
                           "cpu", "--batch", "2", "--prompt", "8", "--new",
                           "4"],
    "train_rwkv6": ["-m", "repro_torch.launch.train", "--arch", "rwkv6-3b",
                    "--smoke", "--device", "cpu", "--steps", "3", "--batch",
                    "2", "--seq", "32"],
    "train_jamba": ["-m", "repro_torch.launch.train", "--arch",
                    "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "32"],
    "train_seamless": ["-m", "repro_torch.launch.train", "--arch",
                       "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                       "--steps", "20", "--batch", "8", "--seq", "64",
                       "--ckpt-dir", "{tmp}/ck"],
    "train_internvl2": ["-m", "repro_torch.launch.train", "--arch",
                        "internvl2-26b", "--smoke", "--device", "cpu",
                        "--steps", "20", "--batch", "8", "--seq", "64",
                        "--ckpt-dir", "{tmp}/ck"],
}
EXPECT = {"train": "qwen1.5-0.5b: 20 steps",
          "serve_index": "index service [uniform/spac-h]",
          "serve_lm": "lm serving [qwen1.5-0.5b]",
          "example_train_lm": "resumed from step 11",
          "example_serve_lm": "agreement: 100.0%",
          "serve_lm_rwkv6": "lm serving [rwkv6-3b]",
          "serve_lm_jamba": "lm serving [jamba-1.5-large-398b]",
          "serve_lm_phi_moe": "lm serving [phi3.5-moe-42b-a6.6b]",
          "serve_lm_qwen3_moe": "lm serving [qwen3-moe-235b-a22b]",
          "train_rwkv6": "rwkv6-3b: 3 steps",
          "train_jamba": "jamba-1.5-large-398b: 3 steps",
          "train_seamless": "seamless-m4t-large-v2: 20 steps",
          "train_internvl2": "internvl2-26b: 20 steps"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    args = [a.format(tmp=tmp_path) for a in CASES[name]]
    out = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert EXPECT[name] in out.stdout
    if name in ("train", "train_seamless", "train_internvl2"):
        assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001",
                                                      "step_00000011"]
    if name == "example_train_lm":
        assert "OK:" in out.stdout


@pytest.mark.parametrize("module", [train_launcher, serve_launcher])
def test_entry_points_need_a_card_unless_cpu_is_asked(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main(["--smoke", "--steps", "1"] if module is train_launcher
                     else ["--service", "lm"])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_multimodal_resume_repeats_losses(arch, tmp_path):
    """The launcher in process: 14 steps of the smoke config with
    checkpoints, then ``--resume`` from the newest (after step 10,
    holding 11 steps): its losses are the first run's of steps 11-13 bit
    for bit (the encoder-decoder's and the adapter's state and the
    moments carried by ``ckpt``)."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "14",
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    first = train_launcher.main(args)
    second = train_launcher.main(args + ["--resume"])
    assert len(first) == 14 and len(second) == 3
    assert second == first[11:]
