"""The port's examples run end to end on the CPU when asked
(``--device cpu``, small sizes) and exit 0; each asserts its own
answers (kNN routes agree, brute-force spot-check)."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": ["examples/port/quickstart.py", "--device", "cpu", "--n",
                   "3000"],
    "dynamic_index_serving": ["examples/port/dynamic_index_serving.py",
                              "--device", "cpu", "--n", "4000", "--epochs",
                              "3", "--warmup", "1", "--queries", "32"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *CASES[name]], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout or "agree" in out.stdout
