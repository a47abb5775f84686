"""The port's examples (``examples/torch_*.py``) run to their own checks
at smoke size on the CPU, each in a subprocess: the quickstart's
linearizability check, the paged serving's identical tokens under a live
Move, and the training example's falling loss with and without
``--mesh host`` (equal losses both ways)."""
import os
import re
import subprocess
import sys

import pytest

from torch_spmd import ROOT

RUNS = {
    "quickstart": ["torch_quickstart.py", "--smoke"],
    "serve_paged": ["torch_serve_paged.py"],
    "train_lm": ["torch_train_lm.py", "--smoke", "--steps", "20"],
    "train_lm_mesh": ["torch_train_lm.py", "--smoke", "--steps", "20",
                      "--mesh", "host"],
}


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / args[0]),
                        *args[1:], "--device", "cpu"] + (
        ["--ckpt-dir", str(tmp_path)] if "train" in args[0] else []),
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "OK" in r.stdout.splitlines()[-1]
    return r.stdout


@pytest.mark.parametrize("name", ["quickstart", "serve_paged"])
def test_example_runs(name, tmp_path):
    _run(RUNS[name], tmp_path)


def test_train_example_with_and_without_the_mesh(tmp_path):
    losses = []
    for n in ("train_lm", "train_lm_mesh"):
        (tmp_path / n).mkdir()
        losses.append(re.findall(r"loss (\S+) -> (\S+)  OK",
                                 _run(RUNS[n], tmp_path / n)))
    assert losses[0] and losses[0] == losses[1]
