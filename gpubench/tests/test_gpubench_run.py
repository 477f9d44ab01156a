"""run.py end to end on the CPU at a tiny size: it refuses without a
card, a sound run is correct, and a run whose timed path is broken
underneath is not; the TF32 control is not correct either."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_root
from gpubench import run

CELLS = ["ctr12m.inmem", "ctr25m.job", "ctr12m.job"]
SEED = 2**31 + 77


def _run(cell, root):
    return run.run_cell(cell, SEED, 0.5, False, root=root, device="cpu",
                        log=lambda s: None)


def test_no_card_no_result():
    """No CUDA device here: exit non-zero and print no result (there is
    no CPU fallback)."""
    assert not torch.cuda.is_available()
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "ctr12m.inmem",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_only_the_benchmark_no_result(tmp_path):
    """A directory with BENCHMARK.json and gpubench/ alone: no program, no
    result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "ctr12m.inmem",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    out = _run(cell, tiny)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    assert out["failed"] == 0 and out["attempted"] > 0


def _state_unchanged(monkeypatch):
    """The x-update takes its inputs and returns them unsolved."""
    from mlease_tpu_torch.train import admm

    monkeypatch.setattr(admm._SolveLoop, "solve",
                        lambda self, z, u, rho, eps:
                        self.set_inputs(z, u, rho, eps))


def _half_the_blocks(monkeypatch):
    """Half of each solve's blocks left out: the consensus mean is taken
    over the rest (their x-updates stand in for the dropped ones)."""
    from mlease_tpu_torch.train import admm

    x = admm._SolveLoop.x

    def half(self):
        out = x(self).clone()
        B = out.shape[1]
        out[:, B - B // 2:] = out[:, :B // 2]
        return out
    monkeypatch.setattr(admm._SolveLoop, "x", half)


def _answer_altered(monkeypatch):
    """The consensus z of the first lambda off by one part in a thousand
    where it is made."""
    from mlease_tpu_torch.ops import admm_math

    z_update = admm_math.z_update_l2

    def altered(*args, **kw):
        z = z_update(*args, **kw).clone()
        z[0] *= 1.001
        return z
    monkeypatch.setattr(admm_math, "z_update_l2", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_blocks,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_blocks",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, tiny, monkeypatch):
    """Each fault a one-card cell can have (these cells exchange nothing
    between cards), planted in the program underneath the harness."""
    fault(monkeypatch)
    out = _run(cell, tiny)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny):
    """The reference in TF32 put in the program's place reads above each
    cell's limit."""
    from gpubench.control import control_gap
    for seed in (1, 2, 3):
        r = control_gap(cell, seed, root=tiny, device="cpu")
        assert r["z_gap"] > r["limit"], r


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    """On a card: the tiny cell through the card's kernels is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny_root(tmp_path)
    out = run.run_cell("ctr12m.inmem", SEED, 0.5, True, root=root,
                       device="cuda", log=lambda s: None)
    assert out["correct"] and out["metrics"]
