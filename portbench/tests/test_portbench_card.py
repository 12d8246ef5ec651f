"""The cells at their own size on a CUDA card: each run comes out correct,
the fp8 control does not, and ``run.py`` in a directory that holds only
the benchmark refuses. Run on the card with
``python -m pytest -m gpu portbench/tests``; skipped without one."""

import shutil
import subprocess
import sys
import time

import pytest

from portbench import core

from conftest import REPO, SEED


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sfx_b8", "resnet_b32"])
def test_cell_is_correct_and_its_fp8_control_is_not(card, bench, cell):
    result, checks, controls = core.run_cell(bench, cell, SEED, 2.0, False, "cuda",
                                             time.monotonic(), controls=("fp8",))
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    fp8 = controls["fp8"]
    assert any(c["value"] > c["limit"] for c in fp8.values()), fp8


@pytest.mark.gpu
def test_run_refuses_without_the_program(card, tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sfx_b8", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
