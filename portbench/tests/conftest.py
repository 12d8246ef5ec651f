"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the repo's root. Tests marked ``gpu`` run the cells on a CUDA card and
skip without one. Nothing here imports JAX."""

import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SEED = 2**31 + 4242  # more than 32 signed bits hold


def small(cell: str, **traffic) -> dict:
    """Overrides that shrink a cell to a CPU test's size: batch 2, a pool
    of 4 frames of 2 panels, one batch compared; PeakNet-TPU at features (8, 16, 32, 64) on
    64 x 64 panels with the init's own head (so that its logits hold
    peaks); ResNet-50 at its widths on 128 x 128 panels (smaller ones pool
    too few pixels to hold the cell's limits)."""
    hw = 64 if cell == "sfx_b8" else 128
    over = {"config": {"detector": {"panels": 2, "height": hw, "width": hw}},
            "traffic": {"batch": 2, "pool_frames": 4, "ring_slots": 4, "warmup_batches": 2,
                        "sample_batches": 1, **traffic}}
    if cell == "sfx_b8":
        over["config"].update(features=[8, 16, 32, 64],
                              head_init={"kernel_std_scale": 1.0, "bias": 0.0})
    else:
        over["config"].update(input_hw=[hw, hw], in_channels=2)
    return over


@pytest.fixture(scope="session")
def bench():
    from portbench import core

    return core.load_json(REPO / "BENCHMARK.json")


@pytest.fixture
def run_small(bench):
    """``run_small(cell, seconds=2.0, controls=())`` -> run_cell's triple,
    on the CPU at a test's size."""
    from portbench import core

    def go(cell, seconds=2.0, controls=(), **traffic):
        return core.run_cell(bench, cell, SEED, seconds, False, "cpu", time.monotonic(),
                             small(cell, **traffic), controls)

    return go


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
