"""The port's peak extraction, peak metrics and planted truth against the JAX package's.

``find_peaks`` must agree exactly: same centres, same scores, same order,
same counts. The sigmoid is the one step whose float32 result may differ
by one ulp between XLA and PyTorch on the CPU (each has its own ``exp``),
so the exact tests draw their logits from a grid of values on which the
two sigmoids agree bit for bit (checked in the test), with many ties and
saturated scores of exactly 1.0; on continuous logits the centres and
counts are exact and the scores within one float32 ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import psana_ray_tpu.models.peaks as jp  # noqa: E402
from psana_ray_tpu.sources import SyntheticSource as JaxSource  # noqa: E402
from psana_ray_tpu_torch.models import peaks as tp  # noqa: E402
from psana_ray_tpu_torch.sources import SyntheticSource  # noqa: E402


def _jax(logits, **kw):
    return [np.asarray(a) for a in jp.find_peaks(jnp.asarray(logits), **kw)]


def _port(logits, **kw):
    return [a.numpy() for a in tp.find_peaks(torch.from_numpy(logits), **kw)]


def _grid_logits(rng, shape):
    """Logits from a coarse grid on which XLA's and PyTorch's sigmoids
    agree exactly, plus saturating values (sigmoid == 1.0 in f32)."""
    grid = np.concatenate([np.arange(-4.0, 4.01, 0.5), [20.0, 30.0]]).astype(np.float32)
    same = np.asarray(jax.nn.sigmoid(jnp.asarray(grid))) == torch.sigmoid(torch.from_numpy(grid)).numpy()
    grid = grid[same]
    assert len(grid) >= 10 and 20.0 in grid
    return rng.choice(grid, size=shape).astype(np.float32)


@pytest.mark.parametrize("min_distance", [1, 2])
@pytest.mark.parametrize("max_peaks", [8, 256])
def test_find_peaks_exact_with_ties_and_saturation(rng, min_distance, max_peaks):
    logits = _grid_logits(rng, (3, 24, 40, 1))
    logits[0, 5:8, 5:8, 0] = 30.0  # a saturated plateau: ties at exactly 1.0
    logits[1] = -4.0  # a row with no peak
    logits[2, ::3, ::3, 0] = 2.0  # a lattice of equal scores
    kw = dict(max_peaks=max_peaks, threshold=0.5, min_distance=min_distance)
    want, got = _jax(logits, **kw), _port(logits, **kw)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    _, score, n = got
    assert n[1] == 0 and n[0] > 0
    assert (score[0] == 1.0).any()


def test_find_peaks_continuous_logits(rng):
    logits = (3.0 * rng.standard_normal((4, 32, 48))).astype(np.float32)
    kw = dict(max_peaks=64, threshold=0.3, min_distance=2)
    (wyx, ws, wn), (gyx, gs, gn) = _jax(logits, **kw), _port(logits, **kw)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gyx, wyx)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1.2e-7)  # one f32 ulp below 1.0


def test_peak_metrics_and_truth_split_match(rng):
    pred_yx = rng.integers(0, 32, size=(6, 10, 2)).astype(np.int32)
    pred_n = rng.integers(0, 11, size=6).astype(np.int32)
    event_truth = np.concatenate([
        rng.integers(0, 6, size=(30, 1)),
        rng.uniform(0, 32, size=(30, 2)),
        rng.uniform(20, 500, size=(30, 1)),
    ], axis=1).astype(np.float32)
    truth = tp.split_truth_by_panel(event_truth, 6)
    for a, b in zip(truth, jp.split_truth_by_panel(event_truth, 6)):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"tolerance": 5.0, "min_amplitude": 100.0}):
        assert tp.peak_metrics(pred_yx, pred_n, truth, **kw) == jp.peak_metrics(
            pred_yx, pred_n, truth, **kw)


@pytest.mark.parametrize("detector,mode", [("smoke_a", "calib"), ("smoke_a", "raw"),
                                           ("epix10k2M", "raw")])
def test_event_with_truth_matches(detector, mode):
    ours = SyntheticSource(run=2, num_events=4, detector_name=detector, seed=5)
    ref = JaxSource(run=2, num_events=4, detector_name=detector, seed=5)
    for idx in (0, 3):
        got, want = ours.event_with_truth(idx, mode), ref.event_with_truth(idx, mode)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(ours.event(idx, mode)[0], want[0])
