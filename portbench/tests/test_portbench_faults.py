"""A run with the timed path broken underneath comes out not correct, once
for each fault a serving cell can have: an answer altered where it is
produced, and half of the batch left out (its rows served copies of the
other half's). The harness's look for a card is skipped: the program's
CPU path runs the whole of a run at a test's size. An unbroken run comes
out correct, and so the fp8 control does not (its readings at the cells'
own size are in ``PERF.md``)."""

import pytest
import torch

FAULTS = ("answer_altered", "half_batch")


def half_batch(fn, rows_of):
    """``fn`` computing only the first half of its batch; the other half's
    rows get copies of the first half's results."""

    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        fixed = []
        for t in outs:
            n = rows_of(t)
            t = t.clone()
            t[n - n // 2:] = t[:n // 2]
            fixed.append(t)
        return tuple(fixed) if isinstance(out, tuple) else fixed[0]

    return broken


def test_unbroken_runs_are_correct(run_small):
    for cell in ("sfx_b8", "resnet_b32"):
        result, checks, _ = run_small(cell)
        assert result["correct"], checks


@pytest.mark.parametrize("fault", FAULTS)
def test_sfx_fault_is_caught(run_small, monkeypatch, fault):
    from psana_ray_tpu_torch import sfx  # the names the program's device step calls

    if fault == "answer_altered":
        find = sfx.find_peaks

        def moved(*args, **kwargs):  # each batch's first peak one pixel to the right
            yx, score, n = find(*args, **kwargs)
            row = int(torch.nonzero(n)[0])
            yx = yx.clone()
            yx[row, 0, 1] += 1
            return yx, score, n

        monkeypatch.setattr(sfx, "find_peaks", moved)
    else:
        monkeypatch.setattr(sfx, "peaknet_tpu_fused_infer",
                            half_batch(sfx.peaknet_tpu_fused_infer, lambda t: t.shape[0]))
    result, checks, _ = run_small("sfx_b8")
    assert not result["correct"], checks
    name = "peak_mismatch" if fault == "answer_altered" else "logits_rel_err"
    assert checks[name]["value"] > checks[name]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_resnet_fault_is_caught(run_small, monkeypatch, fault):
    from psana_ray_tpu_torch.models import fused_resnet

    infer = fused_resnet.resnet_fused_infer
    if fault == "answer_altered":
        def altered(*args, **kwargs):  # each batch's first logit moved by a tenth of the scale
            logits, feat = infer(*args, **kwargs)
            logits = logits.clone()
            logits[0, 0] += 0.1 * float(logits.abs().max())
            return logits, feat

        monkeypatch.setattr(fused_resnet, "resnet_fused_infer", altered)
    else:
        monkeypatch.setattr(fused_resnet, "resnet_fused_infer",
                            half_batch(infer, lambda t: t.shape[0]))
    result, checks, _ = run_small("resnet_b32")
    assert not result["correct"], checks
    assert checks["logits_rel_err"]["value"] > checks["logits_rel_err"]["limit"]


@pytest.mark.parametrize("cell", ["sfx_b8", "resnet_b32"])
def test_fp8_control_is_not_correct(run_small, cell):
    result, checks, controls = run_small(cell, controls=("fp8",))
    assert result["correct"], checks
    fp8 = controls["fp8"]
    assert any(c["value"] > c["limit"] for c in fp8.values()), fp8
    assert fp8["calib_err"]["value"] > fp8["calib_err"]["limit"]
    assert fp8["logits_rel_err"]["value"] > fp8["logits_rel_err"]["limit"]


def test_sfx_step_that_skips_the_kept_names_is_not_compared(run_small, monkeypatch):
    """A program whose device step no longer calls the names the harness
    wraps keeps no batch: nothing is compared and the run is not correct."""
    from psana_ray_tpu_torch import sfx
    from psana_ray_tpu_torch.models.fused_unet import peaknet_tpu_fused_infer
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate

    def device_step(self, frames):
        ped, gain, mask = self._calib
        x = fused_calibrate(frames, ped, gain, mask, threshold=self.cfg.calib_threshold,
                            out_dtype=torch.bfloat16)
        logits = peaknet_tpu_fused_infer(self.params, sfx.panels_to_nhwc(x, mode="batch"))
        return sfx.find_peaks(logits, max_peaks=self.cfg.max_peaks,
                              threshold=self.cfg.peak_threshold,
                              min_distance=self.cfg.min_distance)

    monkeypatch.setattr(sfx.SfxPipeline, "device_step", torch.no_grad()(device_step))
    result, checks, _ = run_small("sfx_b8")
    assert not result["correct"]
    assert checks["batches_compared"]["value"] < checks["batches_compared"]["limit"]
