"""PeakNet-TPU served by the SFX program: its weights, its operations, how
a run drives it, and its comparison with the plain reference.

The entry is the program's ``SfxPipeline.run`` over the in-process ring:
pinned arenas, two batches staged ahead, one batch in flight, peaks
drained into an in-memory writer. The program's own
``SfxPipeline.device_step`` is timed; for the comparison, the calibrated
frames and the logits of each step are kept by wrapping the two names
that the program's ``sfx`` module calls them by (``fused_calibrate`` and
``peaknet_tpu_fused_infer``) for the run. A step in which either is not
called keeps nothing, and its batch cannot be compared.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, roofline, weights
from portbench.reference import calib as ref_calib
from portbench.reference import peaknet_tpu as ref_unet
from portbench.reference import peaks as ref_peaks
from portbench.reference.precision import ROUNDINGS


def leaves(cfg: Dict) -> List[weights.Leaf]:
    """The flax tree of ``PeakNetUNetTPU(norm="frozen")``, in the order and
    with the names and shapes of the port's ``init_peaknet_tpu_params``;
    the head drawn as the configuration's ``head_init`` says."""
    feats, s2d = cfg["features"], cfg["s2d"]
    out: List[weights.Leaf] = []

    def conv(path, cin, cout):
        out.append((path + ("kernel",), (3, 3, cin, cout), ("conv", 9 * cout)))

    def norm(path, ch):
        out.append((path + ("scale",), (ch,), "scale"))
        out.append((path + ("bias",), (ch,), "bias"))

    def block(name, cin, f):
        conv((name, "Conv_0"), cin, f)
        norm((name, "FrozenAffine_0"), f)
        conv((name, "Conv_1"), f, f)
        norm((name, "FrozenAffine_1"), f)

    n_enc = len(feats) - 1
    cin = cfg["in_channels"] * s2d * s2d
    for i, f in enumerate(feats[:-1]):
        block(f"ConvBlock_{i}", cin, f)
        conv((f"Conv_{i}",), f, f)
        cin = f
    block(f"ConvBlock_{n_enc}", cin, feats[-1])
    cin = feats[-1]
    for i, f in enumerate(reversed(feats[:-1])):
        conv((f"Conv_{n_enc + i}",), cin, f)
        mb = f"MergeBlock_{i}"
        conv((mb, "merge_up"), f, f)
        conv((mb, "merge_skip"), f, f)
        norm((mb, "FrozenAffine_0"), f)
        conv((mb, "Conv_0"), f, f)
        norm((mb, "FrozenAffine_1"), f)
        cin = f
    k = cfg["num_classes"] * s2d * s2d
    head = cfg["head_init"]
    out.append((("logits", "kernel"), (1, 1, cin, k), ("dense", cin, head["kernel_std_scale"])))
    out.append((("logits", "bias"), (k,), ("const", head["bias"])))
    return out


def make_tree(cfg: Dict, seed: int, device) -> Dict:
    return weights.draw(leaves(cfg), seed, device)


def flops_per_batch(cfg: Dict, traffic: Dict) -> float:
    """Operations of one batch: every convolution of the U-Net on each
    panel image, and the head."""
    det, feats, s2d = cfg["detector"], cfg["features"], cfg["s2d"]
    rows = traffic["batch"] * det["panels"]
    h, w = det["height"] // s2d, det["width"] // s2d
    cin = cfg["in_channels"] * s2d * s2d
    ops = 0.0
    for i, f in enumerate(feats):
        m = rows * (h >> i) * (w >> i)
        ops += roofline.conv_flops(m, 3, cin, f) + roofline.conv_flops(m, 3, f, f)
        if i < len(feats) - 1:
            ops += roofline.conv_flops(rows * (h >> (i + 1)) * (w >> (i + 1)), 3, f, f)
        cin = f
    for i in range(len(feats) - 2, -1, -1):  # decoder: up, merge_up, merge_skip, conv
        m = rows * (h >> i) * (w >> i)
        f = feats[i]
        ops += roofline.conv_flops(m, 3, feats[i + 1], f) + 3 * roofline.conv_flops(m, 3, f, f)
    ops += 2.0 * rows * h * w * feats[0] * cfg["num_classes"] * s2d * s2d
    return ops


def costs(cfg: Dict, traffic: Dict) -> Dict[str, list]:
    """One batch's launches by layer: ``calib`` (K1) and ``unet_conv`` (K4)."""
    det, s2d = cfg["detector"], cfg["s2d"]
    frame = (det["panels"], det["height"], det["width"])
    raw_bytes = np.dtype(traffic["raw_dtype"]).itemsize
    return {
        "calib": [roofline.calib_cost(traffic["batch"], frame, raw_bytes, 2)],
        "unet_conv": roofline.unet_level_costs(traffic["batch"] * det["panels"],
                                               det["height"] // s2d, det["width"] // s2d,
                                               cfg["features"]),
    }


class Writer:
    """The SFX program's writer, in memory: each event's peaks."""

    def __init__(self, max_peaks: int, capture):
        self.max_peaks = max_peaks
        self.sets: Dict[int, tuple] = {}
        self.events: List[int] = []
        self._capture = capture

    def append(self, peak_sets) -> None:
        with self._capture.range("portbench.writer"):
            for s in peak_sets:
                self.sets[int(s.event_idx)] = (s.y, s.x, s.intensity)
                self.events.append(int(s.event_idx))


class Served:
    KEPT = ("fused_calibrate", "peaknet_tpu_fused_infer")  # the program's names, in order

    def __init__(self, cfg, traffic, tree, data, device, metrics, window, sample, capture):
        from psana_ray_tpu_torch import sfx

        self.pool, self.batch = data["pool"], traffic["batch"]
        self.device = device
        self._sfx = sfx
        self.kept: List = [None] * len(self.KEPT)
        outer = self

        class Pipeline(sfx.SfxPipeline):
            def device_step(self, frames):
                outer.kept = [None] * len(outer.KEPT)
                with capture.range("portbench.device_step"):
                    return super().device_step(frames)

            def dispatch(self, batch):
                pending = super().dispatch(batch)
                if window.is_open and all(k is not None for k in outer.kept):
                    sample.offer((np.array(batch.event_idx), np.array(batch.valid), *outer.kept))
                return pending

        pk = cfg["peaks"]
        self.writer = Writer(pk["writer_max_peaks"], capture)
        consts = tuple(t.cpu().numpy() for t in (data["pedestal"], data["gain"], data["mask"]))
        self.pipe = Pipeline(tree, self.writer, calib=consts, device=device,
                             config=sfx.SfxConfig(batch_size=self.batch,
                                                  peak_threshold=pk["threshold"],
                                                  max_peaks=pk["max_peaks"],
                                                  min_distance=pk["min_distance"],
                                                  calib_threshold=cfg["calib"]["threshold"]))
        self.pipe.metrics = metrics

    @contextlib.contextmanager
    def keeping(self):
        """The program's ``sfx`` module calls the wrapped names while inside:
        each call's output is kept in :attr:`kept`."""
        saved = [getattr(self._sfx, n) for n in self.KEPT]

        def keep(i, fn):
            def kept(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.kept[i] = out
                return out
            return kept

        try:
            for i, (n, fn) in enumerate(zip(self.KEPT, saved)):
                setattr(self._sfx, n, keep(i, fn))
            yield
        finally:
            for n, fn in zip(self.KEPT, saved):
                setattr(self._sfx, n, fn)

    def warm(self) -> None:
        """One batch through the device step: kernels loaded, cuDNN's
        algorithms chosen."""
        frames = torch.from_numpy(self.pool[:self.batch]).to(self.device)
        self.pipe.device_step(frames)

    def run(self, ring) -> None:
        with self.keeping():
            self.pipe.run(ring)

    def answered(self) -> List[int]:
        return list(self.writer.events)

    def written(self) -> Dict[int, tuple]:
        return self.writer.sets

    def info(self) -> Dict[str, float]:
        n = len(self.writer.sets)
        peaks = sum(len(s[0]) for s in self.writer.sets.values())
        return {"peaks_per_event": peaks / n if n else 0.0}

    def release(self) -> None:
        self.pipe = None
        self.kept = [None] * len(self.KEPT)


def check(cfg, traffic, tree, data, items, written, device, control=None) -> Dict[str, dict]:
    """The sampled batches' calibrated frames and logits against the plain
    reference on the same raw frames, and the peak lists written against
    the reference's peaks of those logits; with ``control``, the reference
    computed in that rounding takes the program's place."""
    lim = cfg["limits"]
    p = cfg["detector"]["panels"]
    tree_dev = weights.to_device(tree, device)
    ped, gain, mask = data["pedestal"], data["gain"], data["mask"]
    thr = cfg["calib"]["threshold"]
    rnd = ROUNDINGS[control] if control else None
    cal_err, lg, mismatch = compare.Max(), compare.RelErr(), compare.Max()
    pk = cfg["peaks"]
    for event_idx, valid, cal, logits in items:
        rows = np.flatnonzero(valid)
        ev = event_idx[rows]
        raw = torch.from_numpy(data["pool"][ev % len(data["pool"])].astype(np.float32)).to(device)
        ref_cal = ref_calib.calibrate(raw, ped, gain, mask, thr)
        got_cal = (ref_calib.calibrate(raw, ped, gain, mask, thr, rnd) if rnd
                   else cal[torch.as_tensor(rows, device=cal.device)].float())
        cal_err.add(compare.calib_err(got_cal, ref_cal))
        for j, row in enumerate(rows):
            ref_lg = ref_unet.logits(tree_dev, ref_cal[j].unsqueeze(1), cfg["s2d"])[:, 0]
            if rnd:
                got_lg = ref_unet.logits(tree_dev, got_cal[j].unsqueeze(1), cfg["s2d"], rnd)[:, 0]
                ys, xs, ss = ref_peaks.event_peaks(got_lg, pk["threshold"], pk["min_distance"],
                                                   pk["max_peaks"], pk["writer_max_peaks"])
            else:
                got_lg = logits[row * p:(row + 1) * p, :, :, 0]
                ys, xs, ss = written.get(int(ev[j]), ((), (), ()))
            lg.add(got_lg, ref_lg)
            mismatch.add(compare.peak_mismatch(got_lg, ys, xs, ss, pk))
    return {"calib_err": {"value": cal_err.value, "limit": lim["calib_err"]},
            "logits_rel_err": {"value": lg.value, "limit": lim["logits_rel_err"]},
            "peak_mismatch": {"value": mismatch.value, "limit": lim["peak_mismatch"]}}
