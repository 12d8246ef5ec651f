"""ResNet-50 served as the hit/miss classifier: its weights, its
operations, how a run drives it, and its comparison with the plain
reference.

The entry is the program's ``InfeedPipeline.run(step, on_result,
block_until_ready=True)`` over the in-process ring (pinned arenas, two
batches staged ahead, the per-row metadata kept on the host), driving
the serving step composed from the port's public functions as
``entry.entry()`` composes it: ``fused_calibrate`` to bf16,
``panels_to_nhwc``, ``resnet_fused_infer`` with the pooled features.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import compare, roofline, weights
from portbench.reference import calib as ref_calib
from portbench.reference import resnet50 as ref_resnet
from portbench.reference.precision import ROUNDINGS

PREFETCH_DEPTH = 2
ARENAS = PREFETCH_DEPTH + 4  # the least pool InfeedPipeline takes
FRAMES_PER_BLOCK = 8  # frames of the reference's forward at a time


def leaves(cfg: Dict) -> List[weights.Leaf]:
    """The flax tree of ``ResNetClassifier(norm="frozen")`` with bottleneck
    blocks, in the order and with the names and shapes of the port's
    ``init_resnet_params``."""
    width = cfg["width"]
    out: List[weights.Leaf] = []

    def conv(path, k, cin, cout):
        out.append((path + ("kernel",), (k, k, cin, cout), ("conv", k * k * cout)))

    def norm(path, ch):
        out.append((path + ("scale",), (ch,), "scale"))
        out.append((path + ("bias",), (ch,), "bias"))

    conv(("stem",), 7, cfg["in_channels"], width)
    norm(("stem_norm",), width)
    cin, idx = width, 0
    for i, n_blocks in enumerate(cfg["stage_sizes"]):
        f = width * 2 ** i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            name = f"BottleneckBlock_{idx}"
            conv((name, "Conv_0"), 1, cin, f)
            norm((name, "FrozenAffine_0"), f)
            conv((name, "Conv_1"), 3, f, f)
            norm((name, "FrozenAffine_1"), f)
            conv((name, "Conv_2"), 1, f, 4 * f)
            norm((name, "FrozenAffine_2"), 4 * f)
            if stride != 1 or cin != 4 * f:
                conv((name, "proj"), 1, cin, 4 * f)
                norm((name, "proj_norm"), 4 * f)
            cin, idx = 4 * f, idx + 1
    out.append((("head", "kernel"), (cin, cfg["num_classes"]), ("dense", cin)))
    out.append((("head", "bias"), (cfg["num_classes"],), "zeros"))
    return out


def make_tree(cfg: Dict, seed: int, device) -> Dict:
    return weights.draw(leaves(cfg), seed, device)


def _half(n: int) -> int:
    """The extent after a stride-2 SAME layer."""
    return (n + 1) // 2


def _stage_extent(cfg: Dict):
    """The first stage's extent: the stem's 7x7/2 and the 3x3/2 pool, SAME."""
    h, w = cfg["input_hw"]
    return _half(_half(h)), _half(_half(w))


def flops_per_batch(cfg: Dict, traffic: Dict) -> float:
    """Operations of one batch: the stem, every bottleneck's convolutions
    (projections too) and the head."""
    b, width = traffic["batch"], cfg["width"]
    h, w = cfg["input_hw"]
    ops = roofline.conv_flops(b * _half(h) * _half(w), 7, cfg["in_channels"], width)
    h, w = _stage_extent(cfg)
    cin = width
    for i, n_blocks in enumerate(cfg["stage_sizes"]):
        f = width * 2 ** i
        for j in range(n_blocks):
            s = 2 if (i > 0 and j == 0) else 1
            m_in = b * h * w
            h, w = h // s, w // s
            m_out = b * h * w
            ops += (roofline.conv_flops(m_in, 1, cin, f) + roofline.conv_flops(m_out, 3, f, f)
                    + roofline.conv_flops(m_out, 1, f, 4 * f))
            if s != 1 or cin != 4 * f:
                ops += roofline.conv_flops(m_out, 1, cin, 4 * f)
            cin = 4 * f
    return ops + 2.0 * b * cin * cfg["num_classes"]


def costs(cfg: Dict, traffic: Dict) -> Dict[str, list]:
    """One batch's launches by layer: ``calib`` (K1) and ``resnet_conv``
    (K2 and K3)."""
    det = cfg["detector"]
    frame = (det["panels"], det["height"], det["width"])
    raw_bytes = np.dtype(traffic["raw_dtype"]).itemsize
    h, w = _stage_extent(cfg)
    return {
        "calib": [roofline.calib_cost(traffic["batch"], frame, raw_bytes, 2)],
        "resnet_conv": roofline.bottleneck_costs(traffic["batch"], h, w, cfg["stage_sizes"],
                                                 cfg["width"]),
    }


class Served:
    def __init__(self, cfg, traffic, tree, data, device, metrics, window, sample, capture):
        from psana_ray_tpu_torch.convert import resnet_from_flax
        from psana_ray_tpu_torch.infeed import InfeedPipeline
        from psana_ray_tpu_torch.models import fused_resnet, heads
        from psana_ray_tpu_torch.ops import fused_calib

        self.pool, self.batch, self.device = data["pool"], traffic["batch"], device
        self.metrics = metrics
        self._pipeline = InfeedPipeline
        self.events: List[int] = []
        ped, gain, mask = data["pedestal"], data["gain"], data["mask"]
        thr = cfg["calib"]["threshold"]
        self.params = fused_resnet.pack_fused(
            resnet_from_flax(tree, stage_sizes=cfg["stage_sizes"], device=device))
        stage_sizes = tuple(cfg["stage_sizes"])

        @torch.no_grad()
        def step(batch):
            with capture.range("portbench.step"):
                cal = fused_calib.fused_calibrate(batch.frames, ped, gain, mask, threshold=thr,
                                                  out_dtype=torch.bfloat16)
                logits, feat = fused_resnet.resnet_fused_infer(
                    self.params, heads.panels_to_nhwc(cal), stage_sizes, return_features=True)
            if window.is_open:
                sample.offer((np.array(batch.event_idx), np.array(batch.valid), cal, logits,
                              feat))
            return logits, feat

        self.step = step

    def on_result(self, out, batch) -> None:
        ev = np.asarray(batch.event_idx)[np.asarray(batch.valid) != 0]
        self.events.extend(int(e) for e in ev)

    def warm(self) -> None:
        """One batch through the step: kernels loaded, cuDNN's algorithms
        chosen."""
        from psana_ray_tpu_torch.infeed.batcher import Batch

        frames = torch.from_numpy(self.pool[:self.batch]).to(self.device)
        meta = (np.zeros(self.batch),) * 4
        self.step(Batch(frames, *meta, num_valid=self.batch))

    def run(self, ring) -> None:
        pipe = self._pipeline(ring, batch_size=self.batch, device=self.device,
                              prefetch_depth=PREFETCH_DEPTH, batcher_buffers=ARENAS,
                              stage_meta=False, metrics=self.metrics)
        pipe.run(self.step, on_result=self.on_result, block_until_ready=True)

    def answered(self) -> List[int]:
        return list(self.events)

    def written(self):
        return None

    def info(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        self.params = self.step = None


def check(cfg, traffic, tree, data, items, written, device, control=None) -> Dict[str, dict]:
    """The sampled batches' calibrated frames, logits and pooled features
    against the plain reference on the same raw frames; with ``control``,
    the reference computed in that rounding takes the program's place."""
    lim = cfg["limits"]
    tree_dev = weights.to_device(tree, device)
    ped, gain, mask = data["pedestal"], data["gain"], data["mask"]
    thr = cfg["calib"]["threshold"]
    rnd = ROUNDINGS[control] if control else None
    cal_err, lg, ft = compare.Max(), compare.RelErr(), compare.RelErr()
    for event_idx, valid, cal, logits, feat in items:
        rows = np.flatnonzero(valid)
        for lo in range(0, len(rows), FRAMES_PER_BLOCK):
            blk = rows[lo:lo + FRAMES_PER_BLOCK]
            ev = event_idx[blk]
            raw = torch.from_numpy(
                data["pool"][ev % len(data["pool"])].astype(np.float32)).to(device)
            ref_cal = ref_calib.calibrate(raw, ped, gain, mask, thr)
            ref_lg, ref_ft = ref_resnet.forward(tree_dev, ref_cal, cfg["stage_sizes"])
            idx = torch.as_tensor(blk, device=cal.device)
            if rnd:
                got_cal = ref_calib.calibrate(raw, ped, gain, mask, thr, rnd)
                got_lg, got_ft = ref_resnet.forward(tree_dev, got_cal, cfg["stage_sizes"], rnd)
            else:
                got_cal, got_lg, got_ft = cal[idx].float(), logits[idx], feat[idx]
            cal_err.add(compare.calib_err(got_cal, ref_cal))
            lg.add(got_lg, ref_lg)
            ft.add(got_ft, ref_ft)
    return {"calib_err": {"value": cal_err.value, "limit": lim["calib_err"]},
            "logits_rel_err": {"value": lg.value, "limit": lim["logits_rel_err"]},
            "features_rel_err": {"value": ft.value, "limit": lim["features_rel_err"]}}
