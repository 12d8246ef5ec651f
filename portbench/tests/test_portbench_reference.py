"""The plain reference against the port's CPU path at small sizes: the
calibration, PeakNet-TPU and ResNet-50 in f32, and the peak definition;
the seeded weight trees against the port's own init."""

import numpy as np
import pytest
import torch

from portbench import compare, core, weights
from portbench.reference import calib as ref_calib
from portbench.reference import peaknet_tpu as ref_unet
from portbench.reference import peaks as ref_peaks
from portbench.reference import precision
from portbench.reference import resnet50 as ref_resnet

from conftest import SEED, small


def cell(bench, name, **traffic):
    return core.Cell(bench, name, small(name, **traffic))


def tree_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def test_trees_have_the_port_inits_names_and_shapes(bench):
    from psana_ray_tpu_torch.models import init_peaknet_tpu_params, init_resnet_params

    for name in ("sfx_b8", "resnet_b32"):
        c = core.Cell(bench, name)  # the cells' own sizes
        tree = c.module.make_tree(c.config, SEED, "cpu")
        if name == "sfx_b8":
            port = init_peaknet_tpu_params(tuple(c.config["features"]), s2d=c.config["s2d"])
        else:
            port = init_resnet_params(c.config["in_channels"], tuple(c.config["stage_sizes"]),
                                      c.config["width"], c.config["num_classes"])
        assert tree_shapes(tree) == tree_shapes(port)
        # every value a bf16 one: the program's cast loses nothing
        flat = np.concatenate([np.ravel(v) for v in _leaves(tree)])
        assert np.array_equal(flat, torch.from_numpy(flat).bfloat16().float().numpy())


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_same_seed_same_weights_and_frames(bench):
    from portbench import generator

    c = cell(bench, "resnet_b32")
    a, b = (c.module.make_tree(c.config, SEED, "cpu") for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    d1, d2 = (generator.make_data(c.config["detector"], c.traffic, SEED, "cpu") for _ in range(2))
    assert np.array_equal(d1["pool"], d2["pool"]) and d1["pool"].dtype == np.uint16
    d3 = generator.make_data(c.config["detector"], c.traffic, SEED + 1, "cpu")
    assert not np.array_equal(d1["pool"], d3["pool"])


def test_calibration_matches_the_ports_plain_path(bench):
    from portbench import generator
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    c = cell(bench, "sfx_b8")
    data = generator.make_data(c.config["detector"], c.traffic, SEED, "cpu")
    raw = torch.from_numpy(data["pool"])
    ped, gain, mask = data["pedestal"], data["gain"], data["mask"]
    got = fused_calibrate_plain(raw, ped, gain, mask, threshold=10.0, out_dtype=torch.float32)
    ref = ref_calib.calibrate(raw, ped, gain, mask, 10.0)
    # the repo's tolerance for the calibration (tests/test_ops.py)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert float(ref.abs().max()) > 100  # peaks were planted


def test_peaknet_tpu_matches_the_ports_f32_model(bench):
    from psana_ray_tpu_torch.convert import unet_from_flax

    c = cell(bench, "sfx_b8")
    tree = c.module.make_tree(c.config, SEED, "cpu")
    x = torch.randn(3, 1, 32, 64, generator=torch.Generator().manual_seed(1)) * 20
    model = unet_from_flax(tree, dtype=torch.float32)
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 1))[..., 0]
    ref = ref_unet.logits(weights.to_device(tree, "cpu"), x, c.config["s2d"])[:, 0]
    assert compare.RelErr().value == float("inf")  # nothing compared yet
    err = compare.RelErr()
    err.add(got, ref)
    assert err.value < 1e-4, err.value


def test_resnet50_matches_the_ports_f32_model(bench):
    from psana_ray_tpu_torch.convert import resnet_from_flax

    c = cell(bench, "resnet_b32")
    tree = c.module.make_tree(c.config, SEED, "cpu")
    x = torch.randn(2, 2, 128, 128, generator=torch.Generator().manual_seed(2)) * 20
    model = resnet_from_flax(tree, dtype=torch.float32)
    with torch.no_grad():
        logits, feat = model(x.permute(0, 2, 3, 1), return_features=True)
    ref_logits, ref_feat = ref_resnet.forward(weights.to_device(tree, "cpu"), x)
    for got, ref in ((logits, ref_logits), (feat, ref_feat)):
        err = compare.RelErr()
        err.add(got, ref)
        assert err.value < 1e-4, err.value


def _port_event_peaks(logits, pk):
    """The SFX program's peak list of one event: ``find_peaks`` and the
    drain's per-event cap, on ``[P, H, W]`` logits."""
    from psana_ray_tpu_torch.cxi import unpad_peaks
    from psana_ray_tpu_torch.models.peaks import find_peaks

    p, h, _ = logits.shape
    yx, score, n = (a.numpy() for a in find_peaks(logits[..., None], pk["max_peaks"],
                                                  pk["threshold"], pk["min_distance"]))
    panels = unpad_peaks(yx, score, n)
    ys = np.concatenate([q.y + i * h for i, q in enumerate(panels)])
    xs = np.concatenate([q.x for q in panels])
    ss = np.concatenate([q.intensity for q in panels])
    if len(ss) > pk["writer_max_peaks"]:
        keep = np.argsort(-ss)[:pk["writer_max_peaks"]]
        ys, xs, ss = ys[keep], xs[keep], ss[keep]
    return ys, xs, ss


@pytest.mark.parametrize("max_peaks,writer_max", [(128, 128), (6, 10)])
def test_peak_definition_matches_find_peaks(max_peaks, writer_max):
    pk = {"threshold": 0.5, "max_peaks": max_peaks, "min_distance": 2,
          "writer_max_peaks": writer_max}
    logits = 3 * torch.randn(3, 32, 48, generator=torch.Generator().manual_seed(3))
    logits[1, 5:8, 5:8] = 30.0  # a saturated plateau: raster order breaks its ties
    ys, xs, ss = _port_event_peaks(logits, pk)
    assert len(ss) > 0
    assert compare.peak_mismatch(logits, ys, xs, ss, pk) == 0
    ry, rx, rs = ref_peaks.event_peaks(logits, 0.5, 2, max_peaks, writer_max)
    assert sorted(zip(ry.tolist(), rx.tolist())) == sorted(zip(ys.tolist(), xs.tolist()))
    # one peak moved by a pixel, one dropped, one score altered: each counts
    assert compare.peak_mismatch(logits, ys, xs + np.eye(1, len(xs))[0], ss, pk) >= 1
    assert compare.peak_mismatch(logits, ys[1:], xs[1:], ss[1:], pk) == 1
    s2 = ss.copy()
    s2[0] *= 0.5
    assert compare.peak_mismatch(logits, ys, xs, s2, pk) >= 1


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(4)) * 100
    assert torch.equal(precision.exact(x), x)
    y = precision.fp8(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 1.0]
    assert 2 ** -9 < float(rel.max()) <= 2 ** -4 + 1e-6
    assert float(x.abs().max()) == pytest.approx(float(y.abs().max()))
