"""The port's serving step, calibration through ResNet-50, against the
same composition in the JAX package, at a small geometry.

Both take the same raw frames, calibration constants and weights (the
port's seeded numpy init, which flax's ``apply`` accepts as it is): the
JAX side runs ``fused_calibrate`` (bf16) -> ``panels_to_nhwc`` ->
``resnet_fused_infer`` with its Pallas kernels in interpret mode, the
port the plain versions of its kernels on CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.models import panels_to_nhwc as jax_panels_to_nhwc  # noqa: E402
from psana_ray_tpu.models.pallas_resnet import resnet_fused_infer as jax_infer  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_calibrate  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402

REL_TOL = 0.05
STAGES = (3, 4, 6, 3)


def rel_err(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-3))


def test_serving_step_matches_jax_composition():
    rng = np.random.default_rng(4)
    b, p, h, w = 2, 4, 64, 96
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    photons = rng.poisson(0.1, (b, p, h, w))
    raw = (ped + 35.0 * photons * gain + rng.normal(0, 2.5, (b, p, h, w))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=p, stage_sizes=STAGES, width=16, seed=0)

    # the JAX reference returns logits only: widen its head with an
    # identity block so that the pooled features come out beside them
    c = params["head"]["kernel"].shape[0]
    wide = dict(params, head={
        "kernel": np.concatenate([np.eye(c, dtype=np.float32), params["head"]["kernel"]], 1),
        "bias": np.concatenate([np.zeros(c, np.float32), params["head"]["bias"]]),
    })
    cal = jax_calibrate(jnp.asarray(raw), jnp.asarray(ped), jnp.asarray(gain), jnp.asarray(mask),
                        threshold=10.0, out_dtype=jnp.bfloat16, interpret=True)
    out = np.asarray(jax_infer({"params": jax.tree.map(jnp.asarray, wide)},
                               jax_panels_to_nhwc(cal), stage_sizes=STAGES, interpret=True))
    ref_feat, ref_logits = out[:, :c], out[:, c:]

    model = pt.resnet_from_flax(params, STAGES, device="cpu")
    got_cal = pt.fused_calibrate(torch.from_numpy(raw), torch.from_numpy(ped),
                                 torch.from_numpy(gain), torch.from_numpy(mask),
                                 threshold=10.0, out_dtype=torch.bfloat16)
    logits, feat = pt.resnet_fused_infer(pt.pack_fused(model), pt.panels_to_nhwc(got_cal),
                                         STAGES, return_features=True)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (b, 2)
    assert torch.isfinite(logits).all()
    errs = {"logits": rel_err(ref_logits, logits.numpy()), "features": rel_err(ref_feat, feat.numpy())}
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert np.abs(ref_feat).max() >= 1e-2
    assert max(errs.values()) < REL_TOL, errs


def test_panels_to_nhwc_round_trip():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    nhwc = pt.panels_to_nhwc(x)
    assert tuple(nhwc.shape) == (2, 4, 5, 3)
    np.testing.assert_array_equal(nhwc.numpy(), np.asarray(jax_panels_to_nhwc(jnp.asarray(x.numpy()))))
    batch = pt.panels_to_nhwc(x, mode="batch")
    assert tuple(batch.shape) == (6, 4, 5, 1)
    torch.testing.assert_close(pt.nhwc_to_panels(batch, 3), x)
    with pytest.raises(ValueError):
        pt.panels_to_nhwc(x, mode="diagonal")
    with pytest.raises(ValueError):
        pt.nhwc_to_panels(nhwc, 3)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.entry(device="cuda")
