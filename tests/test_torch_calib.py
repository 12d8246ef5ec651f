"""The port's calibration ops against the JAX package's.

The same numpy frames go through ``psana_ray_tpu.ops`` (the fused Pallas
kernel in interpret mode) and ``psana_ray_tpu_torch.ops`` (plain versions
on CPU tensors). Tolerance: rtol 1e-5, atol 1e-4, the JAX package's own
for its fused kernel; bf16 output may differ by one more bf16 ulp, where
f32 values within that tolerance round to neighbouring bf16 values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.ops import calib as jcalib  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_fused  # noqa: E402
from psana_ray_tpu_torch.ops import calib as tcalib  # noqa: E402
from psana_ray_tpu_torch.ops import fused_calibrate, fused_calibrate_plain  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
MASKED_PANEL = 2


@pytest.fixture
def frames():
    """Raw ADUs ``[2, 4, 64, 96]`` with photons above the common-mode
    threshold, per-panel offsets, bad pixels and one all-masked panel."""
    rng = np.random.default_rng(7)
    b, p, h, w = 2, 4, 64, 96
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    mask[MASKED_PANEL] = 0
    photons = rng.poisson(0.1, (b, p, h, w)).astype(np.float32)
    cm = rng.uniform(-8.0, 8.0, (b, p, 1, 1)).astype(np.float32)
    raw = ped + 35.0 * photons * gain + cm + 2.5 * rng.standard_normal((b, p, h, w))
    return {"raw": raw.astype(np.float32), "pedestal": ped, "gain": gain, "mask": mask}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, bf16=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    tol = ATOL + RTOL * np.abs(ref)
    if bf16:
        _, exp = np.frexp(ref)
        tol = tol + np.ldexp(1.0, exp - 8)
    assert got.shape == ref.shape
    print(f"max_abs_err {np.abs(got - ref).max()}")  # observed values: pytest -rP
    np.testing.assert_array_less(np.abs(got - ref), tol + 1e-30)


@pytest.mark.parametrize("algorithm", ["mean", "median"])
def test_calibrate_matches_jax(frames, algorithm):
    f = frames
    ref = jcalib.calibrate(*(jnp.asarray(f[k]) for k in ("raw", "pedestal", "gain", "mask")),
                           cm_threshold=10.0, cm_algorithm=algorithm)
    got = tcalib.calibrate(*(_t(f[k]) for k in ("raw", "pedestal", "gain", "mask")),
                           cm_threshold=10.0, cm_algorithm=algorithm)
    _close(got.numpy(), ref)
    assert np.all(got.numpy()[:, MASKED_PANEL] == 0)


@pytest.mark.parametrize("algorithm", ["mean", "median"])
@pytest.mark.parametrize("use_mask", [True, False])
def test_common_mode_matches_jax(frames, algorithm, use_mask):
    f = frames
    x = ((f["raw"] - f["pedestal"]) / f["gain"]).astype(np.float32)
    mask = f["mask"] if use_mask else None
    ref = jcalib.common_mode(jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                             threshold=10.0, algorithm=algorithm)
    got = tcalib.common_mode(_t(x), None if mask is None else _t(mask), threshold=10.0,
                             algorithm=algorithm)
    _close(got.numpy(), ref)
    if use_mask:
        # an all-masked panel gets no correction (median: the +inf sort
        # leaves no valid pixel; mean: the count is clamped to 1)
        np.testing.assert_array_equal(got.numpy()[:, MASKED_PANEL], x[:, MASKED_PANEL])


def test_common_mode_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown common-mode"):
        tcalib.common_mode(torch.zeros(1, 4, 4), algorithm="mode")


def test_elementwise_ops_match_jax(frames):
    f = frames
    raw, ped, gain, mask = (f[k] for k in ("raw", "pedestal", "gain", "mask"))
    _close(tcalib.subtract_pedestal(_t(raw), _t(ped)).numpy(),
           jcalib.subtract_pedestal(jnp.asarray(raw), jnp.asarray(ped)))
    _close(tcalib.gain_correct(_t(raw), _t(gain)).numpy(),
           jcalib.gain_correct(jnp.asarray(raw), jnp.asarray(gain)))
    np.testing.assert_array_equal(tcalib.apply_mask(_t(raw), _t(mask)).numpy(),
                                  np.asarray(jcalib.apply_mask(jnp.asarray(raw), jnp.asarray(mask))))


def _jax_fused(raw, f, **kw):
    return jax_fused(jnp.asarray(raw), jnp.asarray(f["pedestal"]), jnp.asarray(f["gain"]),
                     jnp.asarray(f["mask"]), threshold=10.0, interpret=True, **kw)


def _port_fused(raw, f, **kw):
    return fused_calibrate(_t(raw), _t(f["pedestal"]), _t(f["gain"]), _t(f["mask"]),
                           threshold=10.0, **kw)


def test_fused_matches_jax_fused_kernel(frames):
    ref = _jax_fused(frames["raw"], frames)
    got = _port_fused(frames["raw"], frames)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_fused_integer_raw_promotes(frames):
    raw_u16 = np.clip(frames["raw"], 0, 65535).astype(np.uint16)
    ref = _jax_fused(raw_u16, frames)
    got = _port_fused(raw_u16, frames)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_fused_auto_batches_single_frame(frames):
    one = frames["raw"][1]
    got = _port_fused(one, frames)
    assert tuple(got.shape) == one.shape
    _close(got.numpy(), _jax_fused(one, frames))
    np.testing.assert_array_equal(got.numpy(), _port_fused(frames["raw"], frames)[1].numpy())


def test_fused_bf16_output(frames):
    ref = _jax_fused(frames["raw"], frames, out_dtype=jnp.bfloat16)
    got = _port_fused(frames["raw"], frames, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref, np.float32), bf16=True)


def test_fused_plain_is_the_mean_path_of_calibrate(frames):
    args = [_t(frames[k]) for k in ("raw", "pedestal", "gain", "mask")]
    np.testing.assert_array_equal(
        fused_calibrate_plain(*args).numpy(),
        tcalib.calibrate(*args, cm_threshold=10.0, cm_algorithm="mean").numpy(),
    )
