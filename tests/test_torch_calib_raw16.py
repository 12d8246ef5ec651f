"""bf16 and f16 raw frames through the port's calibration, against the JAX
package's.

The JAX package calibrates a 16-bit float raw frame in the raw dtype, its
background sum and count too (``pallas_calib.py:76-77,145``,
``ops/calib.py:63-65,73``). The port computes each pixel as it does
(``(raw - ped) / gain``, the baseline and ``x - baseline`` rounded to the
raw dtype) but takes the sum and count in f32. So:

- where the reference's 16-bit sums hold (a few thousand pixels a panel,
  background near zero) the two agree: rtol 1e-5, atol 1e-4 (the JAX
  package's own tolerance for its fused kernel) plus one ulp of the output
  at the precision it was last rounded to, the narrower of the raw and
  the output dtype (f32 values within that tolerance round to
  neighbouring 16-bit values);
- at a real panel's size in f16 the reference's count passes 65504 and
  every good pixel comes out non-finite, while the port's output is
  finite and within one f16 ulp of an f64 computation of the same steps;
- in bf16 the reference's 8-bit sums drift, while the port's baseline is
  the f64 mean rounded to bf16;
- the reference's f16 median takes its count from an f16 sum and leaves
  the panel uncorrected, while the port's median path corrects it.

Frames are made with numpy from a seed; the reference runs its Pallas
kernel in interpret mode, at batch 1 on the large panels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.ops import calib as jcalib  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_fused  # noqa: E402
from psana_ray_tpu_torch.ops import calib as tcalib  # noqa: E402
from psana_ray_tpu_torch.ops import fused_calibrate  # noqa: E402
from psana_ray_tpu_torch.sources import DETECTORS  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-4
THRESHOLD = 10.0
BITS = {"f32": 24, "bf16": 8, "f16": 11}  # significant bits
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
NUMPY16 = {"f16": np.float16}
EPIX10K2M = DETECTORS["epix10k2M"].frame_shape[1:]  # (352, 384)
EPIX100 = DETECTORS["epix100"].frame_shape[1:]  # (704, 768)


def _frames(b, p, h, w, seed=0, offset=0.0, photons=0.05):
    """``(raw, ped, gain, mask)`` in f32: pedestal N(1000, 5), gain
    U(0.9, 1.1), 2% bad pixels, signal ``offset + N(0, 2)`` plus 35 ADU
    photons."""
    rng = np.random.default_rng(seed)
    ped = (1000.0 + 5.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = rng.uniform(0.9, 1.1, (p, h, w)).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.02).astype(np.uint8)
    signal = offset + 2.0 * rng.standard_normal((b, p, h, w)) + 35.0 * rng.poisson(
        photons, (b, p, h, w))
    raw = (ped + gain * signal).astype(np.float32)
    return raw, ped, gain, mask


def _in(a, name):
    """``a`` rounded to the dtype ``name``, as f64 (exact)."""
    return torch.from_numpy(a).to(TORCH[name]).double().numpy()


def _port(raw, ped, gain, mask, raw_dt, out_dt=None):
    return fused_calibrate(torch.from_numpy(raw).to(TORCH[raw_dt]), torch.from_numpy(ped),
                           torch.from_numpy(gain), torch.from_numpy(mask),
                           threshold=THRESHOLD, out_dtype=out_dt and TORCH[out_dt])


def _reference(raw, ped, gain, mask, raw_dt, out_dt=None):
    return jax_fused(jnp.asarray(raw).astype(JAX[raw_dt]), jnp.asarray(ped), jnp.asarray(gain),
                     jnp.asarray(mask), threshold=THRESHOLD,
                     out_dtype=out_dt and JAX[out_dt], interpret=True)


def _round(a, name):
    """f64 ``a`` rounded to the dtype ``name`` (an f64 op rounded once to
    a 16-bit type is that op in the 16-bit type), back in f64."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(TORCH[name]).double().numpy()


def _steps_f64(raw, ped, gain, mask, raw_dt):
    """The three steps in f64 at the port's rounding points for ``raw_dt``:
    ``x = rnd(rnd(raw - ped) / gain)``, the baseline the f64 mean of the
    background rounded, ``rnd(x - baseline)`` where the mask is set.
    Returns ``(out, baseline)``."""
    r, p, g = _in(raw, raw_dt), _in(ped, raw_dt), _in(gain, raw_dt)
    x = _round(_round(r - p, raw_dt) / g, raw_dt)
    thr = float(torch.tensor(THRESHOLD, dtype=TORCH[raw_dt]))
    bg = (np.abs(x) < thr) & (mask != 0)
    base = _round((x * bg).sum(axis=(-2, -1), keepdims=True)
                  / np.maximum(bg.sum(axis=(-2, -1), keepdims=True), 1), raw_dt)
    return np.where(mask != 0, _round(x - base, raw_dt), 0.0), base


def _ulp(ref, bits):
    _, exp = np.frexp(np.asarray(ref, np.float64))
    return np.ldexp(1.0, exp - bits)


def _assert_close(got, ref, bits):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    print(f"max_abs_err {diff.max()}")  # pytest -rP
    assert np.all(diff <= ATOL + RTOL * np.abs(ref) + _ulp(ref, bits))


@pytest.mark.parametrize("out_dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("raw_dt", ["bf16", "f16"])
@pytest.mark.parametrize("shape", [(2,) + DETECTORS["smoke_a"].frame_shape, (2, 1, 64, 128)],
                         ids=["smoke_a", "64x128"])
def test_raw16_matches_the_reference_where_its_sums_hold(one_torch_thread, shape, raw_dt, out_dt):
    """Against the fused Pallas kernel and the XLA ``calibrate``, at panel
    sizes whose background count and sum the reference's 16-bit
    accumulator holds closely (background near zero)."""
    raw, ped, gain, mask = _frames(*shape, seed=3)
    got = _port(raw, ped, gain, mask, raw_dt, out_dt)
    assert got.dtype == TORCH[out_dt] and bool(torch.isfinite(got).all())
    got = got.float().numpy()
    bits = min(BITS[raw_dt], BITS[out_dt])
    ref = _reference(raw, ped, gain, mask, raw_dt, out_dt)
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), bits)
    xla = jcalib.calibrate(*(jnp.asarray(a).astype(JAX[raw_dt]) for a in (raw, ped, gain)),
                           jnp.asarray(mask), cm_threshold=THRESHOLD, cm_algorithm="mean")
    _assert_close(got, np.asarray(xla.astype(JAX[out_dt]).astype(jnp.float32)), bits)
    assert np.all(got[:, mask == 0] == 0)


@pytest.mark.parametrize("hw", [EPIX10K2M, EPIX100], ids=["epix10k2M", "epix100"])
def test_f16_overflow_of_the_reference_is_not_kept(one_torch_thread, hw):
    """A real panel's background count passes f16's 65504 in the
    reference: every good pixel is non-finite. The port's output is finite
    and within one f16 ulp of the f64 steps (the baselines equal)."""
    raw, ped, gain, mask = _frames(1, 1, *hw, offset=3.0, photons=0.0)
    good = np.broadcast_to(mask != 0, raw.shape)
    ref = np.asarray(_reference(raw, ped, gain, mask, "f16").astype(jnp.float32))
    assert not np.isfinite(ref[good]).any()
    got = _port(raw, ped, gain, mask, "f16")
    assert got.dtype == torch.float16
    got = got.float().numpy()
    want, base = _steps_f64(raw, ped, gain, mask, "f16")
    assert np.isfinite(got).all() and np.all(got[~good] == 0)
    diff = np.abs(got - want)
    print(f"baseline {float(base.ravel()[0])} max_abs_err {diff.max()}")  # pytest -rP
    assert np.all(diff <= _ulp(want, BITS["f16"]))
    assert np.array_equal(
        tcalib.common_mode_baseline(torch.from_numpy(_round(
            _round(_in(raw, "f16") - _in(ped, "f16"), "f16") / _in(gain, "f16"), "f16"))
            .half(), torch.from_numpy(mask), THRESHOLD).double().numpy(), base)


@pytest.mark.parametrize("hw", [EPIX10K2M, EPIX100], ids=["epix10k2M", "epix100"])
def test_bf16_drift_of_the_reference_is_not_kept(one_torch_thread, hw):
    """The reference rounds a bf16 panel's background sum and count to 8
    bits; the port's baseline is the f64 mean rounded to bf16 and its
    output the f64 steps at the same rounding points."""
    raw, ped, gain, mask = _frames(1, 1, *hw, offset=3.0, photons=0.0)
    r, p, g = (torch.from_numpy(_in(a, "bf16")).bfloat16() for a in (raw, ped, gain))
    x = (r - p) / g
    base = tcalib.common_mode_baseline(x, torch.from_numpy(mask), THRESHOLD)
    want, want_base = _steps_f64(raw, ped, gain, mask, "bf16")
    assert base.dtype == torch.bfloat16 and np.array_equal(base.double().numpy(), want_base)
    got = _port(raw, ped, gain, mask, "bf16").double().numpy()
    assert np.array_equal(got, want)
    ref = np.asarray(_reference(raw, ped, gain, mask, "bf16").astype(jnp.float32), np.float64)
    good = np.broadcast_to(mask != 0, raw.shape)
    print(f"baseline {float(want_base.ravel()[0])}: mean output over good pixels "
          f"{got[good].mean()} (port), {ref[good].mean()} (reference); "
          f"reference max deviation {np.abs(ref - want).max()}")  # pytest -rP


def test_f16_median_of_the_reference_is_not_kept(one_torch_thread):
    """The reference's f16 median takes its count as an int of an f16 sum,
    which passes 65504 on an epix10k2M panel: no correction at all. The
    port's median output equals the f32 median path's within one f16 ulp
    of the baseline it removes."""
    raw, ped, gain, mask = _frames(1, 1, *EPIX10K2M, offset=3.0, photons=0.0)
    good = np.broadcast_to(mask != 0, raw.shape)
    args16 = [_in(a, "f16") for a in (raw, ped, gain)]

    def median_out(fn, dt):
        return np.median(np.asarray(fn(dt), np.float64)[good])

    ref16 = median_out(lambda dt: jcalib.calibrate(
        *(jnp.asarray(a, dt) for a in args16), jnp.asarray(mask), cm_threshold=THRESHOLD,
        cm_algorithm="median").astype(jnp.float32), jnp.float16)
    ref32 = median_out(lambda dt: jcalib.calibrate(
        *(jnp.asarray(a, dt) for a in args16), jnp.asarray(mask), cm_threshold=THRESHOLD,
        cm_algorithm="median"), jnp.float32)
    port = {name: tcalib.calibrate(*(torch.from_numpy(a).to(TORCH[name]) for a in args16),
                                   torch.from_numpy(mask), cm_threshold=THRESHOLD,
                                   cm_algorithm="median")
            for name in ("f16", "f32")}
    got16, got32 = (float(np.median(port[n].double().numpy()[good])) for n in ("f16", "f32"))
    base32 = tcalib.common_mode_baseline(
        torch.from_numpy((args16[0] - args16[1]) / args16[2]).float(), torch.from_numpy(mask),
        THRESHOLD, "median")
    print(f"median output over good pixels: reference f16 {ref16}, f32 {ref32}; "
          f"port f16 {got16}, f32 {got32}; baseline {float(base32)}")  # pytest -rP
    assert ref16 > 1.0 and abs(ref32) < 0.1  # the reference's f16 median corrects nothing
    assert port["f16"].dtype == torch.float16 and bool(torch.isfinite(port["f16"]).all())
    assert abs(got16 - got32) <= float(_ulp(float(base32), BITS["f16"]))
