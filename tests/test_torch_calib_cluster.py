"""K1's cluster route on the CPU: its plan, its reduction order, uint16 raw.

``calib_kernel`` runs only on the card. What it does that a CPU can check:
``calib_plan`` slices each panel into the rows its cluster's CTAs hold
(every row exactly once, in the shared memory a CTA may use); the kernel
sums (sum, count) per slice and then the slices' partials in rank order,
which a torch emulation below repeats and holds against the JAX package's
fused Pallas kernel (interpret mode) on the same numpy-seeded frames; and
uint16 raw reaches the kernel unpromoted while the plain path gives what
JAX gives for it. Tolerance: rtol 1e-5, atol 1e-4, the JAX package's own
for its fused kernel; bf16 output one bf16 ulp more
(``tests/test_torch_calib.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_fused  # noqa: E402
from psana_ray_tpu_torch.ops import fused_calib as fc  # noqa: E402
from psana_ray_tpu_torch.sources import DETECTORS  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
THRESHOLD = 10.0
MASKED_PANEL = 2


def _slices(plan, h):
    """Row ranges of the plan's CTAs, as the kernel computes them."""
    rows = plan.rows_per_cta
    return [(min(k * rows, h), min(k * rows + rows, h)) for k in range(plan.cluster)]


@pytest.mark.parametrize(
    "h,w,cluster",
    [
        (DETECTORS["epix10k2M"].height, DETECTORS["epix10k2M"].width, 8),  # 67.6 KB a CTA
        (DETECTORS["jungfrau4M"].height, DETECTORS["jungfrau4M"].width, 16),  # 2 MiB: 16 x 128 KB
        (DETECTORS["smoke_a"].height, DETECTORS["smoke_a"].width, 1),
        (64, 95, 1),  # the unaligned width of the card tests
        (301, 384, 8),  # H % 8 != 0: the last CTA holds 35 rows
    ],
)
def test_plan_slices_every_row_once(h, w, cluster):
    plan = fc.calib_plan(h, w)
    assert plan.route == "cluster" and plan.cluster == cluster
    assert plan.smem_bytes == 4 * plan.rows_per_cta * w
    assert plan.smem_bytes + fc.STATIC_SMEM <= 232448
    covered = [r for lo, hi in _slices(plan, h) for r in range(lo, hi)]
    assert covered == list(range(h))
    if plan.cluster > 1:  # the smallest cluster: half as many CTAs would hold too much
        assert 4 * -(-h // (plan.cluster // 2)) * w > fc.SLICE_TARGET


@pytest.mark.parametrize("h,cluster", [(9, 8), (60, 8), (352, 4), (5, 16)])
def test_forced_cluster_covers_ragged_and_empty_slices(h, cluster):
    plan = fc.calib_plan(h, 96, cluster=cluster)
    assert plan.cluster == cluster and plan.rows_per_cta == -(-h // cluster)
    slices = _slices(plan, h)
    assert [r for lo, hi in slices for r in range(lo, hi)] == list(range(h))
    assert all(lo <= hi for lo, hi in slices)  # trailing CTAs may hold no row


def test_plan_takes_the_two_pass_route_beyond_sixteen_ctas():
    # the most rows of 1024 pixels a CTA holds; a panel one row taller than
    # 16 such slices needs the two-pass kernel
    w = 1024
    rows = max(r for r in range(1, 64) if 4 * r * w + fc.STATIC_SMEM <= 232448)
    h = 16 * rows + 1
    assert fc.calib_plan(h, w) == fc.TWO_PASS
    assert fc.calib_plan(h - 16, w).route == "cluster"
    with pytest.raises(ValueError, match="cannot hold"):
        fc.calib_plan(h, w, cluster=16)
    with pytest.raises(ValueError):
        fc.calib_plan(0, w)


def test_runnable_plan_falls_back_when_the_card_cannot_place_the_cluster(monkeypatch):
    raw = torch.zeros((1, 2, 64, 96))
    ped, gain, mask = torch.zeros((2, 64, 96)), torch.ones((2, 64, 96)), torch.ones(
        (2, 64, 96), dtype=torch.uint8)
    monkeypatch.setattr(fc, "active_clusters", lambda *a: 0)
    assert fc.runnable_plan(raw, ped, gain, mask, torch.float32) == (fc.TWO_PASS, fc.LOAD_BULK, 0)
    forced = fc.calib_plan(64, 96, cluster=2)
    with pytest.raises(RuntimeError, match="cannot place"):
        fc.runnable_plan(raw, ped, gain, mask, torch.float32, forced)
    monkeypatch.setattr(fc, "active_clusters", lambda *a: 7)
    assert fc.runnable_plan(raw, ped, gain, mask, torch.float32) == (
        fc.calib_plan(64, 96), fc.LOAD_BULK, 7)


def test_load_mode():
    ped, gain = torch.zeros((2, 8, 96)), torch.ones((2, 8, 96))
    mask = torch.ones((2, 8, 96), dtype=torch.uint8)
    assert fc.load_mode(torch.zeros((1, 2, 8, 96)), ped, gain, mask) == fc.LOAD_BULK
    u16 = torch.zeros((1, 2, 8, 96), dtype=torch.uint16)
    assert fc.load_mode(u16, ped, gain, mask) == fc.LOAD_VECTOR
    odd = torch.zeros((1, 2, 8, 95))
    assert fc.load_mode(odd, ped[..., :95].contiguous(), gain[..., :95].contiguous(),
                        mask[..., :95].contiguous()) == fc.LOAD_SCALAR
    shifted = torch.zeros(1 + 2 * 8 * 96)[1:].view(1, 2, 8, 96)  # 4 bytes off alignment
    assert fc.load_mode(shifted, ped, gain, mask) == fc.LOAD_SCALAR


def test_prepare_keeps_uint16_for_the_kernel_only():
    raw = torch.zeros((2, 4, 4), dtype=torch.uint16)
    ped = torch.zeros((2, 4, 4), dtype=torch.float64)
    kept, kped, _, squeeze = fc._prepare(raw, ped, ped, keep_u16=True)
    assert kept.dtype == torch.uint16 and kped.dtype == torch.float32 and squeeze
    assert fc._prepare(raw, ped, ped)[0].dtype == torch.float32
    assert fc._prepare(raw.to(torch.int32), ped, ped, keep_u16=True)[0].dtype == torch.float32


# -- the kernel's reduction order against the JAX kernel ---------------------------


@pytest.fixture
def frames():
    """Raw ADUs ``[2, 4, 60, 96]`` with photons above the common-mode
    threshold, per-panel offsets, bad pixels and one all-masked panel; 60
    rows, which 8 CTAs of 8 rows cover with a short last slice."""
    rng = np.random.default_rng(11)
    b, p, h, w = 2, 4, 60, 96
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    mask[MASKED_PANEL] = 0
    photons = rng.poisson(0.1, (b, p, h, w)).astype(np.float32)
    cm = rng.uniform(-8.0, 8.0, (b, p, 1, 1)).astype(np.float32)
    raw = ped + 35.0 * photons * gain + cm + 2.5 * rng.standard_normal((b, p, h, w))
    return {"raw": raw.astype(np.float32), "pedestal": ped, "gain": gain, "mask": mask}


def emulate_kernel(raw, ped, gain, mask, plan, out_dtype=torch.float32):
    """``calib_kernel``'s arithmetic in its order: x, (sum, count) per CTA
    slice of ``plan`` (one slice on the two-pass route), the slices'
    partials added in rank order, then the baseline applied."""
    raw = raw.to(torch.float32)
    if raw.dim() == 3:
        return emulate_kernel(raw[None], ped, gain, mask, plan, out_dtype)[0]
    h = raw.shape[2]
    x = (raw - ped) / gain
    good = mask != 0
    bg = (x.abs() < THRESHOLD) & good
    xb = torch.where(bg, x, torch.zeros(()))
    slices = _slices(plan, h) if plan.route == "cluster" else [(0, h)]
    s = torch.zeros(raw.shape[:2])
    c = torch.zeros(raw.shape[:2])
    for lo, hi in slices:
        s = s + xb[:, :, lo:hi].sum((2, 3))
        c = c + bg[:, :, lo:hi].sum((2, 3)).to(torch.float32)
    base = (s / c.clamp(min=1.0))[:, :, None, None]
    return torch.where(good, x - base, torch.zeros(())).to(out_dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_fused(raw, f, **kw):
    return jax_fused(jnp.asarray(raw), jnp.asarray(f["pedestal"]), jnp.asarray(f["gain"]),
                     jnp.asarray(f["mask"]), threshold=THRESHOLD, interpret=True, **kw)


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


PLANS = {
    "chosen": None,  # calib_plan's own choice for 60 x 96 (one CTA)
    "cluster2": 2,
    "cluster4": 4,
    "cluster8": 8,  # 8 rows a CTA, the last 4
    "cluster16": 16,  # 4 rows a CTA, the last 0
    "two_pass": 0,
}


def _plan(name, h, w):
    c = PLANS[name]
    if c == 0:
        return fc.TWO_PASS
    return fc.calib_plan(h, w, cluster=c)


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_kernel_order_matches_jax_fused_kernel(frames, plan_name, out):
    f = frames
    plan = _plan(plan_name, *f["raw"].shape[2:])
    bf16 = out == "bf16"
    got = emulate_kernel(*(_t(f[k]) for k in ("raw", "pedestal", "gain", "mask")), plan,
                         torch.bfloat16 if bf16 else torch.float32)
    ref = _jax_fused(f["raw"], f, out_dtype=jnp.bfloat16 if bf16 else None)
    _close(got.float().numpy(), np.asarray(ref, np.float32), bf16=bf16)
    assert np.all(got.float().numpy()[:, MASKED_PANEL] == 0)


@pytest.mark.parametrize("plan_name", ["cluster8", "two_pass"])
def test_kernel_order_single_frame_matches_jax(frames, plan_name):
    f = frames
    one = f["raw"][0]
    got = emulate_kernel(_t(one), _t(f["pedestal"]), _t(f["gain"]), _t(f["mask"]),
                         _plan(plan_name, *one.shape[1:]))
    assert tuple(got.shape) == one.shape
    _close(got.numpy(), _jax_fused(one, f))


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_uint16_raw_matches_jax(frames, out):
    f = frames
    raw_u16 = np.clip(np.rint(f["raw"]), 0, 65535).astype(np.uint16)
    bf16 = out == "bf16"
    ref = _jax_fused(raw_u16, f, out_dtype=jnp.bfloat16 if bf16 else None)
    got = fc.fused_calibrate(_t(raw_u16), _t(f["pedestal"]), _t(f["gain"]), _t(f["mask"]),
                             threshold=THRESHOLD, out_dtype=torch.bfloat16 if bf16 else None)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(got.float().numpy(), np.asarray(ref, np.float32), bf16=bf16)
    # the kernel converts uint16 in registers: the same as promoting first
    emu = emulate_kernel(_t(raw_u16), _t(f["pedestal"]), _t(f["gain"]), _t(f["mask"]),
                         _plan("cluster8", *raw_u16.shape[2:]),
                         torch.bfloat16 if bf16 else torch.float32)
    _close(emu.float().numpy(), np.asarray(ref, np.float32), bf16=bf16)
