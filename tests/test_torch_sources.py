"""The port's sources against the JAX package's, bit for bit: the
synthetic source's IMAGE mosaic and ``start_event``, ``iter_events``,
``ReplaySource`` over ``.npz`` (a true mmap when uncompressed) and
``.npy``, ``open_source``'s dispatch with the JAX error text on a host
without psana, the psana adapter on a fake psana module, and
``narrow_panels``."""

import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu import records as jax_records  # noqa: E402
from psana_ray_tpu import sources as jax_sources  # noqa: E402
from psana_ray_tpu_torch import records  # noqa: E402
from psana_ray_tpu_torch.config import RetrievalMode  # noqa: E402
from psana_ray_tpu_torch.sources import (  # noqa: E402
    DataSource,
    ReplaySource,
    SyntheticSource,
    open_source,
)
from test_psana_compat import _FakeRun  # noqa: E402


def _same(ours, theirs):
    """Two event streams equal bit for bit: indices, dtypes, shapes, bytes
    and energies."""
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for (i, a, ea), (j, b, eb) in zip(ours, theirs):
        assert i == j and ea == eb
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode", RetrievalMode.ALL)
@pytest.mark.parametrize("detector,dtype", [("smoke_a", "float32"), ("epix100", "uint16")])
def test_synthetic_modes_equal_the_jax_source(mode, detector, dtype):
    kw = dict(detector_name=detector, num_events=5, seed=4, dtype=dtype, shard_rank=1,
              num_shards=2)
    _same(SyntheticSource("synthetic", 2, **kw).iter_indexed_events(mode),
          jax_sources.SyntheticSource("synthetic", 2, **kw).iter_indexed_events(mode))


def test_image_mode_is_the_jax_mosaic():
    ours = SyntheticSource(detector_name="epix10k2M", num_events=1, seed=1)
    theirs = jax_sources.SyntheticSource(detector_name="epix10k2M", num_events=1, seed=1)
    img, _ = ours.event(0, RetrievalMode.IMAGE)
    assert img.shape == (4 * 352, 4 * 384)  # 16 panels, 4 x 4
    np.testing.assert_array_equal(img, theirs.event(0, RetrievalMode.IMAGE)[0])
    # a panel's photons sit in its tile
    calib, _ = ours.event(0, RetrievalMode.CALIB)
    np.testing.assert_array_equal(img[352:704, 768:1152], calib[6])


@pytest.mark.parametrize("start_event", [0, 3, 7, 50])
def test_start_event_filters_shards_as_the_jax_source(start_event):
    for rank in range(3):
        kw = dict(detector_name="smoke_a", num_events=11, shard_rank=rank, num_shards=3,
                  start_event=start_event)
        ours, theirs = SyntheticSource(**kw), jax_sources.SyntheticSource(**kw)
        np.testing.assert_array_equal(ours.shard_event_indices(), theirs.shard_event_indices())
        assert len(ours) == len(theirs)
        assert all(i >= start_event for i in ours.shard_event_indices())
        if len(ours):
            _same(ours.iter_indexed_events("raw"), theirs.iter_indexed_events("raw"))


def test_iter_events_and_the_protocol():
    src = SyntheticSource(detector_name="smoke_a", num_events=4)
    got = list(src.iter_events(RetrievalMode.RAW))
    want = list(src.iter_indexed_events(RetrievalMode.RAW))
    assert len(got) == 4
    for (a, ea), (_, b, eb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ea == eb
    assert isinstance(src, DataSource)


def _record(tmp_path, n=7, ndim=4, compressed=False, extras=True):
    rng = np.random.default_rng(2)
    shape = (n, 2, 16, 128) if ndim == 4 else (n, 16, 128)
    frames = rng.standard_normal(shape).astype(np.float32)
    arrays = {"frames": frames}
    if extras:
        arrays["photon_energy"] = rng.uniform(8, 12, n)
        arrays["bad_pixel_mask"] = (rng.random(frames.shape[1:]) > 0.1).astype(np.uint8)
    path = str(tmp_path / f"run_{ndim}_{int(compressed)}.npz")
    (np.savez_compressed if compressed else np.savez)(path, **arrays)
    return path, frames


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("rank,shards,start", [(0, 1, 0), (1, 2, 0), (2, 3, 4)])
def test_replay_npz_equals_the_jax_source(tmp_path, ndim, compressed, rank, shards, start):
    path, frames = _record(tmp_path, ndim=ndim, compressed=compressed)
    kw = dict(shard_rank=rank, num_shards=shards, start_event=start)
    ours, theirs = ReplaySource(path, **kw), jax_sources.ReplaySource(path, **kw)
    assert ours.num_events == theirs.num_events == 7
    _same(ours.iter_indexed_events(), theirs.iter_indexed_events())
    np.testing.assert_array_equal(ours.create_bad_pixel_mask(), theirs.create_bad_pixel_mask())
    assert list(ours.iter_indexed_events())[0][1].shape == (2 if ndim == 4 else 1, 16, 128)
    # a true mmap exactly where the JAX source has one: uncompressed members
    assert isinstance(ours._frames, np.memmap) == isinstance(theirs._frames, np.memmap)
    assert isinstance(ours._frames, np.memmap) == (not compressed)


def test_replay_npy_and_defaults(tmp_path):
    frames = np.arange(5 * 16 * 8, dtype=np.float32).reshape(5, 16, 8)
    path = str(tmp_path / "frames.npy")
    np.save(path, frames)
    ours, theirs = ReplaySource(path), jax_sources.ReplaySource(path)
    _same(ours.iter_indexed_events(), theirs.iter_indexed_events())
    assert [e for _, e in ours.iter_events()] == [9.5] * 5  # no energy recorded
    np.testing.assert_array_equal(ours.create_bad_pixel_mask(), np.ones((1, 16, 8), np.uint8))
    bare, _ = _record(tmp_path, extras=False)
    np.testing.assert_array_equal(ReplaySource(bare).create_bad_pixel_mask(),
                                  jax_sources.ReplaySource(bare).create_bad_pixel_mask())
    with pytest.raises(FileNotFoundError):
        ReplaySource(str(tmp_path / "missing.npz"))


def test_open_source_dispatch_equals_the_jax_dispatch(tmp_path):
    path, _ = _record(tmp_path)
    for exp in ("synthetic", "synthetic-x", f"replay:{path}"):
        kw = dict(shard_rank=1, num_shards=2, num_events=6, seed=3, dtype="float32",
                  start_event=2)
        ours = open_source(exp, 4, "smoke_a", **kw)
        theirs = jax_sources.open_source(exp, 4, "smoke_a", **kw)
        assert type(ours).__name__ == type(theirs).__name__
        _same(ours.iter_indexed_events("raw"), theirs.iter_indexed_events("raw"))


def test_open_source_without_psana_raises_the_jax_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "psana", None)
    for mod in ("psana_ray_tpu_torch.sources.psana_compat", "psana_ray_tpu.sources.psana_compat"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    errors = []
    for fn in (open_source, jax_sources.open_source):
        with pytest.raises(RuntimeError, match="requires psana") as e:
            fn("mfxl1038923", 58, "epix10k2M")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _fake_psana(monkeypatch, n_events=10, damaged=(3,)):
    frames = [np.full((2, 4, 4), float(i), dtype=np.float64) for i in range(n_events)]
    energies = {i: 9500.0 + i for i in range(n_events)}
    energies[1] = None
    fake = types.ModuleType("psana")
    fake.DataSource = lambda exp=None, run=None: types.SimpleNamespace(
        runs=lambda: iter([_FakeRun(frames, damaged, energies)]))
    monkeypatch.setitem(sys.modules, "psana", fake)
    for mod in ("psana_ray_tpu_torch.sources.psana_compat", "psana_ray_tpu.sources.psana_compat"):
        monkeypatch.delitem(sys.modules, mod, raising=False)


@pytest.mark.parametrize("mode", RetrievalMode.ALL)
def test_psana_adapter_equals_the_jax_adapter(monkeypatch, mode):
    _fake_psana(monkeypatch)
    try:
        for rank, shards, start in ((0, 1, 0), (1, 2, 0), (1, 3, 5)):
            ours = open_source("mfx", 1, "det", shard_rank=rank, num_shards=shards,
                               start_event=start)
            theirs = jax_sources.open_source("mfx", 1, "det", shard_rank=rank,
                                             num_shards=shards, start_event=start)
            assert type(ours).__module__ == "psana_ray_tpu_torch.sources.psana_compat"
            _same(ours.iter_indexed_events(mode), theirs.iter_indexed_events(mode))
            mask = ours.create_bad_pixel_mask()
            assert mask.dtype == np.uint8
            np.testing.assert_array_equal(mask, theirs.create_bad_pixel_mask())
    finally:
        for mod in ("psana_ray_tpu_torch.sources.psana_compat",
                    "psana_ray_tpu.sources.psana_compat"):
            sys.modules.pop(mod, None)


@pytest.mark.parametrize("dtype", ["uint16", "int16", "uint8", "int32", "float32", "float64"])
@pytest.mark.parametrize("src", ["float32", "float64", "uint16", "int32"])
def test_narrow_panels_equals_the_jax_narrowing(dtype, src):
    rng = np.random.default_rng(0)
    panels = (rng.standard_normal((2, 8, 16)) * 4e4).astype(src)
    if np.issubdtype(panels.dtype, np.floating):
        panels[0, 0, :3] = (np.nan, np.inf, -np.inf)
    try:
        theirs = jax_records.narrow_panels(panels, dtype)
    except OverflowError:  # numpy 2 clips an unsigned array to no negative bound
        with pytest.raises(OverflowError):
            records.narrow_panels(panels, dtype)
        return
    ours = records.narrow_panels(panels, dtype)
    assert ours.dtype == theirs.dtype == np.dtype(dtype)
    assert ours.tobytes() == theirs.tobytes()
    if src == dtype:
        assert ours is panels  # a no-op


def test_validate_wire_dtype_equals_the_jax_rule():
    for name in ("uint16", "float32", "int8", "complex64", "bfloat16x"):
        try:
            want = jax_records.validate_wire_dtype(name)
        except (TypeError, ValueError) as e:
            with pytest.raises(type(e)):
                records.validate_wire_dtype(name)
        else:
            assert records.validate_wire_dtype(name) == want
