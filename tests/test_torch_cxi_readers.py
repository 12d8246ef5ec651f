"""The port's CXI readers and merge tool against the JAX package's.

Files written by each package's ``CxiWriter`` read back through the
other's ``read_cxi_peaks`` and ``read_cxi_peaksets``; both packages'
``merge_cxi`` give identical datasets on the cases of
``tests/test_sfx.py``: an at-least-once replay (keep last and first),
chunked slabs with events of two shards, files whose winners interleave
within a slab; and their refusals. The merge command runs as
``python -m psana_ray_tpu_torch.cxi``. ``unpad_peaks`` equals the JAX
package's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from psana_ray_tpu import cxi as jcxi  # noqa: E402
from psana_ray_tpu_torch import cxi as tcxi  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jcxi, "port": tcxi}
DATASETS = ("entry_1/result_1/nPeaks", "entry_1/result_1/peakXPosRaw",
            "entry_1/result_1/peakYPosRaw", "entry_1/result_1/peakTotalIntensity",
            "LCLS/photon_energy_eV", "LCLS/shard_rank", "LCLS/event_idx")


def _sets(pkg, rng, events, rank_of=lambda i: 0, offset=0.0):
    out = []
    for i in events:
        k = 0 if i % 5 == 4 else int(rng.integers(1, 5))  # some events find no peak
        out.append(pkg.PeakSet(event_idx=i, shard_rank=rank_of(i),
                               y=(rng.random(k) * 100 + offset).astype(np.float32),
                               x=(rng.random(k) * 100).astype(np.float32),
                               intensity=rng.random(k).astype(np.float32),
                               photon_energy=9.0 + 0.25 * i))
    return out


def _write(pkg, path, sets, max_peaks=8):
    with pkg.CxiWriter(str(path), max_peaks=max_peaks) as w:
        w.append([pkg.PeakSet(s.event_idx, s.shard_rank, s.y, s.x, s.intensity, s.photon_energy)
                  for s in sets])


def _datasets(path):
    with h5py.File(str(path), "r") as f:
        return {name: (f[name].dtype, f[name][:]) for name in DATASETS}


def _assert_same_file(a, b):
    da, db = _datasets(a), _datasets(b)
    for name in DATASETS:
        assert da[name][0] == db[name][0], name
        np.testing.assert_array_equal(da[name][1], db[name][1], err_msg=name)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    sets = _sets(tcxi, np.random.default_rng(1), range(9), rank_of=lambda i: i % 3)
    path = tmp_path / f"{writer}.cxi"
    _write(PACKAGES[writer], path, sets)
    back = PACKAGES[reader].read_cxi_peaksets(str(path))
    assert [s.event_idx for s in back] == list(range(9))
    for s, want in zip(back, sets):
        assert s.shard_rank == want.shard_rank
        np.testing.assert_array_equal(s.y, want.y)
        np.testing.assert_array_equal(s.x, want.x)
        np.testing.assert_array_equal(s.intensity, want.intensity)
        assert s.photon_energy == pytest.approx(want.photon_energy)
    ours, theirs = tcxi.read_cxi_peaks(str(path)), jcxi.read_cxi_peaks(str(path))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_readers_refuse_a_foreign_layout(tmp_path):
    path = str(tmp_path / "foreign.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=[1])
    for reader in (tcxi.read_cxi_peaks, tcxi.read_cxi_peaksets):
        with pytest.raises(ValueError, match="not a CxiWriter file"):
            reader(path)


def _merge_both(tmp_path, inputs, **kw):
    """Merge ``inputs`` with each package into its own file; the two files
    must hold identical datasets. Returns the port's file and count."""
    outs = {}
    for name, pkg in PACKAGES.items():
        out = tmp_path / f"merged_{name}_{kw.get('keep', 'last')}.cxi"
        outs[name] = (out, pkg.merge_cxi([str(p) for p in inputs], str(out), **kw))
    assert outs["jax"][1] == outs["port"][1]
    _assert_same_file(outs["jax"][0], outs["port"][0])
    return outs["port"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_merge_dedupes_a_replay_like_the_jax_package(tmp_path, writer):
    """A crashed run's file and its resumed run's file: the duplicate event
    keeps the resumed run's row (``keep="last"``) or the crashed run's
    (``"first"``), the output sorted by (shard_rank, event_idx)."""
    rng = np.random.default_rng(2)
    pkg = PACKAGES[writer]
    run1, run2 = tmp_path / "r1.cxi", tmp_path / "r2.cxi"
    _write(pkg, run1, _sets(pkg, rng, [0, 1, 2]))
    _write(pkg, run2, _sets(pkg, rng, [2, 3, 4], offset=500.0))
    out, n = _merge_both(tmp_path, [run1, run2])
    assert n == 5
    sets = tcxi.read_cxi_peaksets(str(out))
    assert [s.event_idx for s in sets] == [0, 1, 2, 3, 4]
    assert sets[2].n and sets[2].y.min() >= 500.0  # the resumed run's row
    out_first, _ = _merge_both(tmp_path, [run1, run2], keep="first")
    first = tcxi.read_cxi_peaksets(str(out_first))[2]
    assert first.n and first.y.max() < 500.0  # the crashed run's row


def test_merge_chunked_two_shards_like_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "src.cxi"
    _write(tcxi, src, _sets(tcxi, rng, range(7), rank_of=lambda i: i % 2))
    out, n = _merge_both(tmp_path, [src], chunk_events=2)
    assert n == 7
    assert [s.event_idx for s in tcxi.read_cxi_peaksets(str(out))] == [0, 2, 4, 6, 1, 3, 5]


def test_merge_interleaved_files_chunked_like_the_jax_package(tmp_path):
    rng = np.random.default_rng(4)
    evens, odds = tmp_path / "e.cxi", tmp_path / "o.cxi"
    _write(jcxi, evens, _sets(jcxi, rng, range(0, 20, 2)), max_peaks=4)
    _write(tcxi, odds, _sets(tcxi, rng, range(1, 20, 2)), max_peaks=6)
    out, n = _merge_both(tmp_path, [evens, odds], chunk_events=3)
    assert n == 20
    sets = tcxi.read_cxi_peaksets(str(out))
    assert [s.event_idx for s in sets] == list(range(20))
    with h5py.File(str(out), "r") as f:
        assert f["entry_1/result_1/peakXPosRaw"].shape == (20, 6)  # the widest input's row


def test_merge_refusals_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    src = tmp_path / "src.cxi"
    _write(tcxi, src, _sets(tcxi, rng, range(3)), max_peaks=8)
    existing = tmp_path / "exists.cxi"
    existing.write_bytes(b"x")
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="refusing to overwrite"):
            pkg.merge_cxi([str(src)], str(existing))
        with pytest.raises(ValueError, match="lossless"):
            pkg.merge_cxi([str(src)], str(tmp_path / "narrow.cxi"), max_peaks=4)
        with pytest.raises(ValueError, match="chunk_events"):
            pkg.merge_cxi([str(src)], str(tmp_path / "z.cxi"), chunk_events=0)
        with pytest.raises(ValueError, match="keep"):
            pkg.merge_cxi([str(src)], str(tmp_path / "z.cxi"), keep="middle")
    assert existing.read_bytes() == b"x"


def test_merge_command(tmp_path):
    """``python -m psana_ray_tpu_torch.cxi``: a self-merge dedupes; a missing
    input and a foreign layout are clean errors (exit 1), not tracebacks."""
    p = tmp_path / "a.cxi"
    _write(tcxi, p, _sets(tcxi, np.random.default_rng(6), [7]), max_peaks=4)
    out = tmp_path / "m.cxi"
    run = subprocess.run([sys.executable, "-m", "psana_ray_tpu_torch.cxi", str(p), str(p),
                          "--output", str(out)], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert run.returncode == 0, run.stderr
    assert "1 unique events" in run.stdout
    n, *_, ev = jcxi.read_cxi_peaks(str(out))
    assert len(n) == 1 and int(ev[0]) == 7
    assert tcxi.merge_cxi_main([str(tmp_path / "nope.cxi"), "--output",
                                str(tmp_path / "x.cxi")]) == 1
    foreign = tmp_path / "foreign.h5"
    with h5py.File(str(foreign), "w") as f:
        f.create_dataset("d", data=[1])
    assert tcxi.merge_cxi_main([str(foreign), "--output", str(tmp_path / "y.cxi")]) == 1


def test_unpad_peaks_matches_the_jax_package():
    rng = np.random.default_rng(8)
    yx = rng.integers(0, 64, (5, 6, 2)).astype(np.int32)
    score = rng.random((5, 6)).astype(np.float32)
    n = np.array([0, 6, 3, 1, 2], np.int32)
    stamps = dict(event_idx=np.arange(10, 15), shard_rank=np.arange(5) % 2,
                  photon_energy=np.linspace(8, 9, 5))
    for kw in ({}, stamps):
        ours, theirs = tcxi.unpad_peaks(yx, score, n, **kw), jcxi.unpad_peaks(yx, score, n, **kw)
        assert len(ours) == len(theirs) == 5
        for a, b in zip(ours, theirs):
            assert (a.event_idx, a.shard_rank, a.photon_energy, a.n) == (
                b.event_idx, b.shard_rank, b.photon_energy, b.n)
            for f in ("y", "x", "intensity"):
                assert getattr(a, f).dtype == getattr(b, f).dtype == np.float32
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
