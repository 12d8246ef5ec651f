"""The port's wire codec against the JAX package's.

``shuffle-rle`` round trips every wire dtype; a frame that would grow
ships raw, as do small payloads, EOS markers and pickles; the codec
registry and the server's pick; hostile compressed payloads (truncated,
bit-flipped framing, nested ``C``, trailing bytes, RLE counts that lie)
fail as ``ConnectionError`` with no lease left out; the relay's lazy
receive validates without inflating and re-sends the exact bytes; and
``encode_for_wire`` gives the JAX codec's bytes for the same seeded
frames, each package decoding the other's.
"""

import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu.transport import codec as jax_codec  # noqa: E402
from psana_ray_tpu.utils.bufpool import BufferPool as JaxPool  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, LazyFrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import codec  # noqa: E402
from psana_ray_tpu_torch.utils.bufpool import BufferPool  # noqa: E402

SHUFFLE = codec.get_codec("shuffle-rle")
DTYPES = [np.float32, np.float64, np.uint16, np.int32, np.uint8, np.int16]


def detector(shape=(4, 64, 96), dtype=np.uint16, seed=42):
    """Pedestal, noise and sparse peaks: detector-like, compressible."""
    rng = np.random.default_rng(seed)
    ped = 2000 + 200 * np.sin(np.linspace(0, 9, int(np.prod(shape)))).reshape(shape)
    f = ped + rng.normal(0, 3, shape)
    hits = rng.random(shape) < 1e-3
    f[hits] += rng.integers(500, 3000, int(hits.sum()))
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    return (f.clip(info.min, info.max) if info else f).astype(dtype)


def wire_of(item, codec_obj=SHUFFLE, pool=None):
    parts, lease = codec.encode_for_wire(item, codec_obj, pool or BufferPool())
    wire = b"".join(bytes(p) for p in parts)
    if lease is not None:
        lease.release()
    return wire


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_wire_dtype_roundtrips(dtype):
    rec = FrameRecord(2, 9, detector(dtype=dtype), 7.5, 3.25)
    wire = wire_of(rec)
    got = codec.decode_payload(wire)
    assert got.equals(rec) and got.panels.dtype == dtype and got.timestamp == 3.25
    if dtype in (np.uint16, np.int16, np.uint8):
        assert wire[:1] == codec.TAG_COMPRESSED and len(wire) < 0.6 * rec.nbytes


def test_strided_panels_and_odd_tails():
    panels = detector((2, 64, 130))[:, :, ::2]  # not contiguous
    rec = FrameRecord(0, 1, panels, 1.0)
    assert codec.decode_payload(wire_of(rec)).equals(rec)
    odd = detector((1, 64, 64)).tobytes() + b"\x07"  # a body of u16 and a 1-byte tail
    scratch, out = bytearray(len(odd)), bytearray(len(odd))
    n = SHUFFLE.compress(memoryview(odd), 2, memoryview(scratch))
    assert n is not None and n < len(odd)
    SHUFFLE.decompress(memoryview(bytes(scratch[:n])), memoryview(out))
    assert bytes(out) == odd
    # read as bytes, the same data has no small planes: it would grow
    assert SHUFFLE.compress(memoryview(odd), 1, memoryview(scratch)) is None


@pytest.mark.parametrize("item", ["noise", "small", "eos", "pickle"])
def test_what_cannot_shrink_ships_raw(item):
    rng = np.random.default_rng(5)
    before = codec.CODEC_STATS.stats()["expansions_total"]
    obj = {
        "noise": FrameRecord(0, 0, rng.integers(0, 2**16, (2, 64, 64), dtype=np.uint16), 1.0),
        "small": FrameRecord(0, 0, np.zeros((1, 8, 8), np.uint16), 1.0),
        "eos": EndOfStream(3, 10),
        "pickle": {"x": list(range(5000))},
    }[item]
    parts, lease = codec.encode_for_wire(obj, SHUFFLE, BufferPool())
    assert lease is None
    assert b"".join(map(bytes, parts)) == codec.encode_payload(obj)  # the raw payload
    expanded = codec.CODEC_STATS.stats()["expansions_total"] - before
    assert expanded == (1 if item == "noise" else 0)


def test_registry_and_negotiation_match_the_jax_package():
    assert codec.available_codecs() == jax_codec.available_codecs()
    assert codec.get_codec(None) is None and codec.get_codec("none") is None
    assert codec.get_codec("auto") is codec.get_codec(codec.available_codecs()[0])
    with pytest.raises(ValueError, match="unknown wire codec"):
        codec.get_codec("zstd")
    for names in (["zstd", "shuffle-rle"], ["none", "shuffle-rle"], ["lz9"], [" shuffle-rle "]):
        ours, theirs = codec.negotiate_codec(names), jax_codec.negotiate_codec(names)
        assert getattr(ours, "name", None) == getattr(theirs, "name", None), names
    assert SHUFFLE.codec_id == jax_codec.get_codec("shuffle-rle").codec_id == 1


# -- hostile payloads ------------------------------------------------------


def _wire():
    return wire_of(FrameRecord(0, 1, detector(), 9.5))


def _both_fail(bad, match="compressed"):
    """The port and the JAX package both refuse ``bad`` as ConnectionError."""
    for decode in (codec.decode_payload, jax_codec.decode_payload):
        with pytest.raises(ConnectionError, match=match):
            decode(bad)


@pytest.mark.parametrize("cut", [3, 9, 0.5, -1])
def test_truncated_payload_is_a_connection_error(cut):
    wire = _wire()
    _both_fail(wire[: int(len(wire) * cut) if isinstance(cut, float) else cut])


def test_framing_bitflips_trailing_bytes_and_nesting():
    wire = bytearray(_wire())
    wire[1] = 0xEE
    _both_fail(bytes(wire), "unknown wire codec")
    wire = bytearray(_wire())
    struct.pack_into("<I", wire, 2, 1 << 30)  # an absurd raw_len
    _both_fail(bytes(wire))
    _both_fail(_wire() + b"\x00" * 7)
    # a compressed payload whose head is another compressed payload
    inner = wire_of(FrameRecord(0, 1, detector((1, 64, 64)), 9.5))
    scratch = bytearray(8192)
    clen = SHUFFLE.compress(memoryview(bytes(4096)), 1, memoryview(scratch))
    outer = (codec.TAG_COMPRESSED + struct.pack("<BIH", inner[1], len(inner) + 4096, len(inner))
             + inner + bytes(scratch[:clen]))
    _both_fail(outer, "nested")


def test_no_lease_left_out_after_a_decode_error():
    pool = BufferPool()
    bad = _wire()[:-9]
    lease = pool.lease(len(bad))
    lease.mv[:] = bad
    with pytest.raises(ConnectionError):
        codec.decode_payload(lease.mv, lease=lease)
    assert pool.stats()["leases"] == 0, pool.stats()


def test_lying_rle_counts_fail_before_the_expansion():
    n_runs = 1000
    buf = struct.pack("<I", n_runs) + b"\xaa" * n_runs + struct.pack("<H", 65535) * n_runs
    with pytest.raises(ValueError, match="expands to"):
        codec._decode_plane(memoryview(buf), 0, codec._PLANE_RLE, len(buf), 4096)


def test_validate_mirrors_decompress():
    rec = FrameRecord(0, 1, detector(), 9.5)
    parts, lease = codec.encode_for_wire(rec, SHUFFLE, BufferPool())
    body = bytes(parts[1])
    SHUFFLE.validate(memoryview(body), rec.nbytes)
    for cut in (1, 6, len(body) // 3, len(body) - 1):
        with pytest.raises(ValueError):
            SHUFFLE.validate(memoryview(body[:cut]), rec.nbytes)
    lease.release()


# -- the relay's lazy receive ----------------------------------------------


def test_lazy_relay_forwards_c_without_decoding():
    rec = FrameRecord(4, 11, detector(), 6.5, 2.0)
    wire = wire_of(rec)
    pool = BufferPool()
    lease = pool.lease(len(wire))
    lease.mv[:] = wire
    before = codec.CODEC_STATS.stats()
    lazy = codec.decode_payload(lease.mv, lease=lease, lazy=True)
    assert isinstance(lazy, LazyFrameRecord)
    assert (lazy.shard_rank, lazy.event_idx, lazy.photon_energy, lazy.nbytes) == (
        4, 11, 6.5, rec.nbytes)
    # a peer of the same codec gets the received bytes verbatim, uninflated
    parts, staging = codec.encode_for_wire(lazy, SHUFFLE, pool)
    assert staging is None and b"".join(map(bytes, parts)) == wire
    after = codec.CODEC_STATS.stats()
    assert after["frames_decompressed_total"] == before["frames_decompressed_total"]
    assert after["lazy_frames_total"] == before["lazy_frames_total"] + 1
    assert after["cache_hits_total"] == before["cache_hits_total"] + 1
    # a raw peer gets the inflated frame; the panels inflate at first touch
    raw_parts, _ = codec.encode_for_wire(lazy, None, pool)
    assert b"".join(map(bytes, raw_parts)) == codec.encode_payload(rec)
    assert np.array_equal(lazy.panels, rec.panels)
    owned = lazy.materialize()
    assert owned.equals(rec) and owned.lease is None and owned.wire_cache is None
    assert pool.stats()["leases"] == 0


def test_lazy_corrupt_payload_still_fails_at_receive():
    """A lying shuffle header fails at the relay's receive, where the
    connection dies and its in-flight frames requeue, not at a later push
    to an innocent consumer."""
    wire = bytearray(_wire())
    _, _, head_len = struct.unpack_from("<BIH", wire, 1)
    body = 1 + 7 + head_len
    n_body = struct.unpack_from("<I", wire, body + 2)[0]
    struct.pack_into("<I", wire, body + 2, n_body - 2)  # geometry no longer adds up
    pool = BufferPool()
    lease = pool.lease(len(wire))
    lease.mv[:] = wire
    with pytest.raises(ConnectionError, match="shuffle geometry"):
        codec.decode_payload(lease.mv, lease=lease, lazy=True)
    assert pool.stats()["leases"] == 0


# -- the same bytes as the JAX package --------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_for_wire_bytes_equal_the_jax_codec(dtype, seed):
    panels = detector((3, 48, 80), dtype=dtype, seed=seed)
    ours = wire_of(FrameRecord(seed, 5, panels, 8.25, 1.5))
    parts, lease = jax_codec.encode_for_wire(
        JaxRecord(seed, 5, panels, 8.25, 1.5), jax_codec.get_codec("shuffle-rle"), JaxPool())
    theirs = b"".join(bytes(p) for p in parts)
    if lease is not None:
        lease.release()
    assert ours == theirs
    assert codec.decode_payload(theirs).equals(FrameRecord(seed, 5, panels, 8.25, 1.5))
    assert jax_codec.decode_payload(ours).equals(JaxRecord(seed, 5, panels, 8.25, 1.5))
