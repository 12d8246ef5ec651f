"""Tagged payloads of the shared-memory ring and the TCP transport.

The port's copy of ``psana_ray_tpu/transport/codec.py``. One leading tag
byte selects the codec:

- ``R``: the records wire format (:mod:`psana_ray_tpu_torch.records`);
- ``P``: pickle, for any other Python object;
- ``V``: void, a shm ring slot a producer committed after its encode
  failed mid-write; consumers skip it;
- ``C``: a compressed frame, on TCP connections that negotiated a codec
  (opcode ``Z``): ``C + codec_id:u8 + raw_len:u32 + head_len:u16``, then
  the first ``head_len`` bytes of the ``R`` payload raw (the tag, the
  frame header and the shape), then the codec's encoding of the panel
  bytes. A frame the codec cannot shrink ships raw as ``R``: compression
  is an encoding, never a requirement, and the bytes are the JAX
  package's for the same frame.

The TCP transport sends scatter-gather parts (:func:`encode_payload_parts`,
:func:`encode_for_wire`) so that a frame is never built as one bytes
object, and both directions stage compressed bytes in
:class:`~psana_ray_tpu_torch.utils.bufpool.BufferPool` leases. The codecs:
``shuffle-rle`` (pure numpy, always there), and ``lz4`` and
``bitshuffle-lz4`` where those modules import. :data:`CODEC_STATS` counts
the bytes each way.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
from typing import Any, List, Optional

import numpy as np

from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, decode

TAG_RECORD = b"R"
TAG_PICKLE = b"P"
TAG_VOID = b"V"
TAG_COMPRESSED = b"C"
_CPREFIX = struct.Struct("<BIH")  # codec_id:u8, raw_len:u32, head_len:u16
# payloads below this never compress: the codec's header would eat the win
WIRE_COMPRESS_MIN = 4096
# the largest decompressed size a compressed prefix may claim (the largest
# real frame, jungfrau4M f64, is about 67 MB)
_MAX_RAW_PAYLOAD = 256 * 1024 * 1024


def encode_payload_parts(item: Any) -> List[Any]:
    """``[tag + header bytes, payload buffer]`` for a scatter-gather send:
    a frame's payload is the record's own memory. ``b"".join(map(bytes,
    parts))`` equals :func:`encode_payload`."""
    if isinstance(item, FrameRecord):
        header, payload = item.wire_parts()
        return [TAG_RECORD + header, payload]
    if isinstance(item, EndOfStream):
        return [TAG_RECORD + item.to_bytes()]
    return [TAG_PICKLE + pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)]


def payload_nbytes(parts: List[Any]) -> int:
    """The wire length of :func:`encode_payload_parts`'s output."""
    return sum(p.nbytes if hasattr(p, "nbytes") else len(p) for p in parts)


def encode_payload(item: Any) -> bytes:
    if isinstance(item, (FrameRecord, EndOfStream)):
        return TAG_RECORD + item.to_bytes()
    return TAG_PICKLE + pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)


def decode_payload(buf, lease=None, pool=None, lazy=False) -> Any:
    """Decode a tagged payload (bytes or a memoryview).

    Without ``lease`` the result owns its data. With ``lease`` (a
    checked-out buffer that ``buf`` views) a frame record comes back
    zero-copy with the lease attached (see
    :func:`psana_ray_tpu_torch.records.decode`); any other payload
    releases the lease here, after the parse. Only this package's and the
    JAX package's producers write the pickles it reads.

    A compressed payload inflates into a lease of ``pool`` (default: the
    incoming lease's pool; a ``bytearray`` when neither is given) and
    decodes from there. Corrupt compressed framing raises
    ``ConnectionError``: the byte stream is untrustworthy past it, so the
    connection must die. ``lazy=True`` (the queue server's receive)
    validates a compressed frame without inflating it and returns a
    :class:`~psana_ray_tpu_torch.records.LazyFrameRecord`."""
    tag = bytes(buf[:1])
    if tag == TAG_COMPRESSED:
        return _decode_compressed(buf, lease, pool, lazy)
    body = buf[1:]
    if tag == TAG_RECORD:
        return decode(body, lease=lease)
    try:
        if tag == TAG_PICKLE:
            return pickle.loads(body)
        raise ValueError(f"unknown payload tag {tag!r}")
    finally:
        # after the parse: a released buffer may be leased again at once
        if lease is not None:
            lease.release()


# -- the codecs ----------------------------------------------------------
# A codec has ``name``, ``codec_id`` and two methods that work in the
# caller's buffers (pool leases): ``compress(src, itemsize, dst)`` returns
# the bytes written, or None when the encoding does not fit ``dst`` (the
# frame then ships raw); ``decompress(src, dst)`` is its exact inverse and
# raises ValueError on any corruption. A codec with ``validate(src,
# out_len)`` can be received lazily.

CODEC_NONE = "none"
_SHUFFLE_HDR = struct.Struct("<BBII")  # flags, itemsize, n_body, n_tail
_PLANE_HDR = struct.Struct("<BI")  # mode, encoded length
_PLANE_RAW, _PLANE_RLE, _PLANE_PACKED = 0, 1, 2
_RLE_MAX_RUN = 65535  # u16 run counts; longer runs split
# chunk-min-offset transform (flags bit 0, u8/u16 elements): elements
# per chunk. Chosen so a chunk's pedestal drift stays small against
# readout noise while the offsets array stays negligible (2 bytes per
# 4096 elements)
_OFFSET_CHUNK = 4096


def _chunk_min_offsets(v):
    """Per-chunk minima of ``v`` (any unsigned dtype): ONE reduction
    pass. Subtracting them re-centers smooth detector payloads
    (pedestal + noise) near zero so the shuffled high planes collapse
    and the low planes bit-pack — the role delta coding plays in
    classic schemes, at a third of the memory passes and with no
    serial carry chain on decode."""
    n = v.size
    c = n // _OFFSET_CHUNK
    mins = np.empty(c + (1 if n % _OFFSET_CHUNK else 0), v.dtype)
    if c:
        mins[:c] = v[: c * _OFFSET_CHUNK].reshape(c, _OFFSET_CHUNK).min(axis=1)
    if n % _OFFSET_CHUNK:
        mins[c] = v[c * _OFFSET_CHUNK :].min()
    return mins


def _apply_offsets(src, mins, out, subtract: bool) -> None:
    """Modular per-chunk ``out = src -/+ mins``: one broadcast pass
    (``src`` may BE ``out`` for the in-place decode direction)."""
    n = src.size
    c = n // _OFFSET_CHUNK
    op = np.subtract if subtract else np.add
    if c:
        op(
            src[: c * _OFFSET_CHUNK].reshape(c, _OFFSET_CHUNK),
            mins[:c, None],
            out=out[: c * _OFFSET_CHUNK].reshape(c, _OFFSET_CHUNK),
        )
    if n % _OFFSET_CHUNK:
        op(src[c * _OFFSET_CHUNK :], mins[c], out=out[c * _OFFSET_CHUNK :])


def _pack_kbits(p, k: int):
    """Pack u8 values (< 2^k) at ``k`` bits each: a big-endian k*8-bit
    stream per 8-value group, built with ~8+k vectorized u8 column ops
    (value bits land in at most two adjacent output bytes; uint8 shift
    wrap IS the byte-boundary mask). Output: ceil(n/8)*k bytes."""
    n = p.size
    g = -(-n // 8)
    v = np.zeros((g, 8), np.uint8)
    v.reshape(-1)[:n] = p
    out = np.zeros((g, k), np.uint8)
    for i in range(8):
        hi = k * i + k  # value i occupies stream bits [k*i, hi)
        for j in range((k * i) // 8, (hi - 1) // 8 + 1):
            sh = (8 * j + 8) - hi
            if sh >= 0:
                out[:, j] |= v[:, i] << sh  # u8 wrap drops carried bits
            else:
                out[:, j] |= v[:, i] >> (-sh)
    return out.reshape(-1)


def _unpack_kbits(buf, n: int, k: int):
    g = -(-n // 8)
    if buf.size != g * k:
        raise ValueError(f"packed plane size {buf.size} != {g * k}")
    b = buf.reshape(g, k)
    v = np.zeros((g, 8), np.uint8)
    for i in range(8):
        hi = k * i + k
        for j in range((k * i) // 8, (hi - 1) // 8 + 1):
            sh = (8 * j + 8) - hi
            if sh >= 0:
                v[:, i] |= b[:, j] >> sh
            else:
                v[:, i] |= b[:, j] << (-sh)  # u8 wrap; mask clears strays
    if k < 8:
        v &= np.uint8((1 << k) - 1)
    return v.reshape(-1)[:n]


def _build_rle(p, n: int):
    change = np.flatnonzero(p[1:] != p[:-1])
    starts = np.empty(change.size + 1, np.int64)
    starts[0] = 0
    starts[1:] = change + 1
    lengths = np.diff(starts, append=n)
    reps = (lengths + (_RLE_MAX_RUN - 1)) // _RLE_MAX_RUN
    n_runs = int(reps.sum())
    values = np.repeat(p[starts], reps).astype(np.uint8)
    counts = np.full(n_runs, _RLE_MAX_RUN, np.uint16)
    last = np.cumsum(reps) - 1
    counts[last] = (lengths - (reps - 1) * _RLE_MAX_RUN).astype(np.uint16)
    return (
        4 + 3 * n_runs,
        [np.array([n_runs], np.uint32), values, counts],
    )


def _encode_plane(p):
    """Best encoding for one shuffled byte plane, sized EXACTLY from one
    histogram + one boundary count before anything is built:

    - raw — incompressible noise planes;
    - run-length — near-constant planes (the high bytes of shuffled
      detector u16);
    - k-bit packing WITH an exception list — planes that are small
      values plus rare outliers (offset-centered residuals around
      sparse photon peaks: one bright pixel must not force the whole
      plane to 8 bits). ``k == 0`` degenerates to a pure sparse
      encoding.

    Returns ``(mode, encoded_len, pieces)``; pieces are contiguous
    arrays written verbatim after the plane header. Mode choice runs on
    a 1/16 SAMPLE of large planes (estimates pick the candidate; the
    build's exact length is what lands in the stream, and raw wins
    whenever the built encoding disappoints)."""
    n = int(p.size)
    if not n:
        return (_PLANE_RAW, n, [p])
    g8 = -(-n // 8)
    step = 16 if n >= (1 << 16) else 1
    sample = p[::step]
    scale = n / sample.size
    hist = np.bincount(sample, minlength=256)
    cum = np.cumsum(hist)
    pk_k, pk_est = 0, None
    for k in range(8):
        n_exc = (sample.size - int(cum[(1 << k) - 1])) * scale
        cost = 5 + 5 * n_exc + (g8 * k if k else 0)
        if pk_est is None or cost < pk_est:
            pk_k, pk_est = k, cost
    # sampled boundary count UNDERESTIMATES runs shorter than the
    # stride; trusted only as a coarse "is this plane near-constant"
    nc_est = int(np.count_nonzero(sample[1:] != sample[:-1]) * scale)
    rle_est = 4 + 3 * (nc_est + 1)
    best_len, pieces = n, [p]  # raw baseline
    mode = _PLANE_RAW
    if rle_est < min(best_len, pk_est):
        blen, built = _build_rle(p, n)
        if blen < best_len:
            mode, best_len, pieces = _PLANE_RLE, blen, built
    if mode == _PLANE_RAW and pk_est < best_len:
        k = pk_k
        exc = p >= (1 << k) if k else p != 0
        pos = np.flatnonzero(exc).astype(np.uint32)
        blen = 5 + 5 * pos.size + (g8 * k if k else 0)
        if blen < best_len:
            built = [
                np.array([k], np.uint8),
                np.array([pos.size], np.uint32),
                pos,
                p[exc],
            ]
            if k:
                masked = p.copy()
                masked[pos] = 0
                built.append(_pack_kbits(masked, k))
            mode, best_len, pieces = _PLANE_PACKED, blen, built
    return (mode, best_len, pieces)


def _decode_plane(mv, off: int, mode: int, blen: int, n: int):
    if mode == _PLANE_RAW:
        if blen != n:
            raise ValueError(f"raw plane length {blen} != {n}")
        return np.frombuffer(mv, np.uint8, n, off)
    if mode == _PLANE_RLE:
        (n_runs,) = struct.unpack_from("<I", mv, off)
        if blen != 4 + 3 * n_runs:
            raise ValueError(f"rle plane length {blen} != 4+3*{n_runs}")
        values = np.frombuffer(mv, np.uint8, n_runs, off + 4)
        counts = np.frombuffer(mv, np.uint16, n_runs, off + 4 + n_runs)
        total = int(counts.sum(dtype=np.int64))
        if total != n:
            raise ValueError(f"rle plane expands to {total} != {n}")
        return np.repeat(values, counts)
    if mode == _PLANE_PACKED:
        k = mv[off]
        (n_exc,) = struct.unpack_from("<I", mv, off + 1)
        g8 = -(-n // 8)
        if k >= 8 or blen != 5 + 5 * n_exc + (g8 * k if k else 0):
            raise ValueError(
                f"packed plane k={k} n_exc={n_exc} length {blen} mismatch"
            )
        pos = np.frombuffer(mv, np.uint32, n_exc, off + 5)
        vals = np.frombuffer(mv, np.uint8, n_exc, off + 5 + 4 * n_exc)
        if k:
            plane = _unpack_kbits(
                np.frombuffer(mv, np.uint8, g8 * k, off + 5 + 5 * n_exc), n, k
            )
        else:
            plane = np.zeros(n, np.uint8)
        if n_exc:
            if int(pos.max()) >= n:
                raise ValueError("exception position out of range")
            plane[pos] = vals
        return plane
    raise ValueError(f"unknown plane mode {mode}")


class _ShuffleRle:
    """Pure-numpy chunk-min-offset + byte-shuffle + RLE/bit-pack codec
    for detector payloads — the stdlib-only default every deployment
    has.

    u16/u8 payloads are re-centered first by subtracting per-chunk
    minima (``_chunk_min_offsets``: pedestal + readout noise become
    small magnitudes, with no decode carry chain the way delta coding
    would have); then bytes shuffle into per-significance planes (SIMD
    via strided numpy views), and each plane ships as the smallest of
    raw / run-length / k-bit-packed. High planes of shuffled detector
    u16 are near-constant (RLE collapses them); low planes of the
    offset-centered residuals fit in a few bits (packing wins).
    Uniform-noise payloads refuse to shrink — compress() returns None
    and the frame ships raw (the expansion-fallback contract)."""

    name = "shuffle-rle"
    codec_id = 1

    def compress(self, src, itemsize: int, dst):
        data = np.frombuffer(src, dtype=np.uint8)
        n = data.size
        if itemsize not in (1, 2, 4, 8):
            itemsize = 1
        n_elems = n // itemsize
        n_body = n_elems * itemsize
        n_tail = n - n_body
        budget = len(dst)
        total = _SHUFFLE_HDR.size + n_tail
        if n_body == 0 or total >= budget:
            return None
        flags = 0
        body = data[:n_body]
        mins = None
        if itemsize <= 2:
            flags |= 1
            dt = np.uint16 if itemsize == 2 else np.uint8
            v = body.view(dt)
            if itemsize == 2:
                # sign-bias: two's-complement -> offset-binary, so the
                # chunk minima re-center i16 payloads too (a pure shift
                # for u16 — the subtracted minimum absorbs it)
                v = v ^ dt(0x8000)
            mins = _chunk_min_offsets(v)
            z = np.empty_like(v)
            _apply_offsets(v, mins, z, subtract=True)
            body = z.view(np.uint8)
            total += mins.nbytes
            if total >= budget:
                return None
        if itemsize == 2:
            # contiguous shift/mask split beats two strided byte
            # gathers (the hot epix/jungfrau u16 case)
            z16 = body.view(np.uint16)
            plane_arrays = [
                z16.astype(np.uint8),  # low bytes (widening truncate)
                (z16 >> 8).astype(np.uint8),  # high bytes
            ]
        else:
            planes = body.reshape(n_elems, itemsize)
            plane_arrays = [
                np.ascontiguousarray(planes[:, i]) for i in range(itemsize)
            ]
        encs = []
        for p in plane_arrays:
            enc = _encode_plane(p)
            total += _PLANE_HDR.size + enc[1]
            if total >= budget:
                return None  # expansion: caller falls back to raw
            encs.append(enc)
        _SHUFFLE_HDR.pack_into(dst, 0, flags, itemsize, n_body, n_tail)
        off = _SHUFFLE_HDR.size
        if mins is not None:
            end = off + mins.nbytes
            dst[off:end] = mins.data.cast("B")
            off = end
        for mode, blen, pieces in encs:
            _PLANE_HDR.pack_into(dst, off, mode, blen)
            off += _PLANE_HDR.size
            for arr in pieces:
                a = np.ascontiguousarray(arr)
                end = off + a.nbytes
                dst[off:end] = a.data.cast("B")
                off = end
        if n_tail:
            end = off + n_tail
            dst[off:end] = data[n_body:].data
            off = end
        return off

    def validate(self, src, out_len: int) -> None:
        """Structural proof that ``decompress(src, dst)`` with
        ``len(dst) == out_len`` CANNOT raise — every length relation,
        RLE count sum, and exception position is checked, and packed /
        raw plane CONTENT needs no checking (any bit pattern decodes).
        Cost: header arithmetic plus tiny metadata passes, no
        frame-sized work — this is what lets the relay accept a
        compressed frame lazily (LazyFrameRecord) while still failing
        corrupt payloads AT RECEIVE, where the in-flight requeue
        contract runs. Raises ValueError exactly when decompress
        would."""
        mv = src if isinstance(src, memoryview) else memoryview(src)
        try:
            flags, itemsize, n_body, n_tail = _SHUFFLE_HDR.unpack_from(mv, 0)
        except struct.error as e:
            raise ValueError(f"short shuffle header: {e}") from e
        if (
            itemsize not in (1, 2, 4, 8)
            or n_body % itemsize
            or n_body + n_tail != out_len
        ):
            raise ValueError(
                f"shuffle geometry body={n_body} tail={n_tail} "
                f"itemsize={itemsize} vs dst={out_len}"
            )
        n_elems = n_body // itemsize
        off = _SHUFFLE_HDR.size
        if flags & 1:
            if itemsize > 2:
                raise ValueError("offset coding on wide elements")
            n_chunks = -(-n_elems // _OFFSET_CHUNK)
            off += n_chunks * itemsize  # offsets content cannot fail
            if off > len(mv):
                raise ValueError("truncated offset table")
        for _ in range(itemsize):
            if off + _PLANE_HDR.size > len(mv):
                raise ValueError("truncated plane header")
            mode, blen = _PLANE_HDR.unpack_from(mv, off)
            off += _PLANE_HDR.size
            if off + blen > len(mv):
                raise ValueError("truncated plane body")
            if mode == _PLANE_RAW:
                if blen != n_elems:
                    raise ValueError(f"raw plane length {blen} != {n_elems}")
            elif mode == _PLANE_RLE:
                (n_runs,) = struct.unpack_from("<I", mv, off)
                if blen != 4 + 3 * n_runs:
                    raise ValueError(f"rle plane length {blen} mismatch")
                counts = np.frombuffer(mv, np.uint16, n_runs, off + 4 + n_runs)
                if int(counts.sum(dtype=np.int64)) != n_elems:
                    raise ValueError("rle counts do not cover the plane")
            elif mode == _PLANE_PACKED:
                k = mv[off]
                (n_exc,) = struct.unpack_from("<I", mv, off + 1)
                g8 = -(-n_elems // 8)
                if k >= 8 or blen != 5 + 5 * n_exc + (g8 * k if k else 0):
                    raise ValueError(f"packed plane k={k} length mismatch")
                if n_exc:
                    pos = np.frombuffer(mv, np.uint32, n_exc, off + 5)
                    if int(pos.max()) >= n_elems:
                        raise ValueError("exception position out of range")
            else:
                raise ValueError(f"unknown plane mode {mode}")
            off += blen
        if off + n_tail != len(mv):
            raise ValueError("shuffle stream length mismatch")

    def decompress(self, src, dst) -> None:
        mv = src if isinstance(src, memoryview) else memoryview(src)
        try:
            flags, itemsize, n_body, n_tail = _SHUFFLE_HDR.unpack_from(mv, 0)
        except struct.error as e:
            raise ValueError(f"short shuffle header: {e}") from e
        if (
            itemsize not in (1, 2, 4, 8)
            or n_body % itemsize
            or n_body + n_tail != len(dst)
        ):
            raise ValueError(
                f"shuffle geometry body={n_body} tail={n_tail} "
                f"itemsize={itemsize} vs dst={len(dst)}"
            )
        n_elems = n_body // itemsize
        out = np.frombuffer(dst, dtype=np.uint8)
        off = _SHUFFLE_HDR.size
        mins = None
        if flags & 1:
            if itemsize > 2:
                raise ValueError("offset coding on wide elements")
            dt = np.uint16 if itemsize == 2 else np.uint8
            n_chunks = -(-n_elems // _OFFSET_CHUNK)
            if off + n_chunks * itemsize > len(mv):
                raise ValueError("truncated offset table")
            mins = np.frombuffer(mv, dt, n_chunks, off)
            off += n_chunks * itemsize
        plane_arrays = []
        for _ in range(itemsize):
            if off + _PLANE_HDR.size > len(mv):
                raise ValueError("truncated plane header")
            mode, blen = _PLANE_HDR.unpack_from(mv, off)
            off += _PLANE_HDR.size
            if off + blen > len(mv):
                raise ValueError("truncated plane body")
            plane_arrays.append(_decode_plane(mv, off, mode, blen, n_elems))
            off += blen
        if itemsize == 2:
            # contiguous widen + shift-or beats two strided byte
            # scatters; the (typical) all-zero high plane skips its
            # passes entirely
            out16 = out[:n_body].view(np.uint16)
            out16[:] = plane_arrays[0]  # widening assign: low bytes
            hi = plane_arrays[1]
            if hi.any():
                np.bitwise_or(
                    out16, hi.astype(np.uint16) << np.uint16(8), out=out16
                )
        else:
            shuf = out[:n_body].reshape(n_elems, itemsize)
            for i, p in enumerate(plane_arrays):
                shuf[:, i] = p
        if mins is not None:
            v = out[:n_body].view(mins.dtype)
            _apply_offsets(v, mins, v, subtract=False)
            if itemsize == 2:
                np.bitwise_xor(v, mins.dtype.type(0x8000), out=v)
        if n_tail:
            if off + n_tail > len(mv):
                raise ValueError("truncated shuffle tail")
            out[n_body:] = np.frombuffer(mv, np.uint8, n_tail, off)
            off += n_tail
        if off != len(mv):
            raise ValueError(
                f"{len(mv) - off} trailing bytes after shuffle stream"
            )


# -- optional native backends (never required; register when importable) ----
try:  # pragma: no cover - depends on the environment
    import lz4.block as _lz4block
except Exception:  # ImportError or a broken install
    _lz4block = None

try:  # pragma: no cover - depends on the environment
    import bitshuffle as _bitshuffle
except Exception:
    _bitshuffle = None


class _Lz4Block:  # pragma: no cover - exercised only where lz4 exists
    """Raw-byte LZ4 block backend (no shuffle): the backend allocates
    its output internally — still correct, one staging copy into the
    lease; documented as the trade for native match-finding speed."""

    name = "lz4"
    codec_id = 2

    def compress(self, src, itemsize: int, dst):
        comp = _lz4block.compress(src, store_size=False)
        if len(comp) >= len(dst):
            return None
        dst[: len(comp)] = comp
        return len(comp)

    def decompress(self, src, dst) -> None:
        try:
            raw = _lz4block.decompress(src, uncompressed_size=len(dst))
        except Exception as e:
            raise ValueError(f"lz4 decompress failed: {e}") from e
        if len(raw) != len(dst):
            raise ValueError(f"lz4 length {len(raw)} != {len(dst)}")
        dst[:] = raw


class _BitshuffleLz4:  # pragma: no cover - exercised only where bitshuffle exists
    """bitshuffle + LZ4 (the HDF5 detector-data workhorse). The element
    width rides as one leading byte so decompress can rebuild the
    typed view."""

    name = "bitshuffle-lz4"
    codec_id = 3
    _DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

    def compress(self, src, itemsize: int, dst):
        dt = self._DTYPES.get(itemsize, np.uint8)
        arr = np.frombuffer(src, dtype=np.uint8)
        if arr.size % np.dtype(dt).itemsize:
            return None
        try:
            comp = _bitshuffle.compress_lz4(arr.view(dt))
        except Exception:
            return None
        if 1 + comp.nbytes >= len(dst):
            return None
        dst[0] = np.dtype(dt).itemsize
        dst[1 : 1 + comp.nbytes] = comp.data
        return 1 + comp.nbytes

    def decompress(self, src, dst) -> None:
        mv = src if isinstance(src, memoryview) else memoryview(src)
        dt = self._DTYPES.get(mv[0] if len(mv) else 0)
        if dt is None or len(dst) % np.dtype(dt).itemsize:
            raise ValueError("bitshuffle stream geometry")
        n = len(dst) // np.dtype(dt).itemsize
        try:
            raw = _bitshuffle.decompress_lz4(
                np.frombuffer(mv, np.uint8, len(mv) - 1, 1), (n,), np.dtype(dt)
            )
        except Exception as e:
            raise ValueError(f"bitshuffle decompress failed: {e}") from e
        np.frombuffer(dst, dtype=np.uint8)[:] = raw.view(np.uint8)


_CODECS: dict = {}  # name -> codec object
_CODECS_BY_ID: dict = {}


def _register_codec(codec) -> None:
    _CODECS[codec.name] = codec
    _CODECS_BY_ID[codec.codec_id] = codec


_register_codec(_ShuffleRle())
if _lz4block is not None:  # pragma: no cover - environment-dependent
    _register_codec(_Lz4Block())
if _bitshuffle is not None:  # pragma: no cover - environment-dependent
    _register_codec(_BitshuffleLz4())


def available_codecs():
    """Codec names this process can ENCODE AND DECODE, preference order
    (fast native backends first, the stdlib-only fallback last) — what a
    client advertises under ``codec="auto"``."""
    order = ("bitshuffle-lz4", "lz4", "shuffle-rle")
    return [n for n in order if n in _CODECS]


def get_codec(name: Optional[str]):
    """Resolve a codec name: None/"none" -> None (uncompressed), "auto"
    -> this process's preferred codec, a registered name -> its codec
    object; unknown names raise."""
    if name is None or name == CODEC_NONE:
        return None
    if name == "auto":
        avail = available_codecs()
        return _CODECS[avail[0]] if avail else None
    codec = _CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown wire codec {name!r} (available: "
            f"{[CODEC_NONE, *available_codecs()]})"
        )
    return codec


def negotiate_codec(client_names):
    """Server side of the 'Z' capability exchange: the first codec the
    client advertises that this process also implements wins; no
    overlap (or an explicit "none") means uncompressed."""
    for name in client_names:
        name = name.strip()
        if name == CODEC_NONE:
            return None
        codec = _CODECS.get(name)
        if codec is not None:
            return codec
    return None


class CodecTelemetry:
    """Wire-compression counters: negotiations by codec, raw and wire
    bytes each way (their quotient is the compression ratio), expansion
    fallbacks, relay pass-through re-sends and lazy receives. One
    process-wide instance, :data:`CODEC_STATS`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.negotiations: dict = {}  # guarded-by: _lock
        self.frames_compressed = 0  # guarded-by: _lock
        self.frames_decompressed = 0  # guarded-by: _lock
        self.bytes_raw_out = 0  # guarded-by: _lock
        self.bytes_wire_out = 0  # guarded-by: _lock
        self.bytes_wire_in = 0  # guarded-by: _lock
        self.bytes_raw_in = 0  # guarded-by: _lock
        self.expansions = 0  # guarded-by: _lock
        self.cache_hits = 0  # guarded-by: _lock
        self.cache_hit_bytes = 0  # guarded-by: _lock
        self.lazy_frames = 0  # guarded-by: _lock
        self.compress_s = 0.0  # guarded-by: _lock
        self.decompress_s = 0.0  # guarded-by: _lock

    def negotiated(self, name: str):
        from psana_ray_tpu_torch.obs.registry import ensure_registered

        ensure_registered("wire_codec", self)
        with self._lock:
            self.negotiations[name] = self.negotiations.get(name, 0) + 1

    def compressed(self, raw: int, wire: int, seconds: float):
        with self._lock:
            self.frames_compressed += 1
            self.bytes_raw_out += raw
            self.bytes_wire_out += wire
            self.compress_s += seconds

    def expanded(self, codec_name: str):
        with self._lock:
            self.expansions += 1

    def cache_hit(self, nbytes: int):
        with self._lock:
            self.cache_hits += 1
            self.cache_hit_bytes += nbytes

    def lazy_frame(self):
        with self._lock:
            self.lazy_frames += 1

    def decompressed(self, wire: int, raw: int, seconds: float):
        with self._lock:
            self.frames_decompressed += 1
            self.bytes_wire_in += wire
            self.bytes_raw_in += raw
            self.decompress_s += seconds

    def stats(self) -> dict:
        with self._lock:
            return {
                "negotiations": dict(self.negotiations),
                "frames_compressed_total": self.frames_compressed,
                "frames_decompressed_total": self.frames_decompressed,
                "bytes_raw_out_total": self.bytes_raw_out,
                "bytes_wire_out_total": self.bytes_wire_out,
                "bytes_wire_in_total": self.bytes_wire_in,
                "bytes_raw_in_total": self.bytes_raw_in,
                "expansions_total": self.expansions,
                "cache_hits_total": self.cache_hits,
                "cache_hit_bytes_total": self.cache_hit_bytes,
                "lazy_frames_total": self.lazy_frames,
                "compress_s_total": self.compress_s,
                "decompress_s_total": self.decompress_s,
            }


CODEC_STATS = CodecTelemetry()


def cached_wire_parts(item, codec):
    """Relay pass-through entry: when ``item`` carries compressed bytes
    for exactly ``codec`` (records.wire_cache), return them as a
    single-part payload — WITHOUT touching ``item.panels`` (a
    LazyFrameRecord must not inflate just to be re-sent verbatim).
    None means encode normally. Call BEFORE building raw parts."""
    cache = getattr(item, "wire_cache", None)
    if codec is not None and cache is not None and cache[0] == codec.codec_id:
        CODEC_STATS.cache_hit(cache[2].nbytes)
        return [cache[2]]
    return None


def encode_for_wire(item, codec, pool):
    """THE send-side dispatch both transports share (client put paths
    under the client lock, evloop response/push paths): scatter-gather
    parts for ``item`` under the connection's negotiated ``codec``,
    returned as ``(parts, staging_lease)``. The lease (None on the
    uncompressed / cached / too-small / expansion-fallback paths) backs
    the compressed part — release it only AFTER the parts have fully
    hit the socket. The relay pass-through cache (records.wire_cache)
    is consulted BEFORE building raw parts: a same-codec compressed
    record re-sends its exact received bytes without ever touching
    ``item.panels`` (building raw parts first would inflate every
    LazyFrameRecord and pay the decompression the lazy receive exists
    to avoid)."""
    if codec is None:
        return encode_payload_parts(item), None
    cached = cached_wire_parts(item, codec)
    if cached is not None:
        return cached, None
    return compress_encoded_parts(item, encode_payload_parts(item), codec, pool)


def compress_encoded_parts(item, parts, codec, pool):
    """Compress :func:`encode_payload_parts` output for a connection
    that negotiated ``codec``. Returns ``(wire_parts, staging_lease)``;
    the caller MUST release the lease only after the parts have fully
    hit the socket (it backs the compressed memoryview part). Frames
    that are too small, non-frame payloads, and frames the codec cannot
    shrink pass through UNCHANGED with a None lease — the expansion
    fallback that keeps compression an encoding, never a requirement."""
    if codec is None or not isinstance(item, FrameRecord) or len(parts) != 2:
        return parts, None
    cached = cached_wire_parts(item, codec)
    if cached is not None:
        # a direct caller's relay pass-through: the record arrived
        # compressed with this codec; its cached lease rides the record
        return cached, None
    head, body = parts
    nbody = body.nbytes
    raw_len = len(head) + nbody
    if raw_len > _MAX_RAW_PAYLOAD:
        # an oversized frame that compresses under the cap would die at
        # the receiver's raw_len guard: a poison record for a resend loop
        raise ValueError(
            f"payload length {raw_len} exceeds wire maximum {_MAX_RAW_PAYLOAD}"
        )
    if nbody < WIRE_COMPRESS_MIN:
        return parts, None
    out = pool.lease(nbody)
    t0 = time.monotonic()
    try:
        # budget strictly under the raw body: any accepted encoding is
        # a real win even after the compressed prefix rides along
        clen = codec.compress(
            body, item.panels.dtype.itemsize, out.mv[: nbody - 16]
        )
        if clen is None:
            CODEC_STATS.expanded(codec.name)
            out.release()
            return parts, None
        prefix = (
            TAG_COMPRESSED
            + _CPREFIX.pack(codec.codec_id, raw_len, len(head))
            + head
        )
        CODEC_STATS.compressed(
            raw_len, len(prefix) + clen, time.monotonic() - t0
        )
    except BaseException:
        # a raise anywhere between the lease and the hand-off below must
        # not strand the staging buffer
        out.release()
        raise
    return [prefix, out.mv[:clen]], out


def _decode_compressed(buf, lease, pool, lazy=False):
    """Decompress a TAG_COMPRESSED payload into a fresh lease (or a
    bytearray off the pooled path) and decode the recovered bytes —
    or, with ``lazy`` and a validatable codec, return a
    LazyFrameRecord over the still-compressed bytes. Framing
    corruption becomes ConnectionError — see decode_payload."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    out = None
    try:
        try:
            codec_id, raw_len, head_len = _CPREFIX.unpack_from(mv, 1)
        except struct.error as e:
            raise ValueError(f"short compressed prefix: {e}") from e
        codec = _CODECS_BY_ID.get(codec_id)
        if codec is None:
            raise ValueError(f"unknown wire codec id {codec_id}")
        off = 1 + _CPREFIX.size
        if raw_len > _MAX_RAW_PAYLOAD or head_len > raw_len:
            raise ValueError(
                f"implausible geometry raw_len={raw_len} head_len={head_len}"
            )
        if len(mv) < off + head_len:
            raise ValueError("truncated compressed head")
        if pool is None and lease is not None:
            pool = lease.pool
        body = mv[off + head_len :]
        body_len = raw_len - head_len
        if lazy and lease is not None and hasattr(codec, "validate"):
            rec = _decode_lazy(
                codec, codec_id, mv, lease, pool, off, head_len, body, body_len
            )
            if rec is not None:
                return rec
        if pool is not None:
            out = pool.lease(raw_len)
            dst = out.mv
        else:
            dst = memoryview(bytearray(raw_len))
        t0 = time.monotonic()
        dst[:head_len] = mv[off : off + head_len]
        codec.decompress(body, dst[head_len:])
        CODEC_STATS.decompressed(
            len(mv), raw_len, time.monotonic() - t0
        )
    except ValueError as e:
        if out is not None:
            out.release()
        if lease is not None:
            lease.release()
        raise ConnectionError(f"corrupt compressed wire payload: {e}") from e
    except BaseException:
        if out is not None:
            out.release()
        if lease is not None:
            lease.release()
        raise
    try:
        if raw_len and dst[0] == TAG_COMPRESSED[0]:
            # no encoder nests 'C' in 'C': such a stream is a crafted
            # amplification bomb
            raise ValueError("nested compressed framing")
        rec = decode_payload(dst, lease=out)
    except (ValueError, struct.error) as e:
        # raw bytes that do not parse after a clean inflate (a bad dtype
        # code, a lying shape) are corruption all the same
        if out is not None:
            out.release()
        if lease is not None:
            lease.release()
        raise ConnectionError(f"corrupt compressed wire payload: {e}") from e
    except BaseException:
        if out is not None:
            out.release()
        if lease is not None:
            lease.release()
        raise
    if lease is not None:
        if lazy and isinstance(rec, FrameRecord):
            # a relay's receive whose codec cannot validate lazily: keep
            # the compressed bytes beside the inflated panels, so a push
            # to a peer of the same codec re-sends them verbatim. A plain
            # consumer never relays: its staging lease goes back now
            object.__setattr__(rec, "wire_cache", (codec_id, lease, mv))
        else:
            lease.release()
    return rec


def _decode_lazy(codec, codec_id, mv, lease, pool, off, head_len, body, body_len):
    """The relay's zero-codec-CPU receive: VALIDATE the compressed
    stream (so a corrupt payload still dies here, at receive), parse
    the raw head, and return a LazyFrameRecord whose panels inflate on
    first touch. Returns None when the payload is not a frame (the
    caller decompresses eagerly). Raises ValueError (wrapped by the
    caller) on corruption."""
    from psana_ray_tpu_torch.records import make_lazy_frame, parse_frame_header

    head = mv[off : off + head_len]
    if not head_len or head[0] != TAG_RECORD[0]:
        return None  # compressed pickle/EOS: rare, eager path handles it
    try:
        rank, idx, shape, dtype, energy, ts, version, trace, hdr_len = (
            parse_frame_header(head[1:])
        )
    except (ValueError, struct.error) as e:
        raise ValueError(f"corrupt compressed frame head: {e}") from e
    panel_nbytes = int(np.prod(shape)) * dtype.itemsize if shape else 0
    if hdr_len + 1 != head_len or panel_nbytes != body_len:
        raise ValueError(
            f"compressed head geometry lies: header {hdr_len + 1} vs "
            f"{head_len}, panels {panel_nbytes} vs {body_len}"
        )
    codec.validate(body, body_len)
    CODEC_STATS.lazy_frame()
    # counted as the eager path counts (plain ints: the closure must
    # stay free of cycles)
    wire_len = mv.nbytes
    raw_len = head_len + body_len

    def inflate():
        # returns (panels, lease); must not capture the record (see
        # records.LazyFrameRecord.panels)
        dst_lease = pool.lease(panel_nbytes) if pool is not None else None
        try:
            dst = (
                dst_lease.mv
                if dst_lease is not None
                else memoryview(bytearray(panel_nbytes))
            )
            t0 = time.monotonic()
            codec.decompress(body, dst)  # validated: cannot raise
            CODEC_STATS.decompressed(
                wire_len, raw_len, time.monotonic() - t0
            )
        except BaseException:
            if dst_lease is not None:
                dst_lease.release()
            raise
        return np.frombuffer(dst, dtype=dtype).reshape(shape), dst_lease

    return make_lazy_frame(
        rank, idx, energy, ts, trace, panel_nbytes,
        inflate, (codec_id, lease, mv),
    )
