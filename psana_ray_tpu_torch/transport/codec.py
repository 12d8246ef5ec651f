"""Tagged payloads of the shared-memory ring.

The port's copy of the part of ``psana_ray_tpu/transport/codec.py`` that
the shm ring carries. One leading tag byte selects the codec:

- ``R``: the records wire format (:mod:`psana_ray_tpu_torch.records`);
- ``P``: pickle, for any other Python object;
- ``V``: void, a slot a producer committed after its encode failed
  mid-write; consumers skip it.

``C``, a compressed frame, only arrives over the TCP transport, which is
not ported (Queue 1 Item 8).
"""

from __future__ import annotations

import pickle
from typing import Any

from psana_ray_tpu_torch.records import decode

TAG_RECORD = b"R"
TAG_PICKLE = b"P"
TAG_VOID = b"V"
TAG_COMPRESSED = b"C"


def decode_payload(buf, lease=None) -> Any:
    """Decode a tagged payload (bytes or a memoryview).

    Without ``lease`` the result owns its data. With ``lease`` (a
    checked-out buffer that ``buf`` views) a frame record comes back
    zero-copy with the lease attached (see
    :func:`psana_ray_tpu_torch.records.decode`); any other payload
    releases the lease here, after the parse. Only this process's
    producers and the JAX package's write the pickles it reads."""
    tag = bytes(buf[:1])
    body = buf[1:]
    if tag == TAG_RECORD:
        return decode(body, lease=lease)
    try:
        if tag == TAG_PICKLE:
            return pickle.loads(body)
        if tag == TAG_COMPRESSED:
            raise NotImplementedError(
                "compressed payloads arrive only over the TCP transport, which the port "
                "does not have yet (ROADMAP.md Queue 1 Item 8)")
        raise ValueError(f"unknown payload tag {tag!r}")
    finally:
        if lease is not None:
            lease.release()
